"""The main thread's ``wait.write_q_put`` and ``wait.writer_join`` (blocked
on the writer) as a share of ``engine`` (all of ``run_se``), %."""

from trimbench import spans

LAYER = "engine pipeline"
UNIT = "%"
MOVES = "bases_per_s"
WORKLOADS = ["encode_se50.bgzf"]


def read(run):
    return spans.share_pct(run, ["wait.write_q_put", "wait.writer_join"],
                           "engine")
