"""The main thread's ``wait.pack_q`` (blocked for the producer's next chunk)
as a share of ``engine`` (all of ``run_se``), %."""

from trimbench import spans

LAYER = "engine pipeline"
UNIT = "%"
MOVES = "bases_per_s"
WORKLOADS = ["encode_se50.bgzf"]


def read(run):
    return spans.share_pct(run, ["wait.pack_q"], "engine")
