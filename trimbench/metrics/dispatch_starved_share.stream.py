"""The main thread's ``wait.pack_q`` (blocked for the producer's next chunk)
as a share of ``engine`` (all of ``run_pe``), %."""

from trimbench import spans

LAYER = "engine pipeline"
UNIT = "%"
MOVES = "bases_per_s"
WORKLOADS = ["wgs_pe150.bgzf_pair", "amplicon_pe250.pooled"]


def read(run):
    return spans.share_pct(run, ["wait.pack_q"], "engine")
