"""Mean over the window's calls of ``call.close_outputs``: the three outputs
closed, with the deflate and write of what the BGZF writer still holds, ms."""

from trimbench import spans

LAYER = "per-file loop"
UNIT = "ms"
MOVES = "bases_per_s"
WORKLOADS = ["amplicon_pe250.pooled"]


def read(run):
    return spans.mean_ms(run, "call.close_outputs")
