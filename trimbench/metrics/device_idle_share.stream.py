"""The share of the window in which no kernel, copy or memset ran on the
card, % (the profiler's trace)."""

from trimbench import readers

LAYER = "device"
UNIT = "%"
MOVES = "bases_per_s"
WORKLOADS = ["wgs_pe150.bgzf_pair", "amplicon_pe250.pooled"]


def read(run):
    return readers.device_idle_pct(run)
