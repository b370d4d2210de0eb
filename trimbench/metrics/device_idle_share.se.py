"""The share of the window in which no kernel, copy or memset ran on the
card, % (the profiler's trace)."""

from trimbench import readers

LAYER = "device"
UNIT = "%"
MOVES = "bases_per_s"
WORKLOADS = ["encode_se50.bgzf"]


def read(run):
    return readers.device_idle_pct(run)
