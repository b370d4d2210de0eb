"""The share of the window in which no kernel, copy or memset ran on the
card, % (the profiler's trace)."""

from trimbench import readers

LAYER = "device"
UNIT = "%"
MOVES = "plate_bases_per_s"
WORKLOADS = ["amplicon_pe250.plate"]


def read(run):
    return readers.device_idle_pct(run)
