"""The 95th percentile (nearest rank) of the per-sample wall over the window's
calls, ms."""

from trimbench import readers

LAYER = "per-file loop"
UNIT = "ms"
MOVES = "plate_bases_per_s"
WORKLOADS = ["amplicon_pe250.plate"]


def read(run):
    return readers.percentile_wall_ms(run, 95)
