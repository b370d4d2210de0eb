"""Mean over the window's calls of the harness's wall around ``cli.main`` less
the ``--metrics`` ``wall_ms``: what a file costs outside the engine."""

from trimbench import readers

LAYER = "per-file loop"
UNIT = "ms"
MOVES = "plate_bases_per_s"
WORKLOADS = ["amplicon_pe250.plate"]


def read(run):
    return readers.mean_file_overhead_ms(run)
