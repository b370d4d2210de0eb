"""The ``--metrics`` ``pack`` total (host parse and pack on the producer
thread) over the input bases, ns/base."""

from trimbench import readers

LAYER = "engine producer"
UNIT = "ns/base"
MOVES = "plate_bases_per_s"
WORKLOADS = ["amplicon_pe250.plate"]


def read(run):
    return readers.stage_ns_per_base(run, "pack")
