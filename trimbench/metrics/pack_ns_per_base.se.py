"""The ``--metrics`` ``pack`` total (host parse and pack on the producer
thread) over the input bases, ns/base."""

from trimbench import readers

LAYER = "engine producer"
UNIT = "ns/base"
MOVES = "bases_per_s"
WORKLOADS = ["encode_se50.bgzf"]


def read(run):
    return readers.stage_ns_per_base(run, "pack")
