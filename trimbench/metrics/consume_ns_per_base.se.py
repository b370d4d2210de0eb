"""The ``--metrics`` ``consume`` total (quality recheck, assembly and the
BGZF writer on the writer thread) over the input bases, ns/base."""

from trimbench import readers

LAYER = "engine writer"
UNIT = "ns/base"
MOVES = "bases_per_s"
WORKLOADS = ["encode_se50.bgzf"]


def read(run):
    return readers.stage_ns_per_base(run, "consume")
