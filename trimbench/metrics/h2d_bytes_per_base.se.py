"""Bytes copied host to device (``--metrics`` ``h2d_bytes``) over the input
bases."""

from trimbench import readers

LAYER = "H2D copy"
UNIT = "B/base"
MOVES = "bases_per_s"
WORKLOADS = ["encode_se50.bgzf"]


def read(run):
    return readers.h2d_bytes_per_base(run)
