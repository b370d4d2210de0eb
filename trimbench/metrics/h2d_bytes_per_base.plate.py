"""Bytes copied host to device (``--metrics`` ``h2d_bytes``) over the input
bases."""

from trimbench import readers

LAYER = "H2D copy"
UNIT = "B/base"
MOVES = "plate_bases_per_s"
WORKLOADS = ["amplicon_pe250.plate"]


def read(run):
    return readers.h2d_bytes_per_base(run)
