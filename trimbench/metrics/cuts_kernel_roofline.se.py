"""The cuts kernels' share of their roofline, %: the least bytes of the reads
the card trimmed (``trimbench/roofline.py``) at peak bandwidth, over the
device time of every kernel whose name holds ``trim_cuts``."""

from trimbench import readers

LAYER = "cuts kernel"
UNIT = "%"
MOVES = "bases_per_s"
WORKLOADS = ["encode_se50.bgzf"]


def read(run):
    return readers.cuts_kernel_roofline_pct(run)
