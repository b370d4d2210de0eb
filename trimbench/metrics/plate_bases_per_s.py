"""Input bases of all samples completed in the window over the whole
window, Mbp/s: the rate at which a demultiplexed plate is trimmed,
per-file costs included."""

from trimbench import readers

UNIT = "Mbp/s"


def read(run):
    return readers.rate_mbp_s(run)
