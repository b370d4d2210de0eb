"""Input bases of all file pairs completed in the window over the whole
window, Mbp/s: the rate at which a deep lane is trimmed."""

from trimbench import readers

UNIT = "Mbp/s"


def read(run):
    return readers.rate_mbp_s(run)
