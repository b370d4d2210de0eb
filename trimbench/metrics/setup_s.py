"""Seconds from the process's start to the window's: start-up, the inputs made
and written (and synced), and the one warm-up call on a small file pair."""

UNIT = "s"


def read(run):
    return run.setup_s
