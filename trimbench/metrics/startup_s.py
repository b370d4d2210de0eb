"""Seconds from the process's start to the port's CLI imported, its native
libraries loaded and the CUDA context made (the harness's clock); input
generation is not in it."""

LAYER = "start-up"
UNIT = "s"
MOVES = "setup_s"
WORKLOADS = ["wgs_pe150.bgzf_pair", "amplicon_pe250.plate",
             "amplicon_pe250.pooled"]


def read(run):
    return run.startup_s
