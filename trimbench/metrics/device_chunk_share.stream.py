"""Chunks the router sent to the card over all chunks it routed, %
(``--metrics`` ``hybrid`` counters)."""

from trimbench import readers

LAYER = "router"
UNIT = "%"
MOVES = "bases_per_s"
WORKLOADS = ["wgs_pe150.bgzf_pair", "amplicon_pe250.pooled"]


def read(run):
    return readers.device_chunk_share_pct(run)
