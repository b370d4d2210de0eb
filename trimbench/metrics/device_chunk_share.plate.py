"""Chunks the router sent to the card over all chunks it routed, %
(``--metrics`` ``hybrid`` counters)."""

from trimbench import readers

LAYER = "router"
UNIT = "%"
MOVES = "plate_bases_per_s"
WORKLOADS = ["amplicon_pe250.plate"]


def read(run):
    return readers.device_chunk_share_pct(run)
