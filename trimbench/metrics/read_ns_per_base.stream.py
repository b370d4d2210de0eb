"""The ``read`` spans (the producer's chunked reads of the two BGZF mate
files: their inflate, the chunk copies and the mate-pair join) over the
input bases, ns/base."""

from trimbench import spans

LAYER = "engine producer"
UNIT = "ns/base"
MOVES = "bases_per_s"
WORKLOADS = ["wgs_pe150.bgzf_pair"]


def read(run):
    return spans.ns_per_base(run, "read")
