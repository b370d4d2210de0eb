"""The ``read`` spans (the producer's refills of the BGZF file's decode
window: their inflate, and the live bytes a rotation to a fresh buffer
copies) over the input bases, ns/base."""

from trimbench import spans

LAYER = "engine producer"
UNIT = "ns/base"
MOVES = "bases_per_s"
WORKLOADS = ["encode_se50.bgzf"]


def read(run):
    return spans.ns_per_base(run, "read")
