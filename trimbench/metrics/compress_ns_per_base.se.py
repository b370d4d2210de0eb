"""The ``compress`` spans (the BGZF writer's deflate, mid-run under
``consume`` and at the outputs' close) over the input bases, ns/base."""

from trimbench import spans

LAYER = "engine writer"
UNIT = "ns/base"
MOVES = "bases_per_s"
WORKLOADS = ["encode_se50.bgzf"]


def read(run):
    return spans.ns_per_base(run, "compress")
