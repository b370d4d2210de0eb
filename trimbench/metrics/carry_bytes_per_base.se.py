"""The ``carry_bytes`` counter (the live bytes that the producer copied
when its decode window rotated to a fresh buffer) over the input bases,
B/base."""

LAYER = "engine producer"
UNIT = "B/base"
MOVES = "bases_per_s"
WORKLOADS = ["encode_se50.bgzf"]


def read(run):
    calls = [c for c in run.calls if c.rc == 0 and c.metrics
             and "carry_bytes" in c.metrics.get("counters", {})]
    bases = sum(c.bases for c in calls)
    if not bases:
        return None
    return sum(c.metrics["counters"]["carry_bytes"] for c in calls) / bases
