"""Reduces a ``torch.profiler`` Chrome trace of the window to device numbers.

The harness marks the window and each call with ``record_function``
(``WINDOW`` and ``CALL`` + the sample), which the trace holds as host
``user_annotation`` events on the device events' clock.  Device work is
every ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` event.  Busy time is
the length of the union of those events within the window; an idle gap is
a stretch of the window between them, named by what the host was doing at
its middle: the innermost of the program's own spans (its ``--metrics``
spans, which it enters as ``record_function`` while a profiler records)
open on the call's thread then, such as ``wait.pack_q``, or, where none
is, the call itself.
"""

from __future__ import annotations

import json
from typing import Dict, List

WINDOW = "trimbench.window"
CALL = "trimbench.call "
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def _label(mid: float, calls: List[tuple], program: List[tuple]) -> str:
    """What the host was doing at ``mid``: the innermost program span on
    the thread of the call then in flight, or the call."""
    for start, end, name, thread in calls:
        if start <= mid <= end:
            inner = [s for s in program
                     if s[3] == thread and s[0] <= mid <= s[1]]
            if inner:
                return max(inner, key=lambda s: (s[0], -s[1]))[2]
            return f"host in cli.main ({name[len(CALL):]})"
    return "host between cli.main calls"


def _span(e: dict) -> tuple:
    """``(start, end, name, thread)`` of a complete event, in us."""
    start = float(e["ts"])
    return start, start + float(e["dur"]), e["name"], (e.get("pid"),
                                                       e.get("tid"))


def reduce(path: str) -> Dict:
    """``busy_s``, ``window_s``, ``ops`` (device seconds by op name, most
    first) and ``gaps`` (the longest idle gaps, labelled, in seconds)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X"]
    window = next(e for e in spans if e.get("name") == WINDOW
                  and e.get("cat") == "user_annotation")
    w0 = float(window["ts"])
    w1 = w0 + float(window["dur"])
    host = [_span(e) for e in spans if e.get("cat") == "user_annotation"]
    calls = sorted(s for s in host if s[2].startswith(CALL))
    program = [s for s in host
               if s[2] != WINDOW and not s[2].startswith(CALL)]
    device = sorted((max(float(e["ts"]), w0),
                     min(float(e["ts"]) + float(e["dur"]), w1), e["name"])
                    for e in spans if e.get("cat") in DEVICE_CATS)
    device = [d for d in device if d[1] > d[0]]
    ops: Dict[str, float] = {}
    for start, end, name in device:
        ops[name] = ops.get(name, 0.0) + (end - start) / 1e6
    busy = 0.0
    gaps = []  # (length, middle)
    edge = w0
    for start, end, _ in device:
        if start > edge:
            gaps.append((start - edge, (start + edge) / 2))
        if end > edge:
            busy += end - max(start, edge)
            edge = end
    if w1 > edge:
        gaps.append((w1 - edge, (w1 + edge) / 2))
    gaps.sort(reverse=True)
    return {
        "busy_s": busy / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "ops": sorted(ops.items(), key=lambda kv: -kv[1]),
        "gaps": [(_label(mid, calls, program), gap / 1e6)
                 for gap, mid in gaps[:TOP]],
    }
