"""What a run records, and the arithmetic its metric files share.

A metric file (``trimbench/metrics/<name>.py``) reads one number from a
``Run``: the harness's clock (host_clock), the program's ``--metrics``
summary of each call (its spans and counters) or the reduced device trace.
A reader that finds nothing to read returns None, and the run's line
leaves that metric out.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional

from . import roofline


@dataclasses.dataclass
class Call:
    """One ``cli.main`` call of the window: one set of mate files (a
    sample's, or a pooled plate's).  ``pairs`` counts the records of one
    mate file, ``bases`` those of all of them."""

    sample: int
    pairs: int
    bases: int
    wall_s: float
    rc: Optional[int]          # None: the call raised
    metrics: Optional[dict]    # the ``--metrics`` summary (traced runs)
    mates: int = 2             # mate files: 2 for ``pe``, 1 for ``se``

    @property
    def reads(self) -> int:
        return self.mates * self.pairs


@dataclasses.dataclass
class Run:
    card: str
    startup_s: float
    setup_s: float
    window_s: float
    bits_per_base: int
    calls: List[Call]
    trace: Optional[dict] = None  # devtrace.reduce() of a traced window


def _done(run: Run) -> List[Call]:
    return [c for c in run.calls if c.rc == 0]


def rate_mbp_s(run: Run) -> Optional[float]:
    """Input bases of the completed calls over the whole window, Mbp/s."""
    bases = sum(c.bases for c in _done(run))
    return bases / run.window_s / 1e6 if bases and run.window_s > 0 else None


def _summarised(run: Run) -> List[Call]:
    return [c for c in _done(run) if c.metrics]


def _per_base(run: Run, value: Callable[[dict], float]) -> Optional[float]:
    calls = _summarised(run)
    bases = sum(c.bases for c in calls)
    return sum(value(c.metrics) for c in calls) / bases if bases else None


def stage_ns_per_base(run: Run, stage: str) -> Optional[float]:
    return _per_base(run, lambda m: m[stage]["total_ms"] * 1e6)


def h2d_bytes_per_base(run: Run) -> Optional[float]:
    return _per_base(run, lambda m: m["h2d_bytes"])


def _card_share(call: Call) -> Optional[float]:
    """The call's share of chunks the router sent to the card."""
    hybrid = call.metrics.get("hybrid")
    if hybrid is None:
        return None
    chunks = hybrid["chunks_device"] + hybrid["chunks_host"]
    return hybrid["chunks_device"] / chunks if chunks else None


def device_chunk_share_pct(run: Run) -> Optional[float]:
    counts = [c.metrics.get("hybrid") for c in _summarised(run)]
    counts = [h for h in counts if h]
    dev = sum(h["chunks_device"] for h in counts)
    total = dev + sum(h["chunks_host"] for h in counts)
    return 100.0 * dev / total if total else None


def device_idle_pct(run: Run) -> Optional[float]:
    if run.trace is None or run.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def kernel_s(run: Run, substring: str) -> float:
    return sum(s for name, s in run.trace["ops"] if substring in name)


def cuts_kernel_roofline_pct(run: Run) -> Optional[float]:
    """The least bytes of the reads the card trimmed (each call's reads
    times its share of chunks sent to the card; all of them where no
    router ran) at peak bandwidth, over the device time of every kernel
    whose name holds ``trim_cuts``."""
    if run.trace is None:
        return None
    least = 0.0
    for call in _summarised(run):
        share = _card_share(call)
        share = 1.0 if share is None else share
        least += share * roofline.least_bytes(call.bases, call.reads,
                                              run.bits_per_base)
    return roofline.share_pct(least, kernel_s(run, "trim_cuts"), run.card)


def mean_file_overhead_ms(run: Run) -> Optional[float]:
    """The harness's wall around each call less the program's own
    ``wall_ms``: argument parsing, the cuts function and router built and
    stopped, the summary, all that lies outside the engine."""
    calls = _summarised(run)
    if not calls:
        return None
    return sum(c.wall_s * 1e3 - c.metrics["wall_ms"] for c in calls) / len(calls)


def percentile_wall_ms(run: Run, pct: float) -> Optional[float]:
    """Nearest-rank percentile of the per-call wall, ms."""
    walls = sorted(c.wall_s * 1e3 for c in _done(run))
    if not walls:
        return None
    return walls[max(0, math.ceil(pct / 100 * len(walls)) - 1)]
