"""Arithmetic on the program's own spans: the ``spans`` table (per span name
``n``, ``total_ms``, ``self_ms``) of each call's ``--metrics`` summary.

A call's summary holds the table where the program records spans
(``sickle_tpu_torch/utils/metrics.py``).  Where no call of the run holds
the span a metric reads, the reader returns None and the run's line leaves
the metric out.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from .readers import Call, Run


def _spanned(run: Run) -> List[Call]:
    """The completed calls whose summary holds a span table."""
    return [c for c in run.calls
            if c.rc == 0 and c.metrics and "spans" in c.metrics]


def _total_ms(call: Call, names: Sequence[str]) -> float:
    table = call.metrics["spans"]
    return sum(table[n]["total_ms"] for n in names if n in table)


def _found(calls: List[Call], names: Sequence[str]) -> bool:
    return any(n in c.metrics["spans"] for c in calls for n in names)


def ns_per_base(run: Run, name: str) -> Optional[float]:
    """The span's total over the calls' input bases, ns/base."""
    calls = _spanned(run)
    bases = sum(c.bases for c in calls)
    if not bases or not _found(calls, [name]):
        return None
    return sum(_total_ms(c, [name]) for c in calls) * 1e6 / bases


def share_pct(run: Run, names: Sequence[str], whole: str) -> Optional[float]:
    """The named spans' total as a share of the ``whole`` span's total, %,
    over the calls that hold ``whole``."""
    calls = [c for c in _spanned(run) if whole in c.metrics["spans"]]
    total = sum(_total_ms(c, [whole]) for c in calls)
    if total <= 0 or not _found(calls, names):
        return None
    return 100.0 * sum(_total_ms(c, names) for c in calls) / total


def mean_ms(run: Run, name: str) -> Optional[float]:
    """The span's total per call, over the calls that hold it, ms."""
    calls = [c for c in _spanned(run) if name in c.metrics["spans"]]
    if not calls:
        return None
    return sum(_total_ms(c, [name]) for c in calls) / len(calls)
