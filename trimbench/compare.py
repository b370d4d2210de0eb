"""The comparison that decides ``correct``: exact, so every limit is 0.

An output is right when its decompressed bytes equal the reference's.
Where they differ, the count is of records: each record of the program's
output that differs from the reference's record at the same position,
plus each record missing or extra.  A call's printed summary is right when
it equals, character for character, what sickle prints.
"""

from __future__ import annotations

from typing import Dict, List

LIMITS = {"wrong_records": 0, "wrong_summaries": 0, "failed_calls": 0}


def _records(data: bytes) -> List[tuple]:
    lines = data.split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    lines += [b""] * (-len(lines) % 4)
    return list(zip(lines[0::4], lines[1::4], lines[2::4], lines[3::4]))


def wrong_records(got: bytes, want: bytes) -> int:
    if got == want:
        return 0
    g, w = _records(got), _records(want)
    return sum(a != b for a, b in zip(g, w)) + abs(len(g) - len(w))


def verdict(numbers: Dict[str, int]) -> bool:
    return all(numbers[name] <= limit for name, limit in LIMITS.items())


def lines(numbers: Dict[str, int]) -> List[str]:
    return [f"check {name}: {numbers[name]} (limit {limit})"
            for name, limit in LIMITS.items()]


def as_json(numbers: Dict[str, int]) -> Dict[str, dict]:
    return {name: {"value": numbers[name], "limit": limit}
            for name, limit in LIMITS.items()}
