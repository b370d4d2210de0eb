"""Checkpoint/resume for streaming trim runs (SURVEY.md §5.3).

The reference has no restart story beyond trim_all.py's skip-if-exists
(the reference's trim_all.py:70,102).  Here, a sidecar JSON next to the
run records (records consumed, counter state, output byte sizes) after
every durably-written chunk; a restart truncates the outputs to the
recorded sizes and fast-forwards the inputs — valid because the engine's
output is deterministic and order-preserving at any parallelism.

Plain outputs truncate anywhere; gzip outputs are resumable when written
as BGZF (the ``-g`` default with the native codec): every flush emits
whole gzip members, so recorded sizes are member boundaries and
truncate+append yields a valid multi-member stream.  Only SERIAL gzip
output (no native codec) is unresumable — a byte size inside its single
member is not a boundary.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import BinaryIO, Dict, Optional, Sequence


@dataclasses.dataclass
class CheckpointState:
    records_done: int
    counters: Dict[str, int]
    out_sizes: Dict[str, int]  # output path -> byte size


class TrimCheckpoint:
    """Atomic sidecar file (tmp + rename) tracking restartable progress."""

    def __init__(self, path: str):
        self.path = path

    def load(self) -> Optional[CheckpointState]:
        try:
            with open(self.path) as f:
                d = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None
        return CheckpointState(
            records_done=int(d["records_done"]),
            counters={k: int(v) for k, v in d["counters"].items()},
            out_sizes={k: int(v) for k, v in d["out_sizes"].items()},
        )

    def save(self, state: CheckpointState) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(
                {
                    "records_done": state.records_done,
                    "counters": state.counters,
                    "out_sizes": state.out_sizes,
                },
                f,
            )
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    def clear(self) -> None:
        try:
            os.remove(self.path)
        except FileNotFoundError:
            pass


def resume_outputs(state: CheckpointState, streams: Dict[str, BinaryIO]) -> None:
    """Truncate each output stream to its checkpointed size and seek there.

    ``streams`` maps output path -> a file object opened "r+b".
    """
    for path, f in streams.items():
        size = state.out_sizes.get(path, 0)
        f.truncate(size)
        f.seek(size)


def progress_saver(
    ck: TrimCheckpoint,
    counters_to_dict,
    out_streams: Dict[str, BinaryIO],
    every_chunks: int = 1,
):
    """Build an EngineConfig.progress_cb: flush outputs, snapshot sizes,
    persist.  Runs on the writer thread strictly in output order."""
    n = {"chunks": 0}

    def cb(counters):
        n["chunks"] += 1
        if n["chunks"] % every_chunks:
            return
        sizes = {}
        for path, f in out_streams.items():
            f.flush()
            sizes[path] = f.tell()
        d = counters_to_dict(counters)
        ck.save(CheckpointState(records_done=d["total"], counters=d, out_sizes=sizes))

    return cb
