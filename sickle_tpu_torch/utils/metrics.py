"""The port's one recorder: spans and counters of a CLI call (``--metrics``).

The reference's only observability is the ``msg()`` debug macro and
end-of-run counters (the reference's src/sickle.h:99-120,
src/trim_single.cpp:347).  A pipelined engine needs more: when a pass is
slow, the record must say which thread was doing what, chunk by chunk.

A span is a name, its thread, a start and an end (``time.perf_counter_ns``)
and its parent, the enclosing span on the same thread.  Spans stay in
memory and are summarised once, at ``report()``: per name the count, the
total and the self time (total less the child spans on the same thread).
Counters are named integers.  While a ``torch.profiler`` records, every
span is also entered as a ``record_function`` of its name on its own
thread, so it lands in the Chrome trace beside the kernel and copy events,
on their clock.

The five per-chunk stages are spans that also hold the chunk's ordinal;
FIFO queues keep that ordinal the same on every thread, so no chunk ids are
threaded through the queues:

* ``pack``      — host parse+pack (producer thread)
* ``prep``      — wire prep: the chunk's wire plan and field/rank pack
                  (producer thread; once per prepared batch, so a pe
                  chunk dispatched per mate records two)
* ``dispatch``  — device dispatch (main thread; H2D + kernel launch)
* ``fetch``     — result materialization (main thread; D2H sync point)
* ``consume``   — quality recheck + assemble + output write (writer thread)

The other spans, by thread (the names PERF.md cites):

* call: ``call.parse``, ``call.build_cuts_fn``, ``call.open_outputs``,
  ``engine`` (all of ``run_pe``/``run_se``), ``call.close_outputs`` >
  ``bgzf.flush``, ``call.close_cuts_fn``;
* producer: ``read`` (chunked input reads) > ``inflate``;
  ``wait.workspace``, ``wait.pack_q_put``;
* main: ``wait.pack_q``, ``wait.write_q_put``, ``wait.writer_join``;
* writer: ``wait.write_q``; ``consume`` > ``recheck``, ``assemble``,
  ``bgzf.buffer`` (the BGZF writer's copy of what it is handed),
  ``bgzf.flush`` > ``compress``, ``sink.write``;
* router workers: ``router.device``, ``wait.device_q``; ``router.host``.

Counters: ``read_bytes``, ``inflated_bytes``, ``deflate_in_bytes``,
``deflate_out_bytes``, ``sink_bytes``; per chunk the records, input bytes
and H2D bytes; per run the chunks of each device-batch route (pe: one
``combined`` mate-1 + mate-2 batch, two ``split`` batches, one
``interleaved`` batch, or two ``indexed`` per-mate chunks whose rows were
never packed) and, when the cuts fn is the hybrid router, its routing
counters and the EWMA per-chunk service time of each route.

Code that has no engine config (the I/O classes, the router's workers)
reaches the call's recorder through one module-level slot, which
``cli.pe_main``/``se_main`` set for the duration of the call.  With no
recorder every hook costs one ``is None`` test.

Start-up is process-wide: library loads and the CUDA context record one
span each (``record_process``) whether or not ``--metrics`` is given, and
every summary carries them under ``process``.
"""

from __future__ import annotations

import itertools
import json
import sys
import threading
import time
from typing import Optional

# the per-chunk stages, in pipeline order
STAGES = ("pack", "prep", "dispatch", "fetch", "consume")

# the hybrid router's counters, as the --metrics JSON names them
HYBRID_FIELDS = (
    ("chunks_device", "n_device"),
    ("chunks_host", "n_host"),
    ("chunks_rescued", "n_rescued"),
    ("chunks_drained", "n_drained"),
    ("chunks_probe", "n_probe"),
    ("ewma_dev_ms", "ewma_dev_ms"),
    ("ewma_host_ms", "ewma_host_ms"),
)

_ids = itertools.count()  # span ids; next() is atomic under the GIL


def _profiling() -> bool:
    """True while a torch.profiler records, on any thread (the profiler
    sets a process-wide flag as it starts; its own per-thread check is
    True only on the thread that started it)."""
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is None:
        return False
    import torch

    return bool(getattr(prof, "_is_profiler_enabled", False)
                or torch.autograd._profiler_enabled())


class _Span:
    """Context manager recording one span into a Metrics."""

    __slots__ = ("_m", "_name", "_chunk", "_id", "_parent", "_t0", "_rf")

    def __init__(self, m: "Metrics", name: str, chunk: Optional[int] = None):
        self._m = m
        self._name = name
        self._chunk = chunk

    def __enter__(self):
        stack = self._m._stack()
        self._parent = stack[-1] if stack else None
        self._id = next(_ids)
        stack.append(self._id)
        self._rf = None
        if _profiling():
            import torch

            self._rf = torch.profiler.record_function(self._name)
            self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        self._m._stack().pop()
        self._m.spans.append((self._id, self._name, threading.get_native_id(),
                              self._t0, t1, self._parent, self._chunk))
        return False


class Metrics:
    """Records the spans and counters of one CLI call (or engine run)."""

    def __init__(self) -> None:
        # (id, name, native thread id, t0 ns, t1 ns, parent id, chunk)
        self.spans: list = []
        self.counters: dict = {}
        self.records: list = []
        self.in_bytes: list = []
        self.h2d_bytes: list = []
        self.routes: dict = {}
        self.hybrid: Optional[dict] = None
        self.t_start = time.perf_counter()
        self.t_end: Optional[float] = None
        self._local = threading.local()
        self._lock = threading.Lock()
        self._ordinal = dict.fromkeys(STAGES, 0)

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    # -- spans and counters ------------------------------------------
    def span(self, name: str, chunk: Optional[int] = None) -> _Span:
        return _Span(self, name, chunk)

    def add_span(self, name: str, t0_ns: int, t1_ns: int) -> None:
        """Record a span that ended before the recorder existed (the
        call's argument parsing), on this thread, under its open span."""
        stack = self._stack()
        self.spans.append((next(_ids), name, threading.get_native_id(),
                           t0_ns, t1_ns, stack[-1] if stack else None, None))

    def count(self, name: str, n: int) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + int(n)

    def stop(self) -> None:
        """End ``wall_ms`` here (the call's outputs are closed)."""
        self.t_end = time.perf_counter()

    # -- stage hooks (each returns a context manager) -----------------
    def _stage(self, name: str) -> _Span:
        if name == "prep":  # prepares the chunk packed last
            return _Span(self, name, self._ordinal["pack"] - 1)
        chunk = self._ordinal[name]
        self._ordinal[name] = chunk + 1
        return _Span(self, name, chunk)

    def pack(self) -> _Span:
        return self._stage("pack")

    def prep(self) -> _Span:
        return self._stage("prep")

    def add_chunk(self, records: int, in_bytes: int) -> None:
        """Record a packed chunk's size (call once per chunk, post-pack)."""
        self.records.append(records)
        self.in_bytes.append(in_bytes)

    def dispatch(self, h2d_bytes: int) -> _Span:
        self.h2d_bytes.append(h2d_bytes)
        return self._stage("dispatch")

    def add_route(self, name: str) -> None:
        """Count one chunk dispatched by the named route (main thread)."""
        self.routes[name] = self.routes.get(name, 0) + 1

    def add_cuts_fn(self, fn) -> None:
        """Record the hybrid router's counters, when ``fn`` has them
        (call once the run has ended)."""
        if hasattr(fn, "n_device"):
            self.hybrid = {k: getattr(fn, a) for k, a in HYBRID_FIELDS}

    def fetch(self) -> _Span:
        return self._stage("fetch")

    def consume(self) -> _Span:
        return self._stage("consume")

    # -- analysis ------------------------------------------------------
    def stage_ms(self, name: str) -> list:
        """The durations (ms) of the spans named ``name``, in the order
        they ended (per chunk, for a stage)."""
        return [(t1 - t0) / 1e6 for _, n, _, t0, t1, _, _ in self.spans
                if n == name]

    @property
    def n_chunks(self) -> int:
        return len(self.stage_ms("pack"))

    def span_table(self) -> dict:
        """Per span name: ``n``, ``total_ms`` and ``self_ms`` (total less
        the child spans on the same thread)."""
        child_ns: dict = {}
        for _, _, _, t0, t1, parent, _ in self.spans:
            if parent is not None:
                child_ns[parent] = child_ns.get(parent, 0) + t1 - t0
        table: dict = {}
        for sid, name, _, t0, t1, _, _ in self.spans:
            row = table.setdefault(name, [0, 0, 0])
            row[0] += 1
            row[1] += t1 - t0
            row[2] += t1 - t0 - child_ns.get(sid, 0)
        return {name: {"n": n, "total_ms": round(total / 1e6, 3),
                       "self_ms": round(own / 1e6, 3)}
                for name, (n, total, own) in sorted(table.items())}

    def summary(self) -> dict:
        def agg(lst):
            if not lst:
                return {"total_ms": 0.0, "median_ms": 0.0, "max_ms": 0.0}
            return {
                "total_ms": round(sum(lst), 2),
                "median_ms": round(sorted(lst)[len(lst) // 2], 3),
                "max_ms": round(max(lst), 2),
            }

        end = self.t_end if self.t_end is not None else time.perf_counter()
        out = {
            "chunks": self.n_chunks,
            "records": sum(self.records),
            "in_bytes": sum(self.in_bytes),
            "h2d_bytes": sum(self.h2d_bytes),
            "wall_ms": round((end - self.t_start) * 1e3, 2),
        }
        for stage in STAGES:
            out[stage] = agg(self.stage_ms(stage))
        out["routes"] = dict(self.routes)
        if self.hybrid is not None:
            out["hybrid"] = dict(self.hybrid)
        out["spans"] = self.span_table()
        out["counters"] = dict(self.counters)
        out["process"] = {k: dict(v) for k, v in PROCESS.items()}
        return out

    def report(self, stream=None, per_chunk: bool = True) -> None:
        """Human-readable table to ``stream`` (default stderr)."""
        out = stream or sys.stderr
        stage = {s: self.stage_ms(s) for s in STAGES}
        n = len(stage["pack"])
        if per_chunk and n:
            out.write(
                "chunk  records      pack  dispatch     fetch   consume"
                "   h2d_KB\n"
            )
            for i in range(n):
                def col(lst, j=i):
                    return f"{lst[j]:9.2f}" if j < len(lst) else "        -"
                h2d = (f"{self.h2d_bytes[i] / 1024:8.0f}"
                       if i < len(self.h2d_bytes) else "       -")
                rec = (f"{self.records[i]:8d}"
                       if i < len(self.records) else "       -")
                out.write(
                    f"{i:5d} {rec} {col(stage['pack'])}"
                    f" {col(stage['dispatch'])} {col(stage['fetch'])}"
                    f" {col(stage['consume'])} {h2d}\n"
                )
        out.write("metrics: " + json.dumps(self.summary()) + "\n")
        out.flush()


# -- the call's recorder, for code that has no engine config -----------

_CURRENT: Optional[Metrics] = None


def install(metrics: Optional[Metrics]) -> None:
    """Make ``metrics`` the call's recorder (None: no recorder)."""
    global _CURRENT
    _CURRENT = metrics


def span(name: str, metrics: Optional[Metrics] = None):
    """A span of ``name`` in ``metrics``, else in the call's recorder;
    a no-op without either."""
    m = metrics if metrics is not None else _CURRENT
    if m is None:
        return _NULL
    return m.span(name)


def count(name: str, n: int, metrics: Optional[Metrics] = None) -> None:
    """Add ``n`` to the counter ``name`` (as ``span`` finds its recorder)."""
    m = metrics if metrics is not None else _CURRENT
    if m is not None:
        m.count(name, n)


# -- start-up, process-wide ---------------------------------------------

# name -> {"ms": ..., and counters such as "built"}; the first of each
PROCESS: dict = {}


def record_process(name: str, t0_ns: int, **counters) -> None:
    """Record a start-up step of the process (a library load, the CUDA
    context) that began at ``t0_ns`` and ends now; once per process."""
    if name not in PROCESS:
        ms = round((time.perf_counter_ns() - t0_ns) / 1e6, 3)
        PROCESS[name] = {"ms": ms, **{k: int(v) for k, v in counters.items()}}


def maybe(metrics: Optional[Metrics], stage: str, *args):
    """Stage hook that no-ops when metrics is None.

    Returns a context manager; usage:
        with maybe(m, "pack"): ...
    """
    if metrics is None:
        return _NULL
    return getattr(metrics, stage)(*args)


class _NullTimer:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullTimer()
