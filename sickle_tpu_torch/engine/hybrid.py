"""Hybrid device+host chunk dispatch with stall failover (port of the
JAX package's ``engine/hybrid.py`` onto the CUDA device step).

Every chunk is routed to the DEVICE worker while its queue has room and
the device is competitive, and to the HOST cuts kernel (ops.trim_host,
exact scalar semantics in C++) when the device is back-pressured — so a
pass bound by the device path runs at device rate PLUS host rate, and a
pass the device keeps up with runs pure-device.

Structure (this is just a cuts_fn; the engine calls its hooks):

  main thread      submit(): route to device_q (preferred) or host_q,
                   return an ordered _Slot; the engine's finalize window
                   waits on slots in dispatch order as it does for
                   _PendingCodes
  device worker    the ONLY thread that touches CUDA (H2D, launches,
                   event waits), under ``torch.cuda.device`` of the device
                   fn; keeps the engine's H2D/compute overlap window
                   internally
  host worker      runs sk_cuts (GIL released) on host-routed chunks

Failure detection + failover (SURVEY.md §5.4): if a device slot is not
filled within ``rescue_s``, the waiter recomputes the chunk host-side,
fills the slot, and marks the device suspect; new chunks route host-only
until the device worker drains.  The late device result is discarded on
arrival (first fill wins), so a stall costs ``rescue_s`` once instead of
stopping the pass.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import time
from typing import Optional

import torch

from ..ops import TrimParams
from ..ops.trim_host import compute_cuts_host
from ..utils import metrics as _metrics

_SENTINEL = object()


class _Slot:
    """One chunk's result slot; first fill wins (device vs rescue)."""

    __slots__ = ("_ev", "_val", "_lk", "job", "route")

    def __init__(self, job, route):
        self._ev = threading.Event()
        self._val = None
        self._lk = threading.Lock()
        self.job = job  # (seq, qual, lengths) kept for rescue recompute
        self.route = route

    def fill(self, kind, value) -> bool:
        with self._lk:
            if self._val is not None:
                return False
            self._val = (kind, value)
        self._ev.set()
        return True

    def wait(self, timeout=None):
        if self._ev.wait(timeout):
            return self._val
        return None


class _SlotResult:
    """Engine-facing lazy result (duck-types _PendingCodes.materialize)."""

    __slots__ = ("slot", "owner")

    def __init__(self, slot, owner):
        self.slot = slot
        self.owner = owner

    def materialize(self):
        return self.owner._resolve(self.slot)


class HybridCutsFn:
    """Engine cuts_fn wrapping a device cuts_fn with host failover/assist.

    ``device_fn`` may be None (host-only mode: every chunk takes the host
    kernel — the fair same-silicon comparison against the reference's
    pthreads loop).  Thread-safe for the engine's single dispatch thread;
    ``close()`` stops the workers (restarted lazily on next use).
    """

    lazy = True  # engine defers materialize to its finalize window

    def __init__(self, params: TrimParams, device_fn=None,
                 device_depth: int = 1, host_depth: int = 2,
                 rescue_s: Optional[float] = None,
                 host_threads: Optional[int] = None):
        # device_depth=1: the device worker holds one chunk in flight
        # plus one queued (its internal overlap window).  Deeper queues
        # over-commit a slow device: the in-order finalize then waits out
        # each device chunk while the host kernel sits idle.
        self.params = params
        self.device_fn = device_fn
        # a stall costs one rescue_s wait + fast cascade, once, then
        # routing goes host-only until the device worker drains
        self.rescue_s = (rescue_s if rescue_s is not None else
                         float(os.environ.get("SICKLE_TPU_RESCUE_S", "4")))
        self.host_threads = host_threads
        self._device_q: queue.Queue = queue.Queue(maxsize=device_depth)
        self._host_q: queue.Queue = queue.Queue(maxsize=host_depth)
        self._threads: list = []
        self._atexit = False
        self._draining = False
        self._lk = threading.Lock()
        self._suspect = False
        self.n_device = 0
        self.n_host = 0
        self.n_rescued = 0
        self.n_drained = 0
        self.n_probe = 0
        # cost-aware routing: EWMA per-chunk service time of each route.
        # The device gets work while it is COMPETITIVE (<= handicap x the
        # host kernel per chunk); a probe chunk re-tests an uncompetitive
        # device every ``probe_s`` so a recovered device is picked back up.
        self.ewma_dev_ms: Optional[float] = None
        self.ewma_host_ms: Optional[float] = None
        self.device_handicap = float(
            os.environ.get("SICKLE_TPU_DEVICE_HANDICAP", "2.0"))
        self.probe_s = float(os.environ.get("SICKLE_TPU_PROBE_S", "10"))
        self._last_dev_mono = 0.0
        self.last_h2d = 0
        # host-only + native lib: the engine can skip packing row matrices
        # entirely; cuts read records straight from the source buffer via
        # the line index (sk_cuts_indexed) — ~2 fewer bytes of memory
        # traffic per input byte
        from ..io import native as _native

        self._can_index = _native.available()
        self.needs_rows = not (device_fn is None and self._can_index)
        # the engine's finalize window must cover BOTH routes' in-flight
        # depth, or its in-order wait throttles routing to device pace
        # and the host never sees overflow
        self.pipeline_window = (device_depth + host_depth + 1
                                if device_fn is not None else 2)
        # forwarded engine-protocol hook: producer-thread wire prep
        if device_fn is not None and hasattr(device_fn, "prepare"):
            self.prepare = device_fn.prepare

    def _device_competitive(self) -> bool:
        if self.ewma_dev_ms is None:
            return True  # first chunk probes the device
        host = self.ewma_host_ms if self.ewma_host_ms is not None else 15.0
        return self.ewma_dev_ms <= self.device_handicap * max(host, 1.0)

    def wire_useful(self) -> bool:
        """Producer hint: skip the (expensive) wire prep for chunks that
        will route to the host kernel anyway; a device probe computes its
        own wire on the device worker thread."""
        return (self.device_fn is not None and not self._suspect
                and self._device_competitive())

    def want_rows(self) -> bool:
        """Producer hint: pack seq/qual row matrices only for chunks the
        device might see (competitive routing, or a due probe) — the
        indexed host path reads records straight from the source buffer,
        skipping the row memcpy entirely."""
        if self.device_fn is None or not self._can_index:
            return self.device_fn is not None
        if self._suspect:
            return False
        return (self._device_competitive()
                or time.monotonic() - self._last_dev_mono > self.probe_s)

    def _maybe_probe(self, job):
        """Out-of-band device probe: when the device is rated
        uncompetitive, periodically send a DUPLICATE of a chunk to the
        device purely to refresh its service-time EWMA (a recovered
        device is picked back up).  Nothing waits on the probe slot, so a
        slow or stalled probe never blocks the in-order pipeline; its
        result is discarded."""
        if (self.device_fn is None or self._suspect
                or self.ewma_dev_ms is None
                or self._device_competitive()
                or time.monotonic() - self._last_dev_mono < self.probe_s):
            return
        try:
            self._last_dev_mono = time.monotonic()  # one probe in flight
            self._device_q.put_nowait(_Slot(job, "probe"))
            self.n_probe += 1
        except queue.Full:
            pass

    def _wire_estimate(self, qual, wire) -> int:
        if wire is not None:
            try:
                return sum(p.nbytes for p in wire[1]) + 4
            except Exception:
                pass
        return qual.nbytes

    # --- engine entry points --------------------------------------------
    def drain(self):
        """Engine hint: no more chunks are coming (producer finished);
        pending device slots resolve by fast host rescue instead of
        waiting out their device calls.  Cleared on the next dispatch."""
        self._draining = True

    def call_packed(self, packed):
        """Dispatch a PackedReads chunk (engine fast path): a chunk
        whose rows were never packed (indexed mode — host-only, or a
        host-bound stretch of a hybrid run) carries the line index and
        MUST take the host kernel; rows chunks route normally."""
        if not packed.rows_packed:
            ws = packed.workspace
            n = packed.n_records
            self._ensure_workers()
            self._draining = False
            self.last_h2d = 0
            job = ("idx", packed.data, ws.starts4[: 4 * n],
                   ws.lens4[: 4 * n], n)
            slot = _Slot(job, "host")
            self._host_q.put(slot)
            self.n_host += 1
            return _SlotResult(slot, self)
        return self(packed.seq, packed.qual, packed.lengths,
                    qual_clean=packed.qual_clean, wire=packed.wire)

    def __call__(self, seq, qual, lengths, qual_clean=False, wire=None):
        self._ensure_workers()
        self._draining = False
        job = ("rows", seq, qual, lengths, qual_clean, wire)
        # per-chunk wire accounting for --metrics: device routes ship the
        # prepared wire (estimate; the worker transfers asynchronously),
        # host routes ship nothing
        self.last_h2d = 0
        if (self.device_fn is not None and not self._suspect
                and self._device_competitive()):
            try:
                slot = _Slot(job, "device")
                self._device_q.put_nowait(slot)
                self.n_device += 1
                self.last_h2d = self._wire_estimate(qual, wire)
                return _SlotResult(slot, self)
            except queue.Full:
                pass
        if self.device_fn is None:
            slot = _Slot(job, "host")
            self._host_q.put(slot)
            self.n_host += 1
            return _SlotResult(slot, self)
        # both routes exist: prefer device as soon as it frees up, else
        # overflow to the host kernel
        self._maybe_probe(job)
        while True:
            if not self._suspect and self._device_competitive():
                try:
                    slot = _Slot(job, "device")
                    self._device_q.put_nowait(slot)
                    self.n_device += 1
                    self.last_h2d = self._wire_estimate(qual, wire)
                    return _SlotResult(slot, self)
                except queue.Full:
                    pass
            try:
                slot = _Slot(job, "host")
                self._host_q.put_nowait(slot)
                self.n_host += 1
                return _SlotResult(slot, self)
            except queue.Full:
                time.sleep(0.002)

    # --- result resolution (engine finalize thread) ---------------------
    def _resolve(self, slot: _Slot):
        timeout = self.rescue_s if (slot.route == "device"
                                    and self.rescue_s > 0) else None
        if timeout is not None and self._suspect:
            # cascade: once one device chunk stalled, every chunk queued
            # behind the same stalled call is rescued near-immediately
            # instead of serially waiting the full timeout each
            timeout = min(timeout, 0.25)
        if timeout is not None and self._draining:
            # end of input: don't wait out in-flight device calls — the
            # host recomputes the tail in milliseconds and the late
            # device results are discarded (first fill wins)
            timeout = min(timeout, 0.05)
        val = slot.wait(timeout)
        if val is None:
            # device stall (or end-of-input drain): recompute host-side,
            # first fill wins; on a genuine stall, route new chunks
            # host-only until the device worker drains
            if self._draining:
                self.n_drained += 1
            else:
                self._suspect = True
                self.n_rescued += 1
            try:
                val = ("ok", self._host_compute(slot.job))
            except BaseException as e:  # propagate like a worker error
                val = ("err", e)
            if not slot.fill(*val):
                val = slot.wait()  # device won the race after all
        kind, payload = val
        if kind == "err":
            raise payload
        return payload

    # --- workers --------------------------------------------------------
    def _ensure_workers(self):
        with self._lk:
            if any(t.is_alive() for t in self._threads):
                return
            if not self._atexit:
                # a daemon worker blocked inside a device call at
                # interpreter teardown can abort the runtime's exit
                # hooks; drain workers before exit
                import atexit

                atexit.register(self.close)
                self._atexit = True
            self._threads = []
            if self.device_fn is not None:
                t = threading.Thread(target=self._device_loop, daemon=True,
                                     name="sickle-hybrid-device")
                t.start()
                self._threads.append(t)
            t = threading.Thread(target=self._host_loop, daemon=True,
                                 name="sickle-hybrid-host")
            t.start()
            self._threads.append(t)

    def close(self) -> bool:
        """Stop the workers.  Returns False if a worker is WEDGED (a
        device call stalled for minutes holds its thread hostage) — the
        caller should avoid normal interpreter teardown in that case
        (see cli._finish)."""
        with self._lk:
            threads, self._threads = self._threads, []
        if not threads:
            return True

        def send_sentinel(q):
            # NEVER block: a wedged worker leaves its depth-1 queue full,
            # and a blocking put would deadlock close() itself (the exact
            # scenario the wedge detection below must survive).  Drain
            # abandoned slots (their run already failed) to make room.
            for _ in range(3):
                try:
                    q.put_nowait(_SENTINEL)
                    return
                except queue.Full:
                    try:
                        stale = q.get_nowait()
                        if stale is not _SENTINEL:
                            stale.fill("err", RuntimeError("dispatcher closed"))
                    except queue.Empty:
                        pass

        if self.device_fn is not None:
            send_sentinel(self._device_q)
        send_sentinel(self._host_q)
        ok = True
        for t in threads:
            t.join(timeout=5)
            ok = ok and not t.is_alive()
        return ok

    def _host_compute(self, job):
        if job[0] == "idx":
            from ..ops.trim_host import compute_cuts_indexed

            _, data, starts4, lens4, n = job
            return compute_cuts_indexed(data, starts4, lens4, n, self.params,
                                        n_threads=self.host_threads)
        _, seq, qual, lengths, _, _ = job
        return compute_cuts_host(
            seq if self.params.trunc_n else None, qual, lengths,
            self.params, n_threads=self.host_threads,
        )

    def _host_loop(self):
        while True:
            slot = self._host_q.get()
            if slot is _SENTINEL:
                return
            try:
                t0 = time.monotonic()
                with _metrics.span("router.host"):
                    result = self._host_compute(slot.job)
                ms = (time.monotonic() - t0) * 1e3
                e = self.ewma_host_ms
                self.ewma_host_ms = ms if e is None else 0.7 * e + 0.3 * ms
                slot.fill("ok", result)
            except BaseException as e:
                slot.fill("err", e)

    def _device_loop(self):
        """The single CUDA thread, preserving the engine's cross-chunk
        H2D/compute overlap: a dispatched chunk's fetch is deferred until
        one newer chunk has dispatched (or the queue goes idle).  The
        current CUDA device is per thread, so the loop runs under the
        device fn's."""
        dev = getattr(self.device_fn, "device", None)
        ctx = (torch.cuda.device(dev)
               if dev is not None and dev.type == "cuda"
               else contextlib.nullcontext())
        with ctx:
            self._device_loop_on_device()

    def _device_loop_on_device(self):
        from collections import deque

        window = int(os.environ.get("SICKLE_TPU_WINDOW", "1"))
        local: deque = deque()
        while True:
            try:
                with _metrics.span("wait.device_q"):
                    slot = self._device_q.get(
                        timeout=0.002 if local else None)
            except queue.Empty:
                slot = None
            if slot is _SENTINEL:
                while local:
                    self._finish(*local.popleft())
                return
            if slot is not None:
                _, seq, qual, lengths, qual_clean, wire = slot.job
                try:
                    t0 = time.monotonic()
                    with _metrics.span("router.device"):  # H2D and launch
                        result = self.device_fn(seq, qual, lengths,
                                                qual_clean=qual_clean,
                                                wire=wire)
                    local.append((slot, result, t0))
                except BaseException as e:
                    slot.fill("err", e)
            while len(local) > window or (slot is None and local):
                self._finish(*local.popleft())
            if not local and self._device_q.empty():
                self._suspect = False  # drained: give the device a new shot

    def _finish(self, slot, result, t0):
        from .pipeline import _materialize

        try:
            n = slot.job[2].shape[0]
            with _metrics.span("router.device"):  # the event wait and D2H
                codes = _materialize(result, n)
            slot.fill("ok", codes)
            ms = (time.monotonic() - t0) * 1e3
            e = self.ewma_dev_ms
            self.ewma_dev_ms = ms if e is None else 0.7 * e + 0.3 * ms
            self._last_dev_mono = time.monotonic()
        except BaseException as e:
            slot.fill("err", e)  # no-op if a rescue already won


def hybrid_enabled(cfg_hybrid: Optional[bool]) -> bool:
    if cfg_hybrid is not None:
        return cfg_hybrid
    env = os.environ.get("SICKLE_TPU_HYBRID", "").strip()
    if env:
        return env not in ("0", "off", "false")
    return True  # default on: pure-device when the device keeps up anyway
