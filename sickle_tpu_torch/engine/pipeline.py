"""Pipelined se/pe trimming (the JAX package's engine on the CUDA port).

Three overlapped stages with deterministic, order-preserving output
(unlike the reference's racy detached writer, SURVEY.md §2.4.3):

  [prefetch thread]  read + pack chunk i+1        (host, numpy/C++)
  [main thread]      dispatch device compute i    (H2D + kernel launch)
  [writer thread]    materialize + assemble + write chunk i-1

Chunks hold a fixed record count, so device shapes stay constant.
Counters are exact and global (the reference's pe ``total`` bug,
SURVEY.md §2.4.7, is not reproduced).  The device step is
``_cuda_cuts_fn``: one hand-written CUDA kernel launch per
``[slice_rows, L]`` piece (``ops/trim_cuda.py``), fed raw rows or the
field/rank wire that ``prepare`` packs on the producer thread.  The
cuts fn may be the hybrid router (``engine/hybrid.py``), which decides
per chunk whether rows are packed at all: chunks bound for the indexed
host kernel are parsed but never copied into row matrices.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io as _io
import mmap as _mmap
import os
import queue
import stat as _stat
import threading
import time
from typing import BinaryIO, Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from ..constants import QUALITY_CONSTANTS, Compat
from ..io import native
from ..io.fastq import (
    QUAL_PLANES,
    OutputBuffer,
    PackedReads,
    PackWorkspace,
    _clamp_bm,
    _round_up,
    assemble_records,
    assemble_records_at,
    pack_fastq,
    pack_fastq_stream,
    qual_fields,
    qual_levels,
    qual_rank_fields,
    record_out_sizes,
)
from ..oracle import (
    FastqValidationError,
    PECounters,
    SECounters,
    decode_qual,
    sliding_window_cuts,
)
from ..ops.trim import BIG, MAX_PACKED_L, TrimParams
from ..utils import metrics as _metrics
from ..utils.metrics import Metrics, maybe as _stage
from .chunker import iter_record_chunks

CutsFn = Callable[[np.ndarray, np.ndarray, np.ndarray], Tuple]

_SENTINEL = object()

def _idx_layout(packed):
    """(starts4_view, lens4_view) when the chunk's field views are the
    canonical stride-4 line-index layout sk_plan_assemble reads (base =
    name_start, lines at +0..+3), else None.  True for every packer
    product; defensive for exotic callers passing hand-built
    PackedReads."""
    ns, nl = packed.name_start, packed.name_len
    if (ns.base is not None and ns.strides == (32,)
            and nl.strides == (16,) and ns.dtype == np.int64
            and nl.dtype == np.int32):
        return ns, nl
    return None


def _plan_assemble_fast(out_stream, packed, five, three, compat,
                        three_mask=None):
    """Fused emit: one native call (sk_plan_assemble) does the
    keep-filter, per-record sizes, prefix offsets, and record assembly
    straight into the output mapping, reading the parse line index
    in place — no numpy gathers, no intermediate arrays.

    ``three_mask``: optional bool[n] — rows where it is False are
    dropped (pe pair/single routing: the caller selects which records
    this stream gets by masking, order preserved).

    Returns the records kept, or None when the chunk/stream can't take
    the fused path (no reserve protocol, no stride-4 index
    layout, numpy fallback mode)."""
    reserve = getattr(out_stream, "reserve", None)
    lib = native.get_lib()
    n = packed.n_records
    idx = _idx_layout(packed) if n else None
    if reserve is None or lib is None or n == 0 or idx is None:
        return None if n else 0
    import ctypes

    with _metrics.span("assemble"):
        ns_view, nl_view = idx
        three = np.ascontiguousarray(three, np.int32)
        if three_mask is not None:
            three = np.where(three_mask, three, -1).astype(np.int32)
        five = np.ascontiguousarray(five, np.int32)
        # output bound: each record's emission never exceeds its source
        # extent +1 (a rewritten '+' can outgrow an EMPTY comment line);
        # the span end is the last record's qual line end (qual len ==
        # seq len == lengths[n-1] by validation)
        cap = (int(packed.qual_start[n - 1]) + int(packed.lengths[n - 1])
               + 1 - int(packed.name_start[0])) + n
        buf, start = reserve(cap)
        out_kept = np.zeros(1, np.int64)
        s4 = ctypes.cast(ns_view.ctypes.data, ctypes.POINTER(ctypes.c_int64))
        l4 = ctypes.cast(nl_view.ctypes.data, ctypes.POINTER(ctypes.c_int32))
        total = lib.sk_plan_assemble(
            native.ptr(packed.data, ctypes.c_uint8), s4, l4,
            native.ptr(five, ctypes.c_int32),
            native.ptr(three, ctypes.c_int32),
            n, 1 if compat == Compat.V133 else 0,
            native.ptr(buf[start:], ctypes.c_uint8),
            native.ptr(out_kept, ctypes.c_int64),
            native.N_THREADS,
        )
        out_stream.commit(int(total))
    return int(out_kept[0])


def _assembled(out_stream, data, fields, five, three, compat, qualtype,
               outbuf, n_record_mask=None):
    """Assemble one chunk's (already filtered/ordered) records for
    ``out_stream``: the bytes to write (a view of ``outbuf``, which the
    next assembly reuses), or None when they are already in the stream.

    Streams exposing the ``reserve``/``commit`` protocol (io.output.
    MmapWriter) get records scattered straight into the output file's
    mapped pages — no intermediate buffer, no ``write(2)`` copy (the
    reference pays both: src/trim_single.cpp:390-419).  Everything else
    takes the classic assemble-then-write path.  Callers time the
    assembly, with its record selection, as an ``assemble`` span and
    write after it (``_write``), so a writer's flush is not assembly."""
    k = fields["name_start"].size
    if k == 0:
        return None
    reserve = getattr(out_stream, "reserve", None)
    if reserve is not None and native.available():
        sizes = record_out_sizes(fields["name_len"], fields["comment_len"],
                                 five, three, compat, n_record_mask)
        offsets = np.zeros(k, np.int64)
        if k > 1:
            np.cumsum(sizes[:-1], out=offsets[1:])
        total = int(offsets[-1] + sizes[-1])
        buf, start = reserve(total)
        assemble_records_at(
            data, **fields, five=five, three=three, offsets=offsets + start,
            out_buf=buf, compat=compat, n_record_mask=n_record_mask,
            qualtype=qualtype,
        )
        out_stream.commit(total)
        return None
    return assemble_records(
        data, **fields, five=five, three=three, compat=compat,
        n_record_mask=n_record_mask, qualtype=qualtype, out=outbuf,
    )


def _write(out_stream, b) -> None:
    if b is not None:
        out_stream.write(b)


def _adapt_cuts_fn(fn: CutsFn) -> Callable:
    """Normalize a cuts fn to the kwarg-accepting form
    (seq, qual, lengths, qual_clean=..., wire=...).

    ``qual_clean=True`` tells the device step the packer proved the
    zero-padding invariant (PackedReads.qual_clean), so read lengths can be
    derived on the device; ``wire`` carries the producer-thread-prepared
    wire payload.  Plain 3-arg fns (the host kernel, tests) are wrapped to
    ignore both.
    """
    import inspect

    def forward_attrs(wrapped):
        # engine-protocol attributes (lazy dispatch, producer-thread wire
        # prep) survive the wrapper, or those paths would silently vanish
        for attr in ("lazy", "prepare"):
            if hasattr(fn, attr):
                setattr(wrapped, attr, getattr(fn, attr))
        return wrapped

    try:
        sig = inspect.signature(fn)
        if "wire" in sig.parameters or any(
            p.kind == inspect.Parameter.VAR_KEYWORD
            for p in sig.parameters.values()
        ):
            return fn
        if "qual_clean" in sig.parameters:
            return forward_attrs(
                lambda seq, qual, lengths, qual_clean=False, wire=None: fn(
                    seq, qual, lengths, qual_clean=qual_clean))
    except (TypeError, ValueError):
        pass
    return forward_attrs(
        lambda seq, qual, lengths, qual_clean=False, wire=None: fn(
            seq, qual, lengths))


def _need_rows_fn(cuts_fn):
    """Per-chunk row-packing decision for the producer.  Static for
    plain fns (``needs_rows`` attr; default True); dynamic for hybrid fns
    (``want_rows()``): rows are packed only when the device might see the
    chunk, the indexed host path reads the source buffer directly."""
    want = getattr(cuts_fn, "want_rows", None)
    if want is not None and getattr(cuts_fn, "call_packed", None) is not None:
        return want
    static = bool(getattr(cuts_fn, "needs_rows", True))
    return lambda: static


def _gated_prep(cuts_fn, mtr: Optional[Metrics] = None):
    """Producer-thread wire prep, gated by the fn's routing hint: hybrid
    fns skip the wire prep for chunks that will take the host kernel
    anyway (``wire_useful``).  Timed as the ``prep`` stage when ``mtr``
    collects metrics."""
    prep = getattr(cuts_fn, "prepare", None)
    if prep is None:
        return None
    gate = getattr(cuts_fn, "wire_useful", None)

    def gated(packed):
        # never build wire from unpacked (garbage) rows: an indexed chunk
        # is host-bound by construction
        if gate is None or (packed.rows_packed and gate()):
            with _stage(mtr, "prep"):
                prep(packed)

    return gated


def _finalize_window(cuts_fn) -> int:
    """In-order finalize window (chunks dispatched ahead of the oldest
    un-fetched result).  0 for eager fns; lazy fns default to 1 (the H2D
    and kernel of chunk i+1 start before chunk i's result is
    awaited); hybrid fns advertise a deeper ``pipeline_window`` spanning
    both routes' queues.  ``SICKLE_TPU_WINDOW`` overrides it."""
    if not getattr(cuts_fn, "lazy", False):
        return 0
    env = os.environ.get("SICKLE_TPU_WINDOW")
    if env:
        return int(env)
    return int(getattr(cuts_fn, "pipeline_window", 1))


class _Cancelled(BaseException):
    """Internal: a pipeline stage was cancelled because a peer failed."""


@dataclasses.dataclass
class EngineConfig:
    """Pipeline tuning knobs.

    ``records_per_chunk`` plays the role of the reference's -b batch size
    (bytes), but counted in records so device shapes stay constant.
    ``slice_rows`` is the device launch granularity: each host chunk is
    dispatched as ``[slice_rows, L]`` pieces plus power-of-two tail pieces
    (chunks are padded only to a slice multiple, not to a full chunk).
    """

    records_per_chunk: int = 1 << 16
    prefetch: int = 2
    compat: Compat = Compat.V133
    # cap on one padded device batch's bytes (rows x padded length): long
    # reads (ONT/PacBio) shrink the row count per chunk instead of
    # exploding host/device memory (SURVEY.md §5.7)
    bytes_per_batch: int = 64 << 20
    slice_rows: int = 1 << 16
    # checkpoint/resume (SURVEY.md §5.3): fast-forward this many input
    # records (pe: total mates, even) before processing, and call
    # ``progress_cb(counters)`` after each chunk's output is written —
    # deterministic output makes "records done" a complete restart state
    skip_records: int = 0
    progress_cb: Optional[Callable[[object], None]] = None
    # multi-host input sharding: process at most this many bytes from the
    # stream's starting position (record-aligned by the sharder;
    # parallel.dist.shard_record_ranges).  byte_limit2 bounds pe's second
    # input file.  None = to EOF.
    byte_limit: Optional[int] = None
    byte_limit2: Optional[int] = None
    # the call's span and counter recorder (utils/metrics.py); CLI
    # --metrics.  None = a no-op.
    metrics: Optional[Metrics] = None


def _mmap_input(stream: BinaryIO, byte_limit: Optional[int] = None):
    """``(uint8 view of the readable span, start offset)`` for a plain
    regular-file stream, else ``None``.

    Enables the zero-copy producer: records are parsed straight out of
    the mapped pages (one scan, no chunk byte copies).  Gzip streams,
    pipes, and in-memory streams fall back to the chunked reader.
    ``byte_limit`` bounds the span at ``tell() + byte_limit`` (multi-host
    shard ranges).
    """
    raw = stream.raw if isinstance(stream, _io.BufferedReader) else stream
    if not isinstance(raw, _io.FileIO) or "r" not in getattr(raw, "mode", ""):
        return None
    try:
        st = os.fstat(stream.fileno())
        if not _stat.S_ISREG(st.st_mode) or st.st_size == 0:
            return None
        mm = _mmap.mmap(stream.fileno(), st.st_size, access=_mmap.ACCESS_READ)
    except (OSError, ValueError, AttributeError):
        return None
    arr = np.frombuffer(mm, dtype=np.uint8)
    off = stream.tell()
    if byte_limit is not None:
        arr = arr[: min(arr.size, off + byte_limit)]
    return arr, off


class _LimitedStream:
    """Read-only view of at most ``limit`` bytes from ``stream``'s current
    position (multi-host shard bound for non-mmap inputs)."""

    def __init__(self, stream: BinaryIO, limit: int):
        self._stream = stream
        self._left = limit

    def read(self, n: int = -1) -> bytes:
        if self._left <= 0:
            return b""
        if n is None or n < 0 or n > self._left:
            n = self._left
        data = self._stream.read(n)
        self._left -= len(data)
        return data


def _bounded(stream: BinaryIO, byte_limit: Optional[int]):
    return stream if byte_limit is None else _LimitedStream(stream, byte_limit)


class _RefBuf:
    """One decoded-window buffer with a refcount: the producer holds a
    ref while packing from it, and every chunk packed from it holds one
    until the writer recycles the chunk — so refills can never overwrite
    bytes that output assembly still references."""

    __slots__ = ("arr", "_refs", "_pool", "_lk")

    def __init__(self, arr: np.ndarray, pool: queue.Queue):
        self.arr = arr
        self._refs = 1
        self._pool = pool
        self._lk = threading.Lock()

    def retain(self):
        with self._lk:
            self._refs += 1

    def release(self):
        with self._lk:
            self._refs -= 1
            if self._refs:
                return
        self._pool.put(self.arr)


class _BgzfSource:
    """Zero-copy gzip producer source: BGZF blocks inflate in parallel
    STRAIGHT into the pack source buffer (BgzfReader.inflate_into), and
    records are parsed from it in place — no bytes()/join copies and no
    chunk copies (round-3 VERDICT item 2: the serial read() chain left
    gzip input at 0.44x of a serial-zlib C++ reader).  Buffers rotate
    through a bounded pool, its free (warm) buffers taken first; chunks
    pin their window via _RefBuf.  A rotation's fresh buffer holds the
    live bytes and ``WINDOWS`` inflate windows (or the wanted span, if
    larger), so buffers stay bounded however long the input."""

    # >= the pipeline's in-flight chunk depth so pinned windows never
    # throttle the producer (each ~24 MiB window usually backs one chunk)
    MAX_BUFFERS = 6
    WINDOWS = 4
    extends = True

    def __init__(self, reader, byte_limit: Optional[int], stop: threading.Event):
        self.r = reader
        self.remaining = byte_limit
        self._free: queue.Queue = queue.Queue()
        self._made = 0
        self._stop = stop
        self.cur: Optional[_RefBuf] = None
        self.pos = 0
        self.end = 0

    def _take_buffer(self, size: int) -> np.ndarray:
        try:
            arr = self._free.get_nowait()
        except queue.Empty:
            arr = None
        if arr is None and self._made < self.MAX_BUFFERS:
            self._made += 1
            return np.empty(size, np.uint8)
        while arr is None:  # stop-aware: a failed writer must not deadlock us
            if self._stop.is_set():
                raise _Cancelled()
            try:
                arr = self._free.get(timeout=0.05)
            except queue.Empty:
                continue
        if arr.size < size:
            arr = np.empty(size, np.uint8)
        return arr

    def _rotation_size(self, live: int, need: int, min_total: int) -> int:
        ahead = self.r.peek_window_bytes(self.WINDOWS * self.r.WINDOW_BLOCKS)
        rest = self.r.peek_window_bytes(1 << 62)
        if self.remaining is not None:
            rest = min(rest, self.remaining)
        return live + max(need, min(max(ahead, min_total - live), rest))

    def appendable(self) -> bool:
        """True when the next refill inflates in place (no rotation)."""
        need = self.r.peek_window_bytes()
        return (self.cur is not None and need > 0
                and self.cur.arr.size - self.end >= need)

    def refill(self, min_total: int = 0) -> bool:
        """Extend the live span with the next inflate window.  False at
        EOF/limit.  Appends IN PLACE when the current buffer has room
        (bytes before ``end`` are immutable, so pinned chunks are
        unaffected); rotates to a fresh buffer — sized for
        ``min_total`` so a multi-window chunk rotates once, not per
        window — only when capacity runs out."""
        if self.remaining is not None and self.remaining <= 0:
            return False
        need = self.r.peek_window_bytes()
        if need == 0:
            return False
        live = self.end - self.pos
        if self.cur is None or self.cur.arr.size - self.end < need:
            # rotate: carry the leftover into a fresh buffer
            arr = self._take_buffer(self._rotation_size(live, need, min_total))
            if live:
                arr[:live] = self.cur.arr[self.pos : self.end]
            if self.cur is not None:
                self.cur.release()  # producer's ref on the old window
            self.cur = _RefBuf(arr, self._free)
            self.pos, self.end = 0, live
        n = self.r.inflate_into(self.cur.arr, self.end)
        if n <= 0:
            return False
        if self.remaining is not None:
            n = min(n, self.remaining)
            self.remaining -= n
        self.end += n
        return True

    def exhausted(self) -> bool:
        """True when no further bytes can be produced (the parser may
        then apply EOF trailing-line semantics to the current span)."""
        if self.remaining is not None and self.remaining <= 0:
            return True
        return self.r.peek_window_bytes() == 0

    def view(self) -> np.ndarray:
        return self.cur.arr[: self.end]

    def pin(self) -> _RefBuf:
        """The current window, retained for one packed chunk."""
        self.cur.retain()
        return self.cur

    def close(self):
        if self.cur is not None:
            self.cur.release()
            self.cur = None


class _MappedSource:
    """A plain file's mapped span as a two-file producer source: all of
    it is live from the start, so it never extends and pins nothing."""

    extends = False

    def __init__(self, mapped, skip_records: int = 0):
        arr, off = mapped
        off = _skip_offset(arr, off, 4 * skip_records)
        self._arr = arr
        self.pos = arr.size if off is None else off
        self.end = arr.size

    def view(self) -> np.ndarray:
        return self._arr

    def exhausted(self) -> bool:
        return True

    def appendable(self) -> bool:
        return False

    def pin(self) -> None:
        return None

    def close(self):
        pass


def _bgzf_source(stream, byte_limit, stop) -> Optional[_BgzfSource]:
    from ..io.compression import BgzfReader

    if isinstance(stream, BgzfReader) and native.available():
        return _BgzfSource(stream, byte_limit, stop)
    return None


def _whole_records(src: _BgzfSource) -> int:
    """Whole 4-line records in ``src``'s live span."""
    import ctypes

    view = src.view()[src.pos:]
    return int(native.get_lib().sk_count_newlines(
        native.ptr(view, ctypes.c_uint8), view.size)) // 4


def _extend(src: _BgzfSource, min_total: int, mtr: Optional[Metrics]) -> bool:
    """One window refill of ``src``: a ``read`` span (its inflate
    nested) that counts the bytes it adds as ``read_bytes``, and the live
    bytes a rotation to a fresh buffer copied as ``carry_bytes``."""
    with _metrics.span("read", mtr):
        have = src.end - src.pos  # a rotation keeps the live bytes
        window = src.cur
        more = src.refill(min_total=min_total)
        _metrics.count("read_bytes", src.end - src.pos - have, mtr)
        if window is not None and src.cur is not window:
            _metrics.count("carry_bytes", have, mtr)
    return more


def _produce_bgzf(src, pipe, state, mtr, params, need_rows, eff_fn,
                  prep_put, batch_bytes=None, pair_align=False):
    """Shared zero-copy BGZF producer loop (se and interleaved pe): pack
    records in place from the decode window, extending the span (never
    advancing past partial-record bytes) when a record straddles a
    window, and — for interleaved pairs — handing an odd trailing record
    back to the stream so pairs stay whole.  ``prep_put`` consumes each
    finished chunk (position bookkeeping + wire prep + queue put).
    Each window refill is a ``read`` span (its inflate nested);
    ``carry_bytes`` is counted from 0, so a call without a rotation
    reads 0."""
    _metrics.count("carry_bytes", 0, mtr)

    def extend(min_total: int) -> bool:
        return _extend(src, min_total, mtr)

    try:
        while True:
            eff, bm = eff_fn()
            want = eff * max(state["est"], 300)
            while (src.end - src.pos < want
                   and not pipe.stop.is_set()
                   and extend(want)):
                pass
            if src.end <= src.pos:
                break
            ws = pipe.get_workspace()
            with _stage(mtr, "pack"):
                packed, consumed = pack_fastq_stream(
                    src.view(), src.pos, eff,
                    start_position=state["consumed"],
                    l_max=state["l_max"], batch_multiple=bm,
                    workspace=ws, need_seq=params.trunc_n,
                    est_rec_bytes=state["est"],
                    batch_bytes=batch_bytes,
                    need_rows=need_rows(),
                    at_eof=src.exhausted(),
                )
            n = packed.n_records
            if n == 0:
                # a record spans past the window: extend WITHOUT advancing
                # pos (the n==0 'consumed' covers the partial bytes, which
                # the next pack still needs)
                pipe.ws_pool.put(ws)
                if not extend(2 * want):
                    src.pos += consumed  # true EOF: partial dropped
                    break
                continue
            if pair_align and n % 2 and src.r.peek_window_bytes() > 0:
                # keep pairs whole across window boundaries: hand the odd
                # record back to the stream (it leads the next chunk); at
                # true EOF the odd count stands and errors like the
                # reference.  The dropped row becomes padding again
                # (zero qual, length 0), as the device step requires.
                n -= 1
                consumed = int(ws.starts4[4 * n])
                packed.n_records = n
                packed.lengths[n] = 0
                if packed.rows_packed:
                    packed.qual[n] = 0
            src.pos += consumed
            if n == 0:
                # the odd-carry emptied a single-record window: extend
                pipe.ws_pool.put(ws)
                if not extend(2 * want):
                    break
                continue
            if mtr is not None:
                mtr.add_chunk(n, consumed)
            state["l_max"] = max(state["l_max"], packed.max_len)
            state["est"] = max(state["est"], -(-consumed // n))
            packed.source_ref = src.pin()
            prep_put(packed)
    finally:
        src.close()


def _timed_reads(chunks, mtr: Optional[Metrics], nbytes=len) -> Iterator:
    """``chunks``, each ``next()`` a ``read`` span of ``mtr`` (or of the
    call's recorder), its ``nbytes`` counted as ``read_bytes``."""
    it = iter(chunks)
    while True:
        with _metrics.span("read", mtr):
            chunk = next(it, None)
        if chunk is None:
            return
        _metrics.count("read_bytes", nbytes(chunk), mtr)
        yield chunk


def _skip_offset(arr: np.ndarray, offset: int, n_lines: int) -> Optional[int]:
    """Byte offset just past the ``n_lines``-th newline at/after ``offset``
    (checkpoint fast-forward), or None if the buffer has fewer lines."""
    if n_lines == 0:
        return offset
    import ctypes

    lib = native.get_lib()
    view = arr[offset:]
    if lib is not None:
        pos = int(lib.sk_kth_newline(native.ptr(view, ctypes.c_uint8),
                                     view.size, n_lines))
    else:
        nl = np.flatnonzero(view == 0x0A)
        pos = int(nl[n_lines - 1]) if nl.size >= n_lines else -1
    return None if pos < 0 else offset + pos + 1


def _effective_chunk(cfg: EngineConfig, l_max: int) -> Tuple[int, int]:
    """(records, batch_multiple) for the next chunk, bounded so one padded
    batch stays within ``cfg.bytes_per_batch``.  150 bp reads keep the
    configured chunk/slice shape; 50 kbp reads drop to ~1.3k rows/chunk
    with a matching power-of-two padding multiple."""
    L = max(l_max, 8)
    eff = min(cfg.records_per_chunk, max(8, cfg.bytes_per_batch // L))
    eff &= ~1  # pe interleaved packs mates adjacently; keep pairs whole
    if eff >= cfg.slice_rows:
        return eff, cfg.slice_rows
    return eff, max(8, 1 << (eff.bit_length() - 1))


def _cuda_cuts_fn(params: TrimParams, device, slice_rows: int = 1 << 16) -> CutsFn:
    """The device step on one torch device, on the engine's lazy cuts-fn
    protocol (port of the JAX package's ``_tpu_cuts_fn``):

    * each chunk goes out as ``[slice_rows, L]`` pieces plus the
      power-of-two tail pieces; per piece ONE kernel launch on the current
      stream computes lengths, cuts and the packed int32 codes, and the
      codes come back D2H (``non_blocking``) into pinned host memory
      behind a CUDA event;
    * what a piece ships H2D is chosen per chunk by ``_wire_plan``, as in
      the JAX package: the rank wire (<= 7 distinct quality chars, e.g.
      binned Illumina: ``ceil(log2(levels+1))`` bits per position plus
      the LUT), else the band field wire (``p`` bits per position above
      ``bias``, ``p <= 6``, plus the bias), else the raw uint8 rows (and
      the seq rows under -n).  ``prepare`` packs the wire on the
      producer thread; ``SICKLE_TPU_NO_PLANES`` forces raw rows;
    * per-row lengths are derived in the kernel from the zero padding when
      the packer proved that invariant (``qual_clean``) and the chunk is a
      multiple of 8 rows; otherwise raw rows ship with explicit lengths (a
      NUL inside a read is an invalid quality char and must error, not
      truncate);
    * uniform-length chunks (padding rows are length 0) take the kernel's
      static-window form;
    * ``materialize()`` waits on the events, then decodes
      (``_decode_codes``); rows with ``L >= MAX_PACKED_L`` come back as
      the unpacked ``[3, B]`` result.

    ``device`` may also be a list of devices: the step is then sharded
    row-wise over them (``parallel.mesh.sharded_cuts_fn``), with the JAX
    package's mesh rules: ``slice_rows`` is rounded up to a multiple of
    the device count ``n``; a chunk whose row count is not a multiple of
    ``n`` is padded with length-0 rows (results are cut back to the
    chunk's rows); a chunk that is not a whole number of slices ships raw
    rows with explicit lengths, as one piece.  Each piece is split into
    ``n`` contiguous row blocks, block ``k`` copied to and launched on
    device ``k`` (on its current stream, under ``torch.cuda.device``),
    with its own pinned D2H and event; ``last_h2d`` sums the blocks.

    The H2D copies read the packer's pageable workspace (or the wire
    arrays): such a copy returns once the source bytes are staged, so the
    workspace may be recycled as soon as the call returns.  On a CUDA
    device the kernel library is built and the context created here,
    before the first chunk.  On a CPU device the same steps run the plain
    PyTorch version (``ops/trim.py``).
    """
    from ..ops.trim_cuda import build, trim_cuts, trim_cuts_wire

    mesh = isinstance(device, (list, tuple))
    devices = [torch.device(d) for d in (device if mesh else [device])]
    n_mesh = len(devices)
    for d in set(devices):
        if d.type == "cuda":
            build()
            t0 = time.perf_counter_ns()
            torch.empty(1, device=d)
            _metrics.record_process("load.cuda_context", t0)
    needs_seq = params.trunc_n
    SL = -(-slice_rows // n_mesh) * n_mesh
    enc_offset, enc_qmin, enc_qmax = QUALITY_CONSTANTS[params.qualtype]
    no_planes = bool(os.environ.get("SICKLE_TPU_NO_PLANES"))

    def _wire_plan(qual, qual_clean, B):
        """Per-chunk compressed-wire selection (data-dependent): the
        whole chunk's chars must fit the encoding's range (so the range
        check cannot fire; out-of-range chunks take the raw path whose
        device check preserves the reference's error semantics).  Then
        the cheapest exact format wins:

        * ("rank", levels, p) — <= 7 distinct quality values (binned
          Illumina): chars ship as dictionary ranks in
          p = ceil(log2(levels+1)) bits, regardless of band width;
        * ("band", bias, p)  — narrow band above bias = min - 1,
          p = band bit width (<= 6);
        * None — raw u8 rows.
        """
        if (needs_seq or no_planes or not qual_clean or B % 8
                or qual.shape[1] % 8 or qual.shape[1] >= MAX_PACKED_L
                or (mesh and B % SL)):
            return None
        levels = qual_levels(qual)
        if levels.size == 0:
            return None
        mn, mx = int(levels[0]), int(levels[-1])
        if mn < enc_qmin or mx > enc_qmax:
            return None
        p_band = (mx - (mn - 1)).bit_length()
        p_rank = levels.size.bit_length() if levels.size <= 7 else 99
        if p_rank < min(p_band, QUAL_PLANES + 1):
            return ("rank", levels, p_rank)
        if p_band <= QUAL_PLANES:
            return ("band", mn - 1, max(p_band, 1))
        return None

    def _pieces(B):
        # full slices, then the pow2-padded ragged tail (_clamp_bm) as
        # descending power-of-two pieces
        i = 0
        while i < B:
            rem = B - i
            n = SL if rem >= SL else 1 << (rem.bit_length() - 1)
            yield i, n
            i += n

    def _wire_pieces(qual, plan):
        mode, arg, p = plan
        pack = qual_rank_fields if mode == "rank" else qual_fields
        return [pack(qual[i : i + n], arg, p)
                for i, n in _pieces(qual.shape[0])]

    def prepare(packed):
        """Producer-thread wire prep: pack the chunk's wire fields off the
        dispatch thread.  Stores ``(plan, [per-piece fields])`` on
        ``packed.wire``, or None for raw rows."""
        qual = packed.qual
        plan = _wire_plan(qual, packed.qual_clean, qual.shape[0])
        packed.wire = None if plan is None else (plan, _wire_pieces(qual, plan))

    def to_device(rows: np.ndarray, d: torch.device) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(rows)).to(
            d, non_blocking=True)

    def fetch(codes: torch.Tensor):
        if codes.device.type != "cuda":
            return codes.numpy(), None
        host = torch.empty(codes.shape, dtype=codes.dtype, pin_memory=True)
        host.copy_(codes, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(codes.device))
        return host, done

    def fn(seq, qual, lengths, qual_clean=False, wire=None):
        lengths = np.asarray(lengths)
        n_rows = B = qual.shape[0]
        if B % n_mesh:
            # pad rows so the devices split the chunk evenly; padding rows
            # have length 0 and are discarded
            pad = n_mesh - B % n_mesh
            qual = np.pad(qual, ((0, pad), (0, 0)))
            if needs_seq:
                seq = np.pad(seq, ((0, pad), (0, 0)))
            lengths = np.pad(lengths, (0, pad))
            B += pad
            wire = None
        L = qual.shape[1]
        whole = mesh and B % SL != 0  # ships as one piece
        explicit = not qual_clean or B % 8 != 0 or whole
        # uniform-length chunk (incl. length-0 padding rows): one window
        mx = int(lengths.max()) if lengths.size else 0
        uniform = (mx > 0 and int(np.count_nonzero(
            (lengths == mx) | (lengths == 0))) == lengths.size)
        ul = mx if uniform else None
        plan = None
        if not explicit:
            if wire is not None:
                plan, fields = wire
            else:
                plan = _wire_plan(qual, qual_clean, B)
                fields = _wire_pieces(qual, plan) if plan is not None else None
        if plan is not None:
            mode, arg, p = plan
            if mode == "rank":
                lut = np.zeros(1 << p, np.int32)
                lut[1 : 1 + arg.size] = arg.astype(np.int32) - enc_offset
                kw, side = dict(lut=lut), lut.nbytes
            else:
                kw, side = dict(bias=arg - enc_offset), 4
        parts = []
        h2d = 0
        for k, (i, n) in enumerate([(0, B)] if whole else _pieces(B)):
            if plan is not None:
                h2d += side
            blk = n // n_mesh
            for j, d in enumerate(devices):
                lo, hi = i + j * blk, i + (j + 1) * blk
                with (torch.cuda.device(d) if d.type == "cuda"
                      else contextlib.nullcontext()):
                    if plan is not None:
                        rows = fields[k][j * blk : (j + 1) * blk]
                        codes = trim_cuts_wire(to_device(rows, d), p, L,
                                               params, uniform_len=ul, **kw)
                        h2d += rows.nbytes
                    else:
                        q = to_device(qual[lo:hi], d)
                        s = to_device(seq[lo:hi], d) if needs_seq else None
                        lens = (to_device(lengths[lo:hi].astype(
                            np.int32, copy=False), d) if explicit else None)
                        h2d += (blk * L * (2 if needs_seq else 1)
                                + (4 * blk if explicit else 0))
                        codes = trim_cuts(q, params, lengths=lens, seq=s,
                                          uniform_len=ul)
                    parts.append(fetch(codes))
        fn.last_h2d = h2d
        return _PendingCodes(parts, n_rows)

    fn.prepare = prepare
    fn.device = devices[0]  # the hybrid router's worker runs under it
    fn.lazy = True  # returns _PendingCodes; fetch deferred to the window
    fn.last_h2d = 0
    return fn


class _PendingCodes:
    """One chunk's device results, fetch deferred: the engine dispatches
    chunk i+1's H2D and launches before it waits on chunk i's events.
    ``n``: the chunk's rows (rows past it are mesh padding)."""

    __slots__ = ("parts", "n")

    def __init__(self, parts: list, n: int):
        self.parts = parts  # [(host codes, CUDA event or None)], in row order
        self.n = n

    def materialize(self):
        outs = []
        for host, done in self.parts:
            if done is not None:
                done.synchronize()
                host = host.numpy()
            outs.append(host)
        arr = (outs[0] if len(outs) == 1
               else np.concatenate(outs, axis=outs[0].ndim - 1))
        return _decode_codes(arr[..., : self.n])


def _decode_codes(arr: np.ndarray):
    """Device result -> (five, three, bad) int32 arrays.

    ``arr`` is either the packed per-read int32 codes (see _cuda_cuts_fn)
    or the long-read [3, B] (five, three, flag) stack.  ``bad`` is 0 for
    rows the device flagged as containing an out-of-range quality char,
    BIG otherwise (exact position re-derived host-side from the bytes).
    """
    if arr.ndim == 2:
        five = arr[0].astype(np.int32)
        three = arr[1].astype(np.int32)
        flag = arr[2] != 0
    else:
        three = (arr & 0x7FFF).astype(np.int32) - 1
        five = (arr >> 16).astype(np.int32) - 1
        flag = (arr >> 15) & 1 == 1
    bad = np.where(flag, 0, BIG).astype(np.int32)
    return five, three, bad


def _materialize(result, n: int):
    """Fetch device results -> (five, three, first_bad) numpy arrays.

    Accepts a (five, three, bad) tuple of arrays (the host kernel) or a
    lazy result exposing ``materialize()`` (the device step's deferred
    ``_PendingCodes``)."""
    if hasattr(result, "materialize"):
        five, three, bad = result.materialize()
    else:
        five, three, bad = (np.asarray(r) for r in result)
    return five[:n], three[:n], bad


def _recheck_quality_row(packed: PackedReads, row: int, params: TrimParams):
    """The device flagged an out-of-range quality char in this row; decide
    host-side with the scalar reference semantics.

    Under ``--strict`` every bad char errors (whole-read check).  The
    default matches sickle 1.33 exactly: only chars the scan touches
    error (it breaks at the 3' cut, src/trim.cpp:66-73), so the lazy
    scalar re-scan raises iff the reference would — with its exact
    message — and completes silently for junk past the scan extent
    (whose device-computed cuts are unaffected; see ops.trim.decode_check).
    """
    arr = packed.data
    name = arr[
        packed.name_start[row] : packed.name_start[row] + packed.name_len[row]
    ].tobytes()
    L = int(packed.lengths[row])
    qual = arr[packed.qual_start[row] : packed.qual_start[row] + L].tobytes()
    if params.strict:
        decode_qual(qual, params.qualtype, name)
        raise AssertionError(
            "device flagged a quality error the host cannot find"
        )
    seq = arr[packed.seq_start[row] : packed.seq_start[row] + L].tobytes()
    sliding_window_cuts(
        seq, qual,
        qualtype=params.qualtype,
        qual_threshold=params.qual_threshold,
        length_threshold=params.length_threshold,
        no_fiveprime=params.no_fiveprime,
        trunc_n=params.trunc_n,
        compat=params.compat,
        name=name,
    )


def _check_quality(packed: PackedReads, first_bad: np.ndarray, params: TrimParams):
    with _metrics.span("recheck"):
        n = packed.n_records
        for row in np.flatnonzero(first_bad[:n] < packed.lengths[:n]):
            _recheck_quality_row(packed, int(row), params)


# Process-level reuse pools.  A PackWorkspace's buffers are tens of MB
# and first-touch page faults can cost ~400 us each on some hosts, so a
# run that allocates fresh workspaces pays 100+ ms before the first
# chunk packs; back-to-back runs (bench passes, trim_all directories)
# reuse warm pages instead.  Bounded so idle processes don't hoard.
_POOL_LOCK = threading.Lock()
_WS_POOL: dict = {}  # need_seq -> [PackWorkspace]
_OUTBUF_POOL: list = []
_POOL_MAX = 8


def _ws_checkout(need_seq: bool, n: int) -> list:
    with _POOL_LOCK:
        have = _WS_POOL.setdefault(need_seq, [])
        out = [have.pop() for _ in range(min(len(have), n))]
    out.extend(PackWorkspace(need_seq=need_seq) for _ in range(n - len(out)))
    return out


def _ws_return(need_seq: bool, ws_list: list) -> None:
    with _POOL_LOCK:
        have = _WS_POOL.setdefault(need_seq, [])
        have.extend(ws_list)
        del have[_POOL_MAX:]


def _outbuf_checkout() -> OutputBuffer:
    with _POOL_LOCK:
        if _OUTBUF_POOL:
            return _OUTBUF_POOL.pop()
    return OutputBuffer()


def _outbuf_return(buf: OutputBuffer) -> None:
    with _POOL_LOCK:
        _OUTBUF_POOL.append(buf)
        del _OUTBUF_POOL[_POOL_MAX:]


class _Pipeline:
    """Shared 3-stage machinery; stage bodies are provided by the caller.

    ``producer`` fills ``pack_q`` (and terminates it with the sentinel);
    ``dispatcher(item)`` runs on the main thread (device dispatch);
    ``consume(result)`` runs on the writer thread, strictly in dispatch
    order.  Any stage's exception is re-raised on the main thread; failed
    stages drain their queues so no peer can block forever.  Each
    blocking queue wait is a ``wait.*`` span of ``mtr``.
    """

    def __init__(self, prefetch: int, n_workspaces: int = 0,
                 need_seq: bool = True, mtr: Optional[Metrics] = None):
        self.mtr = mtr
        self.pack_q: queue.Queue = queue.Queue(maxsize=prefetch)
        self.write_q: queue.Queue = queue.Queue(maxsize=prefetch)
        self.errors: list = []
        self.stop = threading.Event()
        # reusable pack workspaces, one per in-flight chunk (+2 slack);
        # producer checks out, writer recycles after materializing
        # results; checked out of (and returned to) the process pool
        self._need_seq = need_seq
        self.ws_pool: queue.Queue = queue.Queue()
        for ws in _ws_checkout(need_seq, n_workspaces):
            self.ws_pool.put(ws)

    def get_workspace(self) -> PackWorkspace:
        # stop-aware: when the writer fails, drained chunks are never
        # recycled, so a plain blocking get would deadlock the producer
        with _metrics.span("wait.workspace", self.mtr):
            while True:
                if self.stop.is_set():
                    raise _Cancelled()
                try:
                    return self.ws_pool.get(timeout=0.05)
                except queue.Empty:
                    continue

    def put(self, item):
        """Hand a packed chunk to the main thread (producer thread)."""
        with _metrics.span("wait.pack_q_put", self.mtr):
            self.pack_q.put(item)

    def recycle(self, *packed_list):
        for p in packed_list:
            if p is None:
                continue
            src = getattr(p, "source_ref", None)
            if src is not None:  # unpin the decoded gzip window
                p.source_ref = None
                src.release()
            if p.workspace is not None:
                self.ws_pool.put(p.workspace)

    def check(self):
        if self.errors:
            raise self.errors[0]

    def _producer_loop(self, producer):
        try:
            producer()
        except _Cancelled:
            pass  # another stage already failed; its error wins
        except BaseException as e:
            self.errors.append(e)
            self.stop.set()
        finally:
            self.put(_SENTINEL)

    def _writer_loop(self, consume):
        while True:
            with _metrics.span("wait.write_q", self.mtr):
                item = self.write_q.get()
            if item is _SENTINEL:
                return
            if self.errors:
                continue  # drain
            try:
                consume(item)
            except BaseException as e:
                self.errors.append(e)
                self.stop.set()

    def run(self, producer, dispatcher, consume, finalize=None, window=0,
            on_drain=None):
        """``finalize``/``window``: dispatched chunks are held in a
        bounded deque and finalized (device-result fetch) on the main
        thread only after ``window`` newer chunks have been dispatched —
        H2D of chunk i+1 overlaps compute/D2H of chunk i.
        ``on_drain`` fires once the producer has delivered its last
        chunk (hybrid fns rescue their pending device tail)."""
        from collections import deque

        tp = threading.Thread(target=self._producer_loop, args=(producer,), daemon=True)
        tw = threading.Thread(target=self._writer_loop, args=(consume,), daemon=True)
        tp.start()
        tw.start()
        pending: deque = deque()
        if finalize is None:
            finalize = lambda item: item  # noqa: E731
            window = 0
        mtr = self.mtr

        def hand_on(item):
            done = finalize(item)
            with _metrics.span("wait.write_q_put", mtr):
                self.write_q.put(done)

        try:
            while True:
                with _metrics.span("wait.pack_q", mtr):
                    item = self.pack_q.get()
                if item is _SENTINEL:
                    break
                if self.stop.is_set():
                    continue  # drain
                pending.append(dispatcher(item))
                while len(pending) > window:
                    hand_on(pending.popleft())
            if on_drain is not None and not self.stop.is_set():
                on_drain()
            while pending and not self.stop.is_set():
                hand_on(pending.popleft())
        finally:
            with _metrics.span("wait.writer_join", mtr):
                self.write_q.put(_SENTINEL)
                tw.join()
            # a dispatch or fetch error leaves the producer blocked on a
            # full pack_q: stop it and drain until it has left
            self.stop.set()
            deadline = time.monotonic() + 10
            while tp.is_alive() and time.monotonic() < deadline:
                try:
                    self.pack_q.get(timeout=0.05)
                except queue.Empty:
                    pass
            drained = []
            while True:
                try:
                    drained.append(self.ws_pool.get_nowait())
                except queue.Empty:
                    break
            _ws_return(self._need_seq, drained)
        self.check()


# ---------------------------------------------------------------------------
# Single-end
# ---------------------------------------------------------------------------


def run_se(
    in_stream: BinaryIO,
    out_stream: BinaryIO,
    params: TrimParams,
    *,
    cfg: Optional[EngineConfig] = None,
    cuts_fn: Optional[CutsFn] = None,
    counters: Optional[SECounters] = None,
) -> SECounters:
    """Trim a single-end stream; returns exact global counters.

    Pass ``counters`` (and ``cfg.skip_records``) to resume a partial run:
    skipped records are fast-forwarded without compute or output.
    """
    cfg = cfg or EngineConfig()
    cuts_fn = _adapt_cuts_fn(
        cuts_fn or _cuda_cuts_fn(params, "cuda", cfg.slice_rows))
    prep = _gated_prep(cuts_fn, cfg.metrics)
    call_packed = getattr(cuts_fn, "call_packed", None)
    # indexed host-cuts mode: the fn reads records straight from the
    # source buffer via the line index, so row matrices are not packed.
    # Hybrid fns decide PER CHUNK (want_rows): rows are packed only when
    # the device might see the chunk
    need_rows = _need_rows_fn(cuts_fn)
    # lazy cuts fns defer the result fetch so chunk i+1's dispatch
    # overlaps chunk i's device compute/D2H (one extra in-flight chunk,
    # hence one extra workspace); hybrid fns ask for a deeper window
    # covering both routes' queues
    window = _finalize_window(cuts_fn)
    pipe = _Pipeline(cfg.prefetch, n_workspaces=cfg.prefetch + 2 + window,
                     need_seq=params.trunc_n, mtr=cfg.metrics)
    counters = counters if counters is not None else SECounters()
    state = {"consumed": cfg.skip_records, "l_max": 0, "est": 0}
    outbuf = _outbuf_checkout()
    mtr = cfg.metrics

    mapped = (_mmap_input(in_stream, cfg.byte_limit)
              if native.available() else None)

    def producer():
        if mapped is not None:
            # zero-copy: parse fixed-record chunks straight from the mmap
            arr, off = mapped
            off = _skip_offset(arr, off, 4 * cfg.skip_records)
            while off is not None and off < arr.size:
                ws = pipe.get_workspace()
                eff, bm = _effective_chunk(cfg, state["l_max"])
                with _stage(mtr, "pack"):
                    packed, consumed = pack_fastq_stream(
                        arr, off, eff,
                        start_position=state["consumed"],
                        l_max=state["l_max"],
                        batch_multiple=bm,
                        workspace=ws,
                        need_seq=params.trunc_n,
                        est_rec_bytes=state["est"],
                        batch_bytes=cfg.bytes_per_batch,
                        need_rows=need_rows(),
                    )
                off += consumed
                if packed.n_records == 0:  # trailing partial record
                    pipe.ws_pool.put(ws)
                    break
                if mtr is not None:
                    mtr.add_chunk(packed.n_records, consumed)
                state["consumed"] += packed.n_records
                state["l_max"] = max(state["l_max"], packed.max_len)
                state["est"] = max(state["est"], -(-consumed // packed.n_records))
                if prep is not None:
                    prep(packed)  # wire prep off the dispatch thread
                pipe.put(packed)
            return
        src = (_bgzf_source(in_stream, cfg.byte_limit, pipe.stop)
               if cfg.skip_records == 0 else None)
        if src is not None:
            # zero-copy gzip: BGZF windows inflate straight into the pack
            # source buffer; records parse in place (see _BgzfSource)
            def prep_put(packed):
                state["consumed"] += packed.n_records
                if prep is not None:
                    prep(packed)
                pipe.put(packed)

            _produce_bgzf(src, pipe, state, mtr, params, need_rows,
                          lambda: _effective_chunk(cfg, state["l_max"]),
                          prep_put, batch_bytes=cfg.bytes_per_batch)
            return
        for chunk in _timed_reads(iter_record_chunks(
            _bounded(in_stream, cfg.byte_limit),
            lambda: _effective_chunk(cfg, state["l_max"])[0],
            skip_records=cfg.skip_records,
            max_chunk_bytes=3 * cfg.bytes_per_batch,
        ), mtr):
            with _stage(mtr, "pack"):
                packed = pack_fastq(
                    chunk,
                    start_position=state["consumed"],
                    l_max=state["l_max"],
                    batch_multiple=_effective_chunk(cfg, state["l_max"])[1],
                    workspace=pipe.get_workspace(),
                    need_seq=params.trunc_n,
                    batch_bytes=cfg.bytes_per_batch,
                    need_rows=need_rows(),
                )
            if mtr is not None:
                mtr.add_chunk(packed.n_records, len(chunk))
            state["consumed"] += packed.n_records
            state["l_max"] = max(state["l_max"], packed.max_len)
            if prep is not None:
                prep(packed)  # wire prep off the dispatch thread
            pipe.put(packed)

    def dispatcher(packed: PackedReads):
        # device work starts here (main thread, or the hybrid fn's
        # device worker); the result fetch happens in finalize, after
        # `window` newer dispatches, so H2D overlaps compute across chunks
        h2d = packed.qual.nbytes * (2 if params.trunc_n else 1)
        with _stage(mtr, "dispatch", h2d):
            if call_packed is not None:
                result = call_packed(packed)
            else:
                result = cuts_fn(packed.seq, packed.qual, packed.lengths,
                                 qual_clean=packed.qual_clean,
                                 wire=packed.wire)
        if mtr is not None:  # bytes actually shipped by the device step
            mtr.h2d_bytes[-1] = getattr(cuts_fn, "last_h2d", h2d)
        return packed, result

    def finalize(item):
        packed, result = item
        with _stage(mtr, "fetch"):
            mat = _materialize(result, packed.n_records)
        return packed, mat

    def consume(item):
        packed, (five, three, first_bad) = item
        with _stage(mtr, "consume"):
            _check_quality(packed, first_bad, params)
            n = packed.n_records
            kept = _plan_assemble_fast(out_stream, packed, five, three,
                                       cfg.compat)
            if kept is None:
                keep = three >= 0
                kept = int(keep.sum())
                if kept:
                    with _metrics.span("assemble"):
                        idx = np.flatnonzero(keep)
                        b = _assembled(
                            out_stream, packed.data, _sel(packed, idx),
                            five[idx].astype(np.int64),
                            three[idx].astype(np.int64),
                            cfg.compat, params.qualtype, outbuf,
                        )
                    _write(out_stream, b)
            counters.kept += kept
            counters.discarded += n - kept
            counters.total += n
            pipe.recycle(packed)
        if cfg.progress_cb is not None:
            cfg.progress_cb(counters)

    try:
        pipe.run(producer, dispatcher, consume, finalize=finalize,
                 window=window, on_drain=getattr(cuts_fn, "drain", None))
    finally:
        _outbuf_return(outbuf)
    if mtr is not None:
        mtr.add_cuts_fn(cuts_fn)
    return counters


# ---------------------------------------------------------------------------
# Paired-end
# ---------------------------------------------------------------------------


def _pair_chunks_two_file(
    in1: BinaryIO, in2: BinaryIO, records_per_chunk, skip_each: int = 0,
    max_chunk_bytes: int = 0,
) -> Iterator[Tuple[bytes, bytes]]:
    # Only file 1 is byte-capped; file 2 follows file 1's exact record
    # count, so a short (byte-capped) chunk can never desynchronize the
    # pair streams even when mate record sizes differ.
    follow = {"n": 0}
    it1 = iter_record_chunks(in1, records_per_chunk, skip_records=skip_each,
                             max_chunk_bytes=max_chunk_bytes)
    it2 = iter_record_chunks(in2, lambda: follow["n"], skip_records=skip_each)
    while True:
        c1 = next(it1, None)
        if c1 is not None:
            nl = c1.count(b"\n")
            if not c1.endswith(b"\n"):
                nl += 1
            follow["n"] = max(nl // 4, 1)
        c2 = next(it2, None)
        if c1 is None and c2 is None:
            return
        if c1 is None or c2 is None:
            raise FastqValidationError(
                "Batch2 and Batch1 have different lengths, exiting"
            )
        yield c1, c2


def run_pe(
    in1: BinaryIO,
    in2: Optional[BinaryIO],
    *,
    interleaved: bool = False,
    out1: Optional[BinaryIO] = None,
    out2: Optional[BinaryIO] = None,
    singles_out: Optional[BinaryIO] = None,
    n_record_mode: bool = False,
    params: TrimParams,
    cfg: Optional[EngineConfig] = None,
    cuts_fn: Optional[CutsFn] = None,
    counters: Optional[PECounters] = None,
) -> PECounters:
    """Trim a paired-end stream.

    Modes (reference src/trim_paired.cpp:626-731):
    * two-file: ``in1``/``in2`` -> ``out1``/``out2`` + ``singles_out``
    * interleaved (-c -m): ``in1`` -> ``out1`` (interleaved) + ``singles_out``
    * interleaved -M (``n_record_mode``): ``in1`` -> ``out1`` with failed
      mates replaced by N records (pairing preserved); no singles file.

    Pair decision per src/trim_paired.cpp:543-567: both pass -> pair
    outputs; one passes -> singles (or N record); neither -> discarded
    (or two N records).

    Device batches: interleaved chunks ship as one ``[2n, L]`` batch
    (mates adjacent).  Two-file chunks from regular or BGZF files ship as
    one combined batch too (mate-1 rows, then mate-2 rows, packed into one
    workspace), or — when mate-2 rows outgrow mate-1's row stride — as
    two batches, one per mate file (the "split" route).
    """
    cfg = cfg or EngineConfig()
    cuts_fn = _adapt_cuts_fn(
        cuts_fn or _cuda_cuts_fn(params, "cuda", cfg.slice_rows))
    prep = _gated_prep(cuts_fn, cfg.metrics)
    call_packed = getattr(cuts_fn, "call_packed", None)
    need_rows = _need_rows_fn(cuts_fn)  # see run_se
    window = _finalize_window(cuts_fn)  # see run_se
    # two-file runs check out one workspace per mate file per chunk
    pipe = _Pipeline(cfg.prefetch,
                     n_workspaces=(cfg.prefetch + 2 + window)
                     * (1 if interleaved else 2),
                     need_seq=params.trunc_n, mtr=cfg.metrics)
    counters = counters if counters is not None else PECounters()
    if cfg.skip_records % 2:
        raise ValueError("pe skip_records must be even (whole pairs)")
    state = {"consumed": cfg.skip_records, "l_max": 0, "est": 0}
    outbuf = _outbuf_checkout()
    mtr = cfg.metrics

    def eff_chunk():
        """Per-chunk (records, batch_multiple), byte-capped for long reads.
        Both are even (whole pairs; mates packed adjacently always land in
        the same padded batch)."""
        eff, bm = _effective_chunk(cfg, state["l_max"])
        if bm % 2:
            bm *= 2
        return eff, bm

    def pack(chunk: bytes) -> PackedReads:
        with _stage(mtr, "pack"):
            packed = pack_fastq(
                chunk,
                start_position=state["consumed"],
                l_max=state["l_max"],
                batch_multiple=eff_chunk()[1],
                workspace=pipe.get_workspace(),
                need_seq=params.trunc_n,
                batch_bytes=cfg.bytes_per_batch,
                need_rows=need_rows(),
            )
        if mtr is not None:
            mtr.add_chunk(packed.n_records, len(chunk))
        state["l_max"] = max(state["l_max"], packed.max_len)
        return packed

    def put_interleaved(packed: PackedReads):
        if packed.n_records % 2:
            raise FastqValidationError(
                "Reading interleaved pair: read1 loaded, but no read2 "
                "to load. Maybe it's not an interleaved file?"
            )
        state["consumed"] += packed.n_records
        if prep is not None:
            prep(packed)  # wire prep off the dispatch thread
        pipe.put((packed, None))

    def producer():
        if interleaved:
            mapped = (_mmap_input(in1, cfg.byte_limit)
                      if native.available() else None)
            if mapped is not None:  # zero-copy (see run_se)
                arr, off = mapped
                off = _skip_offset(arr, off, 4 * cfg.skip_records)
                while off is not None and off < arr.size:
                    ws = pipe.get_workspace()
                    eff, bm = eff_chunk()
                    with _stage(mtr, "pack"):
                        packed, consumed = pack_fastq_stream(
                            arr, off, eff,
                            start_position=state["consumed"],
                            l_max=state["l_max"],
                            batch_multiple=bm,
                            workspace=ws,
                            need_seq=params.trunc_n,
                            est_rec_bytes=state["est"],
                            need_rows=need_rows(),
                        )
                    off += consumed
                    if packed.n_records == 0:
                        pipe.ws_pool.put(ws)
                        break
                    if mtr is not None:
                        mtr.add_chunk(packed.n_records, consumed)
                    state["l_max"] = max(state["l_max"], packed.max_len)
                    state["est"] = max(
                        state["est"], -(-consumed // packed.n_records)
                    )
                    put_interleaved(packed)
                return
            src = (_bgzf_source(in1, cfg.byte_limit, pipe.stop)
                   if cfg.skip_records == 0 else None)
            if src is not None:  # zero-copy gzip (see run_se)
                _produce_bgzf(src, pipe, state, mtr, params, need_rows,
                              eff_chunk, put_interleaved, pair_align=True)
                return
            for chunk in _timed_reads(iter_record_chunks(
                _bounded(in1, cfg.byte_limit), lambda: eff_chunk()[0],
                skip_records=cfg.skip_records,
                max_chunk_bytes=3 * cfg.bytes_per_batch, align_records=2,
            ), mtr):
                put_interleaved(pack(chunk))
        else:
            m1 = (_mmap_input(in1, cfg.byte_limit)
                  if native.available() else None)
            m2 = (_mmap_input(in2, cfg.byte_limit2)
                  if native.available() else None)
            if m1 is not None and m2 is not None:
                skip_each = cfg.skip_records // 2
                _produce_two_file(_MappedSource(m1, skip_each),
                                  _MappedSource(m2, skip_each), skip_each)
                return
            if cfg.skip_records == 0:
                # zero-copy gzip: each mate's BGZF windows inflate straight
                # into its pooled pack source buffers (see _BgzfSource)
                s1 = _bgzf_source(in1, cfg.byte_limit, pipe.stop)
                s2 = (_bgzf_source(in2, cfg.byte_limit2, pipe.stop)
                      if s1 is not None else None)
                if s2 is not None:
                    _produce_two_file(s1, s2, 0)
                    return
            # serial gzip, pipes, a BGZF and plain pair, resumes: pack both
            # mate files' chunks as ONE batch (mate-2 rows after mate-1
            # rows): one device call per chunk, one shared source buffer
            # for output assembly (incl. mixed-source singles)
            def joined(pairs):
                for c1, c2 in pairs:
                    if not c1.endswith(b"\n"):
                        c1 += b"\n"  # keep c2's first line separate at EOF
                    yield c1.count(b"\n") // 4, c1 + c2

            for n1, chunk in _timed_reads(joined(_pair_chunks_two_file(
                _bounded(in1, cfg.byte_limit), _bounded(in2, cfg.byte_limit2),
                lambda: max(eff_chunk()[0] // 2, 4),
                skip_each=cfg.skip_records // 2,
                max_chunk_bytes=3 * cfg.bytes_per_batch,
            )), mtr, nbytes=lambda item: len(item[1])):
                packed = pack(chunk)
                if packed.n_records != 2 * n1:
                    raise FastqValidationError(
                        "Batch2 and Batch1 have different lengths, exiting"
                    )
                state["consumed"] += packed.n_records
                if prep is not None:
                    prep(packed)
                pipe.put((packed, n1))

    def _produce_two_file(s1, s2, pos):
        """Zero-copy two-file producer, ONE device batch per chunk: both
        mate files are parsed in place from their sources into one shared
        workspace (mate-2 rows after mate-1 rows via an offset view), so
        the chunk ships as a single combined [2*n1, L] dispatch.  The
        per-mate index metadata stays separate (two source buffers) for
        output assembly.  Record positions are per input file, as in the
        reference's two readers (src/trim_paired.cpp:670-680); ``pos`` is
        the first chunk's.

        A source is a mapped plain file (``_MappedSource``: all of it
        live) or a BGZF reader's window (``_BgzfSource``), extended a
        ``read`` span at a time: in place while its buffer has room, and
        into a fresh buffer only while little of it is live, so a chunk
        ends at a buffer's end rather than carrying most of itself over.
        Mate 2 packs exactly mate 1's record count, extending its window
        until it holds them.  Each chunk pins the windows it was parsed
        from.

        Falls back to two independent batches for a chunk when the
        combined pack cannot share one row stride (row-length growth
        discovered mid-chunk) or when the chunk's rows are not packed
        (indexed host-cuts mode: a combined line index cannot span two
        buffers, so indexed chunks keep per-mate dispatch).  Queue items
        are ``((pk1, pk2, comb), None)``; ``comb`` is the combined batch,
        or None for per-mate dispatch."""
        zero_copy = s1.extends  # BGZF windows, not mapped files
        _metrics.count("pair_zero_copy_chunks", 0, mtr)
        _metrics.count("carry_bytes", 0, mtr)
        est2 = 0  # mate 2's bytes a record (state["est"] is mate 1's)

        def fill(s, want):
            # a rotation carries the live bytes: rotate only while they
            # are at most an eighth of the chunk's
            while (s.extends and s.end - s.pos < want
                   and not pipe.stop.is_set()
                   and (s.appendable() or s.end - s.pos <= want // 8)
                   and _extend(s, want, mtr)):
                pass

        def pack_from(s, n, least, ws, l_max, nr, bm, want):
            """Up to ``n`` records of ``s``, extending it while fewer
            than ``least`` are whole and more bytes can come."""
            while True:
                eof = s.exhausted()
                pk, c = pack_fastq_stream(
                    s.view(), s.pos, n, start_position=pos,
                    l_max=l_max, batch_multiple=bm, workspace=ws,
                    need_seq=params.trunc_n, est_rec_bytes=state["est"],
                    batch_bytes=cfg.bytes_per_batch, need_rows=nr,
                    at_eof=eof,
                )
                if (pk.n_records >= least or eof
                        or not _extend(s, max(want, 2 * (s.end - s.pos)),
                                       mtr)):
                    return pk, c

        try:
            while True:
                pk1 = pk2 = comb = None
                n1 = n2 = 0
                c1 = c2 = 0
                eff, bm = eff_chunk()
                combine = nr = need_rows()
                want1 = eff * max(state["est"], 300)
                want2 = eff * max(est2, state["est"], 300)
                fill(s1, want1)
                fill(s2, want2)
                if pipe.stop.is_set():
                    raise _Cancelled()  # a window may not have been taken
                if s2.extends and not (s2.appendable() or s2.exhausted()):
                    # mate 2 rotates at its next refill: take no more pairs
                    # than its window holds whole, so it carries < a record
                    with _metrics.span("read", mtr):
                        whole = _whole_records(s2)
                    eff = min(eff, whole) if whole else eff
                with _stage(mtr, "pack"):
                    ws1 = None
                    if s1.pos < s1.end:
                        ws1 = pipe.get_workspace()
                        if combine:
                            # reserve rows for BOTH mates up front: a later
                            # ensure() would reallocate and drop mate-1's
                            # rows
                            ws1.ensure(2 * eff + bm,
                                       _round_up(max(state["l_max"], 1), 8),
                                       bm)
                        pk1, c1 = pack_from(s1, eff, 1, ws1, state["l_max"],
                                            nr, bm, want1)
                        s1.pos += c1
                        state["l_max"] = max(state["l_max"], pk1.max_len)
                        n1 = pk1.n_records
                        if n1:
                            state["est"] = max(state["est"], -(-c1 // n1))
                        else:
                            pipe.ws_pool.put(ws1)
                            ws1 = pk1 = None
                    if s2.pos < s2.end:
                        least = n1 if n1 else 1
                        ws2 = (_OffsetWorkspace(ws1, n1, pk1.max_len)
                               if combine and n1 else pipe.get_workspace())
                        try:
                            pk2, c2 = pack_from(
                                s2, least, least, ws2,
                                pk1.max_len if combine and n1
                                else state["l_max"], nr, bm, want2)
                        except _OffsetOverflow:
                            # mate-2 rows outgrow the shared stride: repack
                            # this chunk as two independent batches.  The
                            # failed facade pack may have scribbled on
                            # pk1's padding rows — restore the all-zero
                            # invariant the device step derives lengths
                            # from.
                            if pk1.n_records < pk1.batch_size:
                                pk1.qual[pk1.n_records:] = 0
                                pk1.lengths[pk1.n_records:] = 0
                            ws2 = pipe.get_workspace()
                            pk2, c2 = pack_from(s2, least, least, ws2,
                                                state["l_max"], nr, bm, want2)
                        s2.pos += c2
                        state["l_max"] = max(state["l_max"], pk2.max_len)
                        n2 = pk2.n_records
                        if n2:
                            est2 = max(est2, -(-c2 // n2))
                        if isinstance(ws2, _OffsetWorkspace):
                            pk2.workspace = None  # ws1 owns the rows
                            if n2 == n1:
                                comb = _combined_pair_batch(pk1, pk2, ws1, bm)
                        if n2 == 0:
                            if not isinstance(ws2, _OffsetWorkspace):
                                pipe.ws_pool.put(ws2)
                            pk2 = None
                if n1 != n2:
                    pipe.recycle(pk1, pk2)
                    raise FastqValidationError(
                        "Batch2 and Batch1 have different lengths, exiting"
                    )
                if n1 == 0:
                    return
                pk1.source_ref = s1.pin()
                pk2.source_ref = s2.pin()
                if mtr is not None:
                    mtr.add_chunk(2 * n1, c1 + c2)
                if zero_copy:
                    _metrics.count("pair_zero_copy_chunks", 1, mtr)
                pos += n1
                state["consumed"] += 2 * n1
                if prep is not None:
                    if comb is not None:
                        prep(comb)
                    else:
                        prep(pk1)
                        prep(pk2)
                pipe.put(((pk1, pk2, comb), None))
        finally:
            s1.close()
            s2.close()

    def dispatcher(item):
        # device work is only started here; fetch deferred to finalize
        packed, n1 = item
        mul = 2 if params.trunc_n else 1

        def call(pk):
            if call_packed is not None:
                return call_packed(pk)
            return cuts_fn(pk.seq, pk.qual, pk.lengths,
                           qual_clean=pk.qual_clean, wire=pk.wire)

        if isinstance(packed, tuple):  # mate batches (mmap producer)
            pk1, pk2, comb = packed
            if comb is not None:
                # one combined [2*n1, L] dispatch: one set of pieces
                with _stage(mtr, "dispatch", comb.qual.nbytes * mul):
                    result = call(comb)
                if mtr is not None:
                    mtr.h2d_bytes[-1] = getattr(cuts_fn, "last_h2d",
                                                comb.qual.nbytes * mul)
                    mtr.add_route("combined")
                return packed, n1, result
            with _stage(mtr, "dispatch",
                        (pk1.qual.nbytes + pk2.qual.nbytes) * mul):
                r1 = call(pk1)
                h2d = getattr(cuts_fn, "last_h2d", pk1.qual.nbytes * mul)
                r2 = call(pk2)
                h2d += getattr(cuts_fn, "last_h2d", pk2.qual.nbytes * mul)
            if mtr is not None:  # bytes actually shipped by the device step
                mtr.h2d_bytes[-1] = h2d
                # per-mate dispatch: rows overflowed the shared stride
                # (split), or were never packed (indexed host kernel)
                mtr.add_route("split" if pk1.rows_packed else "indexed")
            return packed, n1, (r1, r2)
        with _stage(mtr, "dispatch", packed.qual.nbytes * mul):
            result = call(packed)
        if mtr is not None:
            mtr.h2d_bytes[-1] = getattr(cuts_fn, "last_h2d",
                                        packed.qual.nbytes * mul)
            mtr.add_route("interleaved" if interleaved else "combined")
        return packed, n1, result

    def finalize(item):
        # both results of a split chunk are materialized here, in order
        packed, n1, result = item
        with _stage(mtr, "fetch"):
            if isinstance(packed, tuple):
                pk1, pk2, comb = packed
                if comb is not None:
                    f, t, bad = _materialize(result, comb.n_records)
                    k = pk1.n_records
                    mat = ((f[:k], t[:k], bad[:k]),
                           (f[k:2 * k], t[k:2 * k], bad[k:2 * k]))
                else:
                    mat = (_materialize(result[0], pk1.n_records),
                           _materialize(result[1], pk2.n_records))
            else:
                mat = _materialize(result, packed.n_records)
        return packed, n1, mat

    def consume(item):
        packed, n1, result = item
        with _stage(mtr, "consume"):
            if interleaved:
                _write_interleaved_chunk(packed, result, counters, out1,
                                         singles_out, n_record_mode, params,
                                         cfg, outbuf)
                pipe.recycle(packed)
            elif isinstance(packed, tuple):
                p1k, p2k, _ = packed
                r1, r2 = result
                _write_two_file_chunk(p1k, p2k, r1, r2, counters, out1, out2,
                                      singles_out, params, cfg, outbuf)
                pipe.recycle(p1k, p2k)
            else:
                p1, p2 = _split_packed(packed, n1)
                f, t, bad = result
                r1 = (f[:n1], t[:n1], bad[:n1])
                r2 = (f[n1:], t[n1:], bad[n1:])
                _write_two_file_chunk(p1, p2, r1, r2, counters, out1, out2,
                                      singles_out, params, cfg, outbuf)
                pipe.recycle(packed)
        if cfg.progress_cb is not None:
            cfg.progress_cb(counters)

    try:
        pipe.run(producer, dispatcher, consume, finalize=finalize,
                 window=window, on_drain=getattr(cuts_fn, "drain", None))
    finally:
        _outbuf_return(outbuf)
    if mtr is not None:
        mtr.add_cuts_fn(cuts_fn)
    return counters


class _OffsetOverflow(Exception):
    """Mate-2 rows cannot share mate-1's row stride/capacity (row-length
    growth discovered mid-chunk); the producer repacks the chunk as two
    independent batches."""


class _OffsetWorkspace:
    """PackWorkspace view starting at record ``row0`` with a FIXED row
    stride: the combined pe batch packs mate-2's rows/index right after
    mate-1's in the same buffers, so the chunk dispatches as one device
    batch.  ``ensure`` never reallocates — any growth request raises
    :class:`_OffsetOverflow` (rows before ``row0`` would be lost)."""

    def __init__(self, ws: PackWorkspace, row0: int, stride: int):
        self._stride = stride
        self.capacity = ws.capacity - row0
        self.L = stride
        self.need_seq = ws.need_seq
        self.est_rec_bytes = ws.est_rec_bytes
        self.starts4 = ws.starts4[4 * row0:]
        self.lens4 = ws.lens4[4 * row0:]
        self.lengths = ws.lengths[row0:]
        flat = ws.qual.reshape(-1)
        self.qual = flat[row0 * stride:]
        if ws.need_seq:
            self.seq = ws.seq.reshape(-1)[row0 * stride:]
        else:
            self.seq = self.qual

    def ensure(self, max_records: int, L: int, batch_multiple: int) -> None:
        B = _round_up(max(max_records, 1), batch_multiple)
        if L != self._stride or B > self.capacity:
            raise _OffsetOverflow()


def _combined_pair_batch(pk1: PackedReads, pk2: PackedReads,
                         ws: PackWorkspace, bm: int) -> PackedReads:
    """One [2*n1, L] batch over rows packed back to back in ``ws``
    (mate-1 then mate-2).  Index metadata stays on pk1/pk2 (two source
    buffers); this object only carries the fused rows for dispatch.

    Rows past mate-2's own padded batch are zeroed here, on the producer
    thread, before dispatch: the device step derives lengths from the
    zero padding, and those rows may still hold an earlier chunk's
    bytes."""
    n1 = pk1.n_records
    L = pk1.seq.shape[1]
    total = 2 * n1
    B = _round_up(total, _clamp_bm(bm, total, L, None))
    flat_q = ws.qual.reshape(-1)
    qual = flat_q[: B * L].reshape(B, L)
    seq = (ws.seq.reshape(-1)[: B * L].reshape(B, L) if ws.need_seq else qual)
    covered = n1 + pk2.batch_size  # pk2's own pack zeroed up to here
    if B > covered:
        qual[covered:] = 0
        ws.lengths[covered:B] = 0
    return dataclasses.replace(
        pk1,
        seq=seq,
        qual=qual,
        lengths=ws.lengths[:B],
        n_records=total,
        workspace=None,  # pk1 owns/recycles the real workspace
        qual_clean=pk1.qual_clean and pk2.qual_clean,
    )


def _split_packed(packed: PackedReads, n1: int):
    """Two logical PackedReads views over one combined two-file batch
    (mate-1 rows [0, n1), mate-2 rows [n1, 2*n1); same data buffer)."""

    def view(lo, hi):
        return dataclasses.replace(
            packed,
            lengths=packed.lengths[lo:hi],
            name_start=packed.name_start[lo:hi],
            name_len=packed.name_len[lo:hi],
            seq_start=packed.seq_start[lo:hi],
            comment_start=packed.comment_start[lo:hi],
            comment_len=packed.comment_len[lo:hi],
            qual_start=packed.qual_start[lo:hi],
            positions=packed.positions[lo:hi],
            n_records=hi - lo,
            workspace=None,
        )

    return view(0, n1), view(n1, 2 * n1)


def _sel(packed: PackedReads, idx: np.ndarray, offset: int = 0) -> dict:
    return dict(
        name_start=packed.name_start[idx] + offset,
        name_len=packed.name_len[idx],
        seq_start=packed.seq_start[idx] + offset,
        comment_start=packed.comment_start[idx] + offset,
        comment_len=packed.comment_len[idx],
        qual_start=packed.qual_start[idx] + offset,
    )


def _interleave_fields(f1: dict, f2: dict, k: int) -> dict:
    """Merge two per-pair field dicts into mate-interleaved order."""
    out = {}
    for key in f1:
        a = np.empty(2 * k, dtype=np.asarray(f1[key]).dtype)
        a[0::2] = f1[key]
        a[1::2] = f2[key]
        out[key] = a
    return out


def _update_pe_counters(c: PECounters, p1: np.ndarray, p2: np.ndarray):
    both = p1 & p2
    only1 = p1 & ~p2
    only2 = p2 & ~p1
    neither = ~p1 & ~p2
    c.kept_p += 2 * int(both.sum())
    c.kept_s1 += int(only1.sum())
    c.kept_s2 += int(only2.sum())
    c.discard_s2 += int(only1.sum())
    c.discard_s1 += int(only2.sum())
    c.discard_p += 2 * int(neither.sum())
    c.total = c.kept_p + c.kept_s1 + c.kept_s2 + c.discard_p + c.discard_s1 + c.discard_s2


def _write_interleaved_chunk(
    packed, result, counters, out1, singles_out, n_record_mode, params, cfg,
    outbuf=None,
):
    n = packed.n_records
    five, three, first_bad = result  # materialized by finalize
    five = five.astype(np.int64)
    three = three.astype(np.int64)
    _check_quality(packed, first_bad, params)
    f1, t1 = five[0::2], three[0::2]
    f2, t2 = five[1::2], three[1::2]
    p1, p2 = t1 >= 0, t2 >= 0
    _update_pe_counters(counters, p1, p2)
    idx1 = np.arange(n)[0::2]
    idx2 = np.arange(n)[1::2]

    if n_record_mode:
        # every pair appears; failed mates become N records
        with _metrics.span("assemble"):
            sel1 = _sel(packed, idx1)
            sel2 = _sel(packed, idx2)
            k = idx1.size
            fields = _interleave_fields(sel1, sel2, k)
            fv = np.empty(2 * k, np.int64)
            tv = np.empty(2 * k, np.int64)
            fv[0::2], fv[1::2] = np.maximum(f1, 0), np.maximum(f2, 0)
            tv[0::2], tv[1::2] = np.maximum(t1, 0), np.maximum(t2, 0)
            mask = np.empty(2 * k, bool)
            mask[0::2], mask[1::2] = ~p1, ~p2
            b = _assembled(out1, packed.data, fields, fv, tv, cfg.compat,
                           params.qualtype, outbuf, n_record_mask=mask)
        _write(out1, b)
        return

    both = p1 & p2
    if both.any():
        # fused fast path: both-pass pairs are the even/odd row pairs of
        # the interleaved batch, selected by mask in record order
        kf = _plan_assemble_fast(out1, packed, five, three, cfg.compat,
                                 three_mask=np.repeat(both, 2))
        if kf is None:
            with _metrics.span("assemble"):
                kb = np.flatnonzero(both)
                fields = _interleave_fields(
                    _sel(packed, idx1[kb]), _sel(packed, idx2[kb]), kb.size
                )
                fv = np.empty(2 * kb.size, np.int64)
                tv = np.empty(2 * kb.size, np.int64)
                fv[0::2], fv[1::2] = f1[kb], f2[kb]
                tv[0::2], tv[1::2] = t1[kb], t2[kb]
                b = _assembled(out1, packed.data, fields, fv, tv,
                               cfg.compat, params.qualtype, outbuf)
            _write(out1, b)
    single = p1 ^ p2
    if single.any() and singles_out is not None:
        ks = np.flatnonzero(single)
        take1 = p1[ks]
        rows = np.where(take1, idx1[ks], idx2[ks])
        mask_s = np.zeros(n, bool)
        mask_s[rows] = True
        kf = _plan_assemble_fast(singles_out, packed, five, three,
                                 cfg.compat, three_mask=mask_s)
        if kf is None:
            with _metrics.span("assemble"):
                fv = np.where(take1, f1[ks], f2[ks])
                tv = np.where(take1, t1[ks], t2[ks])
                b = _assembled(singles_out, packed.data, _sel(packed, rows),
                               fv, tv, cfg.compat, params.qualtype, outbuf)
            _write(singles_out, b)


def _write_two_file_chunk(
    p1k, p2k, r1, r2, counters, out1, out2, singles_out, params, cfg,
    outbuf=None,
):
    f1, t1, bad1 = r1  # materialized by finalize
    f2, t2, bad2 = r2
    f1, t1 = f1.astype(np.int64), t1.astype(np.int64)
    f2, t2 = f2.astype(np.int64), t2.astype(np.int64)
    _check_quality(p1k, bad1, params)
    _check_quality(p2k, bad2, params)
    p1, p2 = t1 >= 0, t2 >= 0
    _update_pe_counters(counters, p1, p2)

    both = p1 & p2
    if both.any():
        # fused fast path: mask-select the both-pass records in place
        # (order preserved); numpy fallback for exotic layouts/sinks
        k1 = _plan_assemble_fast(out1, p1k, f1, t1, cfg.compat,
                                 three_mask=both)
        k2 = _plan_assemble_fast(out2, p2k, f2, t2, cfg.compat,
                                 three_mask=both)
        kb = None
        for out, pk, fx, tx, kept in ((out1, p1k, f1, t1, k1),
                                      (out2, p2k, f2, t2, k2)):
            if kept is None:
                with _metrics.span("assemble"):
                    if kb is None:
                        kb = np.flatnonzero(both)
                    b = _assembled(out, pk.data, _sel(pk, kb), fx[kb],
                                   tx[kb], cfg.compat, params.qualtype,
                                   outbuf)
                _write(out, b)
    single = p1 ^ p2
    if single.any() and singles_out is not None:
        # singles come from either source file, in pair order
        ks = np.flatnonzero(single)
        take1 = p1[ks]
        fv = np.where(take1, f1[ks], f2[ks])
        tv = np.where(take1, t1[ks], t2[ks])
        if p1k.data is p2k.data:
            # both mates in one source buffer: single assembly pass
            with _metrics.span("assemble"):
                s1 = _sel(p1k, ks)
                s2 = _sel(p2k, ks)
                fields = {key: np.where(take1, s1[key], s2[key])
                          for key in s1}
                b = _assembled(singles_out, p1k.data, fields, fv, tv,
                               cfg.compat, params.qualtype, outbuf)
            _write(singles_out, b)
        else:
            # two source buffers (zero-copy mmap producer): compute the
            # interleaved output offsets once, then one placement pass
            # per source — never concatenate the buffers
            with _metrics.span("assemble"):
                nl = np.where(take1, p1k.name_len[ks], p2k.name_len[ks])
                cl = np.where(take1, p1k.comment_len[ks],
                              p2k.comment_len[ks])
                sizes = record_out_sizes(nl, cl, fv, tv, cfg.compat)
                offsets = np.zeros(ks.size, np.int64)
                if ks.size > 1:
                    np.cumsum(sizes[:-1], out=offsets[1:])
                total = int(offsets[-1] + sizes[-1])
                reserve = getattr(singles_out, "reserve", None)
                if reserve is not None and native.available():
                    # scatter both sources straight into the output mapping
                    buf, start = reserve(total)
                    offsets += start
                else:
                    buf = (outbuf or OutputBuffer()).ensure(total)
                for pk, fx, tx, take in (
                    (p1k, f1, t1, take1),
                    (p2k, f2, t2, ~take1),
                ):
                    sub = np.flatnonzero(take)
                    if sub.size:
                        rows = ks[sub]
                        assemble_records_at(
                            pk.data, **_sel(pk, rows),
                            five=fx[rows], three=tx[rows],
                            offsets=offsets[sub], out_buf=buf,
                            compat=cfg.compat, qualtype=params.qualtype,
                        )
            if reserve is not None and native.available():
                singles_out.commit(total)
            else:
                singles_out.write(memoryview(buf)[:total])
