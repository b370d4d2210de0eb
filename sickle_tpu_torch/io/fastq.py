"""Vectorized FASTQ parse / pack / assemble (numpy host path).

This replaces the reference's per-line heap-allocating reader and
stringstream writer (the reference's src/GZReader.cpp:59-130,
src/trim_single.cpp:374-427) with whole-buffer vectorized passes:

* newline scan -> line index arrays
* structural validation as array comparisons (first offender re-checked
  scalar for the reference's exact error message, src/FQEntry.cpp:53-97)
* packing seq/qual bytes into fixed-shape ``uint8[B, L]`` arrays (padded,
  device-ready)
* output assembly as ONE ragged gather from the source buffer (no
  per-record string building)

A C++ fast path with the same contracts lives in ``sickle_tpu.io.native``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..constants import Compat, QualityType, quality_min
from ..oracle import FastqRecord, FastqValidationError, validate_record
from . import native

NEWLINE = 0x0A


def read_fastq_bytes(path) -> bytes:
    """Read a possibly-gzipped FASTQ file fully into memory.

    Like the reference's gzopen-based reader (src/GZReader.cpp:13), plain
    and gzip files are handled transparently (magic-byte sniff).
    """
    from .compression import open_input

    with open_input(path) as f:
        return f.read()


def _line_index(arr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Return (starts, ends) int64 arrays of line byte-ranges (\\n excluded).

    A trailing unterminated line counts as a line, matching the reference's
    gzgets loop and the oracle's split semantics.
    """
    nl = np.flatnonzero(arr == NEWLINE)
    if arr.size and (nl.size == 0 or nl[-1] != arr.size - 1):
        ends = np.concatenate([nl, [arr.size]])
    else:
        ends = nl
    starts = np.empty_like(ends)
    if ends.size:
        starts[0] = 0
        starts[1:] = ends[:-1] + 1
    return starts.astype(np.int64), ends.astype(np.int64)


@dataclasses.dataclass
class PackedReads:
    """A chunk of FASTQ records in fixed-shape, device-ready layout.

    ``seq``/``qual`` are ``uint8[B, L]`` (B >= n_records, rows beyond
    n_records are zero padding with lengths == 0); all ``*_start``/``*_len``
    index into ``data`` so output assembly can slice the original bytes
    without any unpacking.
    """

    data: np.ndarray  # uint8[n_bytes] original (decompressed) buffer
    seq: np.ndarray  # uint8[B, L]
    qual: np.ndarray  # uint8[B, L]
    lengths: np.ndarray  # int32[B]; 0 for padding rows
    name_start: np.ndarray  # int64[n_records]
    name_len: np.ndarray  # int32[n_records]
    seq_start: np.ndarray  # int64[n_records]
    comment_start: np.ndarray  # int64[n_records]
    comment_len: np.ndarray  # int32[n_records]
    qual_start: np.ndarray  # int64[n_records]
    positions: np.ndarray  # int32[n_records], 1-based global record index
    n_records: int

    workspace: Optional["PackWorkspace"] = None  # owner of the buffers, if reused
    # True when the packer proved no read's quality string contains a NUL
    # byte, i.e. zero bytes in ``qual`` are exactly the padding — the
    # invariant the TPU path needs to derive lengths on device.
    qual_clean: bool = False
    # producer-thread-prepared wire payload (engine cuts_fn.prepare):
    # (plan, [per-slice field-wire buffers]) or None for raw rows
    wire: Optional[tuple] = None
    # False when the seq/qual row matrices were deliberately NOT filled
    # (indexed host-cuts mode reads records straight from ``data`` via
    # the line index — saves the row memcpy traffic); index arrays,
    # lengths, validation, and qual_clean are valid either way
    rows_packed: bool = True

    @property
    def batch_size(self) -> int:
        return self.seq.shape[0]

    @property
    def max_len(self) -> int:
        return self.seq.shape[1]


class PackWorkspace:
    """Reusable buffers for one in-flight packed chunk.

    Fresh pages can fault at ~400us each on some hosts; reusing warm
    buffers across chunks removes that cost from the steady state (see
    io/native.py).  One workspace is checked out per in-flight chunk by
    the engine's pool and recycled after the writer finishes with it.
    """

    def __init__(self, need_seq: bool = True):
        self.capacity = 0  # records
        self.L = 0
        self.need_seq = need_seq
        # running estimate of bytes per record, used as the native line
        # indexer's scan hint so a streaming chunk never scans far past
        # its own records (shared across chunks via the engine's pool)
        self.est_rec_bytes = 0

    def ensure(self, max_records: int, L: int, batch_multiple: int) -> None:
        B = _round_up(max(max_records, 1), batch_multiple)
        if self.capacity >= B and self.L >= L:
            return
        B = max(B, self.capacity)
        L = max(L, self.L)
        self.starts4 = np.empty(B * 4, np.int64)
        self.lens4 = np.empty(B * 4, np.int32)
        self.qual = np.zeros((B, L), np.uint8)
        # when the kernel never reads seq (no -n), alias it to qual: no
        # second 16MB buffer, no second memcpy pass in the packer
        self.seq = np.zeros((B, L), np.uint8) if self.need_seq else self.qual
        self.lengths = np.zeros(B, np.int32)
        self.capacity = B
        self.L = L


class OutputBuffer:
    """Grow-only reusable byte buffer for assembled output."""

    def __init__(self):
        self.buf = np.empty(1 << 20, np.uint8)

    def ensure(self, n: int) -> np.ndarray:
        if self.buf.size < n:
            self.buf = np.empty(max(n, self.buf.size * 2), np.uint8)
        return self.buf


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def qual_minmax(qual: np.ndarray) -> Tuple[int, int]:
    """(min over nonzero bytes, max over all bytes) of a packed qual
    matrix.  Zero bytes are row padding by the packer's invariant.
    Returns (255, 0) for an all-padding matrix."""
    lib = native.get_lib()
    flat = qual.reshape(-1)
    if lib is not None and flat.flags.c_contiguous:
        import ctypes

        mn = np.empty(1, np.uint8)
        mx = np.empty(1, np.uint8)
        lib.sk_qual_minmax(native.ptr(flat, ctypes.c_uint8), flat.size,
                           native.ptr(mn, ctypes.c_uint8),
                           native.ptr(mx, ctypes.c_uint8), native.N_THREADS)
        return int(mn[0]), int(mx[0])
    mx = int(qual.max(initial=0))
    mn = int(np.where(qual == 0, 255, qual).min(initial=255))
    return mn, mx


QUAL_PLANES = 6  # band-wire plane cap (adaptive: chunks ship fewer)


def qual_levels(qual: np.ndarray) -> np.ndarray:
    """Ascending distinct NONZERO byte values of a packed qual matrix
    (zero bytes are row padding).  One parallel pass; subsumes
    qual_minmax (min/max = ends) and gates the rank wire."""
    lib = native.get_lib()
    flat = qual.reshape(-1)
    if lib is not None and flat.flags.c_contiguous:
        import ctypes

        out = np.empty(256, np.uint8)
        n = lib.sk_qual_levels(native.ptr(flat, ctypes.c_uint8), flat.size,
                               native.ptr(out, ctypes.c_uint8),
                               native.N_THREADS)
        return out[:n].copy()
    vals = np.unique(flat)
    return vals[vals != 0]


def field_widths(p: int):
    """Binary decomposition of a ``p``-bit value into byte-aligned
    subfields: [(width, v-bit offset, byte column offset factor)] —
    the field-wire layout contract shared by sk_fieldpack and
    ops.trim.decode_fields.  Widest field first, carrying v's LOWEST
    bits; column offsets are in bytes for a row of length L when
    multiplied by L."""
    out = []
    sh = 0
    col = 0.0
    for w in (4, 2, 1):
        if p - sh >= w:
            out.append((w, sh, col))
            sh += w
            col += w / 8.0
    return out


def _fields_numpy(v: np.ndarray, p: int) -> np.ndarray:
    B, L = v.shape
    out = np.empty((B, p * L // 8), np.uint8)
    for w, sh, colf in field_widths(p):
        col = int(colf * L)
        f = (v >> sh) & ((1 << w) - 1)
        if w == 4:
            packed = f[:, 0::2] | (f[:, 1::2] << 4)
        elif w == 2:
            packed = (f[:, 0::4] | (f[:, 1::4] << 2) | (f[:, 2::4] << 4)
                      | (f[:, 3::4] << 6))
        else:
            packed = np.packbits(f, axis=1, bitorder="little")
        out[:, col:col + L * w // 8] = packed
    return out


def qual_fields(qual: np.ndarray, bias: int, p: int = QUAL_PLANES) -> np.ndarray:
    """Field-wire pack of ``saturate(qual - bias)``: the p-bit value
    split into byte-aligned 4/2/1-bit subfields (field_widths) — the
    same ``p * L / 8`` wire bytes as ``p`` bit-planes but ~3x fewer
    device decode ops (one repeat+shift+mask per FIELD, not per bit;
    ops/trim.decode_fields is the inverse).  Returns uint8[B, p*L//8].
    """
    B, L = qual.shape
    lib = native.get_lib()
    if lib is not None and qual.flags.c_contiguous:
        import ctypes

        out = np.empty((B, p * L // 8), np.uint8)
        rc = lib.sk_fieldpack(native.ptr(qual, ctypes.c_uint8), B, L, bias,
                              ctypes.POINTER(ctypes.c_uint8)(), 0, p,
                              native.ptr(out, ctypes.c_uint8),
                              native.N_THREADS)
        if rc == 0:
            return out
    v = qual.astype(np.int16) - bias
    np.clip(v, 0, None, out=v)
    return _fields_numpy(v.astype(np.uint8), p)


def qual_rank_fields(qual: np.ndarray, levels: np.ndarray, p: int) -> np.ndarray:
    """Field-wire pack of the rank code ``v = 1 + rank(qual in levels)``
    (0 = padding NUL); binned Illumina ships 3-bit ranks as a 2-bit +
    1-bit field pair.  Returns uint8[B, p*L//8]."""
    B, L = qual.shape
    levels = np.ascontiguousarray(levels, np.uint8)
    lib = native.get_lib()
    if lib is not None and qual.flags.c_contiguous:
        import ctypes

        out = np.empty((B, p * L // 8), np.uint8)
        rc = lib.sk_fieldpack(native.ptr(qual, ctypes.c_uint8), B, L, 0,
                              native.ptr(levels, ctypes.c_uint8),
                              int(levels.size), p,
                              native.ptr(out, ctypes.c_uint8),
                              native.N_THREADS)
        if rc == 0:
            return out
    v = np.zeros(qual.shape, np.uint8)
    for lv in levels:
        v += (qual >= lv).astype(np.uint8)
    return _fields_numpy(v, p)


def _clamp_bm(batch_multiple: int, n: int, L: int, batch_bytes: Optional[int]) -> int:
    """Padding multiple actually used for a batch of ``n`` records.

    Two clamps on the configured (slice-sized) multiple:
    * never pad a small batch past the next power of two above ``n`` — a
      2500-read file ships a [4096, L] batch (0.6 MB), not a full 64k-row
      slice (10 MB of mostly padding on the metered link).  Full chunks
      (n == multiple) are untouched, so multi-chunk runs keep their one
      shared executable;
    * halve until the padded batch fits the byte budget (long reads:
      never pad 24 rows of 40 kbp up to a 32768-row slice).
    """
    bm = batch_multiple
    pow2 = 1 << max(max(n, 8) - 1, 1).bit_length()
    if pow2 < bm:
        bm = pow2
    if not batch_bytes:
        return bm
    target = max(batch_bytes, max(n, 1) * L)
    while bm > 8 and _round_up(max(n, 1), bm) * L > target:
        bm //= 2
    return bm


def _validate(
    arr: np.ndarray,
    name_start: np.ndarray,
    name_len: np.ndarray,
    seq_len: np.ndarray,
    qual_len: np.ndarray,
    all_starts: np.ndarray,
    all_ends: np.ndarray,
    positions: np.ndarray,
) -> None:
    """Vectorized structural validation (reference src/FQEntry.cpp:53-97).

    Finds the first offending record (input order) and raises with the
    reference's exact message via the scalar oracle validator.
    """
    first_byte = arr[np.minimum(name_start, arr.size - 1)] if arr.size else name_start
    bad = (
        (name_len <= 1)
        | (first_byte != ord("@"))
        | (seq_len < 1)
        | (qual_len < 1)
        | (seq_len != qual_len)
    )
    if not bad.any():
        return
    i = int(np.argmax(bad))

    def line(k: int) -> bytes:
        return arr[all_starts[4 * i + k] : all_ends[4 * i + k]].tobytes()

    rec = FastqRecord(line(0), line(1), line(2), line(3), int(positions[i]))
    validate_record(rec)
    raise FastqValidationError("FASTQ validation failed")  # pragma: no cover


def pack_fastq(
    data,
    *,
    start_position: int = 0,
    l_max: Optional[int] = None,
    batch_multiple: int = 8,
    len_multiple: int = 8,
    validate: bool = True,
    workspace: Optional[PackWorkspace] = None,
    need_seq: bool = True,
    batch_bytes: Optional[int] = None,
    need_rows: bool = True,
) -> PackedReads:
    """Parse a FASTQ byte buffer into a :class:`PackedReads`.

    Trailing partial records (< 4 lines) are ignored, as in the reference's
    4-line batch alignment (src/GZReader.cpp:104-126).  ``start_position``
    is the number of records already consumed before this buffer (for
    chunked streaming; positions stay globally 1-based).

    With ``workspace`` and the native library available, the parse +
    validate + pack runs as one C++ pass into the workspace's reused
    buffers; otherwise the vectorized numpy path allocates fresh arrays.
    """
    arr = np.frombuffer(data, dtype=np.uint8) if not isinstance(data, np.ndarray) else data
    if workspace is not None and native.available():
        return _pack_fastq_native(
            arr, workspace, start_position, l_max, batch_multiple, len_multiple,
            need_seq, batch_bytes=batch_bytes, pack_rows=need_rows,
        )
    starts, ends = _line_index(arr)
    n_lines = starts.size - starts.size % 4
    n = n_lines // 4
    starts4 = starts[:n_lines].reshape(n, 4)
    ends4 = ends[:n_lines].reshape(n, 4)
    lens4 = (ends4 - starts4).astype(np.int32)

    name_start = starts4[:, 0]
    name_len = lens4[:, 0]
    seq_start = starts4[:, 1]
    seq_len = lens4[:, 1]
    comment_start = starts4[:, 2]
    comment_len = lens4[:, 2]
    qual_start = starts4[:, 3]
    qual_len = lens4[:, 3]
    positions = (start_position + 1 + np.arange(n)).astype(np.int32)

    if validate and n:
        _validate(
            arr, name_start, name_len, seq_len, qual_len,
            starts[:n_lines], ends[:n_lines], positions,
        )

    max_len = int(seq_len.max()) if n else 1
    L = _round_up(max(l_max or 0, max_len, 1), len_multiple)
    B = _round_up(max(n, 1), _clamp_bm(batch_multiple, n, L, batch_bytes))

    qual = np.zeros((B, L), dtype=np.uint8)
    seq = np.zeros((B, L), dtype=np.uint8) if need_seq else qual
    lengths = np.zeros(B, dtype=np.int32)
    qual_clean = False
    if n:
        lengths[:n] = seq_len
        lane = np.arange(L, dtype=np.int64)
        valid = lane[None, :] < seq_len[:, None]
        if need_seq:
            np.copyto(
                seq[:n],
                arr[np.minimum(seq_start[:, None] + lane[None, :], arr.size - 1)],
                where=valid,
            )
        np.copyto(
            qual[:n],
            arr[np.minimum(qual_start[:, None] + lane[None, :], arr.size - 1)],
            where=valid,
        )
        # no NUL inside any read <=> nonzeros == total read bytes
        qual_clean = int(np.count_nonzero(qual[:n])) == int(seq_len.sum())

    return PackedReads(
        data=arr,
        seq=seq,
        qual=qual,
        lengths=lengths,
        name_start=name_start,
        name_len=name_len,
        seq_start=seq_start,
        comment_start=comment_start,
        comment_len=comment_len,
        qual_start=qual_start,
        positions=positions,
        n_records=n,
        workspace=workspace,  # passed through so pool recycling works
        qual_clean=qual_clean,
    )


def _raise_validation_error_native(
    arr: np.ndarray, ws: PackWorkspace, rec: int, start_position: int
) -> None:
    def line(k: int) -> bytes:
        s = ws.starts4[4 * rec + k]
        return arr[s : s + ws.lens4[4 * rec + k]].tobytes()

    validate_record(
        FastqRecord(line(0), line(1), line(2), line(3), start_position + rec + 1)
    )
    raise FastqValidationError("FASTQ validation failed")  # pragma: no cover


def pack_fastq_stream(
    arr: np.ndarray,
    offset: int,
    max_records: int,
    *,
    start_position: int = 0,
    l_max: Optional[int] = None,
    batch_multiple: int = 8,
    len_multiple: int = 8,
    workspace: PackWorkspace,
    need_seq: bool = True,
    est_rec_bytes: int = 0,
    batch_bytes: Optional[int] = None,
    need_rows: bool = True,
    at_eof: bool = True,
) -> Tuple[PackedReads, int]:
    """Parse up to ``max_records`` records from ``arr[offset:]`` in place.

    Zero-copy streaming entry point (native path only): the caller holds
    one buffer for the whole input (e.g. an mmap of the file) and advances
    by the returned consumed-byte count — no per-chunk byte copies, no
    separate newline-count pass (the reference pays a heap copy per line
    here, src/GZReader.cpp:76-92).  A trailing partial record parses as 0
    records (consumed covers it) — the loop's natural termination.
    """
    view = arr[offset:]
    workspace.est_rec_bytes = max(workspace.est_rec_bytes, est_rec_bytes)
    packed = _pack_fastq_native(
        view, workspace, start_position, l_max, batch_multiple, len_multiple,
        need_seq, max_records=max_records, batch_bytes=batch_bytes,
        shrink_records=True, pack_rows=need_rows, at_eof=at_eof,
    )
    n = packed.n_records
    if n == 0:
        return packed, view.size
    ws = packed.workspace
    last = int(ws.starts4[4 * n - 1]) + int(ws.lens4[4 * n - 1])
    return packed, min(last + 1, view.size)  # +1 skips the newline


def _pack_fastq_native(
    arr: np.ndarray,
    ws: PackWorkspace,
    start_position: int,
    l_max: Optional[int],
    batch_multiple: int,
    len_multiple: int,
    need_seq: bool = True,
    max_records: Optional[int] = None,
    batch_bytes: Optional[int] = None,
    shrink_records: bool = False,
    pack_rows: bool = True,
    at_eof: bool = True,
) -> PackedReads:
    import ctypes

    if not need_seq:
        ws.need_seq = False
    lib = native.get_lib()
    scan_hint = 0  # whole buffer
    if max_records is None:
        n_lines = lib.sk_count_lines(native.ptr(arr, ctypes.c_uint8), arr.size)
        max_records = max(int(n_lines) // 4 + 1, 1)
    elif ws.est_rec_bytes:
        # streaming chunk out of a larger buffer: scan only ~the records
        # we will take (the indexer self-extends if the estimate is short)
        scan_hint = max_records * (ws.est_rec_bytes + 16)
    # L is the chunk's TIGHT row stride (caller's running l_max estimate,
    # grown below if this chunk proves longer) — NOT the reusable
    # buffer's width: a pooled workspace that once held long reads must
    # not widen every later chunk's rows (wire bytes are the TPU path's
    # binding cost).  Rows are packed at stride L into the workspace's
    # flat storage and viewed as [B, L].
    L = _round_up(max(l_max or 0, 1), len_multiple)
    ws.ensure(max_records, L, batch_multiple)

    def row_views(n_rows):
        q = ws.qual.reshape(-1)[: n_rows * L].reshape(n_rows, L)
        s = (ws.seq.reshape(-1)[: n_rows * L].reshape(n_rows, L)
             if need_seq else q)
        return s, q

    n_out = np.zeros(1, np.int64)
    max_len = np.zeros(1, np.int64)
    err_rec = np.full(1, -1, np.int64)
    flags = np.zeros(1, np.int64)
    for _attempt in range(2):
        rc = lib.sk_parse_pack2(
            native.ptr(arr, ctypes.c_uint8), arr.size, max_records, scan_hint,
            L,
            native.ptr(ws.starts4, ctypes.c_int64),
            native.ptr(ws.lens4, ctypes.c_int32),
            native.ptr(ws.seq, ctypes.c_uint8),
            native.ptr(ws.qual, ctypes.c_uint8),
            native.ptr(ws.lengths, ctypes.c_int32),
            native.ptr(n_out, ctypes.c_int64),
            native.ptr(max_len, ctypes.c_int64),
            native.ptr(err_rec, ctypes.c_int64),
            native.ptr(flags, ctypes.c_int64),
            native.N_THREADS,
            1 if need_seq else 0,
            # -1: no rows AND no qual NUL scan — an indexed chunk is
            # host-bound by construction, so qual_clean is never read
            1 if pack_rows else -1,
            1 if at_eof else 0,
        )
        if rc == 0:
            break
        if rc == 1:
            _raise_validation_error_native(arr, ws, int(err_rec[0]), start_position)
        # rc == 2: rows longer than L -> grow and retry once.  Streaming
        # callers (consumed-byte contract) also shrink the record count so
        # the retried batch honors the byte budget — the remainder simply
        # lands in the next chunk (long reads discovered mid-stream).
        L = _round_up(int(max_len[0]), len_multiple)
        if shrink_records and batch_bytes:
            # even count: pe interleaved chunks must hold whole pairs
            max_records = min(max_records,
                              max(8, batch_bytes // L) & ~1)
            batch_multiple = _clamp_bm(batch_multiple, max_records, L,
                                       batch_bytes)
        ws.ensure(max_records, L, batch_multiple)
    else:
        raise AssertionError("native pack failed to size rows")

    n = int(n_out[0])
    if n:
        last = int(ws.starts4[4 * n - 1]) + int(ws.lens4[4 * n - 1])
        ws.est_rec_bytes = max(ws.est_rec_bytes, -(-last // n))
    B = _round_up(max(n, 1), _clamp_bm(batch_multiple, n, L, batch_bytes))
    seq_v, qual_v = row_views(B)
    if n < B:
        # padding rows must read as empty — including stale bytes from a
        # previous (fuller) chunk in this reused workspace, so the TPU
        # path's derive-lengths-from-zero-padding invariant holds on the
        # ragged final chunk too
        ws.lengths[n:B] = 0
        if pack_rows:
            qual_v[n:B] = 0
    starts4 = ws.starts4[: 4 * n].reshape(n, 4)
    lens4 = ws.lens4[: 4 * n].reshape(n, 4)
    return PackedReads(
        data=arr,
        seq=seq_v,
        qual=qual_v,
        lengths=ws.lengths[:B],
        name_start=starts4[:, 0],
        name_len=lens4[:, 0],
        seq_start=starts4[:, 1],
        comment_start=starts4[:, 2],
        comment_len=lens4[:, 2],
        qual_start=starts4[:, 3],
        positions=(start_position + 1 + np.arange(n)).astype(np.int32),
        n_records=n,
        workspace=ws,
        qual_clean=bool(pack_rows) and int(flags[0]) & 1 == 0,
        rows_packed=pack_rows,
    )


def _ragged_arange(lens: np.ndarray) -> np.ndarray:
    """[0..l0), [0..l1), ... concatenated."""
    cum = np.cumsum(lens)
    total = int(cum[-1]) if lens.size else 0
    return np.arange(total, dtype=np.int64) - np.repeat(cum - lens, lens)


def assemble_records(
    src: np.ndarray,
    *,
    name_start: np.ndarray,
    name_len: np.ndarray,
    seq_start: np.ndarray,
    comment_start: np.ndarray,
    comment_len: np.ndarray,
    qual_start: np.ndarray,
    five: np.ndarray,
    three: np.ndarray,
    compat: Compat = Compat.V133,
    n_record_mask: Optional[np.ndarray] = None,
    qualtype: QualityType = QualityType.SANGER,
    out: Optional[OutputBuffer] = None,
):
    """Emit trimmed FASTQ for the given records, in the given order.

    All index arrays must already be filtered/ordered to the records being
    written.  Emission format matches the reference writer
    (src/trim_single.cpp:390-396): ``name\\nseq[five:three]\\ncomment\\n``
    ``qual[five:three]\\n``; ``compat=V133`` rewrites the comment to a bare
    ``+`` (upstream behavior).  Rows where ``n_record_mask`` is true are
    emitted as the pe -M replacement record (seq ``N``, lowest quality
    char; reference README.md:116-121) and their cuts are ignored.

    Implementation: one flat ragged gather — every output byte's source
    index is computed vectorized, then a single fancy-index pass builds the
    buffer.
    """
    k = name_start.size
    if k == 0:
        return b""
    if out is not None and native.available():
        return _assemble_native(
            src, name_start, name_len, seq_start, comment_start, comment_len,
            qual_start, five, three, compat, n_record_mask, qualtype, out,
        )
    # aux bytes appended to the source for constant segments:
    #   [n] = '\n', [n+1] = '+', [n+2] = 'N', [n+3] = lowest qual char
    nsrc = src.size
    aux = np.frombuffer(b"\n+N" + bytes([quality_min(qualtype)]), dtype=np.uint8)
    full = np.concatenate([src, aux])
    NL, PLUS, NCHAR, LOWQ = nsrc, nsrc + 1, nsrc + 2, nsrc + 3

    cut_len = (three - five).astype(np.int64)
    in_starts = np.empty((k, 8), dtype=np.int64)
    seg_lens = np.empty((k, 8), dtype=np.int64)

    in_starts[:, 0] = name_start
    seg_lens[:, 0] = name_len
    in_starts[:, 2] = seq_start + five
    seg_lens[:, 2] = cut_len
    if compat == Compat.V133:
        in_starts[:, 4] = PLUS
        seg_lens[:, 4] = 1
    else:
        in_starts[:, 4] = comment_start
        seg_lens[:, 4] = comment_len
    in_starts[:, 6] = qual_start + five
    seg_lens[:, 6] = cut_len
    in_starts[:, 1::2] = NL
    seg_lens[:, 1::2] = 1

    if n_record_mask is not None and n_record_mask.any():
        m = n_record_mask
        in_starts[m, 2] = NCHAR
        seg_lens[m, 2] = 1
        in_starts[m, 6] = LOWQ
        seg_lens[m, 6] = 1

    flat_starts = in_starts.reshape(-1)
    flat_lens = seg_lens.reshape(-1)
    idx = np.repeat(flat_starts, flat_lens) + _ragged_arange(flat_lens)
    return full[idx].tobytes()


def record_out_sizes(
    name_len: np.ndarray,
    comment_len: np.ndarray,
    five: np.ndarray,
    three: np.ndarray,
    compat: Compat = Compat.V133,
    n_record_mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    """int64 emitted byte count per record (4 newlines + segments)."""
    cut = (np.asarray(three, np.int64) - np.asarray(five, np.int64))
    if n_record_mask is not None:
        cut = np.where(np.asarray(n_record_mask, bool), 1, cut)
    com = 1 if compat == Compat.V133 else np.asarray(comment_len, np.int64)
    return np.asarray(name_len, np.int64) + 2 * cut + com + 4


def assemble_records_at(
    src: np.ndarray,
    *,
    name_start: np.ndarray,
    name_len: np.ndarray,
    seq_start: np.ndarray,
    comment_start: np.ndarray,
    comment_len: np.ndarray,
    qual_start: np.ndarray,
    five: np.ndarray,
    three: np.ndarray,
    offsets: np.ndarray,
    out_buf: np.ndarray,
    compat: Compat = Compat.V133,
    n_record_mask: Optional[np.ndarray] = None,
    qualtype: QualityType = QualityType.SANGER,
) -> None:
    """Emit records from ``src`` into ``out_buf`` at explicit byte
    ``offsets`` (caller-computed, e.g. interleaving records from two
    source buffers without concatenating them).  Native-path core of
    :func:`assemble_records`; a numpy fallback covers lib-less hosts."""
    k = name_start.size
    if k == 0:
        return
    if native.available():
        import ctypes

        lib = native.get_lib()
        rewrite = 1 if compat == Compat.V133 else 0
        if n_record_mask is not None:
            mask = np.ascontiguousarray(n_record_mask, dtype=np.uint8)
            mask_ptr = native.ptr(mask, ctypes.c_uint8)
        else:
            mask_ptr = ctypes.POINTER(ctypes.c_uint8)()
        lib.sk_assemble(
            native.ptr(src, ctypes.c_uint8), k,
            native.ptr(np.ascontiguousarray(name_start, np.int64), ctypes.c_int64),
            native.ptr(np.ascontiguousarray(name_len, np.int32), ctypes.c_int32),
            native.ptr(np.ascontiguousarray(seq_start, np.int64), ctypes.c_int64),
            native.ptr(np.ascontiguousarray(comment_start, np.int64), ctypes.c_int64),
            native.ptr(np.ascontiguousarray(comment_len, np.int32), ctypes.c_int32),
            native.ptr(np.ascontiguousarray(qual_start, np.int64), ctypes.c_int64),
            native.ptr(np.ascontiguousarray(five, np.int32), ctypes.c_int32),
            native.ptr(np.ascontiguousarray(three, np.int32), ctypes.c_int32),
            mask_ptr, rewrite, quality_min(qualtype),
            native.ptr(np.ascontiguousarray(offsets, np.int64), ctypes.c_int64),
            native.ptr(out_buf, ctypes.c_uint8),
            native.N_THREADS,
        )
        return
    chunk = assemble_records(
        src, name_start=name_start, name_len=name_len, seq_start=seq_start,
        comment_start=comment_start, comment_len=comment_len,
        qual_start=qual_start, five=np.asarray(five, np.int64),
        three=np.asarray(three, np.int64), compat=compat,
        n_record_mask=n_record_mask, qualtype=qualtype,
    )
    sizes = record_out_sizes(name_len, comment_len, five, three, compat,
                             n_record_mask)
    pos = 0
    for r in range(k):
        s = int(sizes[r])
        out_buf[int(offsets[r]) : int(offsets[r]) + s] = np.frombuffer(
            chunk[pos : pos + s], np.uint8
        )
        pos += s


def _assemble_native(
    src, name_start, name_len, seq_start, comment_start, comment_len,
    qual_start, five, three, compat, n_record_mask, qualtype,
    out: OutputBuffer,
):
    """Single-pass parallel C++ assembly into a reused output buffer."""
    import ctypes

    lib = native.get_lib()
    k = name_start.size
    rewrite = 1 if compat == Compat.V133 else 0

    def c64(a):
        return np.ascontiguousarray(a, dtype=np.int64)

    def c32(a):
        return np.ascontiguousarray(a, dtype=np.int32)

    name_start = c64(name_start)
    name_len = c32(name_len)
    seq_start = c64(seq_start)
    comment_start = c64(comment_start)
    comment_len = c32(comment_len)
    qual_start = c64(qual_start)
    five32 = c32(five)
    three32 = c32(three)

    cut = (three32 - five32).astype(np.int64)
    if n_record_mask is not None:
        mask = np.ascontiguousarray(n_record_mask, dtype=np.uint8)
        cut = np.where(mask.astype(bool), 1, cut)
        mask_ptr = native.ptr(mask, ctypes.c_uint8)
    else:
        mask_ptr = ctypes.POINTER(ctypes.c_uint8)()
    com = 1 if rewrite else comment_len.astype(np.int64)
    sizes = name_len.astype(np.int64) + 2 * cut + com + 4
    offsets = np.empty(k, np.int64)
    offsets[0] = 0
    if k > 1:
        np.cumsum(sizes[:-1], out=offsets[1:])
    total = int(offsets[-1] + sizes[-1])

    buf = out.ensure(total)
    lib.sk_assemble(
        native.ptr(src, ctypes.c_uint8), k,
        native.ptr(name_start, ctypes.c_int64),
        native.ptr(name_len, ctypes.c_int32),
        native.ptr(seq_start, ctypes.c_int64),
        native.ptr(comment_start, ctypes.c_int64),
        native.ptr(comment_len, ctypes.c_int32),
        native.ptr(qual_start, ctypes.c_int64),
        native.ptr(five32, ctypes.c_int32),
        native.ptr(three32, ctypes.c_int32),
        mask_ptr, rewrite, quality_min(qualtype),
        native.ptr(offsets, ctypes.c_int64),
        native.ptr(buf, ctypes.c_uint8),
        native.N_THREADS,
    )
    return memoryview(buf)[:total]
