"""Record-aligned chunking of FASTQ byte streams.

Equivalent of the reference's GZReader 4-line batch alignment and
remainder carry (src/GZReader.cpp:104-126), but chunks contain an exact
fixed number of RECORDS (not bytes) so every device batch has the same
shape — one XLA compilation serves the whole run.

The newline scan is the whole-input hot loop (the reference pays a
gzgets + heap copy per line here, src/GZReader.cpp:76-92); we count
newlines per block with C++ memchr (multi-GB/s) and locate an exact
byte position only at chunk boundaries.
"""

from __future__ import annotations

from typing import BinaryIO, Iterator

import numpy as np

from ..io import native

NEWLINE = 0x0A
BLOCK_BYTES = 8 << 20


def _nl_count(block: bytes) -> int:
    lib = native.get_lib()
    if lib is not None:
        import ctypes

        arr = np.frombuffer(block, dtype=np.uint8)
        return int(lib.sk_count_newlines(native.ptr(arr, ctypes.c_uint8), arr.size))
    return int(np.count_nonzero(np.frombuffer(block, dtype=np.uint8) == NEWLINE))


def _nl_kth(block: bytes, k: int) -> int:
    """Byte index of the k-th (1-based) newline; caller guarantees it exists."""
    lib = native.get_lib()
    if lib is not None:
        import ctypes

        arr = np.frombuffer(block, dtype=np.uint8)
        pos = int(lib.sk_kth_newline(native.ptr(arr, ctypes.c_uint8), arr.size, k))
    else:
        pos = int(
            np.flatnonzero(np.frombuffer(block, dtype=np.uint8) == NEWLINE)[k - 1]
        )
    return pos


def iter_record_chunks(
    stream: BinaryIO,
    records_per_chunk,
    lines_per_record: int = 4,
    block_bytes: int = BLOCK_BYTES,
    skip_records: int = 0,
    max_chunk_bytes: int = 0,
    align_records: int = 1,
) -> Iterator[bytes]:
    """Yield byte buffers of exactly ``records_per_chunk`` records each.

    The final chunk may be short; a trailing unterminated line counts as a
    line (matching ``pack_fastq``).  Lines are only counted, never copied
    per-line.  ``records_per_chunk`` may be a zero-arg callable,
    re-evaluated per chunk (the engine shrinks chunks once long reads are
    seen, EngineConfig.bytes_per_batch).

    ``skip_records`` drops that many records from the stream's start
    before the first yield (checkpoint/resume fast-forward): the skipped
    bytes are scanned for record boundaries but never buffered or packed.

    ``max_chunk_bytes`` (if nonzero) yields a short chunk once the
    pending bytes exceed it — the memory bound for long-read inputs whose
    record size is unknown before the first chunk.  Short chunks are cut
    at a multiple of ``align_records`` records (pe interleaved: 2, whole
    pairs).
    """
    records_fn = (
        records_per_chunk if callable(records_per_chunk)
        else lambda: records_per_chunk
    )
    target = records_fn() * lines_per_record
    align_lines = align_records * lines_per_record
    pending: list[bytes] = []
    nl_pending = 0
    carried: bytes = b""
    skip_lines = skip_records * lines_per_record
    while skip_lines > 0:
        block = stream.read(block_bytes)
        if not block:
            return
        n_nl = _nl_count(block)
        if n_nl < skip_lines:
            skip_lines -= n_nl
            continue
        cut = _nl_kth(block, skip_lines) + 1
        skip_lines = 0
        carried = block[cut:]  # remainder re-enters the normal chunk loop
    while True:
        if carried:
            block, carried = carried, b""
        else:
            block = stream.read(block_bytes)
        if not block:
            break
        n_nl = _nl_count(block)
        while nl_pending + n_nl >= target:
            need = target - nl_pending
            cut = _nl_kth(block, need) + 1
            pending.append(block[:cut])
            yield b"".join(pending)
            pending = []
            nl_pending = 0
            block = block[cut:]
            n_nl -= need
            target = records_fn() * lines_per_record
        if block:
            pending.append(block)
            nl_pending += n_nl
            if max_chunk_bytes and nl_pending >= align_lines:
                pending_bytes = sum(len(b) for b in pending)
                if pending_bytes >= max_chunk_bytes:
                    buf = pending[0] if len(pending) == 1 else b"".join(pending)
                    k = (nl_pending // align_lines) * align_lines
                    cut = _nl_kth(buf, k) + 1
                    yield buf[:cut]
                    rest = buf[cut:]
                    pending = [rest] if rest else []
                    nl_pending -= k
                    target = records_fn() * lines_per_record
    if pending:
        yield b"".join(pending)
