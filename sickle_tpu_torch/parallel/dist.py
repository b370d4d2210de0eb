"""Multi-host distribution: process-group init, input sharding, counter
merge (port of the JAX package's ``parallel/dist.py`` onto
``torch.distributed``).

The reference is strictly single-process (SURVEY.md §2.2).  The
scale-out story: every process streams its own record-aligned shard of
the input (reads are embarrassingly parallel; no traffic between
processes on the read path), GPUs within a process shard each batch
row-wise (``mesh.sharded_cuts_fn``), and the ONLY global communication is
the end-of-run scalar counter reduction: one ``all_reduce`` of an int64
CPU tensor over gloo.  No row data crosses processes, so NCCL is not
needed.
"""

from __future__ import annotations

import datetime
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.trim import TrimParams

# how long a process waits for its peers, at the rendezvous and in the
# counter all_reduce, before it fails instead of hanging (a peer that
# exited on an error never arrives)
TIMEOUT = datetime.timedelta(minutes=10)


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the process group (gloo; only CPU scalars cross processes).

    ``coordinator_address`` is ``host:port`` of rank 0's rendezvous; the
    world size and this process's rank are passed explicitly.  With no
    address, the launcher-set variables (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``: ``env://``) fill in
    whatever is not given.
    """
    import torch.distributed as dist

    kw = {}
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    init = (f"tcp://{coordinator_address}" if coordinator_address
            else "env://")
    dist.init_process_group("gloo", init_method=init, timeout=TIMEOUT, **kw)


def _rank_and_size() -> Tuple[int, int]:
    """(rank, world size) of the process group, or (0, 1) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_file_shard(paths: Sequence, process_id: Optional[int] = None,
                    num_processes: Optional[int] = None) -> List:
    """Round-robin assignment of input files to this process.

    SERIAL gzip inputs are not byte-splittable, so multi-host sharding
    for them is by file (pre-shard datasets per host); plain files and
    BGZF gzip (including this framework's own ``-g`` output) are
    byte-range split with :func:`split_record_ranges`.
    """
    rank, size = _rank_and_size()
    pid = rank if process_id is None else process_id
    n = size if num_processes is None else num_processes
    return [p for i, p in enumerate(paths) if i % n == pid]


def _looks_like_record_start(lines: List[bytes]) -> bool:
    """Phase detection for FASTQ byte-range splitting: a line is a record
    start if it begins with '@', the line 2 later begins with '+', and the
    seq/qual line lengths match.  ('@' can also start a quality line, so
    the single-char test alone is ambiguous.)"""
    if len(lines) < 4:
        return False
    return (
        lines[0][:1] == b"@"
        and lines[2][:1] == b"+"
        and len(lines[1]) == len(lines[3])
    )


def _first_record_start(probe: bytes) -> Optional[int]:
    """Offset within ``probe`` of the first FASTQ record start after a
    line boundary, else None."""
    starts = []
    pos = probe.find(b"\n")
    while pos >= 0 and pos + 1 < len(probe):
        starts.append(pos + 1)
        pos = probe.find(b"\n", pos + 1)
    for s in starts:
        if _looks_like_record_start(probe[s:].split(b"\n")):
            return s
    return None


class _PlainSpan:
    """Record-address space of a plain FASTQ file (mmap-backed)."""

    def __init__(self, path):
        self.arr = _mapped(path)
        self.size = int(self.arr.size)

    def probe(self, offset: int, n: int) -> bytes:
        return self.arr[offset : offset + n].tobytes()

    def records_before(self, offset: int) -> int:
        """Record count in [0, offset) (offset must be record-aligned)."""
        from ..io import native

        lib = native.get_lib()
        view = self.arr[:offset]
        if lib is not None:
            import ctypes

            nl = int(lib.sk_count_newlines(
                native.ptr(view, ctypes.c_uint8), view.size))
        else:
            nl = int(np.count_nonzero(view == 0x0A))
        return nl // 4

    def offset_of_record(self, k: int) -> int:
        """Byte offset where 0-based record ``k`` starts (size if past EOF)."""
        if k == 0:
            return 0
        from ..io import native

        lib = native.get_lib()
        if lib is not None:
            import ctypes

            pos = int(lib.sk_kth_newline(
                native.ptr(self.arr, ctypes.c_uint8), self.arr.size, 4 * k))
        else:
            nl = np.flatnonzero(self.arr == 0x0A)
            pos = int(nl[4 * k - 1]) if nl.size >= 4 * k else -1
        return self.size if pos < 0 else pos + 1


class _BgzfSpan:
    """Record-address space of a BGZF FASTQ file, in UNCOMPRESSED bytes.

    The block index makes the compressed file byte-splittable: offsets
    here are uncompressed offsets, which the engine consumes directly
    (BgzfReader.seek + byte_limit on the inflated stream).  Counting
    streams block-parallel inflate windows (csrc/fastqio.cpp), so a
    boundary probe costs one window and a record count costs one prefix
    pass — never a whole-file inflate per host.

    Sharding-time cost scaling: ``records_before``/``offset_of_record``
    inflate from offset 0 per boundary, so computing N shard boundaries
    is O(N * file) of (block-parallel) inflate at STARTUP — fine at the
    2-8 hosts this targets, noticeable by ~64.  The fix, if a fleet that
    wide materializes, is one shared prefix pass caching per-block
    newline counts in the block index (the scan is already blockwise);
    the per-read path is unaffected either way.
    """

    CHUNK = 1 << 24

    def __init__(self, path, reader):
        self._r = reader
        self.size = int(reader.usize)

    def probe(self, offset: int, n: int) -> bytes:
        self._r.seek(offset)
        return self._r.read(n)

    def records_before(self, offset: int) -> int:
        self._r.seek(0)
        left, nl = offset, 0
        while left > 0:
            chunk = self._r.read(min(left, self.CHUNK))
            if not chunk:
                break
            nl += chunk.count(b"\n")
            left -= len(chunk)
        return nl // 4

    def offset_of_record(self, k: int) -> int:
        if k == 0:
            return 0
        self._r.seek(0)
        need, pos = 4 * k, 0
        while True:
            chunk = self._r.read(self.CHUNK)
            if not chunk:
                return self.size
            c = chunk.count(b"\n")
            if c >= need:
                nls = np.flatnonzero(
                    np.frombuffer(chunk, np.uint8) == 0x0A)
                return pos + int(nls[need - 1]) + 1
            need -= c
            pos += len(chunk)


def open_span(path):
    """The record-address space of ``path``: plain bytes, or BGZF
    uncompressed bytes (block-splittable gzip).  Raises ValueError for
    serial gzip, which has no splittable address space."""
    from ..io.compression import BgzfReader, is_gzip
    from ..io import native

    if is_gzip(path):
        r = BgzfReader.try_open(path) if native.available() else None
        if r is None:
            raise ValueError(
                f"'{path}' is serial gzip (not BGZF): no byte-splittable "
                "address space; pre-shard per host"
            )
        return _BgzfSpan(path, r)
    return _PlainSpan(path)


def realign_to_record(path, offset: int, probe_bytes: int = 1 << 16) -> int:
    """Smallest byte offset >= ``offset`` that starts a FASTQ record."""
    return _realign_span(open_span(path), offset, probe_bytes)


def _realign_span(span, offset: int, probe_bytes: int = 1 << 16) -> int:
    if offset == 0:
        return 0
    probe = span.probe(offset, probe_bytes)
    s = _first_record_start(probe)
    if s is None:
        raise ValueError(
            f"no FASTQ record boundary within {probe_bytes} bytes of offset {offset}"
        )
    return offset + s


def split_record_ranges(path, n_shards: int) -> List[Tuple[int, int]]:
    """Split a FASTQ file (plain, or BGZF in uncompressed space) into
    record-aligned (offset, length) byte ranges, one per shard."""
    return _split_span(open_span(path), n_shards)


def _split_span(span, n_shards: int) -> List[Tuple[int, int]]:
    size = span.size
    bounds = [_realign_span(span, size * i // n_shards) for i in range(n_shards)]
    bounds.append(size)
    return [(bounds[i], bounds[i + 1] - bounds[i]) for i in range(n_shards)]


def _mapped(path) -> np.ndarray:
    return np.memmap(path, dtype=np.uint8, mode="r")


def shard_record_ranges(path, n_shards: int, align: int = 1) -> List[Tuple[int, int]]:
    """Record-aligned (offset, length) byte ranges, one per host, with
    every boundary additionally on an ``align``-record multiple
    (interleaved pe passes 2 so no host splits a pair).  BGZF inputs
    shard in uncompressed space (the engine seeks the block index).

    The per-host work is an independent stream over its range — no
    cross-host traffic on the read path (SURVEY.md §2.2); concatenating
    the shard outputs in shard order reproduces the single-host bytes.
    """
    span = open_span(path)
    ranges = _split_span(span, n_shards)
    if align <= 1:
        return ranges
    bounds = []
    for off, _length in ranges:
        rec = span.records_before(off)
        if rec % align:
            off = span.offset_of_record(rec + (align - rec % align))
        bounds.append(off)
    bounds.append(span.size)
    return [(bounds[i], bounds[i + 1] - bounds[i]) for i in range(n_shards)]


def shard_paired_ranges(
    path1, path2, n_shards: int
) -> List[Tuple[Tuple[int, int], Tuple[int, int]]]:
    """Per-host byte ranges for a two-file pe run, split by PAIR index.

    File 1 is split byte-proportionally (record-aligned); file 2's
    boundaries are derived from file 1's record counts so both shards of a
    host hold exactly the same mates — pair decisions never cross hosts.
    Either file may be plain or BGZF (uncompressed-space offsets).
    """
    span1 = open_span(path1)
    span2 = open_span(path2)
    r1 = _split_span(span1, n_shards)
    recs = [span1.records_before(off) for off, _ in r1]
    bounds2 = [span2.offset_of_record(k) for k in recs] + [span2.size]
    out = []
    for i in range(n_shards):
        out.append(
            (r1[i], (bounds2[i], bounds2[i + 1] - bounds2[i]))
        )
    return out


def sharded_trim_step(params: TrimParams, devices: Sequence):
    """The full sharded device step: per-row cuts plus counters summed
    over the shards (the JAX package's ``psum`` step).

    Returns ``step(seq, qual, lengths) -> (five, three, first_bad,
    total, kept)``: the rows are split into one contiguous block per
    device, each block runs the cuts kernel (``ops.trim_cuda.trim_cuts``,
    explicit lengths) on its device, and ``total`` (rows with length > 0)
    and ``kept`` (rows with ``three >= 0``) are summed over the blocks.
    ``first_bad`` is 0 for a row with an out-of-range quality char, else
    ``BIG`` (the kernel reports a flag, not the position).  The arrays
    come back as int32 numpy arrays in row order; the counters as ints.
    The row count must be a multiple of the device count.
    """
    from ..engine.pipeline import _decode_codes
    from ..ops.trim_cuda import trim_cuts

    devices = [torch.device(d) for d in devices]

    def step(seq, qual, lengths):
        seq, qual, lengths = (torch.as_tensor(np.asarray(x))
                              for x in (seq, qual, lengths))
        B = qual.shape[0]
        if B % len(devices):
            raise ValueError(f"{B} rows do not split over {len(devices)} devices")
        blk = B // len(devices)
        outs, total, kept = [], 0, 0
        for k, d in enumerate(devices):
            rows = slice(k * blk, (k + 1) * blk)
            n = lengths[rows].to(d, torch.int32)
            codes = trim_cuts(qual[rows].to(d), params, lengths=n,
                              seq=seq[rows].to(d) if params.trunc_n else None)
            five, three, bad = _decode_codes(codes.cpu().numpy())
            total += int((n > 0).sum())
            kept += int((three >= 0).sum())
            outs.append((five, three, bad))
        five, three, bad = (np.concatenate(x) for x in zip(*outs))
        return five, three, bad, total, kept

    return step


def allreduce_host_counters(values: Sequence[int]) -> List[int]:
    """Sum per-process scalar counters across all processes (no-op with
    one process): one ``all_reduce(SUM)`` of an int64 CPU tensor.

    Used to merge the exact host-side SE/PE counters at end of run.
    """
    import torch.distributed as dist

    if _rank_and_size()[1] == 1:
        return list(values)
    t = torch.tensor(list(values), dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return [int(x) for x in t.tolist()]
