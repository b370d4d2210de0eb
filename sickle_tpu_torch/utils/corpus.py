"""Seeded synthetic FASTQ corpora (numpy only, no inputs from outside).

One generator for the port's tests and ``chip_smoke.py``: Illumina-like
reads whose quality is high at the 5' end and decays toward the 3' end,
with a share of 3' quality crashes, low-quality starts and all-low reads
so every branch of the trim runs.  Options add what the conformance tests
need: ragged lengths, NovaSeq-style binned qualities, N/n bases for
``-n``, and out-of-range quality chars either where the trimming scan
cannot reach them (``bad_tail``: the run must finish) or where it always
does (``bad_head``: the run must fail with the reference's message).

Records are ``@r<9 digits>`` / seq / ``+`` / qual, so the whole file is
assembled with array scatters, in chunks.  ``write_pairs`` writes read
pairs, as two mate files or one interleaved file: the mates of a pair
share their name, and each mate can have its own length model (2x150,
150/100, ragged 30-160).  ``edge_fastq`` gives small files with one odd
or malformed feature each (``EDGES``), the inputs where a reader or a
device path is most likely to part from the reference.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np

from ..constants import QUALITY_CONSTANTS, QualityType

NOVASEQ_BINS = np.array([2, 12, 23, 37])
_NAME_DIGITS = 9
_REC_FIXED = 2 + _NAME_DIGITS + 1 + 1 + 2 + 1  # "@r" digits \n .. \n "+\n" .. \n


def _window(lengths: np.ndarray) -> np.ndarray:
    w = lengths // 10
    return np.where(w == 0, lengths, w)


def make_reads(
    seed: int,
    n: int,
    *,
    length: Union[int, Tuple[int, int]] = 150,
    qualtype: QualityType = QualityType.SANGER,
    binned: bool = False,
    n_rate: float = 0.0,
    bad_tail: float = 0.0,
    bad_head: float = 0.0,
    width: Optional[int] = None,
):
    """``(seq, qual, lengths)``: uint8[n, width] rows (zero past each read)
    and int32[n] lengths.  ``length`` is one read length or an inclusive
    ``(lo, hi)`` range; ``width`` defaults to the longest read."""
    rng = np.random.default_rng(seed)
    if isinstance(length, tuple):
        lengths = rng.integers(length[0], length[1] + 1, n)
    else:
        lengths = np.full(n, length)
    lengths = lengths.astype(np.int32)
    L = int(width or (lengths.max() if n else 1))
    pos = np.arange(L)[None, :]
    in_read = pos < lengths[:, None]
    frac = pos / np.maximum(lengths[:, None], 1)
    offset, qmin, qmax = QUALITY_CONSTANTS[qualtype]
    q_lo, q_hi = qmin - offset, min(qmax - offset, 41)

    # Phred model: per-read level, quadratic 3' decay, noise
    level = rng.uniform(28, 38, (n, 1))
    q = level - 12 * frac ** 2 + rng.normal(0, 4, (n, L))
    kind = rng.random(n)
    drop = kind < 0.2  # 3' crash at a random point
    p_drop = (lengths * rng.uniform(0.3, 0.9, n)).astype(np.int64)
    low_start = (kind >= 0.2) & (kind < 0.25)
    k_start = (lengths * rng.uniform(0.02, 0.2, n)).astype(np.int64) + 1
    all_low = (kind >= 0.25) & (kind < 0.27)

    bad_t = (rng.random(n) < bad_tail) & (lengths >= 40)
    if bad_t.any():  # a clean start, then a crash well before the bad char
        w = _window(lengths)
        hi_p = np.maximum(lengths // 4 + 1, lengths - 2 * w - 2)
        p_drop = np.where(bad_t, rng.integers(lengths // 4, hi_p), p_drop)
        drop |= bad_t
        low_start &= ~bad_t
        all_low &= ~bad_t
        level = np.where(bad_t[:, None], 36.0, level)
        q = np.where(bad_t[:, None], level - 4 * frac + rng.normal(0, 2, (n, L)), q)
    q = np.where(drop[:, None] & (pos >= p_drop[:, None]),
                 rng.uniform(2, 15, (n, L)), q)
    q = np.where(low_start[:, None] & (pos < k_start[:, None]),
                 rng.uniform(2, 12, (n, L)), q)
    q = np.where(all_low[:, None], rng.uniform(2, 18, (n, L)), q)
    q = np.clip(np.rint(q), q_lo, q_hi).astype(np.int64)
    if binned:
        nearest = np.abs(q[..., None] - NOVASEQ_BINS).argmin(axis=-1)
        q = np.maximum(NOVASEQ_BINS[nearest], q_lo)
    qual = np.where(in_read, q + offset, 0).astype(np.uint8)

    bad_char = qmax + 1 if qmax < 255 else qmin - 1
    last = np.maximum(lengths - 1, 0)
    qual[np.flatnonzero(bad_t), last[bad_t]] = bad_char
    bad_h = (rng.random(n) < bad_head) & (lengths >= 2)
    qual[np.flatnonzero(bad_h), 1] = bad_char

    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (n, L))]
    if n_rate:
        r = rng.random((n, L))
        seq = np.where(r < n_rate, ord("N"), seq)
        seq = np.where((r >= n_rate) & (r < 1.5 * n_rate), ord("n"), seq)
    seq = np.where(in_read, seq, 0).astype(np.uint8)
    return seq, qual, lengths


def wire_quals(seed: int, n: int, L: int, p: int, *, rank: bool = False,
               qualtype: QualityType = QualityType.SANGER,
               uniform: Optional[int] = None) -> np.ndarray:
    """uint8[n, L] quality rows that a ``p``-bit wire carries: chars drawn
    from ``2**p - 1`` consecutive values (the band wire; fewer where the
    encoding's range is narrower) or from ``2**p - 1`` levels spread over
    the encoding (the rank wire), all in the encoding's range, zero
    padded.  Lengths are 1..L, or ``uniform``; the last rows are padding
    (length 0)."""
    rng = np.random.default_rng(seed)
    _, qmin, qmax = QUALITY_CONSTANTS[qualtype]
    k = min((1 << p) - 1, qmax - qmin + 1)
    if rank:
        chars = np.sort(rng.choice(np.arange(qmin, qmax + 1), k, replace=False))
    else:
        lo = int(rng.integers(qmin, qmax - k + 2))
        chars = np.arange(lo, lo + k)
    qual = chars[rng.integers(0, k, (n, L))].astype(np.uint8)
    lengths = (np.full(n, uniform) if uniform is not None
               else rng.integers(1, L + 1, n))
    lengths[-max(n // 16, 1):] = 0
    qual[np.arange(L)[None, :] >= lengths[:, None]] = 0
    return qual


def fastq_bytes(seq: np.ndarray, qual: np.ndarray, lengths: np.ndarray,
                first: int = 0, names: Optional[np.ndarray] = None) -> bytes:
    """FASTQ text of the rows, named ``@r<first + i>`` (9 digits), or
    ``@r<names[i]>`` when ``names`` is given."""
    n = lengths.size
    if n == 0:
        return b""
    lens = lengths.astype(np.int64)
    sizes = 2 * lens + _REC_FIXED
    start = np.cumsum(sizes) - sizes
    out = np.empty(int(sizes.sum()), np.uint8)
    out[start] = ord("@")
    out[start + 1] = ord("r")
    idx = (first + np.arange(n, dtype=np.int64) if names is None
           else np.asarray(names, np.int64))
    for d in range(_NAME_DIGITS):
        out[start + 2 + d] = 48 + (idx // 10 ** (_NAME_DIGITS - 1 - d)) % 10
    seq_at = start + 3 + _NAME_DIGITS
    out[seq_at - 1] = ord("\n")
    in_read = np.arange(seq.shape[1])[None, :] < lens[:, None]
    lane = np.arange(seq.shape[1])[None, :]
    out[(seq_at[:, None] + lane)[in_read]] = seq[in_read]
    out[seq_at + lens] = ord("\n")
    out[seq_at + lens + 1] = ord("+")
    out[seq_at + lens + 2] = ord("\n")
    qual_at = seq_at + lens + 3
    out[(qual_at[:, None] + lane)[in_read]] = qual[in_read]
    out[qual_at + lens] = ord("\n")
    return out.tobytes()


def write_fastq(f, seed: int, n: int, chunk: int = 1 << 16, first: int = 0,
                **kw) -> int:
    """Write ``n`` reads of ``make_reads(**kw)`` to the binary stream ``f``
    in chunks (each chunk seeded from ``seed`` and its index); returns
    the bytes written."""
    total = 0
    for k, i in enumerate(range(0, n, chunk)):
        m = min(chunk, n - i)
        data = fastq_bytes(*make_reads(seed * 1_000_003 + k, m, **kw),
                           first=first + i)
        f.write(data)
        total += len(data)
    return total


def write_pairs(f1, f2, seed: int, n: int, *, mate1: Optional[dict] = None,
                mate2: Optional[dict] = None, chunk: int = 1 << 16,
                first: int = 0, **kw) -> int:
    """Write ``n`` read pairs: mate 1 to the binary stream ``f1`` and
    mate 2 to ``f2``, or both interleaved (mate 1, mate 2, ...) to ``f1``
    when ``f2`` is None.  ``kw`` are ``make_reads`` options for both
    mates; ``mate1``/``mate2`` override them per mate (e.g.
    ``length=150`` and ``length=100``).  The mates of pair ``i`` are both
    named ``@r<first + i>``.  Returns the bytes written."""
    total = 0
    for k, i in enumerate(range(0, n, chunk)):
        m = min(chunk, n - i)
        base = seed * 1_000_003 + 2 * k
        s1, q1, l1 = make_reads(base, m, **{**kw, **(mate1 or {})})
        s2, q2, l2 = make_reads(base + 1, m, **{**kw, **(mate2 or {})})
        if f2 is not None:
            b1 = fastq_bytes(s1, q1, l1, first=first + i)
            b2 = fastq_bytes(s2, q2, l2, first=first + i)
            f1.write(b1)
            f2.write(b2)
            total += len(b1) + len(b2)
            continue
        W = max(s1.shape[1], s2.shape[1])
        seq = np.zeros((2 * m, W), np.uint8)
        qual = np.zeros((2 * m, W), np.uint8)
        seq[0::2, : s1.shape[1]], seq[1::2, : s2.shape[1]] = s1, s2
        qual[0::2, : q1.shape[1]], qual[1::2, : q2.shape[1]] = q1, q2
        lengths = np.empty(2 * m, np.int32)
        lengths[0::2], lengths[1::2] = l1, l2
        data = fastq_bytes(seq, qual, lengths,
                           names=first + i + np.arange(2 * m) // 2)
        f1.write(data)
        total += len(data)
    return total


# odd or malformed inputs of edge_fastq
EDGES = ("crlf", "no_plus", "truncated", "multiline", "empty_read", "nul")


def edge_fastq(edge: str, seed: int, n: int = 40, **kw) -> bytes:
    """FASTQ text of ``n`` reads of ``make_reads(seed, n, **kw)`` with one
    feature of ``EDGES``: CRLF line ends (``crlf``), the middle record's
    ``+`` line missing (``no_plus``), the last record cut after its
    sequence line (``truncated``), the middle record's sequence and
    quality each wrapped over two lines (``multiline``), the middle read
    of length 0 (``empty_read``), or a NUL quality char past the 3' cut
    of a share of the reads (``nul``: ``bad_tail``'s chars, 0.1 of the
    reads unless given, become NUL, so the reads are clean to the scan
    but not to the zero-padding length rule)."""
    if edge not in EDGES:
        raise ValueError(f"no edge {edge!r}; one of {EDGES}")
    if edge == "nul":
        kw.setdefault("bad_tail", 0.1)
    seq, qual, lengths = make_reads(seed, n, **kw)
    mid = n // 2
    if edge == "nul":
        qual[qual > QUALITY_CONSTANTS[kw.get("qualtype", QualityType.SANGER)][2]] = 0
    if edge == "empty_read":
        lengths[mid] = 0
    data = fastq_bytes(seq, qual, lengths)
    if edge == "crlf":
        return data.replace(b"\n", b"\r\n")
    lines = data.split(b"\n")[:-1]
    if edge == "no_plus":
        del lines[4 * mid + 2]
    elif edge == "truncated":
        del lines[-2:]
    elif edge == "multiline":
        s, q = lines[4 * mid + 1], lines[4 * mid + 3]
        h = len(s) // 2
        lines[4 * mid + 1: 4 * mid + 4] = [s[:h], s[h:], b"+", q[:h], q[h:]]
    return b"\n".join(lines) + b"\n"
