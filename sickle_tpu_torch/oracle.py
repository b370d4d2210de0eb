"""Trusted scalar oracle for sickle's windowed adaptive trimming.

This module is a direct, *scalar* implementation of the intended sickle 1.33
semantics (the spec in SURVEY.md §2.3, derived from
the reference's src/trim.cpp:3-116).  It is deliberately simple Python: the
device kernels (sickle_tpu.ops) are property-tested against it, and it is
itself golden-tested byte-for-byte against clean runs of the reference binary
(tests/golden_manifest.json).

It intentionally does NOT reproduce the reference fork's defects (SURVEY.md
§2.4): the -n npos bug, the unimplemented -M, races, or the broken gzip
output.  Where fork and upstream 1.33 disagree, behavior is selected by
``compat`` (constants.Compat).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, List, Optional, Tuple

from .constants import (
    Compat,
    QUALITY_CONSTANTS,
    QualityType,
    TYPE_NAMES,
    lowest_quality_char,
)

DISCARD = (-1, -1)


class SickleError(Exception):
    """Base error; carries the exit code and pre-formatted stderr message."""

    exit_code = 1

    def __init__(self, message: str):
        super().__init__(message)
        self.message = message


class QualityRangeError(SickleError):
    """Quality char outside the encoding range.

    Message format matches the reference's src/trim.cpp:121-135 (exit(1)).
    """

    exit_code = 1


class FastqValidationError(SickleError):
    """Malformed FASTQ record (reference src/FQEntry.cpp:53-97, EXIT_FAILURE)."""

    exit_code = 1


def quality_range_message(
    qual_value: int, qualtype: QualityType, name: bytes, qual: bytes, pos: int
) -> str:
    tname = TYPE_NAMES[qualtype]
    _, qmin, qmax = QUALITY_CONSTANTS[qualtype]
    return (
        f"ERROR: Quality value ({qual_value}) does not fall within correct "
        f"range for {tname} encoding.\n"
        f"Range for {tname} encoding: {qmin}-{qmax}\n"
        f"FastQ record: {name.decode('latin-1')}\n"
        f"Quality string: {qual.decode('latin-1')}\n"
        f"Quality char: '{chr(qual_value)}'\n"
        f"Quality position: {pos + 1}\n"
    )


def decode_qual(
    qual: bytes, qualtype: QualityType, name: bytes = b""
) -> List[int]:
    """Decode an ASCII quality string, enforcing the encoding's range.

    Mirrors get_quality_num (the reference's src/trim.cpp:118-140): any char
    outside [min, max] is a hard error naming the record and 1-based position.
    """
    offset, qmin, qmax = QUALITY_CONSTANTS[qualtype]
    out = []
    for pos, ch in enumerate(qual):
        if ch < qmin or ch > qmax:
            raise QualityRangeError(
                quality_range_message(ch, qualtype, name, qual, pos)
            )
        out.append(ch - offset)
    return out


class _LazyQuals:
    """Decode-on-touch quality accessor.

    Reproduces the reference's get_quality_num semantics
    (src/trim.cpp:118-134): a char is range-checked only when the scan
    actually touches it, so junk past the 3' break never errors — a
    sickle-1.33 behavior real-world dirty files rely on.
    """

    __slots__ = ("qual", "qualtype", "name", "offset", "qmin", "qmax")

    def __init__(self, qual: bytes, qualtype: QualityType, name: bytes):
        self.qual = qual
        self.qualtype = qualtype
        self.name = name
        self.offset, self.qmin, self.qmax = QUALITY_CONSTANTS[qualtype]

    def __getitem__(self, j: int) -> int:
        ch = self.qual[j]
        if ch < self.qmin or ch > self.qmax:
            raise QualityRangeError(
                quality_range_message(ch, self.qualtype, self.name, self.qual, j)
            )
        return ch - self.offset


def first_n_index(seq: bytes, compat: Compat) -> Optional[int]:
    """Index of the N used by -n truncation, or None.

    compat=1.33: first 'N' if any, else first 'n' (upstream strstr order).
    compat=fork: first 'n' if any, else first 'N' (the fork's intended order,
    the reference's src/trim.cpp:86-95 — its actual code is the npos bug we
    must not replicate, SURVEY.md §2.4.4).
    """
    a, b = (b"N", b"n") if compat == Compat.V133 else (b"n", b"N")
    i = seq.find(a)
    if i >= 0:
        return i
    i = seq.find(b)
    return i if i >= 0 else None


def sliding_window_cuts(
    seq: bytes,
    qual: bytes,
    *,
    qualtype: QualityType,
    qual_threshold: int,
    length_threshold: int,
    no_fiveprime: bool = False,
    trunc_n: bool = False,
    compat: Compat = Compat.V133,
    name: bytes = b"",
    strict_quality: bool = False,
) -> Tuple[int, int]:
    """Compute (five_prime_cut, three_prime_cut) for one read; (-1,-1) = discard.

    Scalar transcription of the spec in SURVEY.md §2.3 / reference
    src/trim.cpp:3-116.  All comparisons are integer-exact: the reference's
    ``window_avg >= q`` (double) equals ``window_total >= q * window_size``
    because both sides are integers and window_size > 0.

    Quality chars are range-checked lazily, exactly where the reference's
    scan touches them (every first touch is in ascending position order:
    the initial window, then each rolling add) — ``strict_quality=True``
    checks the whole string up front instead.
    """
    L = len(seq)
    # upfront length filter (trim.cpp:21-26) — before any quality decode
    if L < length_threshold:
        return DISCARD

    q = (
        decode_qual(qual, qualtype, name)
        if strict_quality
        else _LazyQuals(qual, qualtype, name)
    )
    t = qual_threshold

    # window = int(0.1 * len) with C double->int truncation (trim.cpp:8);
    # if 0, the window is the whole read (trim.cpp:30).
    w = int(0.1 * L)
    if w == 0:
        w = L

    five = 0
    three = L
    found_five = False

    window_total = sum(q[j] for j in range(w))
    for i in range(0, L - w + 1):
        # 5' trigger: first window whose average rises to >= t (trim.cpp:42-56)
        if not no_fiveprime and not found_five and window_total >= t * w:
            for j in range(i, i + w):
                if q[j] >= t:
                    five = j
                    break
            found_five = True
        # 3' trigger: first window (after 5' found, or always with -x) whose
        # average drops below t (trim.cpp:61-73); cut at first low qual in it.
        if window_total < t * w and (found_five or no_fiveprime):
            for j in range(i, i + w):
                if q[j] < t:
                    three = j
                    break
            break
        # slide (trim.cpp:76-80)
        window_total -= q[i]
        if i + w < L:
            window_total += q[i + w]

    # -n: truncate at the base BEFORE the first N (upstream semantics;
    # unconditional override of the quality-derived 3' cut).
    if trunc_n:
        nidx = first_n_index(seq, compat)
        if nidx is not None:
            three = nidx - 1

    # final keep test (trim.cpp:103-106)
    if (not found_five and not no_fiveprime) or (three - five < length_threshold):
        return DISCARD
    return five, three


# ---------------------------------------------------------------------------
# FASTQ record model (scalar parity layer for reference src/FQEntry.cpp)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FastqRecord:
    name: bytes
    seq: bytes
    comment: bytes
    qual: bytes
    position: int = 0  # 1-based record index, as in FQEntry.position


def validate_record(rec: FastqRecord) -> None:
    """FASTQ structural validation; messages per src/FQEntry.cpp:53-97."""

    def ctx() -> str:
        return (
            f"In {rec.name.decode('latin-1')}(line {(rec.position * 4) - 4})"
        )

    if len(rec.name) <= 1:
        raise FastqValidationError(
            f"{ctx()}\nSequence ID is to short.\n"
            f"ID:{rec.name.decode('latin-1')}\n"
            f"Sequence: {rec.seq.decode('latin-1')}\n"
            f"Comment: {rec.comment.decode('latin-1')}\n"
            f"Qualities: {rec.qual.decode('latin-1')}"
        )
    if rec.name[:1] != b"@":
        raise FastqValidationError(
            f"{ctx()}\nInvalid char at the beggining of ID.\n"
            f"Sequence: {rec.seq.decode('latin-1')}\n"
            f"Comment: {rec.comment.decode('latin-1')}\n"
            f"Qualities: {rec.qual.decode('latin-1')}"
        )
    if len(rec.seq) < 1:
        raise FastqValidationError("Sequence line is empty")
    if len(rec.qual) < 1:
        raise FastqValidationError("Quality line is empty.")
    if len(rec.qual) != len(rec.seq):
        raise FastqValidationError(
            "Sequence and quality lines have different lengths:\n"
            f"{rec.seq.decode('latin-1')}\n{rec.qual.decode('latin-1')}"
        )


def parse_fastq_bytes(data: bytes, start_position: int = 0) -> List[FastqRecord]:
    """Parse FASTQ text into records (4 lines each), validating like FQEntry.

    Lines are split on '\\n' only (the reference's gzgets strips only '\\n');
    a trailing unterminated line still counts as a line.
    """
    lines = data.split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    records = []
    pos = start_position
    for i in range(0, len(lines) - len(lines) % 4, 4):
        pos += 1
        rec = FastqRecord(lines[i], lines[i + 1], lines[i + 2], lines[i + 3], pos)
        validate_record(rec)
        records.append(rec)
    return records


def format_record(
    rec: FastqRecord, five: int, three: int, compat: Compat = Compat.V133
) -> bytes:
    """Emit a trimmed record.

    compat=1.33 rewrites the comment line to a bare '+' (upstream behavior,
    reference README.md:44-46); compat=fork emits it verbatim
    (the reference's src/trim_single.cpp:395).
    """
    comment = b"+" if compat == Compat.V133 else rec.comment
    return b"%s\n%s\n%s\n%s\n" % (
        rec.name,
        rec.seq[five:three],
        comment,
        rec.qual[five:three],
    )


def n_record(rec: FastqRecord, qualtype: QualityType, compat: Compat) -> bytes:
    """The pe -M replacement record: seq 'N', lowest quality char."""
    comment = b"+" if compat == Compat.V133 else rec.comment
    return b"%s\nN\n%s\n%s\n" % (rec.name, comment, lowest_quality_char(qualtype))


# ---------------------------------------------------------------------------
# Whole-file oracle entry points (se / pe).  Byte-exact against clean reference runs.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SECounters:
    total: int = 0
    kept: int = 0
    discarded: int = 0


@dataclasses.dataclass
class PECounters:
    total: int = 0
    kept_p: int = 0
    kept_s1: int = 0
    kept_s2: int = 0
    discard_p: int = 0
    discard_s1: int = 0
    discard_s2: int = 0


def trim_se(
    data: bytes,
    *,
    qualtype: QualityType,
    qual_threshold: int = 20,
    length_threshold: int = 20,
    no_fiveprime: bool = False,
    trunc_n: bool = False,
    compat: Compat = Compat.V133,
) -> Tuple[bytes, SECounters]:
    records = parse_fastq_bytes(data)
    out = []
    c = SECounters()
    for rec in records:
        five, three = sliding_window_cuts(
            rec.seq,
            rec.qual,
            qualtype=qualtype,
            qual_threshold=qual_threshold,
            length_threshold=length_threshold,
            no_fiveprime=no_fiveprime,
            trunc_n=trunc_n,
            compat=compat,
            name=rec.name,
        )
        if three >= 0:
            out.append(format_record(rec, five, three, compat))
            c.kept += 1
        else:
            c.discarded += 1
    c.total = c.kept + c.discarded
    return b"".join(out), c


def trim_pe(
    data1: bytes,
    data2: Optional[bytes] = None,
    *,
    interleaved: bool = False,
    qualtype: QualityType,
    qual_threshold: int = 20,
    length_threshold: int = 20,
    no_fiveprime: bool = False,
    trunc_n: bool = False,
    n_record_mode: bool = False,
    compat: Compat = Compat.V133,
) -> Tuple[bytes, bytes, bytes, PECounters]:
    """Paired-end oracle.

    Returns (out1, out2, singles, counters).  For interleaved output modes
    (-m / -M) the combined stream is out1 and out2 is empty.  Pair decision per
    reference src/trim_paired.cpp:543-567; -M per upstream 1.33 / README.
    """
    if interleaved:
        records = parse_fastq_bytes(data1)
        if len(records) % 2:
            raise FastqValidationError(
                "Reading interleaved pair: read1 loaded, but no read2 to load. "
                "Maybe it's not an interleaved file?"
            )
        pairs = [(records[i], records[i + 1]) for i in range(0, len(records), 2)]
    else:
        r1 = parse_fastq_bytes(data1)
        r2 = parse_fastq_bytes(data2 or b"")
        if len(r1) != len(r2):
            raise FastqValidationError(
                "Batch2 and Batch1 have different lengths, exiting"
            )
        pairs = list(zip(r1, r2))

    out1, out2, singles = [], [], []
    c = PECounters()
    kw = dict(
        qualtype=qualtype,
        qual_threshold=qual_threshold,
        length_threshold=length_threshold,
        no_fiveprime=no_fiveprime,
        trunc_n=trunc_n,
        compat=compat,
    )
    for rec1, rec2 in pairs:
        f1, t1 = sliding_window_cuts(rec1.seq, rec1.qual, name=rec1.name, **kw)
        f2, t2 = sliding_window_cuts(rec2.seq, rec2.qual, name=rec2.name, **kw)
        p1, p2 = t1 >= 0, t2 >= 0
        # -M always produces one interleaved stream, regardless of input mode
        mate_stream = out1 if (interleaved or n_record_mode) else out2
        if p1 and p2:
            out1.append(format_record(rec1, f1, t1, compat))
            mate_stream.append(format_record(rec2, f2, t2, compat))
            c.kept_p += 2
        elif p1 or p2:
            if n_record_mode:
                # -M: preserve pairing; the failed mate becomes an N record.
                out1.append(
                    format_record(rec1, f1, t1, compat)
                    if p1
                    else n_record(rec1, qualtype, compat)
                )
                out1.append(
                    format_record(rec2, f2, t2, compat)
                    if p2
                    else n_record(rec2, qualtype, compat)
                )
            else:
                singles.append(
                    format_record(rec1, f1, t1, compat)
                    if p1
                    else format_record(rec2, f2, t2, compat)
                )
            if p1:
                c.kept_s1 += 1
                c.discard_s2 += 1
            else:
                c.kept_s2 += 1
                c.discard_s1 += 1
        else:
            if n_record_mode:
                out1.append(n_record(rec1, qualtype, compat))
                out1.append(n_record(rec2, qualtype, compat))
            c.discard_p += 2
    c.total = (
        c.kept_p + c.kept_s1 + c.kept_s2 + c.discard_p + c.discard_s1 + c.discard_s2
    )
    return b"".join(out1), b"".join(out2), b"".join(singles), c
