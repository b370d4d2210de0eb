"""Batched sliding-window trimming — the plain PyTorch formulation.

Port of ``sickle_tpu/ops/trim.py``: the reference's scalar per-read loop
(spec in ``oracle.sliding_window_cuts``) as masked data-parallel tensor
ops over a padded batch ``[B, L]``:

* rolling window sums     -> prefix-sum difference through the transform
  ``D[j] = C[j] - t*j`` (C = exclusive prefix), so a window starting at
  ``i`` has average ``>= t``  iff  ``D[i+w] >= D[i]``
* sequential 5'/3' triggers -> masked first-index reductions with an
  ``i3 >= i5`` ordering constraint
* within-window scans     -> masked first-index over positions ``>= trigger``
* ``int(0.1*len)`` window size -> ``len // 10`` (whole read if 0)

All arithmetic is int32 with two's-complement wrap, like the JAX
package's int32 path, so results are bit-identical to it.  These are the
plain versions the CUDA kernel (``ops/trim_cuda.py``) is held against,
and what its wrapper runs for tensors that lie on the CPU.

The compressed wires (``io/fastq.qual_fields`` / ``qual_rank_fields``)
decode here too: ``decode_fields`` (the field wire's biased value ``v``),
``apply_rank_lut`` (rank -> quality) and ``wire_codes``, the whole device
step of a wire chunk.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..constants import Compat, QUALITY_CONSTANTS, QualityType

BIG = 0x3FFFFFFF  # "no such index"

# (three+1) must fit 15 bits in the packed per-read code; longer rows use
# the unpacked [3, B] (five, three, flag) result
MAX_PACKED_L = 32766


@dataclasses.dataclass(frozen=True)
class TrimParams:
    """Static trimming configuration.

    Mirrors the reference CLI options (src/trim_single.cpp:90):
    -t/-q/-l/-x/-n plus the fork-vs-1.33 compat switch.
    """

    qualtype: QualityType = QualityType.SANGER
    qual_threshold: int = 20
    length_threshold: int = 20
    no_fiveprime: bool = False
    trunc_n: bool = False
    compat: Compat = Compat.V133
    # --strict: error on ANY out-of-range quality char.  Default matches
    # the reference exactly: only chars its scan touches error, decided
    # host-side per flagged row by a lazy scalar re-scan
    # (engine.pipeline._recheck_quality_row).
    strict: bool = False

    @classmethod
    def from_reference(cls, p) -> "TrimParams":
        """Carry a ``sickle_tpu.ops.TrimParams`` across, field by field,
        enums by value (the two packages define their own enum classes)."""
        return cls(
            qualtype=QualityType(int(p.qualtype)),
            qual_threshold=int(p.qual_threshold),
            length_threshold=int(p.length_threshold),
            no_fiveprime=bool(p.no_fiveprime),
            trunc_n=bool(p.trunc_n),
            compat=Compat(p.compat.value),
            strict=bool(p.strict),
        )


def _first_index(mask: torch.Tensor) -> torch.Tensor:
    """Smallest column index where ``mask`` is True, else BIG; int32[B]."""
    lane = torch.arange(mask.shape[1], dtype=torch.int32, device=mask.device)
    return torch.where(mask, lane, BIG).amin(dim=1)


def derive_lengths(qual: torch.Tensor) -> torch.Tensor:
    """Read lengths from the zero padding: the first zero byte of each row,
    else the row width.  Valid when the packer proved no quality byte
    inside a read is NUL (``PackedReads.qual_clean``)."""
    L = qual.shape[1]
    lane = torch.arange(L, dtype=torch.int32, device=qual.device)
    return torch.where(qual == 0, lane, L).amin(dim=1)


def decode_check(qual: torch.Tensor, lengths: torch.Tensor,
                 qualtype: QualityType):
    """Decode raw ASCII qualities and locate range violations.

    Returns ``(q, first_bad)``: ``q`` is ``int32[B, L]`` decoded quality
    (junk beyond ``lengths``) and ``first_bad`` is ``int32[B]``, the first
    position inside the read whose char is outside the encoding's
    [min, max], or BIG.  The check covers the WHOLE read — a conservative
    flag; the host decides per flagged row whether the reference's scan
    would have touched the char (see ``sickle_tpu.ops.trim.decode_check``).
    """
    offset, qmin, qmax = QUALITY_CONSTANTS[qualtype]
    raw = qual.to(torch.int32)
    lane = torch.arange(qual.shape[1], dtype=torch.int32, device=qual.device)
    in_read = lane[None, :] < lengths.to(torch.int32)[:, None]
    bad = in_read & ((raw < qmin) | (raw > qmax))
    return raw - offset, _first_index(bad)


def compute_cuts(
    seq: Optional[torch.Tensor],  # uint8[B, L]; only read when trunc_n
    qual: torch.Tensor,  # uint8[B, L] raw ASCII quality bytes
    lengths: torch.Tensor,  # int32[B]; 0 marks padding rows
    params: TrimParams,
    uniform_len: Optional[int] = None,
):
    """Per-read cutsites ``(five, three, first_bad)``, int32[B] each;
    ``(-1, -1)`` means discard and padding rows are always discarded."""
    lens = lengths.to(torch.int32)
    q, first_bad = decode_check(qual, lens, params.qualtype)
    five, three = compute_cuts_from_q(q, lens, params, seq, uniform_len)
    return five, three, first_bad


def compute_cuts_from_q(
    q: torch.Tensor,  # int32[B, L] decoded qualities (junk beyond lengths)
    lengths: torch.Tensor,  # int32[B]; 0 marks padding rows
    params: TrimParams,
    seq: Optional[torch.Tensor] = None,  # only read when trunc_n
    uniform_len: Optional[int] = None,
):
    """Core cut computation on decoded qualities.

    ``uniform_len``: every non-padding row has this length (the common
    Illumina case), so the window size is one constant and ``D[i+w]`` is
    a static column shift; otherwise it is one per-row gather.
    """
    B, L = q.shape
    dev = q.device
    t = params.qual_threshold
    lthr = params.length_threshold
    lens = lengths.to(torch.int32)
    lane = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    in_read = lane < lens[:, None]

    # D[j] = C[j] - t*j for j in [0, L], C[j] = sum q[0..j-1] inside the read
    qv = torch.where(in_read, q, 0)
    c_full = torch.cat([torch.zeros((B, 1), dtype=torch.int32, device=dev),
                        torch.cumsum(qv, dim=1, dtype=torch.int32)], dim=1)
    d_full = c_full - t * torch.arange(L + 1, dtype=torch.int32, device=dev)
    d = d_full[:, :L]

    if uniform_len is not None:
        ws = uniform_len // 10 or uniform_len
        w = torch.where(lens > 0, ws, 0).to(torch.int32)
        iw = torch.clamp(torch.arange(L, device=dev) + ws, max=L)
        dw = d_full[:, iw]
    else:
        w = lens // 10
        w = torch.where(w == 0, lens, w)
        iw = torch.clamp(lane + w[:, None], max=L).long()
        dw = torch.gather(d_full, 1, iw)

    i_valid = lane <= (lens - w)[:, None]  # window start i, i + w <= len
    hi = i_valid & (dw >= d)
    lo = i_valid & (dw < d)

    i5 = _first_index(hi)
    found_five = (i5 < BIG) & (lens > 0)
    start3 = torch.zeros_like(i5) if params.no_fiveprime else i5
    i3 = _first_index(lo & (lane >= start3[:, None]))

    # 5' cut: first position >= i5 with q >= t (inside the trigger window)
    if params.no_fiveprime:
        five = torch.zeros_like(lens)
    else:
        five = _first_index(in_read & (q >= t) & (lane >= i5[:, None]))
        five = torch.where(found_five, torch.minimum(five, lens), 0)

    # 3' cut: first position >= i3 with q < t; stays len if never triggered
    three_hit = _first_index(in_read & (q < t) & (lane >= i3[:, None]))
    three = torch.where(i3 < BIG, torch.minimum(three_hit, lens), lens)

    # -n: truncate to the base BEFORE the first N (compat picks N/n order)
    if params.trunc_n:
        up = _first_index(in_read & (seq == ord("N")))
        low = _first_index(in_read & (seq == ord("n")))
        if params.compat == Compat.V133:
            nidx = torch.where(up < BIG, up, low)
        else:
            nidx = torch.where(low < BIG, low, up)
        three = torch.where(nidx < BIG, nidx - 1, three)

    keep = (lens >= lthr) & (three - five >= lthr) & (lens > 0)
    if not params.no_fiveprime:
        keep &= found_five
    return torch.where(keep, five, -1), torch.where(keep, three, -1)


def encode_codes(five: torch.Tensor, three: torch.Tensor,
                 first_bad: torch.Tensor, lengths: torch.Tensor,
                 L: int) -> torch.Tensor:
    """The device step's per-read result for rows of width ``L``.

    ``L < MAX_PACKED_L``: one int32 per read — (five+1) in bits 16-30, a
    has-bad-quality flag in bit 15, (three+1) in bits 0-14.  Longer rows
    (three+1 no longer fits 15 bits): the ``[3, B]`` stack (five, three,
    flag).
    """
    flagged = (first_bad < lengths.to(torch.int32)).to(torch.int32)
    if L < MAX_PACKED_L:
        return (three + 1) | (flagged << 15) | ((five + 1) << 16)
    return torch.stack([five, three, flagged])


def trim_codes(seq: Optional[torch.Tensor], qual: torch.Tensor,
               lengths: Optional[torch.Tensor], params: TrimParams,
               uniform_len: Optional[int] = None) -> torch.Tensor:
    """The whole device step in plain PyTorch: lengths (derived from the
    zero padding when None), cuts, and the encoded result.  The CUDA
    kernel computes the same thing in one launch."""
    if lengths is None:
        lengths = derive_lengths(qual)
    five, three, bad = compute_cuts(seq, qual, lengths, params, uniform_len)
    return encode_codes(five, three, bad, lengths, qual.shape[1])


def decode_fields(buf: torch.Tensor, p: int, L: int) -> torch.Tensor:
    """Inverse of ``io/fastq.qual_fields`` / ``qual_rank_fields``.

    ``buf`` is ``uint8[B, p*L//8]``: the ``p``-bit value split into
    byte-aligned 4/2/1-bit subfields (layout in ``io/fastq.field_widths``;
    ``L % 8 == 0``).  Returns ``v`` as ``uint8[B, L]``; padding packs to
    all-zero fields, so ``v == 0`` marks padding exactly.
    """
    from ..io.fastq import field_widths

    lane = torch.arange(L, device=buf.device)
    v = None
    for w, sh, colf in field_widths(p):
        col = int(colf * L)
        per = 8 // w
        sub = buf[:, col:col + L * w // 8]
        rep = sub.repeat_interleave(per, dim=1)  # byte j // per at lane j
        shift = ((lane % per) * w).to(torch.uint8)
        part = ((rep >> shift) & ((1 << w) - 1)) << sh
        v = part if v is None else v | part
    return v


def apply_rank_lut(v: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Rank-wire decode: ``q = lut[v]`` for ``v`` in ``[1, len(lut))``, 0
    elsewhere (0 is padding; ``io/fastq.qual_rank_fields`` is the host
    inverse)."""
    q = torch.zeros_like(v)
    for k in range(1, lut.shape[0]):
        q = torch.where(v == k, lut[k].to(v.dtype), q)
    return q


def wire_codes(buf: torch.Tensor, p: int, L: int, params: TrimParams, *,
               bias: Optional[int] = None, lut=None,
               uniform_len: Optional[int] = None) -> torch.Tensor:
    """The device step of a wire chunk in plain PyTorch (the JAX
    package's ``step_planes`` / ``step_planes_rank``): decode ``v``,
    derive each length from the first ``v == 0``, decode the quality
    (``v + bias`` on the band wire, ``lut[v]`` on the rank wire) and
    return the packed int32 codes ``(five+1) << 16 | (three+1)``.  The
    bad-quality flag is always 0: the host proved every char in range
    before it chose a wire.  ``-n`` never takes a wire."""
    if params.trunc_n:
        raise ValueError("the wire carries no seq rows: -n takes raw rows")
    if (bias is None) == (lut is None):
        raise ValueError("give exactly one of bias (band wire) and lut (rank wire)")
    v = decode_fields(buf, p, L).to(torch.int32)
    lane = torch.arange(L, dtype=torch.int32, device=buf.device)
    lengths = torch.where(v == 0, lane, L).amin(dim=1)
    if lut is None:
        q = v + bias
    else:
        q = apply_rank_lut(v, torch.as_tensor(lut, dtype=torch.int32,
                                              device=buf.device))
    five, three = compute_cuts_from_q(q, lengths, params,
                                      uniform_len=uniform_len)
    return (three + 1) | ((five + 1) << 16)
