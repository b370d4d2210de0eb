"""The port's plain PyTorch cuts against the JAX package's, exactly.

Inputs come from the port's seeded corpus generator (numpy) and go
unchanged through ``sickle_tpu.ops.trim.compute_cuts`` (jnp), the Pallas
kernels in interpret mode (``compute_cuts_pallas(..., interpret=True)``)
and ``sickle_tpu_torch.ops.trim``; parameters cross over with
``TrimParams.from_reference``.  Outputs are integers: tolerance 0.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sickle_tpu.constants import Compat as JCompat
from sickle_tpu.constants import QualityType as JQualityType
from sickle_tpu.engine.pipeline import _tpu_cuts_fn
from sickle_tpu.ops import TrimParams as JTrimParams
from sickle_tpu.ops.trim import apply_rank_lut as jax_apply_rank_lut
from sickle_tpu.ops.trim import compute_cuts as jax_compute_cuts
from sickle_tpu.ops.trim import compute_cuts_from_q as jax_cuts_from_q
from sickle_tpu.ops.trim import decode_fields as jax_decode_fields
from sickle_tpu.ops.trim_pallas import compute_cuts_pallas
from sickle_tpu_torch.constants import Compat, QualityType
from sickle_tpu_torch.engine.pipeline import _cuda_cuts_fn, _decode_codes
from sickle_tpu_torch.ops import trim_cuda
from sickle_tpu_torch.ops.trim import (
    MAX_PACKED_L,
    TrimParams,
    compute_cuts,
    derive_lengths,
    encode_codes,
    trim_codes,
)
from sickle_tpu_torch.constants import QUALITY_CONSTANTS
from sickle_tpu_torch.io.fastq import qual_fields, qual_levels, qual_rank_fields
from sickle_tpu_torch.ops.trim import wire_codes
from sickle_tpu_torch.utils.corpus import make_reads, wire_quals

S, I, X = JQualityType.SANGER, JQualityType.ILLUMINA, JQualityType.SOLEXA
CONFIGS = [
    # the five of tests/test_trim_pallas.py
    JTrimParams(S, 60, 20, False, False, JCompat.FORK),
    JTrimParams(S, 20, 20, False, True, JCompat.V133),
    JTrimParams(I, 30, 30, True, False, JCompat.V133),
    JTrimParams(X, 20, 5, False, True, JCompat.FORK),
    JTrimParams(S, 0, 0, False, False, JCompat.V133),
    # the four of tools/tpu_kernel_verify.py
    JTrimParams(S, 60, compat=JCompat.FORK),
    JTrimParams(S, 20),
    JTrimParams(S, 30, trunc_n=True),
    JTrimParams(S, 40, no_fiveprime=True),
]
IDS = [f"{p.qualtype.name.lower()}-q{p.qual_threshold}-l{p.length_threshold}"
       f"{'-x' if p.no_fiveprime else ''}{'-n' if p.trunc_n else ''}"
       f"-{p.compat.value}" for p in CONFIGS]
B = 256


def batch(jp, form, seed=0):
    """uint8 seq/qual [B, L] and int32 lengths: uniform 150 bp rows in a
    152-wide batch, or ragged 1-250 bp rows at 256; the last rows are
    padding; N/n bases and out-of-range chars before and past the cut."""
    qt = QualityType(int(jp.qualtype))
    if form == "uniform":
        seq, qual, lens = make_reads(seed, B, length=150, qualtype=qt,
                                     width=152, n_rate=0.02, bad_tail=0.05,
                                     bad_head=0.02)
    else:
        seq, qual, lens = make_reads(seed + 1, B, length=(1, 250), qualtype=qt,
                                     width=256, n_rate=0.02, bad_tail=0.05,
                                     bad_head=0.02)
    seq[-8:], qual[-8:], lens[-8:] = 0, 0, 0
    return seq, qual, lens


def torch_cuts(seq, qual, lens, jp, ul):
    p = TrimParams.from_reference(jp)
    out = compute_cuts(torch.from_numpy(seq), torch.from_numpy(qual),
                       torch.from_numpy(lens), p, uniform_len=ul)
    return [o.numpy() for o in out]


@pytest.mark.parametrize("form", ["generic", "uniform"])
@pytest.mark.parametrize("jp", CONFIGS, ids=IDS)
def test_compute_cuts_matches_jnp(jp, form):
    seq, qual, lens = batch(jp, form)
    ul = 150 if form == "uniform" else None
    want = jax_compute_cuts(seq, qual, lens, jp, uniform_len=ul)
    got = torch_cuts(seq, qual, lens, jp, ul)
    for name, a, b in zip(("five", "three", "first_bad"), want, got):
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=name)


@pytest.mark.parametrize("form", ["generic", "uniform"])
@pytest.mark.parametrize("jp", CONFIGS, ids=IDS)
def test_compute_cuts_matches_pallas_interpret(jp, form):
    seq, qual, lens = batch(jp, form, seed=3)
    ul = 150 if form == "uniform" else None
    want = compute_cuts_pallas(seq, qual, lens, jp, tile_b=B, interpret=True,
                               uniform_len=ul)
    got = torch_cuts(seq, qual, lens, jp, ul)
    for name, a, b in zip(("five", "three", "first_bad"), want, got):
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=name)


@pytest.mark.parametrize("form", ["generic", "uniform"])
@pytest.mark.parametrize("jp", CONFIGS, ids=IDS)
def test_device_step_codes_match_jax(jp, form):
    """The whole device step (lengths from the zero padding, cuts, packed
    codes) against the JAX package's, on the same clean batch."""
    seq, qual, lens = batch(jp, form, seed=5)
    qt = QualityType(int(jp.qualtype))
    if form == "uniform":  # keep it uniform: padding rows only
        seq, qual, lens = make_reads(7, B, length=150, qualtype=qt,
                                     width=152, n_rate=0.02)
        seq[-8:], qual[-8:], lens[-8:] = 0, 0, 0
    jres = _tpu_cuts_fn(jp, slice_rows=B)(seq, qual, lens, qual_clean=True)
    want = np.concatenate([np.asarray(f) for f in jres.outs + jres.futs])
    p = TrimParams.from_reference(jp)
    res = _cuda_cuts_fn(p, "cpu", slice_rows=B)(seq, qual, lens,
                                                 qual_clean=True)
    got = np.concatenate([codes for codes, _ in res.parts])
    np.testing.assert_array_equal(got, want)


def test_encode_and_derive_lengths():
    jp = JTrimParams(S, 20)
    seq, qual, lens = batch(jp, "generic", seed=9)
    p = TrimParams.from_reference(jp)
    tq, tl = torch.from_numpy(qual), torch.from_numpy(lens)
    np.testing.assert_array_equal(derive_lengths(tq).numpy(), lens)
    five, three, bad = compute_cuts(None, tq, tl, p)
    codes = encode_codes(five, three, bad, tl, qual.shape[1]).numpy()
    f2, t2, b2 = _decode_codes(codes)
    np.testing.assert_array_equal(f2, five.numpy())
    np.testing.assert_array_equal(t2, three.numpy())
    np.testing.assert_array_equal(b2 == 0, (bad < tl).numpy())
    assert (bad < tl).any() and (five >= 0).any() and (five < 0).any()
    # rows too wide for 15-bit cuts come back as the (five, three, flag)
    # stack instead
    stack = encode_codes(five, three, bad, tl, MAX_PACKED_L).numpy()
    assert stack.shape == (3, B)
    np.testing.assert_array_equal(stack[0], f2)
    np.testing.assert_array_equal(stack[1], t2)
    np.testing.assert_array_equal(stack[2] == 1, b2 == 0)


def test_long_reads_unpacked_match_jax():
    """Rows of L >= MAX_PACKED_L come back as the unpacked [3, B] result."""
    jp = JTrimParams(S, 30)
    L = MAX_PACKED_L + 2
    seq, qual, lens = make_reads(11, 8, length=(20000, L), width=L,
                                 bad_tail=0.5)
    qual[0] = np.random.default_rng(1).integers(40, 70, L)
    lens[0], seq[0] = L, ord("A")
    seq[-1], qual[-1], lens[-1] = 0, 0, 0
    jres = _tpu_cuts_fn(jp, slice_rows=8)(seq, qual, lens, qual_clean=True)
    want = np.asarray(jres.futs[0])
    assert want.shape == (3, 8)
    p = TrimParams.from_reference(jp)
    got = _cuda_cuts_fn(p, "cpu", slice_rows=8)(seq, qual, lens,
                                                qual_clean=True)
    np.testing.assert_array_equal(got.parts[0][0], want)
    five, three, bad = jax_compute_cuts(seq, qual, lens, jp)
    np.testing.assert_array_equal(want[0], np.asarray(five))
    np.testing.assert_array_equal(want[1], np.asarray(three))


@pytest.mark.parametrize("uniform", [None, 150])
def test_wrapper_runs_plain_version_on_cpu(uniform):
    jp = JTrimParams(S, 20, trunc_n=True)
    seq, qual, lens = batch(jp, "uniform", seed=13)
    p = TrimParams.from_reference(jp)
    args = [torch.from_numpy(a) for a in (seq, qual, lens)]
    before = trim_cuda.LAUNCHES
    got = trim_cuda.trim_cuts(args[1], p, seq=args[0], uniform_len=uniform)
    explicit = trim_cuda.trim_cuts(args[1], p, lengths=args[2], seq=args[0],
                                   uniform_len=uniform)
    assert trim_cuda.LAUNCHES == before  # no kernel launched on the CPU
    want = trim_codes(args[0], args[1], None, p, uniform)
    assert torch.equal(got, want) and torch.equal(explicit, want)


def test_from_reference_carries_every_field():
    jp = JTrimParams(X, 33, 7, True, True, JCompat.FORK, strict=True)
    p = TrimParams.from_reference(jp)
    assert p == TrimParams(QualityType.SOLEXA, 33, 7, True, True, Compat.FORK,
                           strict=True)
    assert [f for f in TrimParams.__dataclass_fields__] == \
        [f for f in JTrimParams.__dataclass_fields__]


@pytest.mark.parametrize("L", [8, 152, 160, 4096, 32765, 50000])
def test_tile_or_direct_choice(L):
    """The kernel's load path is a function of the row shape: the first
    of TILE_ROWS (24, 16, 8 rows) whose block stays within the shared
    memory budget, else the direct kernel (0), always for L >= 32766."""
    forms = [(L, False), (L, True)] + [(p * L // 8, False)
                                       for p in range(1, 8) if L % 8 == 0]
    budget = trim_cuda.TILE_SMEM_BUDGET
    assert trim_cuda.TILE_ROWS == (24, 16, 8)
    for row_bytes, seq in forms:
        rows = trim_cuda.tile_rows(L, row_bytes, seq)
        smem = functools.partial(trim_cuda.tile_smem_bytes, L=L,
                                 row_bytes=row_bytes, seq=seq)
        fits = [r for r in trim_cuda.TILE_ROWS if smem(r) <= budget]
        if L >= MAX_PACKED_L or not fits:
            assert rows == 0
        else:
            assert rows == fits[0] and rows % 8 == 0
    # the main path's shapes take tiles of 24; long rows the direct kernel
    if L in (8, 152, 160):
        assert {trim_cuda.tile_rows(L, rb, seq) for rb, seq in forms} == {24}
    if L == 4096:  # one raw row a warp fits, not with its seq row
        assert trim_cuda.tile_rows(L, L) == 8
        assert trim_cuda.tile_rows(L, L, True) == 0
    if L >= 32765:
        assert {trim_cuda.tile_rows(L, rb, seq) for rb, seq in forms} == {0}
    # 8 warps, each with its 3 rows plus up to 15 bytes of misalignment
    # rounded to 16, and on a wire its 3 rows decoded
    assert trim_cuda.tile_smem_bytes(24, 152, 114) == 8 * (368 + 464)
    assert trim_cuda.tile_smem_bytes(24, 152, 152, True) == 8 * 2 * 480


def _unaligned(x):
    """A contiguous copy of the uint8 rows ``x`` whose data starts one
    byte past an allocation's start, as a view into a larger buffer."""
    flat = torch.zeros(x.numel() + 1, dtype=torch.uint8)
    view = flat[1:].view(x.shape)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 2 == 1
    return view


TRAP_SHAPES = ["b1", "b7", "b9", "b65", "unaligned", "junk_past_len"]


@pytest.mark.parametrize("shape", TRAP_SHAPES)
def test_plain_matches_jax_on_kernel_trap_shapes(shape):
    """Shapes that the tiled kernel's loads must get right (a tile partly
    full, a view that starts at an odd address, explicit lengths with
    non-zero bytes past them): the plain version, which the kernel is held
    to on the card, equals the JAX package's cuts on each."""
    B = {"b1": 1, "b7": 7, "b9": 9, "b65": 65}.get(shape, 63)
    for k, jp in enumerate((CONFIGS[0], CONFIGS[6], CONFIGS[7], CONFIGS[8])):
        qt = QualityType(int(jp.qualtype))
        seq, qual, lens = make_reads(40 + k, B, length=(1, 160), width=160,
                                     qualtype=qt, n_rate=0.02, bad_tail=0.05)
        lens[-1:], qual[-1:], seq[-1:] = 0, 0, 0
        if shape == "junk_past_len":
            rng = np.random.default_rng(k)
            past = np.arange(160)[None, :] >= lens[:, None]
            qual[past] = rng.integers(1, 256, int(past.sum()))
            seq[past] = ord("N")
        five, three, bad = jax_compute_cuts(seq, qual, lens, jp)
        p = TrimParams.from_reference(jp)
        args = [torch.from_numpy(a) for a in (seq, qual, lens)]
        if shape == "unaligned":  # the rows; lengths stay int32-aligned
            args[:2] = [_unaligned(a) for a in args[:2]]
        got = compute_cuts(*args, p)
        for name, a, b in zip(("five", "three", "bad"), (five, three, bad), got):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
        want = encode_codes(*got, args[2], 160)
        codes = trim_cuda.trim_cuts(args[1], p, lengths=args[2], seq=args[0])
        assert torch.equal(codes, want)
        if shape != "junk_past_len":  # lengths from the zero padding
            assert torch.equal(trim_cuda.trim_cuts(args[1], p, seq=args[0]),
                               want)


def _jax_wire_codes(buf, p, L, jp, bias=None, lut=None):
    """The JAX package's step_planes / step_planes_rank math on a wire."""
    v = jax_decode_fields(jnp.asarray(buf), p, L)
    lane = jnp.arange(L, dtype=jnp.int32)[None, :]
    lengths = jnp.min(jnp.where(v == 0, lane, L), axis=1)
    if lut is None:
        q = v.astype(jnp.int32) + bias
    else:
        q = jax_apply_rank_lut(v.astype(jnp.int32), jnp.asarray(lut))
    five, three = jax_cuts_from_q(q, lengths, jp)
    return np.asarray((three + 1) | ((five + 1) << 16))


@pytest.mark.parametrize("shape", TRAP_SHAPES[:5])
def test_wire_plain_matches_jax_on_kernel_trap_shapes(shape):
    """The same trap shapes on the band and rank wires, whose rows of
    p * 152 / 8 bytes rarely start on a 16-byte boundary."""
    B = {"b1": 1, "b7": 7, "b9": 9, "b65": 65}.get(shape, 63)
    jp = CONFIGS[6]
    offset = QUALITY_CONSTANTS[QualityType.SANGER][0]
    for rank, p in [(False, 1), (False, 3), (False, 6), (True, 1), (True, 3)]:
        qual = wire_quals(60 + p, B + 1, 152, p, rank=rank)[:B]  # B = 1: a read
        levels = qual_levels(qual)
        if rank:
            lut = np.zeros(1 << p, np.int32)
            lut[1:1 + levels.size] = levels.astype(np.int32) - offset
            buf, kw = qual_rank_fields(qual, levels, p), dict(lut=lut)
        else:
            bias = int(levels[0]) - 1
            buf, kw = qual_fields(qual, bias, p), dict(bias=bias - offset)
        want = _jax_wire_codes(buf, p, 152, jp, **kw)
        t = torch.from_numpy(buf)
        if shape == "unaligned":
            t = _unaligned(t)
        params = TrimParams.from_reference(jp)
        np.testing.assert_array_equal(
            wire_codes(t, p, 152, params, **kw).numpy(), want)
        np.testing.assert_array_equal(
            trim_cuda.trim_cuts_wire(t, p, 152, params, **kw).numpy(), want)
