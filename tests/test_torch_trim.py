"""The port's plain PyTorch cuts against the JAX package's, exactly.

Inputs come from the port's seeded corpus generator (numpy) and go
unchanged through ``sickle_tpu.ops.trim.compute_cuts`` (jnp), the Pallas
kernels in interpret mode (``compute_cuts_pallas(..., interpret=True)``)
and ``sickle_tpu_torch.ops.trim``; parameters cross over with
``TrimParams.from_reference``.  Outputs are integers: tolerance 0.
"""

import numpy as np
import pytest
import torch

from sickle_tpu.constants import Compat as JCompat
from sickle_tpu.constants import QualityType as JQualityType
from sickle_tpu.engine.pipeline import _tpu_cuts_fn
from sickle_tpu.ops import TrimParams as JTrimParams
from sickle_tpu.ops.trim import compute_cuts as jax_compute_cuts
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
from sickle_tpu_torch.utils.corpus import make_reads

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
