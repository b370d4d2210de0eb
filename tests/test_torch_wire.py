"""The field and rank wires in the port against the JAX package, exactly.

``decode_fields``, ``apply_rank_lut`` and ``wire_codes`` (the plain
versions of the CUDA kernel's ``BAND``/``RANK`` prologues) are held to
``sickle_tpu.ops.trim`` on the same seeded inputs; the port's device step
(``_cuda_cuts_fn`` on the CPU device) is held to the JAX package's
(``_tpu_cuts_fn`` on the CPU backend) chunk by chunk, down to the bytes
each chunk ships (equal H2D means the same wire plan was chosen).  All
outputs are integers or bytes: tolerance 0.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sickle_tpu.constants import QualityType as JQualityType
from sickle_tpu.engine import EngineConfig as JEngineConfig
from sickle_tpu.engine import run_se as jax_run_se
from sickle_tpu.engine.pipeline import _tpu_cuts_fn
from sickle_tpu.ops import TrimParams as JTrimParams
from sickle_tpu.ops.trim import apply_rank_lut as jax_apply_rank_lut
from sickle_tpu.ops.trim import compute_cuts_from_q as jax_cuts_from_q
from sickle_tpu.ops.trim import decode_fields as jax_decode_fields
from sickle_tpu.utils.metrics import Metrics as JMetrics
from sickle_tpu_torch.constants import QUALITY_CONSTANTS, QualityType
from sickle_tpu_torch.engine import EngineConfig, run_se
from sickle_tpu_torch.engine.pipeline import _cuda_cuts_fn
from sickle_tpu_torch.io.fastq import qual_fields, qual_levels, qual_rank_fields
from sickle_tpu_torch.ops import trim_cuda
from sickle_tpu_torch.ops.trim import (
    TrimParams,
    apply_rank_lut,
    decode_fields,
    wire_codes,
)
from sickle_tpu_torch.oracle import SickleError
from sickle_tpu_torch.utils.corpus import fastq_bytes, make_reads
from sickle_tpu_torch.utils.metrics import Metrics

ENCODINGS = [JQualityType.SANGER, JQualityType.ILLUMINA, JQualityType.SOLEXA]


@pytest.fixture(autouse=True)
def _planes_on(monkeypatch):
    monkeypatch.delenv("SICKLE_TPU_NO_PLANES", raising=False)


def _qual(seed, B, L, lo, hi):
    rng = np.random.default_rng(seed)
    qual = rng.integers(lo, hi, (B, L)).astype(np.uint8)
    lens = rng.integers(0, L + 1, B)
    lens[0], lens[-1] = 0, L
    qual[np.arange(L)[None, :] >= lens[:, None]] = 0
    return qual


@pytest.mark.parametrize("L", [8, 152, 160, 1000])
@pytest.mark.parametrize("p", [1, 2, 3, 4, 5, 6, 7])
def test_decode_fields_matches_jax(p, L):
    qual = _qual(p * 1000 + L, 24, L, 59, 59 + (1 << p) - 1)
    buf = qual_fields(qual, 58, p)
    want = np.asarray(jax_decode_fields(jnp.asarray(buf), p, L)).astype(np.int32)
    got = decode_fields(torch.from_numpy(buf), p, L)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy().astype(np.int32), want)
    np.testing.assert_array_equal(want, np.where(qual > 0, qual.astype(np.int32) - 58, 0))


@pytest.mark.parametrize("p", [1, 2, 3])
def test_apply_rank_lut_matches_jax(p):
    rng = np.random.default_rng(p)
    v = rng.integers(0, 1 << p, (16, 40)).astype(np.int32)
    lut = rng.integers(-5, 94, 1 << p).astype(np.int32)
    lut[0] = 0
    want = np.asarray(jax_apply_rank_lut(jnp.asarray(v), jnp.asarray(lut)))
    got = apply_rank_lut(torch.from_numpy(v), torch.from_numpy(lut))
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_wire_codes(buf, p, L, jp, bias=None, lut=None, ul=None):
    """The JAX package's step_planes / step_planes_rank math
    (sickle_tpu/engine/pipeline.py, _tpu_cuts_fn.make_steps)."""
    v = jax_decode_fields(jnp.asarray(buf), p, L)
    lane = jnp.arange(L, dtype=jnp.int32)[None, :]
    lengths = jnp.min(jnp.where(v == 0, lane, L), axis=1)
    if lut is None:
        q = v.astype(jnp.int32) + bias
    else:
        q = jax_apply_rank_lut(v.astype(jnp.int32), jnp.asarray(lut))
    five, three = jax_cuts_from_q(q, lengths, jp, uniform_len=ul)
    return np.asarray((three + 1) | ((five + 1) << 16))


@pytest.mark.parametrize("form", ["generic", "uniform"])
@pytest.mark.parametrize("wire", ["band", "rank"])
@pytest.mark.parametrize("jqt", ENCODINGS, ids=lambda q: q.name.lower())
def test_wire_codes_match_jax(jqt, wire, form):
    qt = QualityType(int(jqt))
    offset = QUALITY_CONSTANTS[qt][0]
    kw = (dict(length=150, width=152) if form == "uniform"
          else dict(length=(1, 200), width=200))
    _, qual, lens = make_reads(7 + int(qt), 300, qualtype=qt,
                               binned=wire == "rank", **kw)
    qual[-9:], lens[-9:] = 0, 0
    L = qual.shape[1]
    ul = 150 if form == "uniform" else None
    levels = qual_levels(qual)
    if wire == "rank":
        p = levels.size.bit_length()
        assert p <= 3
        buf = qual_rank_fields(qual, levels, p)
        lut = np.zeros(1 << p, np.int32)
        lut[1:1 + levels.size] = levels.astype(np.int32) - offset
        args = dict(lut=lut)
    else:
        bias_char = int(levels[0]) - 1
        p = (int(levels[-1]) - bias_char).bit_length()
        assert p <= 6
        buf = qual_fields(qual, bias_char, p)
        args = dict(bias=bias_char - offset)
    for q_thr, x in ((20, False), (30, True), (0, False), (41, False)):
        jp = JTrimParams(jqt, q_thr, 20, x)
        want = _jax_wire_codes(buf, p, L, jp, ul=ul, **args)
        got = wire_codes(torch.from_numpy(buf), p, L,
                         TrimParams.from_reference(jp), uniform_len=ul, **args)
        np.testing.assert_array_equal(got.numpy(), want)
        # the wrapper takes the plain version for a CPU tensor, uncounted
        before = trim_cuda.LAUNCHES
        got = trim_cuda.trim_cuts_wire(torch.from_numpy(buf), p, L,
                                       TrimParams.from_reference(jp),
                                       uniform_len=ul, **args)
        np.testing.assert_array_equal(got.numpy(), want)
        assert trim_cuda.LAUNCHES == before


def test_wire_codes_refuses_trunc_n():
    buf = torch.zeros((8, 6), dtype=torch.uint8)
    with pytest.raises(ValueError):
        wire_codes(buf, 6, 8, TrimParams(trunc_n=True), bias=0)
    with pytest.raises(ValueError):
        wire_codes(buf, 6, 8, TrimParams(), bias=0, lut=[0, 1])


CORPORA = {
    "uniform": dict(length=150),
    "ragged": dict(length=(30, 160)),
    "binned": dict(length=150, binned=True),
    "solexa": dict(length=(60, 100), qualtype=QualityType.SOLEXA),
}
SLICE = 512


def _both_engines(data, jp, slice_rows=SLICE, rpc=1024, **cuda_kw):
    """(bytes, counters, per-chunk H2D) of the JAX package's engine with
    its device step and of the port's engine with its own, at the same
    chunk and slice sizes."""
    jmtr = JMetrics()
    jout = io.BytesIO()
    jc = jax_run_se(io.BytesIO(data), jout, jp,
                    cfg=JEngineConfig(records_per_chunk=rpc,
                                      slice_rows=slice_rows, metrics=jmtr),
                    cuts_fn=_tpu_cuts_fn(jp, slice_rows=slice_rows,
                                         inflight=2))
    p = TrimParams.from_reference(jp)
    mtr = Metrics()
    out = io.BytesIO()
    c = run_se(io.BytesIO(data), out, p,
               cfg=EngineConfig(records_per_chunk=rpc, slice_rows=slice_rows,
                                metrics=mtr),
               cuts_fn=_cuda_cuts_fn(p, "cpu", slice_rows, **cuda_kw))
    return ((jout.getvalue(), (jc.total, jc.kept, jc.discarded), jmtr.h2d_bytes),
            (out.getvalue(), (c.total, c.kept, c.discarded), mtr.h2d_bytes))


@pytest.mark.parametrize("corpus", list(CORPORA))
def test_device_step_matches_jax_chunk_by_chunk(corpus):
    kw = CORPORA[corpus]
    qt = kw.get("qualtype", QualityType.SANGER)
    data = fastq_bytes(*make_reads(40 + len(corpus), 2600, **kw))
    jp = JTrimParams(JQualityType(int(qt)), 20, 20)
    want, got = _both_engines(data, jp)
    assert got[:2] == want[:2]
    assert got[2] == want[2]  # the same wire, piece by piece
    assert sum(got[2]) < 2600 * 150  # a wire shipped fewer bytes than raw rows


def test_no_planes_ships_raw_rows_same_bytes(monkeypatch):
    data = fastq_bytes(*make_reads(5, 2000, length=150, binned=True))
    jp = JTrimParams(JQualityType.SANGER, 20, 20)
    wire_out, _, wire_h2d = _both_engines(data, jp)[1]
    monkeypatch.setenv("SICKLE_TPU_NO_PLANES", "1")
    want, got = _both_engines(data, jp)
    assert got[:2] == want[:2] and got[2] == want[2]
    assert got[0] == wire_out
    assert sum(got[2]) > 2 * sum(wire_h2d)


def _errors(data, jp):
    """The error messages of the JAX package's engine and the port's."""
    from sickle_tpu.oracle import SickleError as JSickleError

    with pytest.raises(JSickleError) as je:
        jax_run_se(io.BytesIO(data), io.BytesIO(), jp,
                   cfg=JEngineConfig(records_per_chunk=64, slice_rows=64),
                   cuts_fn=_tpu_cuts_fn(jp, slice_rows=64, inflight=2))
    p = TrimParams.from_reference(jp)
    with pytest.raises(SickleError) as te:
        run_se(io.BytesIO(data), io.BytesIO(), p,
               cfg=EngineConfig(records_per_chunk=64, slice_rows=64),
               cuts_fn=_cuda_cuts_fn(p, "cpu", 64))
    return je.value.message, te.value.message


def test_out_of_range_char_takes_raw_rows_with_exact_error():
    """A char outside the encoding's range keeps the chunk off the wire:
    the raw path's device flag plus the host re-scan give the reference's
    message, as in the JAX package."""
    rec = b"@r1 x\nACGTACGTACGTACGTACGTACGT\n+\n" + b"I" * 23 + b"\x1f\n"
    jp = JTrimParams(JQualityType.SANGER, 20, 5)
    want, got = _errors(rec * 50, jp)
    assert got == want and "does not fall within correct range" in got


def test_nul_inside_a_read_errors_as_in_jax():
    rec = b"@r1 x\nACGTACGT\n+\nIIII\x00III\n"
    jp = JTrimParams(JQualityType.SANGER, 20, 2)
    want, got = _errors(rec * 4, jp)
    assert got == want


def test_trunc_n_ships_seq_and_qual_rows():
    data = fastq_bytes(*make_reads(6, 2000, length=(30, 160), n_rate=0.02))
    jp = JTrimParams(JQualityType.SANGER, 20, 10, trunc_n=True)
    want, got = _both_engines(data, jp)
    assert got == want
    assert sum(got[2]) == 2 * (2 * 1024 * 160)  # seq + qual rows, 2 chunks
