"""The CUDA cuts kernel on the card against its plain PyTorch versions
(raw rows, and the band and rank wires), and the hybrid router over it.

These tests need an NVIDIA GPU and nvcc and skip elsewhere.  The file
imports no JAX, so on a machine without it they run with:

    SICKLE_TPU_TEST_REAL_DEVICE=1 python -m pytest tests/test_torch_cuda.py -m cuda
"""

import dataclasses
import io

import numpy as np
import pytest
import torch

from sickle_tpu_torch.constants import Compat, QualityType
from sickle_tpu_torch.constants import QUALITY_CONSTANTS
from sickle_tpu_torch.engine import EngineConfig
from sickle_tpu_torch.engine.hybrid import HybridCutsFn
from sickle_tpu_torch.engine.pipeline import _cuda_cuts_fn, run_pe, run_se
from sickle_tpu_torch.io.fastq import qual_fields, qual_levels, qual_rank_fields
from sickle_tpu_torch.ops import trim_cuda
from sickle_tpu_torch.ops.trim import (
    MAX_PACKED_L,
    TrimParams,
    trim_codes,
    wire_codes,
)
from sickle_tpu_torch.ops.trim_host import host_cuts_fn
from sickle_tpu_torch.utils.corpus import (
    fastq_bytes,
    make_reads,
    wire_quals,
    write_pairs,
)
from sickle_tpu_torch.utils.metrics import Metrics

pytestmark = pytest.mark.cuda

S, I, X = QualityType.SANGER, QualityType.ILLUMINA, QualityType.SOLEXA
PARAMS = [
    TrimParams(S, 60, 20, False, False, Compat.FORK),
    TrimParams(S, 20, 20, False, True, Compat.V133),
    TrimParams(I, 30, 30, True, False, Compat.V133),
    TrimParams(X, 20, 5, False, True, Compat.FORK),
    TrimParams(S, 0, 0, False, False, Compat.V133),
    TrimParams(S, 40, no_fiveprime=True, trunc_n=True),
]
# the nine trim configurations of chip_smoke.py, -n off (no wire takes -n)
WIRE_PARAMS = [dataclasses.replace(p, trunc_n=False) for p in [
    TrimParams(S, 60, 20, False, False, Compat.FORK),
    TrimParams(S, 20, 20, False, True, Compat.V133),
    TrimParams(I, 30, 30, True, False, Compat.V133),
    TrimParams(X, 20, 5, False, True, Compat.FORK),
    TrimParams(S, 0, 0, False, False, Compat.V133),
    TrimParams(S, 60, compat=Compat.FORK),
    TrimParams(S, 20),
    TrimParams(S, 30, trunc_n=True),
    TrimParams(S, 40, no_fiveprime=True),
]]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    trim_cuda.build()
    return torch.device("cuda", 0)


def rows(p, form, dev, B=4096, seed=0, L=None):
    kw = dict(length=150, width=152) if form == "uniform" else dict(
        length=(1, 250), width=256)
    if L is not None:
        kw = dict(length=(1, L), width=L)
    s, q, n = make_reads(seed, B, qualtype=p.qualtype, n_rate=0.02,
                         bad_tail=0.02, bad_head=0.01, **kw)
    s[-5:], q[-5:], n[-5:] = 0, 0, 0
    return [torch.from_numpy(a).to(dev) for a in (s, q, n)]


def _odd_address(x):
    """The uint8 rows ``x`` in a contiguous view one byte past the start
    of its allocation."""
    flat = torch.zeros(x.numel() + 1, dtype=torch.uint8, device=x.device)
    view = flat[1:].view(x.shape)
    view.copy_(x)
    return view


def _tile_limit(row_bytes_of, seq=False):
    """The largest L (a multiple of 8) whose rows still take tiles."""
    L = 8
    while trim_cuda.tile_rows(L + 8, row_bytes_of(L + 8), seq):
        L += 8
    return L


# B = 4096 and the shapes the tiled kernel's loads must get right: tiles
# partly full, rows at an odd address, bytes past explicit lengths, and
# rows just under (tiled) and just over (direct) the tile limit
RAW_SHAPES = ["b4096", "b1", "b9", "b65", "odd_address", "junk_past_len",
              "limit_tiled", "limit_direct"]


@pytest.mark.parametrize("shape", RAW_SHAPES)
@pytest.mark.parametrize("form", ["generic", "uniform"])
@pytest.mark.parametrize("p", PARAMS, ids=[f"p{i}" for i in range(len(PARAMS))])
def test_kernel_matches_plain(p, form, shape, dev):
    ul = 150 if form == "uniform" else None
    path = "tiled"
    if shape.startswith("limit"):
        top = _tile_limit(lambda L: L, p.trunc_n)
        path = shape.split("_")[1]
        seq, qual, lens = rows(p, form, dev, B=300,
                               L=top if path == "tiled" else top + 8)
        ul = None
    else:
        seq, qual, lens = rows(p, form, dev)
    B = {"b1": 1, "b9": 9, "b65": 65, "odd_address": 63}.get(shape)
    if B is not None:
        seq, qual, lens = seq[:B], qual[:B], lens[:B]
    if shape == "odd_address":
        seq, qual = _odd_address(seq), _odd_address(qual)
    lengths_cases = (None, lens)
    if shape == "junk_past_len":  # every byte past a read's length set
        past = torch.arange(qual.shape[1], device=dev)[None, :] >= lens[:, None]
        qual = torch.where(past, torch.randint(1, 256, qual.shape, device=dev,
                                               dtype=torch.uint8), qual)
        seq = torch.where(past, ord("N"), seq).to(torch.uint8)
        lengths_cases = (lens,)
    want = trim_codes(seq, qual, lengths_cases[0], p, ul)
    for lengths in lengths_cases:
        before = dict(trim_cuda.LAUNCHES_BY_PATH["raw"])
        got = trim_cuda.trim_cuts(qual, p, lengths=lengths, seq=seq,
                                  uniform_len=ul)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert trim_cuda.LAUNCHES_BY_PATH["raw"][path] == before[path] + 1


def test_long_rows_unpacked(dev):
    p = TrimParams(S, 25)
    L = MAX_PACKED_L + 10
    s, q, n = make_reads(3, 12, length=(5, L), width=L, bad_tail=0.3)
    qual, lens = torch.from_numpy(q).to(dev), torch.from_numpy(n).to(dev)
    got = trim_cuda.trim_cuts(qual, p)
    assert got.shape == (3, 12)
    assert torch.equal(got, trim_codes(None, qual, None, p))
    assert torch.equal(trim_cuda.trim_cuts(qual, p, lengths=lens), got)


def test_launch_count_and_checks(dev):
    p = TrimParams(S, 20, trunc_n=True)
    seq, qual, lens = rows(p, "generic", dev, B=64)
    before = trim_cuda.LAUNCHES
    trim_cuda.trim_cuts(qual, p, seq=seq)
    assert trim_cuda.LAUNCHES == before + 1
    with pytest.raises(ValueError):
        trim_cuda.trim_cuts(qual, p)  # -n needs seq
    with pytest.raises(TypeError):
        trim_cuda.trim_cuts(qual.to(torch.int32), TrimParams())
    with pytest.raises(ValueError):
        trim_cuda.trim_cuts(qual.t(), TrimParams())
    with pytest.raises(ValueError):
        trim_cuda.trim_cuts(qual, TrimParams(), lengths=lens.cpu())
    assert trim_cuda.LAUNCHES == before + 1


@pytest.mark.parametrize("clean", [True, False])
def test_device_step_matches_cpu(clean, dev):
    p = TrimParams(S, 20)
    s, q, n = make_reads(9, 3000, length=(30, 160), width=160, bad_tail=0.02)
    q = np.concatenate([q, np.zeros((72, 160), np.uint8)])
    n = np.concatenate([n, np.zeros(72, np.int32)])
    got = _cuda_cuts_fn(p, dev, slice_rows=1024)(q, q, n, qual_clean=clean)
    want = _cuda_cuts_fn(p, "cpu", slice_rows=1024)(q, q, n, qual_clean=clean)
    for a, b in zip(got.materialize(), want.materialize()):
        np.testing.assert_array_equal(a, b)


def test_run_se_matches_host_kernel(dev):
    p = TrimParams(S, 20)
    data = fastq_bytes(*make_reads(4, 20000, length=(30, 160), bad_tail=0.01))
    outs = []
    for fn in (_cuda_cuts_fn(p, dev), host_cuts_fn(p)):
        out = io.BytesIO()
        c = run_se(io.BytesIO(data), out, p, cuts_fn=fn)
        outs.append((out.getvalue(), c))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("trunc_n", [False, True])
def test_run_pe_routes_match_host_kernel(trunc_n, dev, tmp_path):
    """Two-file pe from regular files, mate 2 growing for the first
    chunks: the split route, then combined batches; interleaved -M on
    the same pairs.  Device outputs equal the host kernel's."""
    p = TrimParams(S, 20, trunc_n=trunc_n)
    f1, f2 = open(tmp_path / "1.fq", "wb"), open(tmp_path / "2.fq", "wb")
    fi = open(tmp_path / "i.fq", "wb")
    with f1, f2, fi:
        for k in range(6):
            kw = dict(first=k * 4096, mate1=dict(length=(30, 60)),
                      mate2=dict(length=(40, 70 + 24 * min(k, 3))),
                      n_rate=0.01, bad_tail=0.01)
            write_pairs(f1, f2, 70 + k, 4096, **kw)
            write_pairs(fi, None, 70 + k, 4096, **kw)
    outs = []
    for fn in (_cuda_cuts_fn(p, dev), host_cuts_fn(p)):
        mtr = Metrics()
        o = [io.BytesIO() for _ in range(4)]
        with open(tmp_path / "1.fq", "rb") as a, open(tmp_path / "2.fq", "rb") as b:
            c = run_pe(a, b, out1=o[0], out2=o[1], singles_out=o[2], params=p,
                       cfg=EngineConfig(records_per_chunk=4096, metrics=mtr),
                       cuts_fn=fn)
        with open(tmp_path / "i.fq", "rb") as a:
            ci = run_pe(a, None, interleaved=True, out1=o[3],
                        n_record_mode=True, params=p, cuts_fn=fn,
                        cfg=EngineConfig(records_per_chunk=4096))
        assert mtr.routes["split"] >= 3 and mtr.routes["combined"] >= 2
        outs.append(([x.getvalue() for x in o], c, ci))
    assert outs[0] == outs[1]


def test_kernel_matches_plain_fuzz(dev):
    """Seeded adversarial batches: any byte 1-255 inside reads (out of
    range for every encoding), lengths 0..L, N/n anywhere, thresholds up
    to 10**8 (the int32 D transform wraps), every flag."""
    rng = np.random.default_rng(2024)
    for _ in range(150):
        L = int(rng.choice([8, 40, 152, 256, 1000, 4104]))
        B = int(rng.integers(1, 300))
        lens = rng.integers(0, L + 1, B).astype(np.int32)
        lens[rng.random(B) < 0.1] = L
        lane = np.arange(L)[None, :]
        inside = lane < lens[:, None]
        qt = QualityType(int(rng.choice([1, 2, 3])))
        lo, hi = {1: (33, 80), 2: (58, 110), 3: (64, 110)}[int(qt)]
        q = rng.integers(lo, hi, (B, L))
        wild = rng.random((B, L)) < rng.choice([0.0, 0.001, 0.05])
        q = np.where(wild, rng.integers(1, 256, (B, L)), q)
        qual = np.where(inside, q, 0).astype(np.uint8)
        seq = np.where(rng.random((B, L)) < 0.01, ord("N"),
                       np.where(rng.random((B, L)) < 0.01, ord("n"), ord("A")))
        seq = np.where(inside, seq, 0).astype(np.uint8)
        p = TrimParams(qt, int(rng.choice([0, 1, 20, 40, 93, 10 ** 8])),
                       int(rng.integers(0, 60)), bool(rng.random() < 0.3),
                       bool(rng.random() < 0.4),
                       Compat.FORK if rng.random() < 0.5 else Compat.V133)
        s_d, q_d, n_d = (torch.from_numpy(a).to(dev) for a in (seq, qual, lens))
        ul = None
        if rng.random() < 0.3:  # make it a uniform batch
            ul = int(rng.integers(1, L + 1))
            keep = lens > 0
            n_d = torch.from_numpy(np.where(keep, ul, 0).astype(np.int32)).to(dev)
            q_d = torch.where(torch.arange(L, device=dev)[None, :] < n_d[:, None],
                              torch.clamp(q_d, min=1), 0).to(torch.uint8)
        want = trim_codes(s_d, q_d, n_d, p, ul)
        for lengths in (None, n_d):
            got = trim_cuda.trim_cuts(q_d, p, lengths=lengths, seq=s_d,
                                      uniform_len=ul)
            assert torch.equal(got, want), (p, L, B, ul)


def _wire(qual, p, rank, qualtype):
    """(wire rows, kernel args) for a qual matrix on a p-bit wire."""
    offset = QUALITY_CONSTANTS[qualtype][0]
    levels = qual_levels(qual)
    if rank:
        lut = np.zeros(1 << p, np.int32)
        lut[1:1 + levels.size] = levels.astype(np.int32) - offset
        return qual_rank_fields(qual, levels, p), dict(lut=lut)
    bias = int(levels[0]) - 1
    return qual_fields(qual, bias, p), dict(bias=bias - offset)


# B = 2048 and the trap shapes of the tiled kernel: tiles partly full,
# wire rows (p * 152 / 8 bytes) at an odd address and one row in
WIRE_SHAPES = ["b2048", "b1", "b7", "b9", "b65", "odd_address", "buf[1:]"]


@pytest.mark.parametrize("shape", WIRE_SHAPES)
@pytest.mark.parametrize("form", ["generic", "uniform"])
@pytest.mark.parametrize("wire, p", [("band", p) for p in range(1, 7)]
                         + [("rank", p) for p in range(1, 4)])
def test_wire_kernel_matches_plain(wire, p, form, shape, dev):
    """The BAND / RANK prologue forms against wire_codes, and against the
    raw-row kernel on the same chars (in range: flag 0, same codes)."""
    L = 152
    ul = 150 if form == "uniform" else None
    B = {"b1": 1, "b7": 7, "b9": 9, "b65": 65, "odd_address": 63}.get(shape)
    before = dict(trim_cuda.LAUNCHES_BY_FORM)
    tiled = trim_cuda.LAUNCHES_BY_PATH[wire]["tiled"]
    for k, params in enumerate(WIRE_PARAMS):
        qual = wire_quals(100 * p + k, 2048, L, p, rank=wire == "rank",
                          qualtype=params.qualtype, uniform=ul)
        buf, kw = _wire(qual, p, wire == "rank", params.qualtype)
        qual, buf = torch.from_numpy(qual), torch.from_numpy(buf)
        if B is not None:
            qual, buf = qual[:B], buf[:B]
        if shape == "buf[1:]":
            qual, buf = qual[1:], buf[1:]
        want = wire_codes(buf, p, L, params, uniform_len=ul, **kw)
        buf = buf.to(dev)
        if shape == "odd_address":
            buf = _odd_address(buf)
        got = trim_cuda.trim_cuts_wire(buf, p, L, params, uniform_len=ul,
                                       **kw)
        raw = trim_cuda.trim_cuts(qual.to(dev), params, uniform_len=ul)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), (params, p)
        assert torch.equal(raw.cpu(), want), (params, p)
    assert (trim_cuda.LAUNCHES_BY_FORM[wire] - before[wire]
            == len(WIRE_PARAMS))
    assert trim_cuda.LAUNCHES_BY_PATH[wire]["tiled"] - tiled == len(WIRE_PARAMS)


def test_wire_device_step_ships_the_wire(dev):
    """The device step on the card picks the JAX package's plan: rank
    wire for binned quals, band wire for Sanger 0-41, raw rows with an
    out-of-range char; results equal the CPU device step's."""
    p = TrimParams(S, 20)
    cases = {
        "rank": make_reads(31, 3000, length=150, width=152, binned=True)[1],
        "band": make_reads(32, 3000, length=(30, 152), width=152)[1],
        "raw": make_reads(33, 3000, length=150, width=152, bad_tail=0.05)[1],
    }
    for form, q in cases.items():
        q = np.concatenate([q, np.zeros((72, 152), np.uint8)])
        n = (q != 0).sum(axis=1).astype(np.int32)
        before = dict(trim_cuda.LAUNCHES_BY_FORM)
        gpu = _cuda_cuts_fn(p, dev, slice_rows=1024)
        got = gpu(q, q, n, qual_clean=True)
        cpu = _cuda_cuts_fn(p, "cpu", slice_rows=1024)
        want = cpu(q, q, n, qual_clean=True)
        for a, b in zip(got.materialize(), want.materialize()):
            np.testing.assert_array_equal(a, b)
        assert gpu.last_h2d == cpu.last_h2d
        assert trim_cuda.LAUNCHES_BY_FORM[form] - before[form] == 3, form


def test_wire_kernel_checks(dev):
    buf = torch.zeros((64, 114), dtype=torch.uint8, device=dev)
    p = TrimParams(S, 20)
    with pytest.raises(ValueError):
        trim_cuda.trim_cuts_wire(buf, 6, 152, TrimParams(trunc_n=True), bias=0)
    with pytest.raises(ValueError):
        trim_cuda.trim_cuts_wire(buf, 6, 150, p, bias=0)  # L % 8
    with pytest.raises(ValueError):
        trim_cuda.trim_cuts_wire(buf, 6, 152, p, lut=[0] * 64)  # rank p > 3
    with pytest.raises(ValueError):
        trim_cuda.trim_cuts_wire(buf[:, :100], 6, 152, p, bias=0)
    with pytest.raises(ValueError):
        trim_cuda.trim_cuts_wire(buf, 6, 152, p, bias=0, lut=[0] * 64)


def test_hybrid_run_se_matches_host_kernel(dev):
    """The router over the card's device step (auto mode): output equal
    to the host kernel's, device chunks taken, no rescue."""
    p = TrimParams(S, 20)
    data = fastq_bytes(*make_reads(5, 200000, length=150))
    outs = []
    fn = HybridCutsFn(p, _cuda_cuts_fn(p, dev))
    try:
        for cuts in (fn, host_cuts_fn(p)):
            out = io.BytesIO()
            c = run_se(io.BytesIO(data), out, p, cuts_fn=cuts)
            outs.append((out.getvalue(), c))
    finally:
        assert fn.close()
    assert outs[0] == outs[1]
    assert fn.n_device >= 1 and fn.n_rescued == 0


def test_wire_kernel_matches_plain_fuzz(dev):
    """Seeded adversarial wire batches: every encoding (Solexa's offset of
    64 gives negative quals), every band width and rank count, lengths
    0..L, thresholds up to 10**8 (the int32 D transform wraps), -x on and
    off, uniform and generic forms."""
    rng = np.random.default_rng(2025)
    for _ in range(120):
        L = int(rng.choice([8, 40, 152, 256, 1000]))
        B = int(rng.integers(1, 300))
        qt = QualityType(int(rng.choice([1, 2, 3])))
        rank = bool(rng.random() < 0.4)
        pw = int(rng.integers(1, 4 if rank else 7))
        ul = int(rng.integers(1, L + 1)) if rng.random() < 0.3 else None
        qual = wire_quals(int(rng.integers(1 << 30)), B, L, pw, rank=rank,
                          qualtype=qt, uniform=ul)
        if not qual.any():
            continue
        p = TrimParams(qt, int(rng.choice([0, 1, 20, 40, 93, 10 ** 8])),
                       int(rng.integers(0, 60)), bool(rng.random() < 0.3))
        buf, kw = _wire(qual, pw, rank, qt)
        want = wire_codes(torch.from_numpy(buf), pw, L, p, uniform_len=ul,
                          **kw)
        got = trim_cuda.trim_cuts_wire(torch.from_numpy(buf).to(dev), pw, L,
                                       p, uniform_len=ul, **kw)
        assert torch.equal(got.cpu(), want), (p, L, B, pw, rank, ul)


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_step_on_one_card_matches_single_device(n, dev):
    """``sharded_cuts_fn`` over ``[cuda:0] * n`` (every row block launched
    on the one card): the same bytes as the single-device step, on the
    band wire and on raw rows, whole slices and single-piece chunks; and
    a 4,001-row batch padded to a multiple of n gives the single-device
    codes for its rows."""
    from sickle_tpu_torch.parallel import data_mesh, sharded_cuts_fn

    p = TrimParams(S, 20)
    data = (fastq_bytes(*make_reads(6, 30000, length=150))
            + fastq_bytes(*make_reads(7, 10000, length=(30, 160),
                                      bad_tail=0.01), first=30000))
    outs = []
    for fn in (sharded_cuts_fn(p, data_mesh(devices=[dev] * n), 1024),
               _cuda_cuts_fn(p, dev, 1024)):
        trim_cuda.reset_counts()
        out = io.BytesIO()
        c = run_se(io.BytesIO(data), out, p, cuts_fn=fn,
                   cfg=EngineConfig(records_per_chunk=4096, slice_rows=1024))
        outs.append((out.getvalue(), c, dict(trim_cuda.LAUNCHES_BY_FORM)))
    assert outs[0][:2] == outs[1][:2]
    # over 2 the 1,024-row slices hold whole 4,096-row chunks (the band
    # wire); over 3 the slice rounds up to 1,026 rows, so each chunk is
    # one piece of raw rows with explicit lengths
    assert outs[0][2]["raw"] > 0 and (outs[0][2]["band"] > 0) == (n == 2)
    s, q, lens = make_reads(8, 4001, length=(1, 120), width=120)
    mesh = sharded_cuts_fn(p, [dev] * n, 1024)
    for clean in (True, False):
        got = mesh(s, q, lens, qual_clean=clean).materialize()
        want = _cuda_cuts_fn(p, dev, 1024)(s, q, lens,
                                           qual_clean=clean).materialize()
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_two_process_dist_run_on_the_card(dev, tmp_path):
    """Two ``python -m sickle_tpu_torch se --dist`` processes on the card:
    the shards concatenated equal the single-process bytes, rank 0 prints
    the single-process summary and rank 1 nothing."""
    import contextlib
    import os
    import pathlib
    import socket
    import subprocess
    import sys

    from sickle_tpu_torch import cli

    src = tmp_path / "in.fastq"
    with open(src, "wb") as f:
        f.write(fastq_bytes(*make_reads(9, 200000, length=(30, 160),
                                        bad_tail=0.01)))
    argv = ["se", "-f", str(src), "-t", "sanger", "--cuts", "device"]
    summary = io.TextIOWrapper(io.BytesIO())
    with contextlib.redirect_stdout(summary):
        assert cli.main(argv + ["-o", str(tmp_path / "one.fastq")],
                        device=dev) == 0
    summary.flush()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(pathlib.Path(__file__).parents[1]))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "sickle_tpu_torch", *argv, "-o",
         str(tmp_path / "dist.fastq"), "--dist", "--coordinator",
         f"127.0.0.1:{port}", "--num-processes", "2", "--process-id",
         str(rank)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in range(2)]
    try:
        res = [p.communicate(timeout=300) + (p.returncode,) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [r[2] for r in res] == [0, 0], [r[1][-2000:] for r in res]
    assert res[0][0] == summary.buffer.getvalue().decode()
    assert res[1][0] == ""
    shards = b"".join((tmp_path / f"dist.fastq.shard{r}").read_bytes()
                      for r in range(2))
    assert shards == (tmp_path / "one.fastq").read_bytes()
