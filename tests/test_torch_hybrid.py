"""The port's hybrid device+host router: byte identity, routing, failover.

Mirrors the JAX package's ``tests/test_hybrid.py`` on the port's
``HybridCutsFn``, with the port's device step on the CPU device (the CUDA
kernel's plain version) as the device fn and seeded corpora in place of
the reference fixtures.  Whatever the routing — host only, mixed, stall
rescue — outputs and counters must equal the JAX package's engine.
"""

import io
import time

import numpy as np
import pytest

from sickle_tpu.constants import QualityType as JQualityType
from sickle_tpu.engine import EngineConfig as JEngineConfig
from sickle_tpu.engine import run_pe as jax_run_pe
from sickle_tpu.engine import run_se as jax_run_se
from sickle_tpu.ops import TrimParams as JTrimParams
from sickle_tpu.ops import compute_cuts_jit
from sickle_tpu_torch.engine import EngineConfig, run_pe, run_se
from sickle_tpu_torch.engine.hybrid import HybridCutsFn
from sickle_tpu_torch.engine.pipeline import _cuda_cuts_fn
from sickle_tpu_torch.ops import TrimParams
from sickle_tpu_torch.oracle import QualityRangeError
from sickle_tpu_torch.utils.corpus import fastq_bytes, make_reads, write_pairs
from sickle_tpu_torch.utils.metrics import Metrics

JP = JTrimParams(qualtype=JQualityType.SANGER, qual_threshold=30,
                 length_threshold=20)
P = TrimParams.from_reference(JP)
RPC = 512


def jax_fn(seq, qual, lengths):
    return compute_cuts_jit(seq, qual, lengths, JP)


def run(data: bytes, cuts_fn, rpc=RPC, params=P, **cfg_kw):
    out = io.BytesIO()
    c = run_se(io.BytesIO(data), out, params, cuts_fn=cuts_fn,
               cfg=EngineConfig(records_per_chunk=rpc, slice_rows=rpc,
                                **cfg_kw))
    return out.getvalue(), (c.total, c.kept, c.discarded)


@pytest.fixture(scope="module")
def data():
    # ~20 chunks of 512 reads; binned quals so device chunks ship the wire
    return fastq_bytes(*make_reads(17, 10000, length=(60, 150), binned=True))


@pytest.fixture(scope="module")
def reference_run(data):
    out = io.BytesIO()
    c = jax_run_se(io.BytesIO(data), out, JP, cuts_fn=jax_fn,
                   cfg=JEngineConfig(records_per_chunk=RPC, prefetch=2))
    return out.getvalue(), (c.total, c.kept, c.discarded)


def device(slow_s=0.0, calls=None):
    """The port's device step on the CPU device, optionally slowed."""
    dev = _cuda_cuts_fn(P, "cpu", RPC)

    def fn(seq, qual, lengths, qual_clean=False, wire=None):
        if calls is not None:
            calls.append(wire is not None)
        time.sleep(slow_s)
        return dev(seq, qual, lengths, qual_clean=qual_clean, wire=wire)

    fn.prepare = dev.prepare
    fn.lazy = True
    return fn


def test_host_only_indexed_matches(data, reference_run):
    fn = HybridCutsFn(P, None)
    mtr = Metrics()
    try:
        got = run(data, fn, metrics=mtr)
    finally:
        fn.close()
    assert got == reference_run
    assert fn.n_host == len(mtr.records) > 0 and fn.n_device == 0
    assert fn.needs_rows is False and sum(mtr.h2d_bytes) == 0


def test_mixed_routing_matches(data, reference_run):
    # 0.2 s per device chunk against ms-scale packs: the depth-1 device
    # queue is full when the next chunk routes, forcing host overflow
    calls = []
    fn = HybridCutsFn(P, device(0.2, calls), device_depth=1, rescue_s=0)
    fn.device_handicap = 1e9  # keep the slow device in the rotation
    try:
        got = run(data, fn)
    finally:
        fn.close()
    assert got == reference_run
    assert fn.n_device > 0, "device route never used"
    assert fn.n_host > 0, "host overflow never used"
    assert fn.n_rescued == 0
    assert any(calls), "no device chunk shipped the wire"


def test_stall_rescue_matches(data, reference_run):
    """A stalled device (1 s per chunk against rescue_s = 0.1) must not
    stall the pass: the host recomputes the chunk, output identical."""
    fn = HybridCutsFn(P, device(1.0), device_depth=1, rescue_s=0.1)
    t0 = time.perf_counter()
    try:
        got = run(data, fn)
    finally:
        assert fn.close()
    dt = time.perf_counter() - t0
    assert got == reference_run
    assert fn.n_rescued >= 1
    # ~20 chunks at 1 s each would be ~20 s device-bound
    assert dt < 8, f"failover did not keep the pass moving ({dt:.1f}s)"


def test_device_errors_propagate(data):
    def broken(seq, qual, lengths, qual_clean=False, wire=None):
        raise RuntimeError("device exploded")

    fn = HybridCutsFn(P, broken, rescue_s=0)
    try:
        with pytest.raises(RuntimeError, match="device exploded"):
            run(data, fn)
    finally:
        fn.close()


def test_quality_error_parity():
    """A touched out-of-range char raises the reference's exact message
    through the host route, as through the JAX package's engine."""
    from sickle_tpu.oracle import QualityRangeError as JQualityRangeError

    bad = (b"@r1\n" + b"A" * 40 + b"\n+\n" + bytes([80]) * 20 + b"\x1f"
           + bytes([80]) * 19 + b"\n") * 8
    jp = JTrimParams(qualtype=JQualityType.SANGER, qual_threshold=60,
                     length_threshold=20)
    with pytest.raises(JQualityRangeError) as want:
        jax_run_se(io.BytesIO(bad), io.BytesIO(), jp,
                   cfg=JEngineConfig(records_per_chunk=8),
                   cuts_fn=lambda s, q, n: compute_cuts_jit(s, q, n, jp))
    for dev in (None, device()):
        fn = HybridCutsFn(TrimParams.from_reference(jp), dev)
        try:
            with pytest.raises(QualityRangeError) as got:
                run(bad, fn, rpc=8, params=TrimParams.from_reference(jp))
        finally:
            fn.close()
        assert got.value.message == want.value.message


def test_pe_host_only_indexed_matches():
    """pe two-file from streams (one combined chunk buffer) through the
    host-only router: the JAX package's outputs and counters."""
    b1, b2 = io.BytesIO(), io.BytesIO()
    write_pairs(b1, b2, 23, 3000, mate1=dict(length=150),
                mate2=dict(length=(30, 160)), bad_tail=0.01)
    d1, d2 = b1.getvalue(), b2.getvalue()
    jo = [io.BytesIO() for _ in range(3)]
    jc = jax_run_pe(io.BytesIO(d1), io.BytesIO(d2), out1=jo[0], out2=jo[1],
                    singles_out=jo[2], params=JP, cuts_fn=jax_fn,
                    cfg=JEngineConfig(records_per_chunk=RPC))
    fn = HybridCutsFn(P, None)
    o = [io.BytesIO() for _ in range(3)]
    try:
        c = run_pe(io.BytesIO(d1), io.BytesIO(d2), out1=o[0], out2=o[1],
                   singles_out=o[2], params=P, cuts_fn=fn,
                   cfg=EngineConfig(records_per_chunk=RPC))
    finally:
        fn.close()
    assert [x.getvalue() for x in o] == [x.getvalue() for x in jo]
    assert (c.kept_p, c.kept_s1, c.kept_s2, c.discard_p, c.total) == (
        jc.kept_p, jc.kept_s1, jc.kept_s2, jc.discard_p, jc.total)
    assert fn.n_host > 0 and fn.n_device == 0


def test_host_only_long_reads():
    """50 kbp reads through the host-only router (indexed path, byte-budget
    chunk shrinking) match the JAX package's engine."""
    rng = np.random.default_rng(21)
    recs = []
    for i in range(24):
        L = 50_000 - (i * 13) % 40
        seq = rng.choice(list(b"ACGT"), L).astype(np.uint8).tobytes()
        q = np.full(L, 70, np.uint8)
        q[: L // 6] = 33 + 5
        q[-L // 7:] = 33 + 3
        recs.append(b"@L%d\n%s\n+\n%s\n" % (i, seq, q.tobytes()))
    data = b"".join(recs)
    jp = JTrimParams(qualtype=JQualityType.SANGER, qual_threshold=20,
                     length_threshold=20)
    want = io.BytesIO()
    wc = jax_run_se(io.BytesIO(data), want, jp,
                    cfg=JEngineConfig(records_per_chunk=8,
                                      bytes_per_batch=1 << 20),
                    cuts_fn=lambda s, q, n: compute_cuts_jit(s, q, n, jp))
    fn = HybridCutsFn(TrimParams.from_reference(jp), None)
    try:
        got = run(data, fn, rpc=8, params=TrimParams.from_reference(jp),
                  bytes_per_batch=1 << 20)
    finally:
        fn.close()
    assert got == (want.getvalue(), (wc.total, wc.kept, wc.discarded))
    assert fn.n_host >= 3 and fn.n_device == 0


def test_hybrid_wire_pe_all_routes(tmp_path):
    """The router with the wire through run_pe from regular files: the
    combined and split two-file routes (mate 2 growing chunk by chunk)
    and interleaved batches, device and host overflow both used; outputs
    equal the JAX package's engine."""
    f1, f2 = tmp_path / "1.fq", tmp_path / "2.fq"
    fi = tmp_path / "i.fq"
    with open(f1, "wb") as a, open(f2, "wb") as b, open(fi, "wb") as c:
        for k in range(5):
            kw = dict(first=k * 1024, mate1=dict(length=(30, 60)),
                      mate2=dict(length=(40, 70 + 24 * min(k, 2))),
                      binned=True)
            write_pairs(a, b, 80 + k, 1024, **kw)
            write_pairs(c, None, 80 + k, 1024, **kw)

    def both(fn_port, interleaved):
        outs = []
        for engine, fn, params, cfg_cls in (
                (jax_run_pe, jax_fn, JP, JEngineConfig),
                (run_pe, fn_port, P, EngineConfig)):
            o = [io.BytesIO() for _ in range(3)]
            mtr = Metrics() if engine is run_pe else None
            kw = dict(metrics=mtr) if mtr is not None else {}
            cfg = cfg_cls(records_per_chunk=1024, slice_rows=1024, **kw)
            if interleaved:
                with open(fi, "rb") as a:
                    c = engine(a, None, interleaved=True, out1=o[0],
                               singles_out=o[2], params=params, cfg=cfg,
                               cuts_fn=fn)
            else:
                with open(f1, "rb") as a, open(f2, "rb") as b:
                    c = engine(a, b, out1=o[0], out2=o[1], singles_out=o[2],
                               params=params, cfg=cfg, cuts_fn=fn)
            outs.append(([x.getvalue() for x in o], c.total, c.kept_p, mtr))
        assert outs[0][:3] == outs[1][:3]
        return outs[1][3]

    calls = []
    fn = HybridCutsFn(P, device(0.05, calls), device_depth=1, rescue_s=0)
    fn.device_handicap = 1e9
    try:
        routes = dict(both(fn, False).routes)
        for k, v in both(fn, True).routes.items():
            routes[k] = routes.get(k, 0) + v
    finally:
        fn.close()
    assert {"combined", "split", "interleaved"} <= set(routes), routes
    assert fn.n_device > 0 and fn.n_host > 0 and fn.n_rescued == 0
    assert any(calls), "no device chunk shipped the wire"


@pytest.mark.parametrize("kind", ["se", "interleaved"])
def test_host_only_bgzf_input_matches(kind, tmp_path, monkeypatch):
    """BGZF input through the host-only router: chunks are parsed in place
    from the decode window and never row-packed (interleaved pairs keep
    the odd-record carry across 1-block windows); outputs equal the
    scalar oracle of the JAX package."""
    from sickle_tpu import oracle as joracle
    from sickle_tpu_torch.io.compression import BgzfReader, BgzfWriter, open_input

    rng = np.random.default_rng(14)
    recs = []
    for i in range(40):  # ~18 KB records vs 48 KB windows: frequent odd cuts
        L = 9000 + (i % 5) * 11
        seq = rng.choice(list(b"ACGT"), L).astype(np.uint8).tobytes()
        q = rng.integers(33 + 5, 33 + 41, L).astype(np.uint8).tobytes()
        recs.append(b"@m%d/%d\n%s\n+\n%s\n" % (i // 2, i % 2 + 1, seq, q))
    data = b"".join(recs)
    gz = tmp_path / "in.fastq.gz"
    w = BgzfWriter(str(gz))
    w.write(data)
    w.close()
    monkeypatch.setattr(BgzfReader, "WINDOW_BLOCKS", 1)
    fn = HybridCutsFn(P, None)
    o1, so = io.BytesIO(), io.BytesIO()
    try:
        with open_input(str(gz)) as fin:
            assert isinstance(fin, BgzfReader)
            cfg = EngineConfig(records_per_chunk=8)
            if kind == "se":
                c = run_se(fin, o1, P, cfg=cfg, cuts_fn=fn)
                want = joracle.trim_se(data, qualtype=JQualityType.SANGER,
                                       qual_threshold=30)
            else:
                c = run_pe(fin, None, interleaved=True, out1=o1,
                           singles_out=so, params=P, cfg=cfg, cuts_fn=fn)
                want = joracle.trim_pe(data, interleaved=True,
                                       qualtype=JQualityType.SANGER,
                                       qual_threshold=30)
    finally:
        fn.close()
    assert o1.getvalue() == want[0]
    if kind == "interleaved":
        assert so.getvalue() == want[2]
    assert c.total == 40 and fn.n_device == 0 and fn.n_host >= 3
