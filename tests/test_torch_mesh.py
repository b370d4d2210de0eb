"""``--devices N`` in the port against the JAX package, exactly.

The port's sharded device step (``parallel.sharded_cuts_fn`` over copies
of the CPU device, where the kernel wrapper takes its plain PyTorch
path) is held to the single-device step and to the JAX package's
sharded step (``sharded_cuts_fn`` over ``data_mesh(n)`` of the 8 virtual
CPU devices of ``tests/conftest.py``): the same codes, the same output
bytes and the same H2D bytes chunk by chunk, on the band and rank wires,
raw rows under ``-n`` and out-of-range chars, chunks padded to a device
multiple, and chunks that are not a whole number of slices.  The CLI's
``--devices 3`` and ``8`` give the bytes of ``--devices 1`` and of
``sickle_tpu --devices 8`` in every ``--cuts`` mode.  Tolerance 0.
"""

import io

import numpy as np
import pytest
import torch

import sickle_tpu.cli as jax_cli
from sickle_tpu.constants import QualityType as JQualityType
from sickle_tpu.engine import EngineConfig as JEngineConfig
from sickle_tpu.engine import run_se as jax_run_se
from sickle_tpu.ops import TrimParams as JTrimParams
from sickle_tpu.parallel import data_mesh as jax_data_mesh
from sickle_tpu.parallel import sharded_cuts_fn as jax_sharded_cuts_fn
from sickle_tpu.parallel.dist import sharded_trim_step as jax_sharded_trim_step
from sickle_tpu.utils.metrics import Metrics as JMetrics
import sickle_tpu_torch.cli as torch_cli
import sickle_tpu_torch.parallel as tparallel
from sickle_tpu_torch.engine import EngineConfig, run_se
from sickle_tpu_torch.engine.pipeline import _cuda_cuts_fn
from sickle_tpu_torch.io.fastq import pack_fastq
from sickle_tpu_torch.ops import TrimParams
from sickle_tpu_torch.parallel import data_mesh, sharded_cuts_fn
from sickle_tpu_torch.parallel.dist import sharded_trim_step
from sickle_tpu_torch.utils.corpus import (
    fastq_bytes,
    make_reads,
    write_fastq,
    write_pairs,
)
from sickle_tpu_torch.utils.metrics import Metrics

SLICE = 512
CORPORA = {
    # name: (make_reads options, trim params options)
    "uniform": (dict(length=150), {}),  # band wire, uniform form
    "ragged": (dict(length=(30, 160)), {}),  # band wire, generic form
    "binned": (dict(length=150, binned=True), {}),  # rank wire
    "trunc_n": (dict(length=(30, 160), n_rate=0.02), dict(trunc_n=True)),
    "bad_tail": (dict(length=(30, 160), bad_tail=0.01), {}),  # raw rows
}


@pytest.fixture(autouse=True)
def _engine_env(monkeypatch):
    for var in ("SICKLE_TPU_NO_PLANES", "SICKLE_TPU_CUTS", "SICKLE_TPU_HYBRID"):
        monkeypatch.delenv(var, raising=False)


def test_data_mesh_lists_local_devices():
    cpu = torch.device("cpu")
    assert data_mesh(devices="cpu") == [cpu]
    assert data_mesh(3, "cpu") == [cpu] * 3
    assert data_mesh(2, ["cuda:0"] * 3) == [torch.device("cuda", 0)] * 2
    assert data_mesh(devices=[cpu, "cpu"]) == [cpu, cpu]
    assert len(data_mesh()) == torch.cuda.device_count()


def _engines(data, jp, n, rpc):
    """(bytes, counters, per-chunk H2D) of the JAX package's engine over
    its sharded step on ``data_mesh(n)``, and of the port's engine over
    its sharded step on n CPU devices and over its single-device step."""
    runs = []
    jmtr = JMetrics()
    jout = io.BytesIO()
    c = jax_run_se(io.BytesIO(data), jout, jp,
                   cfg=JEngineConfig(records_per_chunk=rpc, slice_rows=SLICE,
                                     metrics=jmtr),
                   cuts_fn=jax_sharded_cuts_fn(jp, jax_data_mesh(n),
                                               slice_rows=SLICE, inflight=2))
    runs.append((jout.getvalue(), (c.total, c.kept), jmtr.h2d_bytes))
    p = TrimParams.from_reference(jp)
    for fn in (sharded_cuts_fn(p, data_mesh(n, "cpu"), SLICE),
               _cuda_cuts_fn(p, "cpu", SLICE)):
        mtr = Metrics()
        out = io.BytesIO()
        c = run_se(io.BytesIO(data), out, p,
                   cfg=EngineConfig(records_per_chunk=rpc, slice_rows=SLICE,
                                    metrics=mtr),
                   cuts_fn=fn)
        runs.append((out.getvalue(), (c.total, c.kept), mtr.h2d_bytes))
    return runs


@pytest.mark.parametrize("n", [8, 3])
@pytest.mark.parametrize("corpus", list(CORPORA))
def test_sharded_step_matches_jax_chunk_by_chunk(corpus, n):
    kw, pkw = CORPORA[corpus]
    data = fastq_bytes(*make_reads(60 + len(corpus), 2600, **kw))
    jp = JTrimParams(JQualityType.SANGER, 20, 20, **pkw)
    jax_run, mesh_run, one_run = _engines(data, jp, n, rpc=1024)
    assert mesh_run == jax_run  # bytes, counters, H2D of every chunk
    assert mesh_run[:2] == one_run[:2]
    if corpus in ("uniform", "ragged", "binned") and n == 8:
        # the wire rides the mesh: fewer bytes than raw rows
        assert sum(mesh_run[2]) < 2600 * 150


@pytest.mark.parametrize("n", [8, 3])
@pytest.mark.parametrize("corpus", ["ragged", "trunc_n"])
def test_chunks_that_are_not_whole_slices_match_jax(corpus, n):
    """200-record chunks pad to 256 rows, not a multiple of the slice:
    one piece, raw rows with explicit lengths, as in the JAX package."""
    kw, pkw = CORPORA[corpus]
    data = fastq_bytes(*make_reads(80 + len(corpus), 1500, **kw))
    jp = JTrimParams(JQualityType.SANGER, 20, 20, **pkw)
    jax_run, mesh_run, one_run = _engines(data, jp, n, rpc=200)
    assert mesh_run == jax_run
    assert mesh_run[:2] == one_run[:2]


@pytest.mark.parametrize("clean", [True, False])
@pytest.mark.parametrize("n", [8, 3])
def test_padded_rows_are_cut_from_the_codes(n, clean):
    """A 1,001-row batch is padded to a device multiple; the codes of the
    real rows equal the single-device step's and the JAX sharded step's,
    and the bytes shipped equal the JAX step's."""
    s, q, lens = make_reads(9, 1001, length=(1, 120), n_rate=0.01)
    jp = JTrimParams(JQualityType.SANGER, 20, 20)
    p = TrimParams.from_reference(jp)
    mesh = sharded_cuts_fn(p, data_mesh(n, "cpu"), SLICE)
    got = mesh(s, q, lens, qual_clean=clean).materialize()
    one = _cuda_cuts_fn(p, "cpu", SLICE)(s, q, lens, qual_clean=clean)
    jfn = jax_sharded_cuts_fn(jp, jax_data_mesh(n), slice_rows=SLICE, inflight=2)
    want = jfn(s, q, lens, qual_clean=clean).materialize()
    for g, o, w in zip(got, one.materialize(), want):
        assert g.shape == (1001,)
        np.testing.assert_array_equal(g, o)
        np.testing.assert_array_equal(g, w[:1001])
    assert mesh.last_h2d == jfn.last_h2d


@pytest.mark.parametrize("trunc_n", [False, True])
def test_sharded_trim_step_matches_jax(trunc_n):
    data = fastq_bytes(*make_reads(12, 2400, length=(1, 150), n_rate=0.02,
                                   bad_tail=0.02))
    packed = pack_fastq(data, batch_multiple=24)
    B = packed.batch_size
    jp = JTrimParams(JQualityType.SANGER, 30, 20, trunc_n=trunc_n)
    jstep = jax_sharded_trim_step(jp, jax_data_mesh(8))
    jfive, jthree, jbad, jtotal, jkept = (
        np.asarray(x) for x in jstep(packed.seq, packed.qual, packed.lengths))
    lens = packed.lengths
    for devices in (data_mesh(8, "cpu"), data_mesh(3, "cpu")):
        step = sharded_trim_step(TrimParams.from_reference(jp), devices)
        five, three, bad, total, kept = step(packed.seq, packed.qual, lens)
        assert five.shape == (B,)
        np.testing.assert_array_equal(five, jfive)
        np.testing.assert_array_equal(three, jthree)
        # the kernel reports a flag, not the position
        np.testing.assert_array_equal(bad < lens, jbad < lens)
        assert (total, kept) == (int(jtotal), int(jkept))
        assert total == 2400


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_mesh_cli")
    with open(d / "se.fastq", "wb") as f:
        write_fastq(f, 91, 9000, chunk=3000, length=(30, 160), bad_tail=0.01)
    with open(d / "r1.fastq", "wb") as f1, open(d / "r2.fastq", "wb") as f2:
        write_pairs(f1, f2, 92, 4500, mate1=dict(length=150),
                    mate2=dict(length=(30, 160)), binned=True)
    with open(d / "il.fastq", "wb") as f:
        write_pairs(f, None, 93, 4500, length=(30, 160))
    return d


LAYOUTS = {
    "se": (["se", "-f", "se.fastq"], ["-o"]),
    "pe_two_file": (["pe", "-f", "r1.fastq", "-r", "r2.fastq"],
                    ["-o", "-p", "-s"]),
    "pe_interleaved": (["pe", "-c", "il.fastq"], ["-M"]),
}


def _cli_run(main, argv, tag, out_flags, capsysbinary):
    outs = [f"{tag}.{f[1]}.fastq" for f in out_flags]
    capsysbinary.readouterr()
    rc = main(argv + [x for f, o in zip(out_flags, outs) for x in (f, o)])
    so, se = capsysbinary.readouterr()
    assert rc == 0, se
    return so, [open(o, "rb").read() for o in outs]


@pytest.mark.parametrize("mode", ["device", "auto", "host"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_cli_devices_match_jax_devices_8(layout, mode, cli_inputs,
                                         monkeypatch, capsysbinary):
    monkeypatch.chdir(cli_inputs)
    args, out_flags = LAYOUTS[layout]
    base = args + ["-t", "sanger", "-b", "1"]
    want = _cli_run(jax_cli.main, base + ["--devices", "8"],
                    f"{layout}.{mode}.jax", out_flags, capsysbinary)
    monkeypatch.delenv("SICKLE_TPU_HYBRID", raising=False)
    made = []

    def spy(params, devices, slice_rows=None):
        made.append(len(devices))
        return sharded_cuts_fn(params, devices, slice_rows)

    monkeypatch.setattr(tparallel, "sharded_cuts_fn", spy)
    for n in (1, 3, 8):
        got = _cli_run(lambda a: torch_cli.main(a, device="cpu"),
                       base + ["--devices", str(n), "--cuts", mode],
                       f"{layout}.{mode}.{n}", out_flags, capsysbinary)
        assert got == want, n
    assert made == ([] if mode == "host" else [3, 8])
