"""The port never imports JAX or the JAX package.

Each test runs the port in a fresh interpreter, so nothing this test
process imported can hide an import the port makes.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]


def _python(code_or_args, cwd, **kw):
    args = ["-c", code_or_args] if isinstance(code_or_args, str) else code_or_args
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120, **kw)


@pytest.fixture(scope="module")
def small_fastq(tmp_path_factory):
    from sickle_tpu_torch.utils.corpus import write_fastq, write_pairs

    d = tmp_path_factory.mktemp("nojax")
    with open(d / "in.fastq", "wb") as f:
        write_fastq(f, 5, 800, length=(30, 160), n_rate=0.01, bad_tail=0.02)
    with open(d / "in.1.fastq", "wb") as f1, open(d / "in.2.fastq", "wb") as f2:
        write_pairs(f1, f2, 6, 400, length=(30, 160), bad_tail=0.02)
    return d


def _run_without_jax(argvs, cuts, cwd):
    """Run the port's CLI on each argv in one fresh interpreter; assert
    each run succeeded and wrote its first output, and that neither JAX
    nor the JAX package was loaded."""
    code = f"""
import sys
from sickle_tpu_torch.cli import main
rcs = [main(argv + ["-t", "sanger", "--cuts", "{cuts}", "--quiet"],
            device="cpu") for argv in {argvs!r}]
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "sickle_tpu"))
print(max(rcs), loaded)
"""
    r = _python(code, cwd)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "0 []"
    for argv in argvs:
        out = argv[[i for i, a in enumerate(argv) if a in ("-o", "-M")][0] + 1]
        assert (cwd / out).stat().st_size > 0


@pytest.mark.parametrize("cuts", ["device", "host", "hybrid"])
def test_se_runs_without_jax(cuts, small_fastq):
    _run_without_jax([["se", "-f", "in.fastq", "-o", f"out.{cuts}.fastq"]],
                     cuts, small_fastq)


@pytest.mark.parametrize("cuts", ["device", "host", "hybrid"])
def test_pe_and_checkpoint_run_without_jax(cuts, small_fastq):
    """Two-file pe, interleaved -M, se with --checkpoint and -g, and
    two-file pe with --checkpoint."""
    pe = ["pe", "-f", "in.1.fastq", "-r", "in.2.fastq"]
    _run_without_jax([
        pe + ["-o", f"pe.{cuts}.1.fastq", "-p", f"pe.{cuts}.2.fastq",
              "-s", f"pe.{cuts}.s.fastq"],
        ["pe", "-c", "in.fastq", "-M", f"pe_M.{cuts}.fastq"],
        ["se", "-f", "in.fastq", "-o", f"se_ck.{cuts}.fastq.gz", "-g",
         "--checkpoint", f"se_ck.{cuts}.json"],
        pe + ["-o", f"pe_ck.{cuts}.1.fastq", "-p", f"pe_ck.{cuts}.2.fastq",
              "-s", f"pe_ck.{cuts}.s.fastq", "--checkpoint",
              f"pe_ck.{cuts}.json"],
    ], cuts, small_fastq)


def test_module_entry_point_host(small_fastq):
    r = _python(["-m", "sickle_tpu_torch", "se", "-f", "in.fastq", "-t",
                 "sanger", "-o", "out.m.fastq", "--cuts", "host"], small_fastq)
    assert r.returncode == 0, r.stderr
    assert "Total FastQ records: 800\n" in r.stdout


def test_every_port_module_imports_without_jax():
    code = """
import importlib, pkgutil, sys
import sickle_tpu_torch
names = [m.name for m in pkgutil.walk_packages(sickle_tpu_torch.__path__,
                                               "sickle_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(len(names), sorted(m for m in sys.modules
                         if m.split(".")[0] in ("jax", "jaxlib", "sickle_tpu")))
"""
    r = _python(code, REPO)
    assert r.returncode == 0, r.stderr
    count, loaded = r.stdout.strip().split(" ", 1)
    assert int(count) >= 15 and loaded == "[]"


def test_hybrid_router_imports_without_jax():
    code = """
import sys
from sickle_tpu_torch.engine.hybrid import HybridCutsFn, hybrid_enabled
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "sickle_tpu")))
"""
    r = _python(code, REPO)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_parallel_and_tools_import_without_jax():
    code = """
import sys
import sickle_tpu_torch.parallel
from sickle_tpu_torch.parallel.dist import init_distributed, shard_record_ranges
from sickle_tpu_torch.tools.trim_all import main
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "sickle_tpu")))
"""
    r = _python(code, REPO)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_tools_import_without_jax_and_need_a_card(tmp_path):
    """The entry module, the bench, the kernel-verify tool, the timing
    helpers and the Galaxy test-data module load neither JAX nor the JAX
    package; without a card each tool's ``main`` exits 1 (no CPU
    fallback) and writes nothing."""
    code = """
import json, sys
import torch
import sickle_tpu_torch.galaxy
from sickle_tpu_torch import entry
from sickle_tpu_torch.tools import bench, kernel_verify
from sickle_tpu_torch.utils import timing
rcs = (None if torch.cuda.is_available()
       else [entry.main(), bench.main([]), kernel_verify.main([])])
print(json.dumps([rcs, sorted(m for m in sys.modules if m.split(".")[0]
                              in ("jax", "jaxlib", "sickle_tpu"))]))
"""
    r = _python(code, tmp_path)
    assert r.returncode == 0, r.stderr
    rcs, loaded = json.loads(r.stdout.splitlines()[-1])
    assert loaded == []
    if rcs is not None:
        assert rcs == [1, 1, 1]
        assert os.listdir(tmp_path) == []


def test_dist_cluster_runs_without_jax(small_fastq):
    """A two-process ``--dist`` se run (gloo): each process trims its shard
    and never loads JAX or the JAX package."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    code = """
import sys
from sickle_tpu_torch.cli import main
rc = main(sys.argv[1:], device="cpu")
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "sickle_tpu"))
sys.stderr.write(f"RESULT {rc} {loaded}\\n")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, "se", "-f", "in.fastq", "-t", "sanger",
         "-o", "dist.fastq", "--cuts", "device", "--dist", "--coordinator",
         f"127.0.0.1:{port}", "--num-processes", "2", "--process-id",
         str(rank)], cwd=small_fastq, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in range(2)]
    try:
        errs = [p.communicate(timeout=60)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, err in enumerate(errs):
        assert "RESULT 0 []\n" in err, err
        assert (small_fastq / f"dist.fastq.shard{rank}").stat().st_size > 0


def _needs_cuda(argv, cwd):
    r = _python("import torch; print(torch.cuda.is_available())", cwd)
    if r.stdout.strip() != "False":
        pytest.skip("a CUDA device is present")
    r = _python(["-m", "sickle_tpu_torch", *argv, "-t", "sanger"], cwd)
    assert r.returncode == 1
    assert "no CUDA device is available" in r.stderr


def test_default_device_needs_cuda(small_fastq):
    """``--cuts auto`` means the CUDA kernel: without a card the CLI says so
    and exits 1 instead of falling back."""
    _needs_cuda(["se", "-f", "in.fastq", "-o", "out.auto.fastq"], small_fastq)


def test_pe_default_device_needs_cuda(small_fastq):
    """The same for pe: no CPU fallback."""
    _needs_cuda(["pe", "-c", "in.fastq", "-m", "out.auto.fastq"], small_fastq)
