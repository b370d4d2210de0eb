"""The port never imports JAX or the JAX package.

Each test runs the port in a fresh interpreter, so nothing this test
process imported can hide an import the port makes.
"""

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
    from sickle_tpu_torch.utils.corpus import write_fastq

    d = tmp_path_factory.mktemp("nojax")
    with open(d / "in.fastq", "wb") as f:
        write_fastq(f, 5, 800, length=(30, 160), n_rate=0.01, bad_tail=0.02)
    return d


@pytest.mark.parametrize("cuts", ["device", "host"])
def test_se_runs_without_jax(cuts, small_fastq):
    code = f"""
import sys
from sickle_tpu_torch.cli import main
rc = main(["se", "-f", "in.fastq", "-t", "sanger", "-o", "out.{cuts}.fastq",
           "--cuts", "{cuts}", "--quiet"], device="cpu")
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "sickle_tpu"))
print(rc, loaded)
"""
    r = _python(code, small_fastq)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "0 []"
    assert (small_fastq / f"out.{cuts}.fastq").stat().st_size > 0


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


def test_default_device_needs_cuda(small_fastq):
    """``--cuts auto`` means the CUDA kernel: without a card the CLI says so
    and exits 1 instead of falling back."""
    r = _python("import torch; print(torch.cuda.is_available())", small_fastq)
    if r.stdout.strip() != "False":
        pytest.skip("a CUDA device is present")
    r = _python(["-m", "sickle_tpu_torch", "se", "-f", "in.fastq", "-t",
                 "sanger", "-o", "out.auto.fastq"], small_fastq)
    assert r.returncode == 1
    assert "no CUDA device is available" in r.stderr
