"""The port's host C++ library builds from its own copy of the source.

``sickle_tpu_torch/csrc/fastqio.cpp`` is a copy of the JAX package's
``sickle_tpu/io/_fastqio.cpp``, equal line for line but for two comments
that cite the original sickle's source files; ``io/native.py`` compiles
the copy, so the port reads no file of the JAX package.  A fresh build
of the copy, in a fresh interpreter, writes the JAX package's se and pe
bytes and summaries.
"""

import os
import pathlib
import subprocess
import sys

import sickle_tpu.cli as jax_cli
from sickle_tpu_torch.io import native
from sickle_tpu_torch.utils.corpus import write_fastq, write_pairs

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "sickle_tpu_torch"


def test_native_source_is_the_ports_own_copy():
    assert native._SRC.resolve() == PKG / "csrc" / "fastqio.cpp"
    assert native._SO.resolve().parent == PKG / "_build"
    jax_src = REPO / "sickle_tpu" / "io" / "_fastqio.cpp"
    ours = native._SRC.read_bytes().splitlines()
    theirs = jax_src.read_bytes().splitlines()
    assert len(ours) == len(theirs)
    differ = [(a, b) for a, b in zip(ours, theirs) if a != b]
    assert len(differ) == 2
    assert all(a.startswith(b"// ") and b"sickle 1.33's src/GZReader.cpp" in a
               for a, _ in differ)


def test_fresh_build_of_the_copy_matches_jax_package(tmp_path, capsysbinary):
    with open(tmp_path / "se.fastq", "wb") as f:
        write_fastq(f, 61, 3000, length=(30, 160), n_rate=0.01,
                    bad_tail=0.01)
    with open(tmp_path / "r1.fastq", "wb") as f1, \
            open(tmp_path / "r2.fastq", "wb") as f2:
        write_pairs(f1, f2, 62, 1500, length=(30, 160), bad_tail=0.01)

    def argvs(tag):
        return [
            ["se", "-f", "se.fastq", "-t", "sanger", "-o", f"se.{tag}.fastq"],
            ["se", "-f", "se.fastq", "-t", "sanger", "-n", "-x", "-o",
             f"se_nx.{tag}.fastq"],
            ["pe", "-f", "r1.fastq", "-r", "r2.fastq", "-t", "sanger", "-o",
             f"pe.{tag}.1.fastq", "-p", f"pe.{tag}.2.fastq", "-s",
             f"pe.{tag}.s.fastq"],
        ]

    build = tmp_path / "build"
    code = f"""
import pathlib, sys
from sickle_tpu_torch.io import native
native._BUILD_DIR = pathlib.Path({str(build)!r})
native._SO = native._BUILD_DIR / "_fastqio.so"
from sickle_tpu_torch.cli import main
rcs = [main(argv + ["--cuts", "host"], device="cpu") for argv in {argvs("torch")!r}]
assert native.get_lib() is not None and native._SO.is_file()
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "sickle_tpu"))
print(max(rcs), loaded)
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("SICKLE_TPU_NO_NATIVE", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    *summaries, last = r.stdout.splitlines(keepends=True)
    assert last.strip() == "0 []"

    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        capsysbinary.readouterr()
        assert [jax_cli.main(argv) for argv in argvs("jax")] == [0, 0, 0]
        want = capsysbinary.readouterr()[0].decode()
    finally:
        os.chdir(cwd)
    assert "".join(summaries) == want
    for jax_out in sorted(tmp_path.glob("*.jax*.fastq")):
        torch_out = tmp_path / jax_out.name.replace(".jax", ".torch")
        assert torch_out.read_bytes() == jax_out.read_bytes(), jax_out.name
    assert (build / "_fastqio.so").is_file()
