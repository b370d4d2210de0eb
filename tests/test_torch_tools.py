"""The port's ``tools/trim_all`` against the JAX package's, byte for byte.

Both tools walk the same input directory in-process; the port runs on
the CPU device (the kernel wrapper's plain PyTorch path).  Every output
file and standard output must be equal, with the usage line naming each
package's own module and the output directory's path set aside.
"""

import os

import pytest

from sickle_tpu.tools import trim_all as jax_trim_all
from sickle_tpu_torch.tools import trim_all
from sickle_tpu_torch.utils.corpus import write_fastq, write_pairs


@pytest.fixture(autouse=True)
def _engine_env(monkeypatch):
    for var in ("SICKLE_TPU_CUTS", "SICKLE_TPU_HYBRID"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def in_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("trim_all_in")
    for k, name in enumerate(("a.fastq", "b.fq")):
        with open(d / name, "wb") as f:
            write_fastq(f, 40 + k, 1200, length=(30, 160), bad_tail=0.01)
    for k, stem in enumerate(("pairA", "pairB")):
        with open(d / f"{stem}.1.fastq", "wb") as f1, \
                open(d / f"{stem}.2.fastq", "wb") as f2:
            write_pairs(f1, f2, 50 + k, 600, length=(30, 160))
    return d


def _run(main, argv, capsys):
    capsys.readouterr()
    rc = main(argv)
    return rc, capsys.readouterr().out


def _tree(d):
    return {n: (d / n).read_bytes() for n in sorted(os.listdir(d))}


@pytest.mark.parametrize("extra", [[], ["2", "1"]], ids=["default", "a_b"])
@pytest.mark.parametrize("mode", ["se", "pe"])
def test_trim_all_matches_jax(mode, extra, in_dir, tmp_path, capsys):
    outs = {}
    for tag, main in (("jax", jax_trim_all.main),
                      ("torch", lambda a: trim_all.main(a, device="cpu"))):
        out = tmp_path / tag
        argv = [mode, "sanger", str(in_dir), str(out)] + extra
        rc, so = _run(main, argv, capsys)
        # the second run skips every file whose outputs exist (resume)
        rc2, so2 = _run(main, argv, capsys)
        outs[tag] = (rc, rc2, _tree(out),
                     [s.replace(str(out), "OUT")
                      .replace("sickle_tpu_torch.tools", "sickle_tpu.tools")
                      for s in (so, so2)])
    assert outs["torch"] == outs["jax"]
    rc, rc2, tree, (so, so2) = outs["torch"]
    assert rc == rc2 == 0 and "already exists, skipping it." in so2
    assert len(tree) == 6  # se: every FASTQ; pe: 2 pairs x 3 outputs
    assert all(tree.values())


@pytest.mark.parametrize("argv", [
    ["se"], ["xe", "sanger", "IN", "OUT"], ["pe", "sanger", "IN", "OUT"]],
    ids=["too_few", "bad_mode", "missing_mate"])
def test_trim_all_errors_match_jax(argv, in_dir, tmp_path, capsys):
    src = tmp_path / "in"
    src.mkdir()
    for name in ("pairA.1.fastq", "pairA.2.fastq", "pairB.1.fastq"):
        os.symlink(in_dir / name, src / name)  # pairB lacks its mate 2
    got = []
    for tag, main in (("jax", jax_trim_all.main),
                      ("torch", lambda a: trim_all.main(a, device="cpu"))):
        a = [x.replace("IN", str(src)).replace("OUT", str(tmp_path / tag))
             for x in argv]
        rc, so = _run(main, a, capsys)
        got.append((rc, so.replace(str(tmp_path / tag), "OUT")
                    .replace("sickle_tpu_torch.tools", "sickle_tpu.tools")))
    assert got[0] == got[1] and got[0][0] == 1


def test_trim_all_needs_cuda_by_default(in_dir, tmp_path, capsys):
    if __import__("torch").cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = trim_all.main(["se", "sanger", str(in_dir), str(tmp_path / "o")])
    assert rc == 1
    assert "no CUDA device is available" in capsys.readouterr().err
