"""The port's tools against the JAX package's.

- ``tools/trim_all``, byte for byte: both tools walk the same input
  directory in-process; the port runs on the CPU device (the kernel
  wrapper's plain PyTorch path).  Every output file and standard output
  must be equal, with the usage line naming each package's own module and
  the output directory's path set aside.
- The Galaxy wrapper (``sickle_tpu_torch/galaxy/sickle_tpu_torch.xml``):
  the JAX wrapper's parameter surface, test inputs that regenerate from
  their seeds, and expected outputs that both CLIs write.
- The console scripts that ``pyproject.toml`` names.
"""

import os
import pathlib
import xml.etree.ElementTree as ET

import pytest

import sickle_tpu.cli as jax_cli
import sickle_tpu_torch.cli as torch_cli
from sickle_tpu.tools import trim_all as jax_trim_all
from sickle_tpu_torch.galaxy import TEST_INPUTS, write_test_inputs
from sickle_tpu_torch.tools import trim_all
from sickle_tpu_torch.utils.corpus import write_fastq, write_pairs

REPO = pathlib.Path(__file__).resolve().parents[1]
GALAXY = REPO / "sickle_tpu_torch" / "galaxy"


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


def test_galaxy_wrapper_param_parity():
    """The port's wrapper has the JAX wrapper's parameter surface
    (``tests/test_tools.py::test_galaxy_wrapper_param_parity``), each
    mapped into a ``python -m sickle_tpu_torch`` command."""
    tree = ET.parse(GALAXY / "sickle_tpu_torch.xml")
    jax_tree = ET.parse(REPO / "galaxy" / "sickle_tpu.xml")
    names = {p.get("name") for p in tree.iter("param")}
    for want in ("qual_threshold", "length_threshold", "threads", "batch",
                 "no_five_prime", "trunc_n", "gzip_output", "output_n"):
        assert want in names, want
    cmd = tree.find("command").text
    for frag in ("-q $qual_threshold", "-l $length_threshold", "-a $threads",
                 "-b $batch", "$no_five_prime", "$trunc_n", "$gzip_output"):
        assert frag in cmd, frag
    assert "python -m sickle_tpu_torch\n" in cmd
    test_params = {p.get("name") for p in tree.find("tests").iter("param")}
    assert {"threads", "batch"} <= test_params
    # the same inputs, params and outputs as the JAX wrapper's
    for tag in ("param", "data"):
        assert ({(e.get("name"), e.get("type"), e.get("value"))
                 for e in tree.find("inputs").iter(tag)}
                == {(e.get("name"), e.get("type"), e.get("value"))
                    for e in jax_tree.find("inputs").iter(tag)})
    assert ([e.get("name") for e in tree.find("outputs").iter("data")]
            == [e.get("name") for e in jax_tree.find("outputs").iter("data")])


def _records(data: bytes) -> int:
    return data.count(b"\n") // 4


def test_galaxy_test_data_regenerate(tmp_path):
    write_test_inputs(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == sorted(TEST_INPUTS)
    for name in TEST_INPUTS:
        data = (tmp_path / name).read_bytes()
        assert data == (GALAXY / "test-data" / name).read_bytes(), name
        assert 0 < _records(data) <= 200
    # every file the wrapper's tests name is in test-data, none over 200
    # records
    tree = ET.parse(GALAXY / "sickle_tpu_torch.xml")
    named = {e.get("value") for e in tree.find("tests").iter("param")
             if e.get("value", "").endswith(".fastq")}
    named |= {e.get("file") for e in tree.find("tests").iter("output")}
    assert named == set(os.listdir(GALAXY / "test-data"))
    for name in named:
        assert _records((GALAXY / "test-data" / name).read_bytes()) <= 200


# each <test> of the wrapper as the command it renders: (input and output
# flags, {flag: expected file}, the other flags)
GALAXY_TESTS = {
    "se": (["se", "-f", "se.fastq"], {"-o": "se.trimmed.fastq"},
           ["-q", "20", "-a", "2", "-b", "64"]),
    "se_xn": (["se", "-f", "se.fastq"], {"-o": "se_xn.trimmed.fastq"},
              ["-q", "30", "-a", "1", "-b", "512", "-x", "-n"]),
    "pe_combo": (["pe", "-c", "pe_interleaved.fastq"],
                 {"-m": "pe_combo.trimmed.fastq",
                  "-s": "pe_combo.singles.fastq"},
                 ["-q", "20", "-a", "1", "-b", "512"]),
    "pe_combo_M": (["pe", "-c", "pe_interleaved.fastq"],
                   {"-M": "pe_combo_M.trimmed.fastq"},
                   ["-q", "20", "-a", "1", "-b", "512"]),
    "pe_sep": (["pe", "-f", "pe.1.fastq", "-r", "pe.2.fastq"],
               {"-o": "pe_sep.1.fastq", "-p": "pe_sep.2.fastq",
                "-s": "pe_sep.singles.fastq"},
               ["-q", "20", "-a", "1", "-b", "512"]),
}


@pytest.mark.parametrize("case", list(GALAXY_TESTS))
def test_galaxy_expected_outputs(case, tmp_path, monkeypatch, capsys):
    """Both CLIs, given a test's command, write its expected files."""
    for var in ("SICKLE_TPU_CUTS", "SICKLE_TPU_HYBRID"):
        monkeypatch.setenv(var, "")
        monkeypatch.delenv(var)
    ins, outs, flags = GALAXY_TESTS[case]
    data = GALAXY / "test-data"
    for tag, main in (("jax", jax_cli.main),
                      ("torch", lambda a: torch_cli.main(a, device="cpu"))):
        argv = [a if not a.endswith(".fastq") else str(data / a) for a in ins]
        for flag, name in outs.items():
            argv += [flag, str(tmp_path / f"{tag}.{name}")]
        argv += flags + ["-t", "sanger", "-l", "20", "--quiet"]
        assert main(argv) == 0, tag
        assert capsys.readouterr().out == ""
        for name in outs.values():
            got = (tmp_path / f"{tag}.{name}").read_bytes()
            assert got == (data / name).read_bytes(), (tag, name)


def test_console_scripts_import():
    """Each console script in ``pyproject.toml`` names a callable that
    imports, the port's two beside the JAX package's."""
    import importlib
    import tomllib

    with open(REPO / "pyproject.toml", "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    assert scripts["sickle-torch"] == "sickle_tpu_torch.cli:main"
    assert (scripts["sickle-torch-trim-all"]
            == "sickle_tpu_torch.tools.trim_all:main")
    for name, target in scripts.items():
        module, attr = target.split(":")
        assert callable(getattr(importlib.import_module(module), attr)), name
