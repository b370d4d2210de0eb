"""``sickle_tpu_torch se`` against ``sickle_tpu se``, byte for byte.

The port's CLI runs in-process on the CPU device (the kernel wrapper then
takes its plain PyTorch path through the same device step) in every
``--cuts`` mode: ``device``, ``host`` (the indexed host kernel), and
``auto``/``hybrid`` (the hybrid router over the device step); the JAX
package's CLI runs as it runs everywhere in this test suite.  Output
bytes, the summary, error text and exit codes must be identical on every
corpus.
"""

import pytest

import sickle_tpu.cli as jax_cli
import sickle_tpu_torch.cli as torch_cli
from sickle_tpu_torch.constants import QualityType
from sickle_tpu_torch.utils.corpus import EDGES, edge_fastq, write_fastq

CORPORA = {
    # name: (qual type, generator options)
    "uniform150": ("sanger", dict(length=150, bad_tail=0.01)),
    "ragged": ("sanger", dict(length=(30, 160), n_rate=0.01, bad_tail=0.01)),
    "short": ("sanger", dict(length=(1, 25), n_rate=0.02)),
    "binned": ("sanger", dict(length=150, binned=True)),
    "illumina": ("illumina", dict(length=(60, 110), qualtype=QualityType.ILLUMINA,
                                  n_rate=0.01)),
    "solexa": ("solexa", dict(length=100, qualtype=QualityType.SOLEXA,
                              bad_tail=0.02)),
    "bad_in_scan": ("sanger", dict(length=150, bad_head=0.01)),
}
FLAGS = {
    "default": [],
    "trunc_n": ["-n"],
    "no5_q30": ["-x", "-q", "30", "-l", "30"],
    "fork": ["--compat", "fork", "-q", "25"],
}
N_READS = 1500


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    for k, (name, (_, kw)) in enumerate(sorted(CORPORA.items())):
        with open(d / f"{name}.fastq", "wb") as f:
            write_fastq(f, 100 + k, N_READS, chunk=700, **kw)
    return d


@pytest.fixture(autouse=True)
def _restore_engine_env(monkeypatch):
    # the JAX CLI's --cuts flag writes these into os.environ; setenv
    # records each one's prior state, so teardown restores it and no such
    # change leaks out of a test
    for var in ("SICKLE_TPU_CUTS", "SICKLE_TPU_HYBRID"):
        monkeypatch.setenv(var, "")
        monkeypatch.delenv(var)


def run(main, argv, capsysbinary):
    capsysbinary.readouterr()
    rc = main(argv)
    out, err = capsysbinary.readouterr()
    return rc, out, err


@pytest.mark.parametrize("flags", list(FLAGS), ids=list(FLAGS))
@pytest.mark.parametrize("corpus", list(CORPORA), ids=list(CORPORA))
def test_se_matches_jax_package(corpus, flags, corpus_dir, capsysbinary):
    qt = CORPORA[corpus][0]
    src = str(corpus_dir / f"{corpus}.fastq")
    argv = ["se", "-f", src, "-t", qt] + FLAGS[flags]
    want_out = str(corpus_dir / f"{corpus}.{flags}.jax.fastq")
    want = run(jax_cli.main, argv + ["-o", want_out], capsysbinary)
    if corpus == "bad_in_scan":
        assert want[0] == 1 and b"does not fall within correct range" in want[2]
    else:
        assert want[0] == 0 and b"Total FastQ records: 1500" in want[1]
    for mode in ("device", "host"):
        out = str(corpus_dir / f"{corpus}.{flags}.{mode}.fastq")
        got = run(lambda a: torch_cli.main(a, device="cpu"),
                  argv + ["-o", out, "--cuts", mode], capsysbinary)
        assert got == want, mode
        if want[0] == 0:
            with open(out, "rb") as a, open(want_out, "rb") as b:
                assert a.read() == b.read(), mode


def test_gzip_output_and_metrics(corpus_dir, capsysbinary):
    import gzip

    src = str(corpus_dir / "ragged.fastq")
    plain = str(corpus_dir / "gz.ref.fastq")
    gz = str(corpus_dir / "gz.fastq.gz")
    argv = ["se", "-f", src, "-t", "sanger"]
    assert run(jax_cli.main, argv + ["-o", plain], capsysbinary)[0] == 0
    rc, out, err = run(lambda a: torch_cli.main(a, device="cpu"),
                       argv + ["-o", gz, "-g", "--metrics"], capsysbinary)
    assert rc == 0 and b"metrics: " in err
    with gzip.open(gz, "rb") as a, open(plain, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("codec", ["bgzf", "gzip"])
def test_gzip_input_matches_jax_package(codec, corpus_dir, capsysbinary):
    """BGZF input (the port's own ``-g`` output) takes the zero-copy
    block-parallel producer; serial gzip the chunked reader."""
    import gzip

    src = str(corpus_dir / "binned.fastq")  # no out-of-range chars
    gz = str(corpus_dir / f"in.{codec}.fastq.gz")
    if codec == "bgzf":
        rc = run(lambda a: torch_cli.main(a, device="cpu"),
                 ["se", "-f", src, "-t", "sanger", "-q", "0", "-l", "0",
                  "-x", "-g", "-o", gz], capsysbinary)[0]
        assert rc == 0
    else:
        with open(src, "rb") as f, gzip.open(gz, "wb") as g:
            g.write(f.read())
    argv = ["se", "-f", gz, "-t", "sanger", "-n"]
    want_out = str(corpus_dir / f"gzin.{codec}.jax.fastq")
    got_out = str(corpus_dir / f"gzin.{codec}.torch.fastq")
    want = run(jax_cli.main, argv + ["-o", want_out], capsysbinary)
    got = run(lambda a: torch_cli.main(a, device="cpu"),
              argv + ["-o", got_out], capsysbinary)
    assert got == want and want[0] == 0
    with open(got_out, "rb") as a, open(want_out, "rb") as b:
        assert a.read() == b.read()


def test_profile_writes_a_trace(corpus_dir, capsysbinary):
    src = str(corpus_dir / "short.fastq")
    trace_dir = corpus_dir / "prof"
    rc = run(lambda a: torch_cli.main(a, device="cpu"),
             ["se", "-f", src, "-t", "sanger", "-o",
              str(corpus_dir / "prof.fastq"), "--profile", str(trace_dir)],
             capsysbinary)[0]
    assert rc == 0
    assert (trace_dir / "trace.json").stat().st_size > 0


@pytest.mark.parametrize("mode", ["auto", "hybrid"])
@pytest.mark.parametrize("corpus", ["uniform150", "ragged", "binned",
                                    "solexa", "bad_in_scan"])
def test_se_hybrid_modes_match_jax_package(corpus, mode, capsysbinary,
                                           tmp_path):
    """``--cuts auto`` and ``--cuts hybrid`` (the router over the device
    step, host overflow) write the JAX package's bytes, summary and
    errors over several chunks; ``--metrics`` reports the router's
    counters."""
    import json

    qt, kw = CORPORA[corpus]
    src = str(tmp_path / "in.fastq")
    with open(src, "wb") as f:
        write_fastq(f, 300 + len(corpus), 9000, chunk=3000, **kw)
    argv = ["se", "-f", src, "-t", qt, "-b", "1"]  # 4,096-read chunks
    want_out = str(tmp_path / "jax.fastq")
    got_out = str(tmp_path / "torch.fastq")
    want = run(jax_cli.main, argv + ["-o", want_out], capsysbinary)
    got = run(lambda a: torch_cli.main(a, device="cpu"),
              argv + ["-o", got_out, "--cuts", mode, "--metrics"],
              capsysbinary)
    assert got[:2] == want[:2]
    if want[0]:
        assert got[2] == want[2]
        return
    with open(got_out, "rb") as a, open(want_out, "rb") as b:
        assert a.read() == b.read()
    met = json.loads(got[2].decode().splitlines()[-1][len("metrics: "):])
    hy = met["hybrid"]
    assert hy["chunks_device"] + hy["chunks_host"] == met["chunks"] == 3


@pytest.mark.parametrize("mode", ["auto", "hybrid"])
@pytest.mark.parametrize("layout", ["two_file", "interleaved"])
def test_pe_hybrid_modes_match_jax_package(layout, mode, corpus_dir,
                                           capsysbinary, tmp_path):
    from sickle_tpu_torch.utils.corpus import write_pairs

    r1, r2 = tmp_path / "r1.fastq", tmp_path / "r2.fastq"
    with open(r1, "wb") as f1, open(r2, "wb") as f2:
        if layout == "two_file":
            write_pairs(f1, f2, 31, 9000, mate1=dict(length=150),
                        mate2=dict(length=(30, 160)), bad_tail=0.01)
        else:
            write_pairs(f1, None, 32, 5000, length=(30, 160), binned=True)
    runs = []
    for main, tag, extra in ((jax_cli.main, "jax", []),
                             (lambda a: torch_cli.main(a, device="cpu"),
                              "torch", ["--cuts", mode])):
        outs = [str(tmp_path / f"{tag}.{k}.fastq") for k in "ops"]
        if layout == "two_file":
            argv = ["pe", "-f", str(r1), "-r", str(r2), "-o", outs[0],
                    "-p", outs[1], "-s", outs[2]]
        else:
            argv = ["pe", "-c", str(r1), "-m", outs[0], "-s", outs[2]]
            outs = [outs[0], outs[2]]
        rc = run(main, argv + ["-t", "sanger", "-b", "1"] + extra,
                 capsysbinary)
        runs.append((rc, [open(o, "rb").read() for o in outs]))
    assert runs[0] == runs[1] and runs[0][0][0] == 0


@pytest.mark.parametrize("cuts", [None, "auto", "device"])
def test_cuts_env_host_matches_jax_package(cuts, corpus_dir, capsysbinary,
                                           monkeypatch):
    """``SICKLE_TPU_CUTS=host`` as the JAX package reads it: with no
    ``--cuts`` or with ``--cuts auto`` the run takes the host kernel, so a
    CUDA device without a card is no reason to refuse it; ``--cuts
    device`` takes the device step (here on the CPU device).  Bytes and
    summary equal the JAX package's under the same variable."""
    import json

    src = str(corpus_dir / "ragged.fastq")
    argv = ["se", "-f", src, "-t", "sanger"] + (["--cuts", cuts] if cuts else [])
    got_out = str(corpus_dir / f"env_host.{cuts}.torch.fastq")
    want_out = str(corpus_dir / f"env_host.{cuts}.jax.fastq")
    device = "cpu" if cuts == "device" else "cuda"
    monkeypatch.setenv("SICKLE_TPU_CUTS", "host")
    got = run(lambda a: torch_cli.main(a, device=device),
              argv + ["-o", got_out, "--metrics"], capsysbinary)
    assert got[0] == 0, got[2]
    met = json.loads(got[2].decode().splitlines()[-1][len("metrics: "):])
    if cuts == "device":
        assert met["h2d_bytes"] > 0 and "hybrid" not in met
    else:
        assert met["h2d_bytes"] == 0 and met["hybrid"]["chunks_device"] == 0
    monkeypatch.setenv("SICKLE_TPU_CUTS", "host")
    want = run(jax_cli.main, argv + ["-o", want_out], capsysbinary)
    assert got[:2] == want[:2]
    with open(got_out, "rb") as a, open(want_out, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("cmd", ["se", "pe"])
def test_dist_with_one_process_is_inactive(cmd, corpus_dir, capsysbinary):
    """``--dist`` in a group of one process (as in the JAX package's
    ``_Dist.active``): the output is not sharded, and bytes and summary
    equal the run without ``--dist``."""
    import socket

    import torch.distributed as dist

    src = str(corpus_dir / "ragged.fastq")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    got = []
    for tag, extra in (("plain", []), ("dist", [
            "--dist", "--coordinator", f"127.0.0.1:{port}",
            "--num-processes", "1", "--process-id", "0"])):
        out = str(corpus_dir / f"one_process.{cmd}.{tag}.fastq")
        io_args = (["-f", src, "-o", out] if cmd == "se"
                   else ["-c", src, "-M", out])
        rc, so, _ = run(lambda a: torch_cli.main(a, device="cpu"),
                        [cmd, "-t", "sanger", "--cuts", "device"] + io_args
                        + extra, capsysbinary)
        assert rc == 0 and not (corpus_dir / f"{out}.shard0").exists()
        with open(out, "rb") as f:
            got.append((so, f.read()))
    assert got[0] == got[1]
    assert not dist.is_initialized()  # _finish left the group


@pytest.mark.parametrize("argv", [
    [], ["--version"], ["--help"], ["se"], ["se", "--help"],
    ["se", "-f", "missing.fastq", "-t", "sanger", "-o", "o.fastq"],
    ["se", "-f", "a", "-t", "phred", "-o", "b"],
    ["se", "-f", "a", "-t", "sanger", "-o", "a"],
    ["se", "-f", "a", "-t", "sanger", "-o", "b", "--cuts", "gpu"],
])
def test_usage_and_errors_match(argv, capsysbinary):
    want = run(jax_cli.main, argv, capsysbinary)
    got = run(lambda a: torch_cli.main(a, device="cpu"), argv, capsysbinary)
    if argv == ["--version"]:  # the last line names the build
        assert got[0] == want[0]
        assert got[1].splitlines()[:-1] == want[1].splitlines()[:-1]
    else:
        assert got == want


@pytest.mark.parametrize("cuts", ["device", "host"])
@pytest.mark.parametrize("edge", EDGES)
def test_edge_inputs_match_jax_package(edge, cuts, tmp_path, capsysbinary):
    """One small file per odd or malformed input (``corpus.edge_fastq``):
    exit code, standard output and error, and output bytes equal the JAX
    package's, with default flags and with ``-n``."""
    src = tmp_path / f"{edge}.fastq"
    src.write_bytes(edge_fastq(edge, 500 + EDGES.index(edge), n_rate=0.02))
    if edge == "nul":
        assert b"\0" in src.read_bytes()
    for flags in ([], ["-n"]):
        argv = ["se", "-f", str(src), "-t", "sanger"] + flags
        outs = [str(tmp_path / f"{tag}.out.fastq") for tag in ("jax", "torch")]
        want = run(jax_cli.main, argv + ["-o", outs[0]], capsysbinary)
        got = run(lambda a: torch_cli.main(a, device="cpu"),
                  argv + ["-o", outs[1], "--cuts", cuts], capsysbinary)
        assert got == want, flags
        if want[0] == 0:
            with open(outs[0], "rb") as a, open(outs[1], "rb") as b:
                assert a.read() == b.read(), flags
