"""``sickle_tpu_torch pe`` against ``sickle_tpu pe``, byte for byte.

The port's CLI runs in-process on the CPU device (the kernel wrapper then
takes its plain PyTorch path through the same device step) and with
``--cuts host``; the JAX package's CLI runs as it runs everywhere in this
test suite.  Every output file, the summary, error text and exit codes
must be identical, in every pe mode, on every corpus and flag set.
"""

import dataclasses
import gzip
import io
import threading

import numpy as np
import pytest

import sickle_tpu.cli as jax_cli
import sickle_tpu_torch.cli as torch_cli
from sickle_tpu_torch import oracle
from sickle_tpu_torch.constants import QualityType
from sickle_tpu_torch.engine import EngineConfig, run_pe
from sickle_tpu_torch.engine.pipeline import _cuda_cuts_fn
from sickle_tpu_torch.io.compression import BgzfReader, BgzfWriter, open_input
from sickle_tpu_torch.ops import TrimParams
from sickle_tpu_torch.utils.corpus import write_pairs
from sickle_tpu_torch.utils.metrics import Metrics

N_PAIRS = 1500
CORPORA = {
    # name: write_pairs options
    "2x150": dict(length=150, bad_tail=0.01),
    "150_100": dict(mate1=dict(length=150), mate2=dict(length=100),
                    bad_tail=0.01),
    "ragged": dict(length=(30, 160), n_rate=0.01, bad_tail=0.01),
    "binned": dict(length=150, binned=True),
    "n_rich": dict(length=(60, 150), n_rate=0.05),
    "bad_in_scan": dict(length=150, bad_head=0.01),
}
FLAGS = {
    "default": [],
    "trunc_n": ["-n"],
    "no5_q30": ["-x", "-q", "30", "-l", "30"],
    "fork": ["--compat", "fork"],
}
MODES = ("two_file", "interleaved_s", "interleaved", "n_records")


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_pe")
    for k, (name, kw) in enumerate(sorted(CORPORA.items())):
        with open(d / f"{name}.1.fastq", "wb") as f1, \
                open(d / f"{name}.2.fastq", "wb") as f2:
            write_pairs(f1, f2, 200 + k, N_PAIRS, chunk=700, **kw)
        with open(d / f"{name}.i.fastq", "wb") as f:
            write_pairs(f, None, 200 + k, N_PAIRS, chunk=700, **kw)
    return d


def run(main, argv, capsysbinary):
    capsysbinary.readouterr()
    rc = main(argv)
    out, err = capsysbinary.readouterr()
    return rc, out, err


def port(argv):
    return torch_cli.main(argv, device="cpu")


def mode_argv(mode, d, corpus, tag):
    """(argv without -t, [output paths]) for one pe mode."""
    outs = {k: str(d / f"{corpus}.{tag}.{k}.fastq") for k in ("o", "p", "s")}
    if mode == "two_file":
        return (["-f", str(d / f"{corpus}.1.fastq"),
                 "-r", str(d / f"{corpus}.2.fastq"),
                 "-o", outs["o"], "-p", outs["p"], "-s", outs["s"]],
                [outs["o"], outs["p"], outs["s"]])
    src = ["-c", str(d / f"{corpus}.i.fastq")]
    if mode == "interleaved_s":
        return src + ["-m", outs["o"], "-s", outs["s"]], [outs["o"], outs["s"]]
    if mode == "interleaved":
        return src + ["-m", outs["o"]], [outs["o"]]
    return src + ["-M", outs["o"]], [outs["o"]]


def read(path):
    with open(path, "rb") as f:
        return f.read()


def assert_same_run(want, got, want_files, got_files, what):
    assert got == want, what
    if want[0] == 0:
        for a, b in zip(want_files, got_files):
            assert read(b) == read(a), (what, b)


@pytest.mark.parametrize("flags", list(FLAGS), ids=list(FLAGS))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("corpus", list(CORPORA), ids=list(CORPORA))
def test_pe_matches_jax_package(corpus, mode, flags, corpus_dir,
                                capsysbinary):
    base = ["pe", "-t", "sanger"] + FLAGS[flags]
    argv, want_files = mode_argv(mode, corpus_dir, corpus, f"{flags}.jax")
    want = run(jax_cli.main, base + argv, capsysbinary)
    if corpus == "bad_in_scan":
        assert want[0] == 1 and b"does not fall within correct range" in want[2]
    else:
        assert want[0] == 0 and b"(1500 pairs)" in want[1]
    for cuts in ("device", "host"):
        argv, got_files = mode_argv(mode, corpus_dir, corpus, f"{flags}.{cuts}")
        got = run(port, base + argv + ["--cuts", cuts], capsysbinary)
        assert_same_run(want, got, want_files, got_files, cuts)


def test_fork_compat_names_each_input_file(corpus_dir, capsysbinary):
    """--compat fork prints "Building reader for <path>" once per input
    file, as the fork's reader constructor does."""
    for mode, n_inputs in (("two_file", 2), ("interleaved_s", 1)):
        argv, _ = mode_argv(mode, corpus_dir, "2x150", "readers")
        rc, out, _ = run(port, ["pe", "-t", "sanger", "--compat", "fork"]
                         + argv, capsysbinary)
        assert rc == 0
        lines = [ln for ln in out.decode().splitlines()
                 if ln.startswith("Building reader for ")]
        assert lines == [f"Building reader for {p}"
                         for p in argv[1:2 * n_inputs:2]]


def _compress(src, dst, codec):
    data = read(src)
    if codec == "bgzf":
        w = BgzfWriter(dst)
        w.write(data)
        w.close()
    else:
        with gzip.open(dst, "wb") as g:
            g.write(data)


@pytest.mark.parametrize("codec", ["bgzf", "gzip"])
@pytest.mark.parametrize("mode", ["two_file", "interleaved_s"])
def test_gzip_input_matches_jax_package(mode, codec, corpus_dir,
                                        capsysbinary):
    """BGZF input takes the zero-copy block-parallel producer (interleaved:
    with the pair alignment), serial gzip the chunked reader."""
    for suffix in ("1", "2", "i"):
        _compress(corpus_dir / f"ragged.{suffix}.fastq",
                  corpus_dir / f"gzin_{codec}.{suffix}.fastq", codec)
    corpus = f"gzin_{codec}"
    base = ["pe", "-t", "sanger"]
    argv, want_files = mode_argv(mode, corpus_dir, corpus, "jax")
    want = run(jax_cli.main, base + argv, capsysbinary)
    assert want[0] == 0
    argv, got_files = mode_argv(mode, corpus_dir, corpus, "port")
    got = run(port, base + argv, capsysbinary)
    assert_same_run(want, got, want_files, got_files, codec)


@pytest.mark.parametrize("mode", ["two_file", "n_records"])
def test_gzip_output_and_metrics(mode, corpus_dir, capsysbinary):
    argv, want_files = mode_argv(mode, corpus_dir, "ragged", "gzout.jax")
    assert run(jax_cli.main, ["pe", "-t", "sanger"] + argv,
               capsysbinary)[0] == 0
    argv, got_files = mode_argv(mode, corpus_dir, "ragged", "gzout.port")
    rc, _, err = run(port, ["pe", "-t", "sanger", "-g", "--metrics"] + argv,
                     capsysbinary)
    assert rc == 0 and b"metrics: " in err
    for a, b in zip(want_files, got_files):
        with gzip.open(b, "rb") as g:
            assert g.read() == read(a)


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gzip"])
def test_mismatched_mate_counts(gz, corpus_dir, capsysbinary):
    """A mate file with fewer records: the reference's message and exit
    code, from the mmap producer (plain) and the chunked reader (gzip)."""
    short = corpus_dir / f"short.{gz}.2.fastq"
    lines = read(corpus_dir / "2x150.2.fastq").split(b"\n")
    data = b"\n".join(lines[: 4 * (N_PAIRS - 3)]) + b"\n"
    if gz:
        with gzip.open(short, "wb") as g:
            g.write(data)
    else:
        short.write_bytes(data)
    argv = ["pe", "-t", "sanger", "-f", str(corpus_dir / "2x150.1.fastq"),
            "-r", str(short)]
    outs = lambda t: ["-o", str(corpus_dir / f"mm.{t}.o"),  # noqa: E731
                      "-p", str(corpus_dir / f"mm.{t}.p"),
                      "-s", str(corpus_dir / f"mm.{t}.s")]
    want = run(jax_cli.main, argv + outs("jax"), capsysbinary)
    assert want[0] != 0
    assert b"Batch2 and Batch1 have different lengths, exiting" in want[2]
    for cuts in ("device", "host"):
        got = run(port, argv + outs(cuts) + ["--cuts", cuts], capsysbinary)
        assert got == want, cuts


def test_odd_interleaved_file(corpus_dir, capsysbinary):
    odd = corpus_dir / "odd.i.fastq"
    lines = read(corpus_dir / "2x150.i.fastq").split(b"\n")
    odd.write_bytes(b"\n".join(lines[: 4 * 101]) + b"\n")
    argv = ["pe", "-t", "sanger", "-c", str(odd)]
    want = run(jax_cli.main, argv + ["-m", str(corpus_dir / "odd.jax")],
               capsysbinary)
    assert want[0] != 0 and b"Maybe it's not an interleaved file?" in want[2]
    got = run(port, argv + ["-m", str(corpus_dir / "odd.port")], capsysbinary)
    assert got == want


@pytest.mark.parametrize("argv", [
    ["pe"], ["pe", "--help"],
    ["pe", "-f", "a", "-r", "b", "-o", "c", "-p", "d", "-s", "e"],
    ["pe", "-t", "phred", "-c", "a", "-m", "b"],
    ["pe", "-t", "sanger"],
    ["pe", "-t", "sanger", "-c", "a", "-f", "b", "-m", "c"],
    ["pe", "-t", "sanger", "-c", "a", "-o", "c"],
    ["pe", "-t", "sanger", "-c", "a", "-s", "c"],
    ["pe", "-t", "sanger", "-c", "a", "-M", "b", "-s", "c"],
    ["pe", "-t", "sanger", "-f", "a", "-r", "b", "-o", "c", "-p", "d"],
    ["pe", "-t", "sanger", "-f", "a", "-o", "c", "-p", "d", "-s", "e"],
    ["pe", "-t", "sanger", "-f", "a", "-r", "b", "-o", "c", "-p", "d",
     "-s", "e", "-m", "f"],
    ["pe", "-t", "sanger", "-f", "a", "-r", "b", "-o", "c", "-p", "d",
     "-s", "e", "-M", "f"],
    ["pe", "-t", "sanger", "-c", "a", "-m", "b", "-q", "-1"],
    ["pe", "-t", "sanger", "-c", "a", "-m", "b", "-l", "-1"],
    ["pe", "-t", "sanger", "-c", "a", "-m", "b", "--cuts", "gpu"],
    ["pe", "-t", "sanger", "-c", "a", "-m", "b", "--bogus"],
    ["pe", "-t", "sanger", "-c", "missing.fastq", "-m", "b", "--cuts",
     "host"],
    ["pe", "-t", "sanger", "-f", "missing.1", "-r", "missing.2", "-o", "c",
     "-p", "d", "-s", "e", "--cuts", "host"],
])
def test_pe_usage_and_errors_match(argv, tmp_path, monkeypatch,
                                   capsysbinary):
    monkeypatch.chdir(tmp_path)
    want = run(jax_cli.main, argv, capsysbinary)
    got = run(port, argv, capsysbinary)
    assert got == want


def _grow_pairs(n_chunks, per_chunk):
    """Two mate files whose mate-2 reads grow longer chunk by chunk, so
    the combined batch's row stride overflows (split route) on the first
    chunks, and a steady tail packs combined again."""
    b1, b2 = io.BytesIO(), io.BytesIO()
    for k in range(n_chunks):
        grow = min(k, n_chunks - 3)
        write_pairs(b1, b2, 50 + k, per_chunk, first=k * per_chunk,
                    mate1=dict(length=(30, 60)),
                    mate2=dict(length=(40, 70 + 24 * grow)),
                    n_rate=0.01, bad_tail=0.01)
    return b1.getvalue(), b2.getvalue()


@pytest.mark.parametrize("cuts", ["device", "host"])
def test_run_pe_many_chunks_both_routes(cuts, tmp_path):
    """Engine level: many small chunks from regular files take both the
    combined and the split device-batch route; held to the oracle."""
    from sickle_tpu_torch.ops.trim_host import host_cuts_fn

    d1, d2 = _grow_pairs(8, 96)
    (tmp_path / "1.fastq").write_bytes(d1)
    (tmp_path / "2.fastq").write_bytes(d2)
    params = TrimParams(qualtype=QualityType.SANGER, trunc_n=True)
    fn = (_cuda_cuts_fn(params, "cpu") if cuts == "device"
          else host_cuts_fn(params))
    mtr = Metrics()
    o1, o2, so = io.BytesIO(), io.BytesIO(), io.BytesIO()
    with open(tmp_path / "1.fastq", "rb") as f1, \
            open(tmp_path / "2.fastq", "rb") as f2:
        c = run_pe(f1, f2, out1=o1, out2=o2, singles_out=so, params=params,
                   cfg=EngineConfig(records_per_chunk=96, metrics=mtr),
                   cuts_fn=fn)
    assert mtr.routes.get("split", 0) >= 3 and mtr.routes.get("combined", 0) >= 2
    w1, w2, ws, wc = oracle.trim_pe(d1, d2, qualtype=QualityType.SANGER,
                                    trunc_n=True)
    assert (o1.getvalue(), o2.getvalue(), so.getvalue()) == (w1, w2, ws)
    assert dataclasses.asdict(c) == dataclasses.asdict(wc)


def test_bgzf_interleaved_pairs_span_windows(tmp_path, monkeypatch):
    """Interleaved pe over BGZF with 1-block windows: the odd-record carry
    must keep pairs whole across window boundaries, byte-exactly."""
    rng = np.random.default_rng(13)
    recs = []
    for i in range(40):  # ~27 KB records vs 48 KB windows: frequent odd cuts
        L = 9000 + (i % 5) * 11
        seq = rng.choice(list(b"ACGT"), L).astype(np.uint8).tobytes()
        q = rng.integers(33 + 25, 33 + 41, L).astype(np.uint8).tobytes()
        recs.append(b"@m%d/%d\n%s\n+\n%s\n" % (i // 2, i % 2 + 1, seq, q))
    data = b"".join(recs)
    gz = tmp_path / "inter.fastq.gz"
    w = BgzfWriter(str(gz))
    w.write(data)
    w.close()

    params = TrimParams(qualtype=QualityType.SANGER)
    want1, _, wants, wc = oracle.trim_pe(data, interleaved=True,
                                         qualtype=QualityType.SANGER)
    monkeypatch.setattr(BgzfReader, "WINDOW_BLOCKS", 1)
    o1, so = io.BytesIO(), io.BytesIO()
    with open_input(str(gz)) as fin:
        assert isinstance(fin, BgzfReader)
        c = run_pe(fin, None, interleaved=True, out1=o1, singles_out=so,
                   params=params, cfg=EngineConfig(records_per_chunk=8),
                   cuts_fn=_cuda_cuts_fn(params, "cpu"))
    assert o1.getvalue() == want1
    assert so.getvalue() == wants
    assert c.total == wc.total == 40


# -- the zero-copy two-file BGZF producer ------------------------------------

def _bgzf_file(path, data):
    w = BgzfWriter(str(path))
    w.write(data)
    w.close()
    return path


def _renamed_mate2(data):
    """Mate-2 records whose headers are 240 bytes longer than mate 1's."""
    lines = data.split(b"\n")
    for k in range(0, len(lines) - 1, 4):
        lines[k] += b" 2:N:0:" + b"ACGT+" * 48
    return b"\n".join(lines)


def _pairs(n, **kw):
    b1, b2 = io.BytesIO(), io.BytesIO()
    write_pairs(b1, b2, 71, n, chunk=500, **kw)
    return b1.getvalue(), b2.getvalue()


def _long_mate2_headers():
    d1, d2 = _pairs(1200, length=150, bad_tail=0.01)
    return d1, _renamed_mate2(d2)


def _unequal():
    d1, d2 = _pairs(700, length=(60, 150), bad_tail=0.01)
    return d1, b"\n".join(d2.split(b"\n")[: 4 * 697]) + b"\n"


ZERO_COPY_CASES = {
    # name: (mate 1, mate 2, records_per_chunk)
    "long_mate2_headers": (_long_mate2_headers, 256),
    "ragged_growth": (lambda: _grow_pairs(8, 96), 96),
    "unterminated": (lambda: tuple(d[:-1] for d in _pairs(
        900, length=(40, 150), n_rate=0.01)), 64),
    "chunk_8": (lambda: _pairs(300, length=(30, 160), bad_tail=0.01), 8),
    "chunk_65536": (lambda: _pairs(3000, mate1=dict(length=150),
                                   mate2=dict(length=100)), 65536),
    "unequal": (_unequal, 64),
}


def _run_zero_copy(tmp_path, d1, d2, cfg, params):
    """run_pe over two BGZF mate files; (outputs, counters or the error)."""
    f1 = _bgzf_file(tmp_path / "m1.fastq.gz", d1)
    f2 = _bgzf_file(tmp_path / "m2.fastq.gz", d2)
    o1, o2, so = io.BytesIO(), io.BytesIO(), io.BytesIO()
    with open_input(str(f1)) as in1, open_input(str(f2)) as in2:
        assert isinstance(in1, BgzfReader) and isinstance(in2, BgzfReader)
        try:
            c = run_pe(in1, in2, out1=o1, out2=o2, singles_out=so,
                       params=params, cfg=cfg,
                       cuts_fn=_cuda_cuts_fn(params, "cpu", cfg.slice_rows))
        except oracle.FastqValidationError as e:
            c = e
    return (o1.getvalue(), o2.getvalue(), so.getvalue()), c


@pytest.mark.parametrize("case", list(ZERO_COPY_CASES))
def test_bgzf_two_file_zero_copy_matches_oracle(case, tmp_path, monkeypatch,
                                                capsysbinary):
    """Two BGZF mate files take the zero-copy producer: one-block windows
    cut records in both mates at different places, and every output,
    counter and error equals the oracle's."""
    from sickle_tpu_torch.engine import pipeline

    make, per_chunk = ZERO_COPY_CASES[case]
    d1, d2 = make()
    monkeypatch.setattr(BgzfReader, "WINDOW_BLOCKS", 1)
    calls = []
    pack = pipeline.pack_fastq_stream

    def counted(*a, **kw):
        calls.append(a[1])
        return pack(*a, **kw)

    monkeypatch.setattr(pipeline, "pack_fastq_stream", counted)
    params = TrimParams(qualtype=QualityType.SANGER, trunc_n=True)
    mtr = Metrics()
    cfg = EngineConfig(records_per_chunk=per_chunk, slice_rows=64,
                       metrics=mtr)
    outs, c = _run_zero_copy(tmp_path, d1, d2, cfg, params)
    chunks = mtr.counters["pair_zero_copy_chunks"]
    assert chunks > 0
    if case == "unequal":
        with pytest.raises(oracle.FastqValidationError) as want:
            oracle.trim_pe(d1, d2, qualtype=QualityType.SANGER, trunc_n=True)
        assert str(c) == str(want.value) == (
            "Batch2 and Batch1 have different lengths, exiting")
        # the CLI: the reference's message and exit code, as the JAX CLI
        f1, f2 = tmp_path / "m1.fastq.gz", tmp_path / "m2.fastq.gz"
        argv = ["pe", "-t", "sanger", "-f", str(f1), "-r", str(f2)]
        outs = lambda t: ["-o", str(tmp_path / f"{t}.o"),  # noqa: E731
                          "-p", str(tmp_path / f"{t}.p"),
                          "-s", str(tmp_path / f"{t}.s")]
        want = run(jax_cli.main, argv + outs("jax"), capsysbinary)
        assert want[0] == 1
        assert run(port, argv + outs("port"), capsysbinary) == want
        return
    w1, w2, ws, wc = oracle.trim_pe(d1, d2, qualtype=QualityType.SANGER,
                                    trunc_n=True)
    assert outs == (w1, w2, ws)
    assert dataclasses.asdict(c) == dataclasses.asdict(wc)
    assert chunks == sum(mtr.routes.values())
    assert mtr.counters["read_bytes"] == len(d1) + len(d2)
    if case == "long_mate2_headers":
        # mate 2 ran short of mate 1's count mid-chunk and was packed again
        assert len(calls) > 2 * chunks
    if case == "ragged_growth":
        assert mtr.routes.get("split", 0) >= 1
        assert mtr.routes.get("combined", 0) >= 1


def _plain_file(path, data):
    path.write_bytes(data)
    return path


def _gzip_file(path, data):
    with gzip.open(path, "wb") as g:
        g.write(data)
    return path


@pytest.mark.parametrize("route", ["plain", "gzip", "mixed", "checkpoint"])
def test_two_file_inputs_keep_their_producers(route, tmp_path):
    """Plain mate files keep the mapped producer, serial gzip, a BGZF and
    plain pair and a checkpoint resume the chunked reader: none packs a
    zero-copy BGZF chunk, and all write the oracle's bytes."""
    d1, d2 = _pairs(600, length=(40, 150), bad_tail=0.01)
    make1, make2 = {"plain": (_plain_file, _plain_file),
                    "gzip": (_gzip_file, _gzip_file),
                    "mixed": (_bgzf_file, _plain_file),
                    "checkpoint": (_bgzf_file, _bgzf_file)}[route]
    skip = 2 * 150 if route == "checkpoint" else 0
    f1 = make1(tmp_path / "m1.in", d1)
    f2 = make2(tmp_path / "m2.in", d2)
    params = TrimParams(qualtype=QualityType.SANGER)
    mtr = Metrics()
    o1, o2, so = io.BytesIO(), io.BytesIO(), io.BytesIO()
    with open_input(str(f1)) as in1, open_input(str(f2)) as in2:
        run_pe(in1, in2, out1=o1, out2=o2, singles_out=so, params=params,
               cfg=EngineConfig(records_per_chunk=128, slice_rows=64,
                                skip_records=skip, metrics=mtr),
               cuts_fn=_cuda_cuts_fn(params, "cpu", 64))
    assert mtr.counters.get("pair_zero_copy_chunks", 0) == 0
    assert mtr.counters.get("carry_bytes", 0) == 0
    cut = lambda d: b"\n".join(d.split(b"\n")[2 * skip:])  # noqa: E731
    w1, w2, ws, _ = oracle.trim_pe(cut(d1), cut(d2),
                                   qualtype=QualityType.SANGER)
    assert (o1.getvalue(), o2.getvalue(), so.getvalue()) == (w1, w2, ws)


class _FailingSink(io.BytesIO):
    def write(self, b):
        if self.tell():
            raise OSError("sink closed")
        return super().write(b)


@pytest.mark.parametrize("sink", ["fails", "clean"])
def test_zero_copy_windows_come_back(sink, tmp_path, monkeypatch):
    """A writer that fails mid-run ends run_pe with its error, and no
    hang; after a clean run no window of either mate is left pinned."""
    from sickle_tpu_torch.engine import pipeline

    made = []

    class Recorded(pipeline._BgzfSource):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(pipeline, "_BgzfSource", Recorded)
    monkeypatch.setattr(BgzfReader, "WINDOW_BLOCKS", 1)
    monkeypatch.setattr(pipeline._BgzfSource, "MAX_BUFFERS", 2)
    d1, d2 = _pairs(2000, length=150)
    params = TrimParams(qualtype=QualityType.SANGER)
    cfg = EngineConfig(records_per_chunk=32, slice_rows=64)
    out1 = _FailingSink() if sink == "fails" else io.BytesIO()
    result = []

    def go():
        f1 = _bgzf_file(tmp_path / "m1.fastq.gz", d1)
        f2 = _bgzf_file(tmp_path / "m2.fastq.gz", d2)
        try:
            with open_input(str(f1)) as in1, open_input(str(f2)) as in2:
                result.append(run_pe(
                    in1, in2, out1=out1, out2=io.BytesIO(),
                    singles_out=io.BytesIO(), params=params, cfg=cfg,
                    cuts_fn=_cuda_cuts_fn(params, "cpu", 64)))
        except Exception as e:  # noqa: BLE001 — the test reads it
            result.append(e)

    t = threading.Thread(target=go, daemon=True)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive(), "run_pe hung"
    assert len(made) == 2
    if sink == "fails":
        assert isinstance(result[0], OSError)
        assert str(result[0]) == "sink closed"
        return
    assert result[0].total == 4000
    # every buffer a source made is back in its free queue
    assert all(s.cur is None and s._free.qsize() == s._made for s in made)



@pytest.mark.parametrize("layout", ["se", "interleaved", "two_file"])
def test_bgzf_source_buffers_stay_bounded(layout, tmp_path, monkeypatch):
    """Every BGZF producer sizes a rotated buffer for the live bytes and
    a few inflate windows, however many windows the input holds, and
    writes the oracle's bytes."""
    from sickle_tpu_torch.engine import pipeline
    from sickle_tpu_torch.engine.pipeline import run_se

    sizes = []

    class Recorded(pipeline._BgzfSource):
        def _take_buffer(self, size):
            arr = super()._take_buffer(size)
            sizes.append(arr.size)
            return arr

    monkeypatch.setattr(pipeline, "_BgzfSource", Recorded)
    monkeypatch.setattr(BgzfReader, "WINDOW_BLOCKS", 1)
    d1, d2 = _pairs(6000, length=(60, 150), bad_tail=0.01)
    params = TrimParams(qualtype=QualityType.SANGER)
    cfg = EngineConfig(records_per_chunk=64, slice_rows=64)
    fn = _cuda_cuts_fn(params, "cpu", 64)
    o1, o2, so = io.BytesIO(), io.BytesIO(), io.BytesIO()
    if layout == "se":
        with open_input(str(_bgzf_file(tmp_path / "se.gz", d1))) as fin:
            run_se(fin, o1, params, cfg=cfg, cuts_fn=fn)
        want = (oracle.trim_se(d1, qualtype=QualityType.SANGER)[0],)
        got = (o1.getvalue(),)
    elif layout == "interleaved":
        def recs(d):
            lines = d.split(b"\n")
            return [b"\n".join(lines[k:k + 4]) + b"\n"
                    for k in range(0, len(lines) - 1, 4)]

        both = b"".join(r for pair in zip(recs(d1), recs(d2)) for r in pair)
        with open_input(str(_bgzf_file(tmp_path / "i.gz", both))) as fin:
            run_pe(fin, None, interleaved=True, out1=o1, singles_out=so,
                   params=params, cfg=cfg, cuts_fn=fn)
        w1, _, ws, _ = oracle.trim_pe(both, interleaved=True,
                                      qualtype=QualityType.SANGER)
        want, got = (w1, ws), (o1.getvalue(), so.getvalue())
    else:
        f1 = _bgzf_file(tmp_path / "m1.gz", d1)
        f2 = _bgzf_file(tmp_path / "m2.gz", d2)
        with open_input(str(f1)) as in1, open_input(str(f2)) as in2:
            run_pe(in1, in2, out1=o1, out2=o2, singles_out=so,
                   params=params, cfg=cfg, cuts_fn=fn)
        want = oracle.trim_pe(d1, d2, qualtype=QualityType.SANGER)[:3]
        got = (o1.getvalue(), o2.getvalue(), so.getvalue())
    assert got == tuple(want)
    window = 48 << 10  # one BGZF block's uncompressed bytes at most
    assert len(d1) > 20 * window and len(sizes) > 4
    assert max(sizes) <= (2 * pipeline._BgzfSource.WINDOWS + 2) * window

def test_bgzf_mate2_error_counts_its_own_lines(tmp_path, capsysbinary):
    """A malformed mate-2 record in BGZF input names its line in its own
    file, as the reference's two readers and the mapped producer do."""
    d1, d2 = _pairs(50, length=100)
    lines = d2.split(b"\n")
    lines[4 * 7] = b"Xbad"
    d2 = b"\n".join(lines)
    files = {}
    for ext, make in (("fq", _plain_file), ("gz", _bgzf_file)):
        files[ext] = [make(tmp_path / f"m{k}.{ext}", d)
                      for k, d in ((1, d1), (2, d2))]

    def argv(ext, tag):
        return ["pe", "-t", "sanger", "-f", str(files[ext][0]),
                "-r", str(files[ext][1]), "-o", str(tmp_path / f"{tag}.o"),
                "-p", str(tmp_path / f"{tag}.p"),
                "-s", str(tmp_path / f"{tag}.s")]

    want = run(jax_cli.main, argv("fq", "jax"), capsysbinary)
    assert want[0] == 1 and want[2].startswith(b"In Xbad(line 28)")
    assert run(port, argv("gz", "port"), capsysbinary) == want
