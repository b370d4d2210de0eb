"""Checkpoint/resume on the port (SURVEY.md §5.3): restartable runs.

Mirrors the JAX package's ``tests/test_checkpoint.py`` on the port's
seeded corpora: an interrupted run, resumed, writes the same bytes as a
straight run (plain and BGZF ``-g`` output, se and two-file pe), and
every output also equals what the JAX CLI writes for the same command
without ``--checkpoint``.
"""

import dataclasses
import gzip
import io

import pytest

import sickle_tpu.cli as jax_cli
import sickle_tpu_torch.cli as torch_cli
import sickle_tpu_torch.engine.checkpoint as ckmod
from sickle_tpu_torch.constants import Compat, QualityType
from sickle_tpu_torch.engine import EngineConfig, run_pe, run_se
from sickle_tpu_torch.engine.checkpoint import (
    TrimCheckpoint,
    progress_saver,
    resume_outputs,
)
from sickle_tpu_torch.engine.pipeline import _cuda_cuts_fn
from sickle_tpu_torch.io.compression import BgzfWriter
from sickle_tpu_torch.oracle import PECounters, SECounters
from sickle_tpu_torch.ops import TrimParams
from sickle_tpu_torch.utils.corpus import write_fastq, write_pairs

N_SE = 2500
N_PE = 1200
# the CLI's smallest chunk is 4,096 records (se) or pairs (pe) (-b 1)
N_CLI_SE = 10_000
N_CLI_PE = 10_000
SE_FLAGS = ["-t", "sanger", "-q", "30", "--compat", "fork"]


def params30():
    return TrimParams(qualtype=QualityType.SANGER, qual_threshold=30)


def device_fn():
    return _cuda_cuts_fn(params30(), "cpu")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_ck")
    with open(d / "se.fastq", "wb") as f:
        write_fastq(f, 31, N_SE, chunk=900, length=(30, 160), n_rate=0.01,
                    bad_tail=0.01)
    with open(d / "pe.1.fastq", "wb") as f1, open(d / "pe.2.fastq", "wb") as f2:
        write_pairs(f1, f2, 32, N_PE, chunk=500, mate1=dict(length=150),
                    mate2=dict(length=(30, 160)), bad_tail=0.01)
    with open(d / "cli.fastq", "wb") as f:
        write_fastq(f, 33, N_CLI_SE, length=(30, 100), bad_tail=0.01)
    with open(d / "cli.1.fastq", "wb") as f1, \
            open(d / "cli.2.fastq", "wb") as f2:
        write_pairs(f1, f2, 34, N_CLI_PE // 2, length=(30, 100),
                    bad_tail=0.01)
    return d


def run(main, argv, capsysbinary):
    capsysbinary.readouterr()
    rc = main(argv)
    out, err = capsysbinary.readouterr()
    return rc, out, err


def port(argv):
    return torch_cli.main(argv, device="cpu")


def read(path):
    with open(path, "rb") as f:
        return f.read()


def _skip_offset(data: bytes, skip: int) -> int:
    offset = 0
    for _ in range(skip * 4):
        offset = data.index(b"\n", offset) + 1
    return offset


def _crash_after(saver, n):
    chunks = {"n": 0}

    def cb(counters):
        saver(counters)
        chunks["n"] += 1
        if chunks["n"] == n:
            raise RuntimeError("simulated crash")

    return cb


def test_engine_resume_midway(data, tmp_path, capsysbinary):
    src = read(data / "se.fastq")
    p = params30()
    cfg = lambda **kw: EngineConfig(records_per_chunk=256,  # noqa: E731
                                    compat=Compat.FORK, **kw)
    golden = io.BytesIO()
    want = run_se(io.BytesIO(src), golden, p, cfg=cfg(), cuts_fn=device_fn())
    jax_out = str(tmp_path / "jax.fastq")
    assert run(jax_cli.main, ["se", "-f", str(data / "se.fastq"), "-o",
                              jax_out] + SE_FLAGS, capsysbinary)[0] == 0
    assert golden.getvalue() == read(jax_out)

    out_path = str(tmp_path / "out.fastq")
    ck = TrimCheckpoint(str(tmp_path / "ck.json"))
    out = open(out_path, "w+b")
    crashing = _crash_after(progress_saver(ck, dataclasses.asdict,
                                           {out_path: out}), 3)
    with pytest.raises(RuntimeError):
        run_se(io.BytesIO(src), out, p, cfg=cfg(progress_cb=crashing),
               cuts_fn=device_fn())
    out.write(b"GARBAGE-PARTIAL-CHUNK")  # a half-written later chunk
    out.close()

    st = ck.load()
    assert st is not None and 0 < st.records_done < N_SE
    out = open(out_path, "r+b")
    resume_outputs(st, {out_path: out})
    got = run_se(io.BytesIO(src), out, p,
                 cfg=cfg(skip_records=st.records_done,
                         progress_cb=progress_saver(ck, dataclasses.asdict,
                                                    {out_path: out})),
                 cuts_fn=device_fn(), counters=SECounters(**st.counters))
    out.close()
    assert read(out_path) == golden.getvalue()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert ck.load().records_done == N_SE


@pytest.mark.parametrize("inputs", ["streams", "files"])
def test_engine_resume_pe_two_file(inputs, data, tmp_path, capsysbinary):
    """Resume from the halfway pair: from in-memory streams (the chunked
    reader) and from regular files (the mmap producer's fast-forward)."""
    f1, f2 = read(data / "pe.1.fastq"), read(data / "pe.2.fastq")
    p = params30()
    cfg = lambda **kw: EngineConfig(records_per_chunk=128,  # noqa: E731
                                    compat=Compat.FORK, **kw)

    def open_pair(a, b):
        if inputs == "streams":
            return io.BytesIO(a), io.BytesIO(b)
        (tmp_path / "a.fastq").write_bytes(a)
        (tmp_path / "b.fastq").write_bytes(b)
        return open(tmp_path / "a.fastq", "rb"), open(tmp_path / "b.fastq", "rb")

    def trim(a, b, outs, **kw):
        i1, i2 = open_pair(a, b)
        with i1, i2:
            return run_pe(i1, i2, out1=outs[0], out2=outs[1],
                          singles_out=outs[2], params=p, cuts_fn=device_fn(),
                          **kw)

    full = [io.BytesIO() for _ in range(3)]
    want = trim(f1, f2, full, cfg=cfg())
    jax_outs = [str(tmp_path / f"jax.{k}") for k in "ops"]
    assert run(jax_cli.main, [
        "pe", "-f", str(data / "pe.1.fastq"), "-r", str(data / "pe.2.fastq"),
        "-o", jax_outs[0], "-p", jax_outs[1], "-s", jax_outs[2],
    ] + SE_FLAGS, capsysbinary)[0] == 0
    assert [b.getvalue() for b in full] == [read(x) for x in jax_outs]

    half = 600
    head = [io.BytesIO() for _ in range(3)]
    c_head = trim(f1[: _skip_offset(f1, half)], f2[: _skip_offset(f2, half)],
                  head, cfg=cfg())
    c = trim(f1, f2, head, cfg=cfg(skip_records=2 * half),
             counters=PECounters(**dataclasses.asdict(c_head)))
    assert [b.getvalue() for b in head] == [b.getvalue() for b in full]
    assert dataclasses.asdict(c) == dataclasses.asdict(want)


def test_pe_skip_records_must_be_even(data):
    with pytest.raises(ValueError, match="even"):
        run_pe(io.BytesIO(b""), io.BytesIO(b""), out1=io.BytesIO(),
               out2=io.BytesIO(), singles_out=io.BytesIO(),
               params=params30(), cfg=EngineConfig(skip_records=3),
               cuts_fn=device_fn())


def _cli_cases(data, tmp_path, gz):
    """{name: (argv without outputs, output flags for a tag)}"""
    ext = ".gz" if gz else ""
    return {
        "se": (["se", "-f", str(data / "cli.fastq")] + SE_FLAGS + ["-b", "1"],
               lambda t: ["-o", str(tmp_path / f"se.{t}.fastq{ext}")]),
        "pe": (["pe", "-f", str(data / "cli.1.fastq"), "-r",
                str(data / "cli.2.fastq")] + SE_FLAGS + ["-b", "1"],
               lambda t: [x for k in "ops" for x in
                          (f"-{k}", str(tmp_path / f"pe.{t}.{k}.fastq{ext}"))]),
    }


def _paths(outs):
    return outs[1::2]


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gzip"])
@pytest.mark.parametrize("cmd", ["se", "pe"])
def test_cli_checkpoint_interrupted_and_resumed(cmd, gz, data, tmp_path,
                                                monkeypatch, capsysbinary):
    """The CLI dies after its first chunk; the same command, run again,
    resumes from the sidecar.  Its outputs equal a straight checkpointed
    run's byte for byte (``-g``: the same BGZF members), and, decompressed,
    the JAX CLI's output without ``--checkpoint``."""
    base, outs = _cli_cases(data, tmp_path, gz)[cmd]
    g = ["-g"] if gz else []
    jax = outs("jax")
    jax_plain = [o[: -len(".gz")] if gz and o.endswith(".gz") else o
                 for o in jax]
    want = run(jax_cli.main, base + jax_plain, capsysbinary)
    assert want[0] == 0

    straight = outs("straight")
    ck0 = str(tmp_path / f"{cmd}.straight.ck")
    assert run(port, base + straight + g + ["--checkpoint", ck0],
               capsysbinary) == want

    resumed = outs("resumed")
    ck = str(tmp_path / f"{cmd}.resumed.ck")
    saver = ckmod.progress_saver
    monkeypatch.setattr(ckmod, "progress_saver",
                        lambda *a, **kw: _crash_after(saver(*a, **kw), 1))
    with pytest.raises(RuntimeError, match="simulated crash"):
        port(base + resumed + g + ["--checkpoint", ck])
    monkeypatch.setattr(ckmod, "progress_saver", saver)
    st = TrimCheckpoint(ck).load()
    total = N_CLI_SE if cmd == "se" else N_CLI_PE
    assert st is not None and 0 < st.records_done < total
    assert run(port, base + resumed + g + ["--checkpoint", ck],
               capsysbinary) == want
    assert TrimCheckpoint(ck).load().records_done == total
    for a, b, j in zip(_paths(straight), _paths(resumed), _paths(jax_plain)):
        assert read(b) == read(a)
        assert (gzip.decompress(read(b)) if gz else read(b)) == read(j)

    # re-running a completed run is an idempotent no-op with the full
    # summary (the resume analog of trim_all's skip-if-exists)
    assert run(port, base + resumed + g + ["--checkpoint", ck],
               capsysbinary) == want
    for a, b in zip(_paths(straight), _paths(resumed)):
        assert read(b) == read(a)


def test_gzip_checkpoint_resume_byte_identical(data, tmp_path):
    """-g + --checkpoint at engine level: BgzfWriter flushes whole gzip
    members at every progress callback, so a recorded size is a valid
    truncation point; kill/resume reproduces the straight checkpointed
    run's .gz bytes exactly and the plain run's decompressed bytes."""
    src = read(data / "se.fastq")
    p = params30()

    def cfg_with(cb=None, skip=0):
        return EngineConfig(records_per_chunk=256, compat=Compat.FORK,
                            progress_cb=cb, skip_records=skip)

    golden = io.BytesIO()
    want = run_se(io.BytesIO(src), golden, p, cfg=cfg_with(),
                  cuts_fn=device_fn())

    straight = str(tmp_path / "straight.fastq.gz")
    out = BgzfWriter(straight, resumable=True)
    run_se(io.BytesIO(src), out, p,
           cfg=cfg_with(progress_saver(TrimCheckpoint(str(tmp_path / "ck0")),
                                       dataclasses.asdict, {straight: out})),
           cuts_fn=device_fn())
    out.close()

    out_path = str(tmp_path / "out.fastq.gz")
    ck = TrimCheckpoint(str(tmp_path / "ck.json"))
    out = BgzfWriter(out_path, resumable=True)
    crashing = _crash_after(progress_saver(ck, dataclasses.asdict,
                                           {out_path: out}), 3)
    with pytest.raises(RuntimeError):
        run_se(io.BytesIO(src), out, p, cfg=cfg_with(crashing),
               cuts_fn=device_fn())
    out._f.write(b"GARBAGE-PARTIAL-MEMBER")  # post-checkpoint debris
    out._f.close()

    st = ck.load()
    assert st is not None and 0 < st.records_done < N_SE
    out = BgzfWriter(out_path, resumable=True)
    resume_outputs(st, {out_path: out})
    got = run_se(io.BytesIO(src), out, p,
                 cfg=cfg_with(progress_saver(ck, dataclasses.asdict,
                                             {out_path: out}),
                              skip=st.records_done),
                 cuts_fn=device_fn(), counters=SECounters(**st.counters))
    out.close()

    resumed = read(out_path)
    assert resumed == read(straight)  # exact .gz bytes
    assert gzip.decompress(resumed) == golden.getvalue()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
