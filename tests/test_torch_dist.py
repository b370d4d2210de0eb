"""The port's ``--dist`` against the JAX package's, exactly.

* The record-aligned shard helpers (``parallel/dist.py``) give the JAX
  package's byte ranges on plain, BGZF and mixed inputs, for 2, 3, 5 and
  8 shards, record- and pair-aligned, including offsets that land on a
  quality line starting with ``@``.
* The engine's shard bounds (``EngineConfig.byte_limit/byte_limit2``):
  ``run_se``/``run_pe`` over each shard's range, on the mmap, chunked
  stream and BGZF producers, concatenate to the whole run's bytes.
* Two-process gloo clusters, each process ``cli.main(argv,
  device="cpu")`` with ``--dist``: the shards concatenated equal the
  port's single-process output and ``sickle_tpu``'s; rank 0 prints the
  single-process summary exactly and rank 1 prints nothing; serial gzip
  is refused with the JAX text; a rank that fails fails the run.

All outputs are bytes or integers: tolerance 0.  Every subprocess has a
timeout, so a hung rendezvous fails its test instead of stalling the run.
"""

import gzip
import io
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

import sickle_tpu.cli as jax_cli
from sickle_tpu.parallel import dist as jdist
import sickle_tpu_torch.cli as torch_cli
from sickle_tpu_torch.engine import EngineConfig, run_pe, run_se
from sickle_tpu_torch.engine.pipeline import _cuda_cuts_fn
from sickle_tpu_torch.io import native
from sickle_tpu_torch.io.compression import BgzfWriter, open_input
from sickle_tpu_torch.ops import TrimParams
from sickle_tpu_torch.parallel import dist as tdist
from sickle_tpu_torch.utils.corpus import write_fastq, write_pairs

REPO = pathlib.Path(__file__).resolve().parents[1]
CLUSTER_TIMEOUT = 60  # seconds per process of a cluster run
N_READS = 9000  # se reads; pe files hold N_READS // 2 pairs
SERIAL_GZIP_ERROR = (
    "****Error: multi-host runs need plain or BGZF (block-splittable) "
    "input; serial gzip inputs must be pre-sharded per host ('{}').\n\n")

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="needs the native host library")


def _bgzf_copy(src, dst):
    w = BgzfWriter(str(dst))
    w.write(pathlib.Path(src).read_bytes())
    w.close()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_dist")
    with open(d / "se.fastq", "wb") as f:
        write_fastq(f, 71, N_READS, chunk=3000, length=(30, 160),
                    bad_tail=0.01, n_rate=0.01)
    with open(d / "pe.1.fastq", "wb") as f1, open(d / "pe.2.fastq", "wb") as f2:
        write_pairs(f1, f2, 72, N_READS // 2, mate1=dict(length=150),
                    mate2=dict(length=(30, 160)), bad_tail=0.01)
    with open(d / "il.fastq", "wb") as f:
        write_pairs(f, None, 73, N_READS // 2, length=(30, 160), binned=True)
    for name in ("se", "pe.1", "pe.2", "il"):
        _bgzf_copy(d / f"{name}.fastq", d / f"{name}.fastq.gz")
    with open(d / "se.fastq", "rb") as f, gzip.open(d / "serial.fastq.gz",
                                                   "wb") as g:
        g.write(f.read())
    return d


# -- shard helpers ---------------------------------------------------------

def _records(data: bytes) -> int:
    return data.count(b"\n") // 4


@pytest.mark.parametrize("align", [1, 2])
@pytest.mark.parametrize("n", [2, 3, 5, 8])
@pytest.mark.parametrize("kind", ["plain", "bgzf"])
def test_shard_record_ranges_match_jax(kind, n, align, corpus):
    path = corpus / ("il.fastq" + (".gz" if kind == "bgzf" else ""))
    data = (corpus / "il.fastq").read_bytes()
    want = jdist.shard_record_ranges(path, n, align=align)
    got = tdist.shard_record_ranges(path, n, align=align)
    assert got == want
    assert tdist.split_record_ranges(path, n) == jdist.split_record_ranges(path, n)
    pos = 0
    for off, length in got:  # the ranges tile the file on record bounds
        assert off == pos
        shard = data[off : off + length]
        if shard:
            assert shard.startswith(b"@r") and _records(shard) % align == 0
        pos = off + length
    assert pos == len(data)


@pytest.mark.parametrize("n", [2, 3, 5, 8])
@pytest.mark.parametrize("mix", ["plain", "bgzf", "mixed"])
def test_shard_paired_ranges_match_jax(mix, n, corpus):
    p1 = corpus / ("pe.1.fastq" + (".gz" if mix != "plain" else ""))
    p2 = corpus / ("pe.2.fastq" + (".gz" if mix == "bgzf" else ""))
    got = tdist.shard_paired_ranges(p1, p2, n)
    assert got == jdist.shard_paired_ranges(p1, p2, n)
    d1 = (corpus / "pe.1.fastq").read_bytes()
    d2 = (corpus / "pe.2.fastq").read_bytes()
    for (o1, l1), (o2, l2) in got:  # both halves hold the same mates
        s1, s2 = d1[o1 : o1 + l1], d2[o2 : o2 + l2]
        assert _records(s1) == _records(s2)
        if s1:
            assert s1.split(b"\n", 1)[0] == s2.split(b"\n", 1)[0]


@pytest.mark.parametrize("kind", ["plain", "bgzf"])
def test_realign_matches_jax_at_quality_lines_starting_with_at(kind, corpus):
    """Offsets on and just before quality lines that begin with '@' (a
    Sanger Q31), and random offsets, realign to the same record start."""
    data = (corpus / "se.fastq").read_bytes()
    path = corpus / ("se.fastq" + (".gz" if kind == "bgzf" else ""))
    lines = data.split(b"\n")
    starts = np.cumsum([0] + [len(ln) + 1 for ln in lines[:-1]])
    at_qual = [int(starts[i]) for i in range(3, len(lines) - 1, 4)
               if lines[i][:1] == b"@"]
    assert len(at_qual) > 20
    rng = np.random.default_rng(5)
    offsets = (at_qual[:40] + [o - 2 for o in at_qual[:40]]
               + [o - 1 for o in at_qual[:10]]
               + rng.integers(1, len(data) - 1000, 40).tolist())
    for off in offsets:
        want = jdist.realign_to_record(path, off)
        assert tdist.realign_to_record(path, off) == want, off
        assert data[want : want + 2] == b"@r" and data[want - 1:want] == b"\n"


def test_realign_skips_an_at_quality_line(tmp_path):
    rec1 = b"@r1\nACGTACGT\n+\n@IIIIIII\n"  # the quality line starts with '@'
    rec2 = b"@r2\nACGTACGT\n+\nIIIIIIII\n"
    path = tmp_path / "x.fastq"
    path.write_bytes(rec1 + rec2)
    off = rec1.find(b"@I")
    assert tdist.realign_to_record(path, off) == len(rec1)
    assert jdist.realign_to_record(path, off) == len(rec1)


def test_host_file_shard_and_serial_gzip_match_jax(corpus):
    paths = [f"f{i}.fastq" for i in range(7)]
    for n in (1, 2, 3):
        for pid in range(n):
            assert (tdist.host_file_shard(paths, pid, n)
                    == jdist.host_file_shard(paths, pid, n))
    # no process group: this process is the only one
    assert tdist.host_file_shard(paths) == jdist.host_file_shard(paths) == paths
    serial = corpus / "serial.fastq.gz"
    with pytest.raises(ValueError) as je:
        jdist.shard_record_ranges(serial, 2)
    with pytest.raises(ValueError) as te:
        tdist.shard_record_ranges(serial, 2)
    assert str(te.value) == str(je.value)


# -- the engine's shard bounds ---------------------------------------------

PARAMS = TrimParams(qual_threshold=20)


def _cfg(**kw):
    return EngineConfig(records_per_chunk=1024, slice_rows=512, **kw)


def _open(path, kind):
    """The input stream the producer under test reads: a regular file
    (mmap producer), an in-memory stream (chunked reader) or a BGZF
    reader (zero-copy BGZF producer; two-file pe: chunked over it)."""
    if kind == "stream":
        return io.BytesIO(pathlib.Path(path).read_bytes())
    return open_input(str(path) + (".gz" if kind == "bgzf" else ""))


@pytest.mark.parametrize("kind", ["mmap", "stream", "bgzf"])
def test_run_se_shards_concatenate_to_the_whole_run(kind, corpus):
    path = corpus / "se.fastq"
    data = path.read_bytes()
    whole = io.BytesIO()
    with _open(path, kind) as f:
        c = run_se(f, whole, PARAMS, cfg=_cfg(),
                   cuts_fn=_cuda_cuts_fn(PARAMS, "cpu", 512))
    parts, total, kept = [], 0, 0
    for off, length in tdist.shard_record_ranges(path, 3):
        out = io.BytesIO()
        with _open(path, kind) as f:
            f.seek(off)
            cs = run_se(f, out, PARAMS, cfg=_cfg(byte_limit=length),
                        cuts_fn=_cuda_cuts_fn(PARAMS, "cpu", 512))
        assert cs.total == _records(data[off : off + length])
        parts.append(out.getvalue())
        total, kept = total + cs.total, kept + cs.kept
    assert b"".join(parts) == whole.getvalue()
    assert (total, kept) == (c.total, c.kept) == (N_READS, c.kept)


def _pe_run(layout, kind, corpus, limits=None):
    """(outputs, counters) of one run_pe over the corpus, from offsets
    ``limits = ((off1, len1), (off2, len2))`` or over the whole input."""
    outs = [io.BytesIO() for _ in range(3)]
    cfg = _cfg()
    if limits is not None:
        cfg.byte_limit, cfg.byte_limit2 = limits[0][1], limits[1][1]
    cuts = _cuda_cuts_fn(PARAMS, "cpu", 512)
    if layout == "interleaved":
        with _open(corpus / "il.fastq", kind) as f:
            if limits is not None:
                f.seek(limits[0][0])
            c = run_pe(f, None, interleaved=True, out1=outs[0],
                       singles_out=outs[2], params=PARAMS, cfg=cfg,
                       cuts_fn=cuts)
    else:
        with _open(corpus / "pe.1.fastq", kind) as f1, \
                _open(corpus / "pe.2.fastq", kind) as f2:
            if limits is not None:
                f1.seek(limits[0][0])
                f2.seek(limits[1][0])
            c = run_pe(f1, f2, out1=outs[0], out2=outs[1],
                       singles_out=outs[2], params=PARAMS, cfg=cfg,
                       cuts_fn=cuts)
    return [o.getvalue() for o in outs], c


@pytest.mark.parametrize("kind", ["mmap", "stream", "bgzf"])
@pytest.mark.parametrize("layout", ["interleaved", "two_file"])
def test_run_pe_shards_concatenate_to_the_whole_run(layout, kind, corpus):
    whole, c = _pe_run(layout, kind, corpus)
    if layout == "interleaved":
        ranges = [(r, (0, None)) for r in
                  tdist.shard_record_ranges(corpus / "il.fastq", 3, align=2)]
    else:
        ranges = tdist.shard_paired_ranges(corpus / "pe.1.fastq",
                                           corpus / "pe.2.fastq", 3)
    parts, totals = [], []
    for limits in ranges:
        outs, cs = _pe_run(layout, kind, corpus, limits)
        parts.append(outs)
        totals.append(cs.total)
    for k in range(3):
        assert b"".join(p[k] for p in parts) == whole[k]
    assert sum(totals) == c.total == N_READS and min(totals) > 0


# -- two-process clusters --------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_MAIN = ("import sys; from sickle_tpu_torch.cli import main; "
         "sys.exit(main(sys.argv[1:], device='cpu'))")


def _cluster(argv, cwd, n=2):
    """Run the port's CLI on ``argv`` with --dist in ``n`` processes;
    returns [(rc, stdout, stderr)] by rank."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("SICKLE_TPU_")}
    env["PYTHONPATH"] = str(REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _MAIN, *argv, "--dist", "--coordinator",
         f"127.0.0.1:{port}", "--num-processes", str(n), "--process-id",
         str(rank)], cwd=cwd, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for rank in range(n)]
    res = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=CLUSTER_TIMEOUT)
            res.append((p.returncode, out.decode(), err.decode()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return res


def _single(main, argv, capsysbinary):
    capsysbinary.readouterr()
    rc = main(argv)
    out, err = capsysbinary.readouterr()
    assert rc == 0, err
    return out.decode()


CASES = {
    # name: (argv without outputs, output flags, port-only flags)
    "se_plain": (["se", "-f", "se.fastq"], ["-o"],
                 ["--cuts", "device", "--profile", "prof"]),
    "se_bgzf": (["se", "-f", "se.fastq.gz"], ["-o"], []),
    "pe_two_file": (["pe", "-f", "pe.1.fastq", "-r", "pe.2.fastq"],
                    ["-o", "-p", "-s"], ["--cuts", "hybrid"]),
    "pe_two_file_bgzf": (["pe", "-f", "pe.1.fastq.gz", "-r", "pe.2.fastq"],
                         ["-o", "-p", "-s"], ["--cuts", "host"]),
    "pe_interleaved_m": (["pe", "-c", "il.fastq"], ["-m", "-s"],
                         ["--cuts", "device"]),
    "pe_interleaved_M": (["pe", "-c", "il.fastq.gz"], ["-M"], []),
    "se_checkpoint": (["se", "-f", "se.fastq"], ["-o"],
                      ["--cuts", "device", "--checkpoint", "ck.json"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_two_process_run_matches_single_process(case, corpus, tmp_path,
                                                monkeypatch, capsysbinary):
    args, out_flags, extra = CASES[case]
    for name in os.listdir(corpus):
        os.symlink(corpus / name, tmp_path / name)
    monkeypatch.chdir(tmp_path)
    base = args + ["-t", "sanger", "-b", "1"]

    def outs(tag):
        return [f"{tag}.{flag[1]}.fastq" for flag in out_flags]

    def with_outs(tag):
        return base + [x for f, o in zip(out_flags, outs(tag)) for x in (f, o)]

    want = _single(jax_cli.main, with_outs("jax"), capsysbinary)
    for var in ("SICKLE_TPU_CUTS", "SICKLE_TPU_HYBRID"):
        monkeypatch.delenv(var, raising=False)  # set by the JAX --cuts flag
    cuts = extra[extra.index("--cuts"):][:2] if "--cuts" in extra else []
    one = _single(lambda a: torch_cli.main(a, device="cpu"),
                  with_outs("one") + cuts, capsysbinary)
    assert one == want
    runs = 2 if case == "se_checkpoint" else 1  # the second run resumes
    for _ in range(runs):
        res = _cluster(with_outs("dist") + extra, tmp_path)
        assert [r[0] for r in res] == [0, 0], [r[2][-2000:] for r in res]
        assert res[0][1] == want  # rank 0: the merged summary, exactly
        assert res[1][1] == ""  # rank 1: nothing on stdout
        for o_jax, o_one, o_dist in zip(outs("jax"), outs("one"), outs("dist")):
            shards = [pathlib.Path(f"{o_dist}.shard{r}").read_bytes()
                      for r in range(2)]
            assert not os.path.exists(o_dist)
            assert b"".join(shards) == pathlib.Path(o_one).read_bytes()
            assert b"".join(shards) == pathlib.Path(o_jax).read_bytes()
    if case == "se_checkpoint":  # one sidecar per process
        assert os.path.exists("ck.json.host0") and os.path.exists("ck.json.host1")
        assert not os.path.exists("ck.json")
    if case == "se_plain":  # one trace per process
        assert sorted(os.listdir("prof")) == ["trace.rank0.json",
                                              "trace.rank1.json"]


def test_serial_gzip_is_refused_with_the_jax_text(corpus, tmp_path):
    src = str(corpus / "serial.fastq.gz")
    res = _cluster(["se", "-f", src, "-t", "sanger", "-o", "o.fastq",
                    "--cuts", "device"], tmp_path)
    for rc, out, err in res:
        assert rc == 1 and out == ""
        assert SERIAL_GZIP_ERROR.format(src) in err
    assert not list(tmp_path.iterdir())


def test_a_failed_rank_fails_the_run(corpus, tmp_path):
    """Rank 1's shard holds a record the reference rejects: rank 1 exits
    with the reference's message, and rank 0 exits 1 at the counter merge
    instead of waiting for a peer that is gone."""
    data = bytearray((corpus / "se.fastq").read_bytes())
    at = data.index(b"\n+\n", len(data) * 3 // 4) + 3
    data[at] = 0x01  # first quality char of a record in the last quarter
    (tmp_path / "bad.fastq").write_bytes(bytes(data))
    res = _cluster(["se", "-f", "bad.fastq", "-t", "sanger", "-o", "o.fastq",
                    "--cuts", "device"], tmp_path)
    assert res[1][0] == 1
    assert "does not fall within correct range" in res[1][2]
    assert res[0][0] == 1 and res[0][1] == ""
    assert "lost a peer process before the counter merge" in res[0][2]
