"""The port's spans and counters under ``--metrics`` (``utils/metrics.py``):
every span of every engine thread on a two-file BGZF pe call, their nesting,
the stage aggregates they replace, their place in a ``torch.profiler`` trace,
nothing at all without ``--metrics``, and the process's start-up spans."""

import contextlib
import io
import json
import os
import sys
import threading
from unittest import mock

import pytest
import torch

from sickle_tpu_torch import cli
from sickle_tpu_torch.io.compression import BgzfWriter
from sickle_tpu_torch.ops import trim_cuda
from sickle_tpu_torch.utils import corpus, metrics
from sickle_tpu_torch.utils.metrics import Metrics

PAIRS = 10000
# 4,096 pairs a chunk (-b 1): three chunks
ARGS = ["pe", "-t", "sanger", "-g", "-b", "1", "-a", "2"]
FLUSH_BYTES = 256 << 10  # several flushes mid-run, and one at close

# the spans of each thread; the router's only where it runs
CALL = ("call.parse", "call.build_cuts_fn", "call.open_outputs", "engine",
        "call.close_outputs", "call.close_cuts_fn")
PRODUCER = ("read", "inflate", "pack", "prep", "wait.workspace",
            "wait.pack_q_put")
MAIN = ("wait.pack_q", "dispatch", "fetch", "wait.write_q_put",
        "wait.writer_join")
WRITER = ("wait.write_q", "consume", "recheck", "assemble", "bgzf.buffer",
          "bgzf.flush", "compress", "sink.write")
ENV = ("SICKLE_TPU_CUTS", "SICKLE_TPU_HYBRID", "SICKLE_TPU_NO_PLANES",
       "SICKLE_TPU_WINDOW", "SICKLE_TPU_NO_NATIVE")
COUNTERS = ("read_bytes", "inflated_bytes", "deflate_in_bytes",
            "deflate_out_bytes", "sink_bytes")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("spans")
    mates = [io.BytesIO(), io.BytesIO()]
    corpus.write_pairs(*mates, 31, PAIRS, length=150)
    paths = []
    for k, m in enumerate(mates, 1):
        path = str(d / f"r{k}.fq.gz")
        w = BgzfWriter(path)
        w.write(m.getvalue())
        w.close()
        paths.append(path)
    return d, paths


def _call(d, paths, tag, extra=()):
    """One ``cli.main`` pe call: (rc, stderr, output bytes)."""
    outs = [str(d / f"{tag}.{k}.gz") for k in ("o", "p", "s")]
    argv = ARGS + ["-f", paths[0], "-r", paths[1], "-o", outs[0], "-p",
                   outs[1], "-s", outs[2], *extra]
    err = io.StringIO()
    # the --cuts default, whatever an earlier in-process run left in the
    # environment (the JAX CLI's --cuts host sets SICKLE_TPU_CUTS)
    env = {k: v for k, v in os.environ.items() if k not in ENV}
    with (mock.patch.dict(os.environ, env, clear=True),
          mock.patch.object(BgzfWriter, "FLUSH_BYTES", FLUSH_BYTES),
          contextlib.redirect_stderr(err), contextlib.redirect_stdout(
              io.TextIOWrapper(io.BytesIO()))):
        rc = cli.main(argv, device="cpu")
    blobs = []
    for o in outs:
        with open(o, "rb") as f:
            blobs.append(f.read())
    return rc, err.getvalue(), blobs


def _summary(err: str) -> dict:
    line = [x for x in err.splitlines() if x.startswith("metrics: ")][-1]
    return json.loads(line[len("metrics: "):])


@pytest.fixture(scope="module")
def traced(inputs):
    """The --metrics call: its summary, its recorder and its outputs."""
    d, paths = inputs
    kept = []
    report = Metrics.report

    def keep(self, *a, **kw):
        kept.append(self)
        return report(self, *a, **kw)

    with mock.patch.object(Metrics, "report", keep):
        rc, err, blobs = _call(d, paths, "metrics", ["--metrics"])
    assert rc == 0, err[-2000:]
    assert len(kept) == 1 and metrics._CURRENT is None  # slot cleared
    return _summary(err), kept[0], blobs


def test_every_span_of_every_thread_is_recorded(traced):
    summary, _, _ = traced
    spans = summary["spans"]
    hybrid = summary["hybrid"]  # --cuts auto: the router
    want = list(CALL + PRODUCER + MAIN + WRITER)
    if hybrid["chunks_device"]:
        want += ["router.device", "wait.device_q"]
    if hybrid["chunks_host"]:
        want.append("router.host")
    missing = [name for name in want if spans.get(name, {}).get("n", 0) < 1]
    assert not missing, missing
    assert all(summary["counters"][c] > 0 for c in COUNTERS)
    c = summary["counters"]
    assert c["read_bytes"] == c["inflated_bytes"] == summary["in_bytes"]
    assert c["deflate_out_bytes"] == c["sink_bytes"]
    # the zero-copy two-file producer packed every chunk; a window rotation
    # copies at most what was live
    assert c["pair_zero_copy_chunks"] == sum(summary["routes"].values()) >= 3
    assert 0 <= c["carry_bytes"] < c["read_bytes"]


def test_spans_nest_on_their_thread(traced):
    summary, mtr, _ = traced
    by_id = {s[0]: s for s in mtr.spans}
    threads = {}
    for sid, name, tid, t0, t1, parent, _ in mtr.spans:
        assert t0 <= t1, name
        threads.setdefault(tid, []).append((t0, -t1, name))
        if parent is not None:
            p = by_id[parent]
            assert p[2] == tid and p[3] <= t0 and t1 <= p[4], (name, p[1])
    assert len(threads) >= 4  # call/main, producer, writer, router
    for tid, spans in threads.items():
        open_ends = []
        for t0, neg_t1, name in sorted(spans):
            while open_ends and open_ends[-1] <= t0:
                open_ends.pop()
            # inside every span still open: nested, never partly over
            assert not open_ends or -neg_t1 <= open_ends[-1], name
            open_ends.append(-neg_t1)
    for name, row in summary["spans"].items():
        assert 0 <= row["self_ms"] <= row["total_ms"], name
    # every window refill of either mate is a read span holding its inflate
    inflates = [s for s in mtr.spans if s[1] == "inflate"]
    assert len(inflates) >= 2
    assert all(by_id[s[5]][1] == "read" for s in inflates)
    # compress and sink.write lie inside a flush, in-run and at close
    parents = {by_id[s[5]][1] for s in mtr.spans
               if s[1] == "bgzf.flush" and s[5] is not None}
    assert parents == {"consume", "call.close_outputs"}
    for s in mtr.spans:
        if s[1] in ("compress", "sink.write") and s[5] is not None:
            assert by_id[s[5]][1] in ("bgzf.flush", "call.close_outputs")


def test_stage_aggregates_are_the_stage_spans(traced):
    summary, mtr, _ = traced
    for stage in metrics.STAGES:
        row = summary["spans"][stage]
        assert summary[stage]["total_ms"] == pytest.approx(
            row["total_ms"], abs=0.01), stage
        assert row["n"] == len(mtr.stage_ms(stage))
    assert summary["chunks"] == summary["spans"]["pack"]["n"] >= 3
    assert summary["spans"]["dispatch"]["n"] == sum(
        summary["routes"].values())
    assert summary["records"] == 2 * PAIRS
    for gone in ("stalled", "out_bytes"):
        assert gone not in summary
    # wall_ms runs from the recorder's start to the outputs' close
    assert summary["wall_ms"] >= summary["spans"]["engine"]["total_ms"] - 0.01


def _annotations(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"
            and e.get("ph") == "X"]


@pytest.mark.parametrize("profiler", ["program", "caller"])
def test_spans_land_in_the_profiler_trace(inputs, tmp_path, profiler):
    """``--profile`` records every engine thread; a profiler the caller
    started records the spans of the calling (main) thread."""
    d, paths = inputs
    main = threading.get_native_id()
    if profiler == "program":
        rc, err, _ = _call(d, paths, profiler,
                           ["--metrics", "--profile", str(tmp_path)])
        trace = tmp_path / "trace.json"
    else:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU]) as prof:
            rc, err, _ = _call(d, paths, profiler, ["--metrics"])
        trace = tmp_path / "caller.json"
        prof.export_chrome_trace(str(trace))
    assert rc == 0, err[-2000:]
    events = _annotations(trace)
    tids = {}
    for e in events:
        tids.setdefault(e["name"], set()).add(e["tid"])
    for name in ("wait.pack_q", "dispatch", "fetch", "wait.writer_join"):
        assert main in tids[name], name
    if profiler == "caller":
        return
    assert "engine" not in tids or main in tids["engine"]
    producer = tids["pack"]
    writer = tids["consume"]
    assert len(producer) == len(writer) == 1
    assert len({main, *producer, *writer}) == 3
    assert tids["read"] == tids["inflate"] == producer
    flushes = [e for e in events if e["name"] == "bgzf.flush"]
    for c in (e for e in events if e["name"] == "compress"):
        assert any(f["tid"] == c["tid"] and f["ts"] <= c["ts"]
                   and c["ts"] + c["dur"] <= f["ts"] + f["dur"] + 1
                   for f in flushes)
    # the flushes at close come after --profile's window
    assert 0 < sum(e["name"] == "compress" for e in events) < _summary(
        err)["spans"]["compress"]["n"]


def test_without_metrics_nothing_is_recorded(inputs, traced):
    d, paths = inputs
    from torch.profiler import ProfilerActivity, profile

    def refuse(*a, **kw):
        raise AssertionError("a span was entered without --metrics")

    with (mock.patch.object(metrics._Span, "__enter__", refuse),
          mock.patch.object(torch.profiler, "record_function", refuse),
          mock.patch.object(Metrics, "__init__", refuse),
          profile(activities=[ProfilerActivity.CPU])):
        rc, err, blobs = _call(d, paths, "plain")
    assert rc == 0, err[-2000:]
    assert "metrics: " not in err
    assert blobs == traced[2]


@pytest.mark.parametrize("built", [0, 1])
def test_start_up_spans_are_process_wide(inputs, tmp_path, monkeypatch,
                                         built):
    """``load.native`` and ``load.cuts_kernel`` (here a stand-in compiler
    and loader, as no CUDA toolkit is on a CPU host) with their ``built``
    counters, in every --metrics summary."""
    d, paths = inputs
    monkeypatch.delitem(metrics.PROCESS, "load.cuts_kernel", raising=False)
    monkeypatch.setattr(trim_cuda, "_lib", None)
    monkeypatch.setattr(trim_cuda, "BUILD_LOG", "")
    monkeypatch.setattr(trim_cuda, "_BUILD_DIR", tmp_path)
    lib = tmp_path / "libtrim_cuts.so"
    monkeypatch.setattr(trim_cuda, "_LIB_PATH", lib)
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'wb').close()\n")
    nvcc.chmod(0o755)
    if not built:
        lib.write_bytes(b"")
        newer = os.stat(trim_cuda.SOURCE).st_mtime + 10
        os.utime(lib, (newer, newer))
    with monkeypatch.context() as m:
        m.setattr(trim_cuda, "_nvcc", lambda: str(nvcc))
        m.setattr(trim_cuda.ctypes, "CDLL", lambda path: mock.MagicMock())
        trim_cuda.build()
    rc, err, _ = _call(d, paths, f"process{built}", ["--metrics"])
    assert rc == 0, err[-2000:]
    process = _summary(err)["process"]
    assert process["load.cuts_kernel"]["built"] == built
    assert process["load.cuts_kernel"]["ms"] >= 0
    assert process["load.native"]["built"] in (0, 1)
    assert "load.cuda_context" not in process  # no card, no context


def test_spans_keep_their_parent_and_self_time():
    m = Metrics()
    with m.span("outer"):
        with m.span("inner"):
            pass
        with m.span("inner"):
            pass
    done = threading.Event()

    def other():
        with m.span("outer"):
            done.set()

    t = threading.Thread(target=other)
    t.start()
    t.join()
    m.count("bytes", 3)
    m.count("bytes", 4)
    table = m.span_table()
    assert table["outer"]["n"] == 2 and table["inner"]["n"] == 2
    by_name = {}
    for s in m.spans:
        by_name.setdefault(s[1], []).append(s)
    outer_main = next(s for s in by_name["outer"] if s[5] is None
                      and s[2] == threading.get_native_id())
    assert all(s[5] == outer_main[0] for s in by_name["inner"])
    inner = sum(s[4] - s[3] for s in by_name["inner"])
    outer = sum(s[4] - s[3] for s in by_name["outer"])
    assert table["outer"]["self_ms"] == pytest.approx(
        (outer - inner) / 1e6, abs=2e-3)
    assert m.counters == {"bytes": 7}
    assert metrics.span("x") is metrics._NULL  # no recorder installed
    metrics.count("x", 1)  # a no-op
