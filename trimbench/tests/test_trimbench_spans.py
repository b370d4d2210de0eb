"""The readers of the program's spans, on synthetic runs, and on a tiny traced
run of each cell."""

import pytest

from trimbench import catalog, readers, spans

from .helpers import CELLS, PLATE, POOLED, STREAM, tiny_run

H100 = "NVIDIA H100 80GB HBM3"
SPAN_METRICS = {
    STREAM: ["read_ns_per_base.stream", "compress_ns_per_base.stream",
             "dispatch_starved_share.stream",
             "writer_backpressure_share.stream"],
    PLATE: ["compress_ns_per_base.plate", "output_close_ms.plate",
            "dispatch_starved_share.plate",
            "writer_backpressure_share.plate"],
    # the pooled pair is trimmed whole, as the lane is: the lane's readers
    # and a close of its own
    POOLED: ["compress_ns_per_base.stream", "output_close_ms.pooled",
             "dispatch_starved_share.stream",
             "writer_backpressure_share.stream"],
}


def _run(calls):
    return readers.Run(card=H100, startup_s=1.5, setup_s=9.0, window_s=2.0,
                       bits_per_base=2, calls=calls)


def _call(pairs, table, rc=0):
    metrics = None if table is None else {"wall_ms": 1.0, "spans": {
        name: {"n": 1, "total_ms": ms, "self_ms": ms}
        for name, ms in table.items()}}
    return readers.Call(0, pairs, pairs * 300, 0.5, rc, metrics)


def _read(name, run):
    return catalog.metric(name).read(run)


def test_span_readers_add_over_the_calls():
    a = {"engine": 400.0, "read": 30.0, "compress": 50.0, "wait.pack_q": 40.0,
         "wait.write_q_put": 100.0, "wait.writer_join": 20.0,
         "call.close_outputs": 12.0}
    b = {"engine": 600.0, "read": 10.0, "compress": 70.0, "wait.pack_q": 60.0,
         "wait.write_q_put": 80.0, "call.close_outputs": 18.0}
    run = _run([_call(1000, a), _call(1000, b),
                _call(1000, {"engine": 9e9}, rc=1)])  # failed: not counted
    bases = 2 * 1000 * 300
    for cell in ("stream", "plate"):
        assert _read(f"compress_ns_per_base.{cell}", run) == pytest.approx(
            120e6 / bases)
        assert _read(f"dispatch_starved_share.{cell}", run) == pytest.approx(
            100 * 100 / 1000)
        assert _read(f"writer_backpressure_share.{cell}",
                     run) == pytest.approx(100 * 200 / 1000)
    assert _read("read_ns_per_base.stream", run) == pytest.approx(40e6 / bases)
    assert _read("output_close_ms.plate", run) == pytest.approx(15.0)
    assert _read("output_close_ms.pooled", run) == pytest.approx(15.0)


def test_span_readers_read_nothing_where_no_span_is():
    # the parent program: summaries without a span table, or no summary
    old = _run([readers.Call(0, 1000, 300_000, 0.5, 0, {"wall_ms": 1.0}),
                _call(1000, None)])
    # a table without the spans the metrics read
    bare = _run([_call(1000, {"pack": 5.0})])
    for run in (old, bare, _run([])):
        for names in SPAN_METRICS.values():
            for name in names:
                assert _read(name, run) is None, name
    assert spans.share_pct(_run([_call(10, {"engine": 0.0,
                                            "wait.pack_q": 0.0})]),
                           ["wait.pack_q"], "engine") is None


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_the_span_metrics(cell):
    line = tiny_run(cell, trace=True)
    assert line["correct"] is True
    for name in SPAN_METRICS[cell]:
        assert name in line["metrics"], name
        value = line["metrics"][name]["value"]
        assert value >= 0
        if name.split(".")[0].endswith("share"):
            assert value <= 100
