"""The yardstick's arithmetic: roofline bytes and shares, rates, tails and
the reduction of a device trace."""

import json
import os

import pytest

from trimbench import catalog, devtrace, readers, roofline

H100 = "NVIDIA H100 80GB HBM3"


def test_bits_per_base_is_what_the_symbols_need():
    assert roofline.bits_per_base(4) == 2      # NovaSeq's four bins
    assert roofline.bits_per_base(42) == 6     # Phred 0-41
    assert roofline.bits_per_base(2) == 1
    assert roofline.bits_per_base(64) == 6 and roofline.bits_per_base(65) == 7


def test_roofline_share():
    least = roofline.least_bytes(bases=300e6, reads=2e6, bits=2)
    assert least == 300e6 * 2 / 8 + 4 * 2e6
    # the least time is 83e6 / 3.35e12 s; a kernel that took ten times it
    kernel_s = 10 * least / 3.35e12
    assert roofline.share_pct(least, kernel_s, H100) == pytest.approx(10.0)
    assert roofline.share_pct(least, kernel_s, "another card") is None
    assert roofline.share_pct(least, 0.0, H100) is None


def _run(calls, trace=None, window_s=2.0):
    return readers.Run(card=H100, startup_s=1.5, setup_s=9.0,
                       window_s=window_s, bits_per_base=2, calls=calls,
                       trace=trace)


def _call(pairs, wall_s, metrics=None, rc=0):
    return readers.Call(0, pairs, pairs * 300, wall_s, rc, metrics)


def _metrics(pack_ms, consume_ms, h2d, dev, host, wall_ms):
    return {"pack": {"total_ms": pack_ms}, "consume": {"total_ms": consume_ms},
            "h2d_bytes": h2d, "wall_ms": wall_ms,
            "hybrid": {"chunks_device": dev, "chunks_host": host}}


def test_rates_count_completed_calls_over_the_whole_window():
    run = _run([_call(1000, 0.5), _call(1000, 0.5), _call(1000, 0.4, rc=1)])
    assert readers.rate_mbp_s(run) == pytest.approx(2 * 1000 * 300 / 2.0 / 1e6)
    assert readers.rate_mbp_s(_run([_call(1, 0.1, rc=None)])) is None


def test_per_base_readers_and_the_tail():
    calls = [_call(1000, 0.5, _metrics(30, 10, 75_000, 3, 1, 450)),
             _call(1000, 0.7, _metrics(50, 20, 75_000, 4, 0, 640))]
    run = _run(calls)
    bases = 2 * 1000 * 300
    assert readers.stage_ns_per_base(run, "pack") == pytest.approx(80e6 / bases)
    assert readers.stage_ns_per_base(run, "consume") == pytest.approx(30e6 / bases)
    assert readers.h2d_bytes_per_base(run) == pytest.approx(150_000 / bases)
    assert readers.device_chunk_share_pct(run) == pytest.approx(100 * 7 / 8)
    assert readers.mean_file_overhead_ms(run) == pytest.approx((50 + 60) / 2)
    assert readers.percentile_wall_ms(run, 95) == pytest.approx(700)
    walls = [_call(1, w / 1000) for w in range(1, 101)]
    assert readers.percentile_wall_ms(_run(walls), 95) == pytest.approx(95)


def test_kernel_roofline_counts_the_reads_the_card_trimmed():
    calls = [_call(1000, 0.5, _metrics(1, 1, 1, 3, 1, 400))]
    least = 0.75 * roofline.least_bytes(300_000, 2000, 2)
    trace = {"busy_s": 0.1, "window_s": 2.0,
             "ops": [("void trim_cuts_tiled<1>", least / 3.35e12 * 20),
                     ("Memcpy HtoD", 0.05)], "gaps": []}
    run = _run(calls, trace)
    assert readers.cuts_kernel_roofline_pct(run) == pytest.approx(5.0)
    assert readers.device_idle_pct(run) == pytest.approx(95.0)
    assert readers.cuts_kernel_roofline_pct(_run(calls)) is None


def _ev(name, cat, ts, dur, tid=None):
    event = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if tid is not None:
        event.update(pid=1, tid=tid)
    return event


# the program's own spans: on the call's thread (1) one nests in another
# over the last gap's middle; one on a worker thread (2) covers the first's
SPANS = [_ev("engine", "user_annotation", 8000, 3000, tid=1),
         _ev("wait.write_q_put", "user_annotation", 10_000, 500, tid=1),
         _ev("consume", "user_annotation", 1200, 600, tid=2)]


@pytest.mark.parametrize("spans", [False, True])
def test_trace_reduction_takes_the_union_inside_the_window(tmp_path, spans):
    tid = 1 if spans else None
    events = [
        _ev(devtrace.WINDOW, "user_annotation", 1000, 10_000, tid),
        _ev(devtrace.CALL + "sample 2", "user_annotation", 1000, 3000, tid),
        _ev(devtrace.CALL + "sample 5", "user_annotation", 8000, 3000, tid),
        _ev("trim_cuts_tiled", "kernel", 2000, 1000),
        _ev("Memcpy HtoD", "gpu_memcpy", 2500, 1000),   # overlaps the kernel
        _ev("trim_cuts_tiled", "kernel", 9000, 500),
        _ev("before the window", "kernel", 0, 500),
        _ev(devtrace.WINDOW, "gpu_user_annotation", 1000, 10_000),
    ] + (SPANS if spans else [])
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = devtrace.reduce(str(path))
    assert got["window_s"] == pytest.approx(0.010)
    assert got["busy_s"] == pytest.approx(0.002)  # 2000-3500 and 9000-9500
    assert dict(got["ops"]) == pytest.approx(
        {"trim_cuts_tiled": 0.0015, "Memcpy HtoD": 0.001})
    assert got["gaps"][0] == ("host between cli.main calls", pytest.approx(0.0055))
    # the innermost span on the call's thread at the gap's middle (10,250)
    assert got["gaps"][1] == ("wait.write_q_put" if spans else
                              "host in cli.main (sample 5)",
                              pytest.approx(0.0015))
    # a span of another thread does not name the gap
    assert got["gaps"][2] == ("host in cli.main (sample 2)", pytest.approx(0.001))


def test_a_cell_reports_its_own_metrics():
    bench = catalog.benchmark()
    for cell in (w["name"] for w in bench["workloads"]):
        e2e = {e["name"] for e in catalog.cell_metrics(bench, cell, False)}
        layer = catalog.cell_metrics(bench, cell, True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        assert all(e["moves"] in e2e for e in layer)


def test_the_drain_and_the_program_get_apart_cores():
    from trimbench import run

    program, drain = run.split_cores()
    cores = os.sched_getaffinity(0)
    assert set(program) | set(drain) == cores
    assert len(drain) == 1
    assert not set(program) & set(drain) or len(cores) == 1
