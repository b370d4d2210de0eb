"""The result line holds the contract's keys and nothing else, and a run
that cannot measure prints none."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from trimbench import catalog

from .helpers import PLATE, STREAM, tiny_run

ROOT = catalog.ROOT


@pytest.mark.parametrize("trace", [False, True])
def test_the_line_has_only_the_contract_keys(trace):
    line = tiny_run(STREAM, trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if trace else []) + ["checks"]
    device = {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["device"]) == device | ({"busy_s", "window_s"}
                                            if trace else set())
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    names = {e["name"] for e in catalog.cell_metrics(catalog.benchmark(),
                                                     STREAM, trace)}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == {"bases_per_s", "setup_s"}
    else:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(line["breakdown"]["idle_gaps"]) <= 10
    assert set(line["checks"]) == {"wrong_records", "wrong_summaries",
                                   "failed_calls"}
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    json.loads(json.dumps(line))


def test_the_plate_reports_its_per_file_metrics():
    line = tiny_run(PLATE, True)
    assert {"startup_s", "file_overhead_ms", "sample_wall_p95_ms",
            "pack_ns_per_base.plate"} <= set(line["metrics"])
    assert not any(m.endswith(".stream") for m in line["metrics"])


def _main(cwd):
    return subprocess.run(
        [sys.executable, "-m", "trimbench.run", "--workload", STREAM,
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_without_a_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    done = _main(ROOT)
    assert done.returncode != 0 and done.stdout == ""


def test_without_the_program_no_result(tmp_path):
    shutil.copytree(ROOT / "trimbench", tmp_path / "trimbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    done = _main(tmp_path)
    assert done.returncode != 0 and done.stdout == ""
