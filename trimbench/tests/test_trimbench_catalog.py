"""A later cell comes as files and entries alone: a configuration, a traffic
mix and a per-layer metric dropped into a copy of the benchmark are found
by name and run, with no file of the harness edited: another paired-end
configuration, a pooled traffic mix, and a single-end configuration."""

import json
import shutil
import subprocess
import sys

import pytest

from trimbench import catalog

from .helpers import NEW_CELLS, STREAM, add_cell

ROOT = catalog.ROOT
METRIC = '''"""Calls completed in the window."""

LAYER = "per-file loop"
UNIT = "calls"
MOVES = "bases_per_s"
WORKLOADS = [{cell!r}]


def read(run):
    return len(run.calls)
'''


@pytest.mark.parametrize("shape", sorted(NEW_CELLS))
def test_files_and_entries_make_a_new_cell(tmp_path, shape):
    shutil.copytree(ROOT / "trimbench", tmp_path / "trimbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "sickle_tpu_torch").symlink_to(ROOT / "sickle_tpu_torch")
    bench = catalog.benchmark()
    here = tmp_path / "trimbench"

    cell = add_cell(bench, tmp_path, shape)
    (here / "metrics" / "calls_in_window.py").write_text(
        METRIC.format(cell=cell))
    bench["per_layer"].append({"name": "calls_in_window", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "per-file loop",
                               "moves": "bases_per_s",
                               "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    code = ("import json; from trimbench import catalog, run; "
            "print(json.dumps(run.run_cell(catalog.benchmark(), "
            f"{cell!r}, 17, 0.5, True, 'cpu', scale={NEW_CELLS[shape][3]})))")
    done = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    line = json.loads(done.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, done.stderr[-3000:]
    assert line["metrics"]["calls_in_window"]["value"] == line["attempted"]
    assert "pack_ns_per_base.stream" not in line["metrics"]
    assert "window: " in done.stderr and str(tmp_path) not in done.stdout


def test_metric_files_declare_what_benchmark_json_says():
    bench = catalog.benchmark()
    for entry in bench["end_to_end"] + bench["per_layer"]:
        module = catalog.metric(entry["name"])
        assert module.UNIT == entry["unit"]
        if entry in bench["per_layer"]:
            assert module.LAYER == entry["layer"]
            assert module.MOVES == entry["moves"]
            assert module.WORKLOADS == entry["workloads"]
    for entry in bench["workloads"]:
        cfg = catalog.config(bench, entry["config"])
        assert cfg["name"] == entry["config"]
        assert catalog.traffic(entry["traffic"])["name"] == entry["traffic"]
    for entry in bench["configs"]:
        cfg = json.loads((ROOT / entry["file"]).read_text())
        assert cfg["reduced"] == entry["reduced"]
        assert all(key in cfg and key in cfg["published"]
                   for key in entry["reduced"])
    assert STREAM in {w["name"] for w in bench["workloads"]}
