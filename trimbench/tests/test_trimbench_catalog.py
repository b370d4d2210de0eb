"""A later cell comes as files and entries alone: a configuration, a traffic
mix and a per-layer metric dropped into a copy of the benchmark are found
by name and run, with no file of the harness edited."""

import json
import shutil
import subprocess
import sys

from trimbench import catalog

from .helpers import STREAM

ROOT = catalog.ROOT
NEW_CELL = "wgs_pe100.plain_pair"
METRIC = '''"""Calls completed in the window."""

LAYER = "per-file loop"
UNIT = "calls"
MOVES = "bases_per_s"
WORKLOADS = ["wgs_pe100.plain_pair"]


def read(run):
    return len(run.calls)
'''


def test_files_and_entries_make_a_new_cell(tmp_path):
    shutil.copytree(ROOT / "trimbench", tmp_path / "trimbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "sickle_tpu_torch").symlink_to(ROOT / "sickle_tpu_torch")
    bench = catalog.benchmark()
    here = tmp_path / "trimbench"

    cfg = json.loads((here / "configs" / "wgs_pe150.json").read_text())
    cfg.update(name="wgs_pe100", read_length=[100, 100])
    (here / "configs" / "wgs_pe100.json").write_text(json.dumps(cfg))
    mix = json.loads((here / "traffic" / "plate.json").read_text())
    mix.update(name="plain_pair", flags=["-g", "-q", "25"])
    (here / "traffic" / "plain_pair.json").write_text(json.dumps(mix))
    (here / "metrics" / "calls_in_window.py").write_text(METRIC)

    bench["configs"].append({"name": "wgs_pe100", "source": "https://x.org",
                             "file": "trimbench/configs/wgs_pe100.json",
                             "reduced": ["pairs", "read_length"], "why": "t"})
    bench["workloads"].append({"name": NEW_CELL, "config": "wgs_pe100",
                               "traffic": "plain_pair", "chips": 1, "why": "t"})
    rate = next(e for e in bench["end_to_end"] if e["name"] == "bases_per_s")
    rate["workloads"].append(NEW_CELL)
    bench["per_layer"].append({"name": "calls_in_window", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "per-file loop",
                               "moves": "bases_per_s",
                               "workloads": [NEW_CELL]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    code = ("import json; from trimbench import catalog, run; "
            "print(json.dumps(run.run_cell(catalog.benchmark(), "
            f"{NEW_CELL!r}, 17, 0.5, True, 'cpu', scale=0.0008)))")
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
