"""Finds a cell's parts by the names ``BENCHMARK.json`` gives them.

A configuration is the JSON file its entry names; a traffic mix is
``trimbench/traffic/<name>.json``; a metric, end-to-end or per-layer, is
``trimbench/metrics/<name>.py``, a small reader with ``read(run)``.  A
later cell, configuration, traffic mix or metric is added as files and
entries alone: a configuration with one ``read_length`` is single-end
(``se`` on one mate file), two is paired-end (``pe`` on two), and a traffic
mix with ``"pool": true`` writes every sample into one set of mate files.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
from types import ModuleType
from typing import List

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
QUAL_OFFSETS = {"sanger": 33, "illumina": 64, "solexa": 64}


def benchmark(root: pathlib.Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _named(entries: List[dict], name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"BENCHMARK.json has no {what} {name!r}")


def workload(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config(bench: dict, name: str, root: pathlib.Path = ROOT) -> dict:
    with open(root / _named(bench["configs"], name, "config")["file"]) as f:
        cfg = json.load(f)
    cfg["qual_offset"] = QUAL_OFFSETS[cfg["qual_type"]]
    return cfg


def traffic(name: str) -> dict:
    with open(HERE / "traffic" / f"{name}.json") as f:
        mix = json.load(f)
    # The program opens a plain output read-write first, to map it, which a
    # pipe's reader takes for its writer: plain outputs cannot go to pipes.
    if "-g" not in mix["flags"]:
        raise ValueError(f"traffic {name}: outputs into pipes must be -g")
    return mix


def metric(name: str) -> ModuleType:
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "trimbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The entries a run of ``cell`` reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones.  An entry without ``workloads``
    belongs to every cell (a per-layer one: every cell that reports the
    metric it moves)."""

    def has(entry):
        return cell in entry.get("workloads", [cell])

    end_to_end = [e for e in bench["end_to_end"] if has(e)]
    if not trace:
        return end_to_end
    reported = {e["name"] for e in end_to_end}
    return [e for e in bench["per_layer"]
            if has(e) and ("workloads" in e or e["moves"] in reported)]
