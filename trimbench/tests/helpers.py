"""What the benchmark's tests share: its cells and a tiny run of one."""

from __future__ import annotations

from trimbench import catalog, run

STREAM = "wgs_pe150.bgzf_pair"
PLATE = "amplicon_pe250.plate"
CELLS = (STREAM, PLATE)
# samples a few hundred pairs each: small enough for a test run
SCALE = {STREAM: 0.0008, PLATE: 0.008}
SEED = 2**31 + 99


def parts(cell: str):
    bench = catalog.benchmark()
    entry = catalog.workload(bench, cell)
    return bench, catalog.config(bench, entry["config"]), catalog.traffic(
        entry["traffic"])


def tiny_run(cell: str, trace: bool = False, seconds: float = 1.0) -> dict:
    """One run of ``cell`` on the CPU at a test's size."""
    return run.run_cell(catalog.benchmark(), cell, SEED, seconds, trace,
                        "cpu", scale=SCALE[cell])
