"""What the benchmark's tests share: its cells, a single-end cell of the
tests' own, new cells made as files and entries, and a tiny run of one."""

from __future__ import annotations

import json
import pathlib
from typing import Optional

from trimbench import catalog, run

STREAM = "wgs_pe150.bgzf_pair"
PLATE = "amplicon_pe250.plate"
POOLED = "amplicon_pe250.pooled"
CELLS = (STREAM, PLATE, POOLED)
# a single-end configuration that lives only in the tests (``se_bench``)
SE = "se50.plate"
# samples a few hundred pairs each: small enough for a test run
SCALE = {STREAM: 0.0008, PLATE: 0.008, POOLED: 0.008, SE: 0.0008}
SEED = 2**31 + 99


def se_config() -> dict:
    """A single-end configuration: the lane's, cut to 1x50 reads over the
    full Phred range, in two samples."""
    cfg = json.loads((catalog.HERE / "configs" / "wgs_pe150.json").read_text())
    quality = dict(cfg["quality"])
    del quality["bins"]
    cfg.update(name="se50", read_length=[50], samples=2, quality=quality,
               reduced=["pairs", "read_length", "samples"])
    cfg["published"] = dict(cfg["published"], read_length="2x150",
                            samples="one lane")
    return cfg


def _plain_pair_config() -> dict:
    cfg = json.loads((catalog.HERE / "configs" / "wgs_pe150.json").read_text())
    cfg.update(name="wgs_pe100", read_length=[100, 100])
    return cfg


# shape -> (configuration made or None, traffic made or None, cell, scale)
NEW_CELLS = {
    "plain_pair": (_plain_pair_config, {"name": "plain_pair",
                                        "why": "t", "input": "plain",
                                        "flags": ["-g", "-q", "25"]},
                   "wgs_pe100.plain_pair", 0.0008),
    "pooled_bgzf": (None, {"name": "pooled_bgzf", "why": "t",
                           "input": "bgzf", "bgzf_level": 1, "pool": True,
                           "flags": ["-g"]},
                    "amplicon_pe250.pooled_bgzf", 0.008),
    "se": (se_config, None, SE, SCALE[SE]),
}


def add_cell(bench: dict, root: pathlib.Path, shape: str) -> str:
    """Writes the files of a new cell of ``shape`` (``NEW_CELLS``) under
    ``root / "trimbench"`` and adds its entries to ``bench``; returns the
    cell's name.  Its rate is ``bases_per_s``."""
    make_cfg, mix, cell, _ = NEW_CELLS[shape]
    config, traffic = cell.split(".", 1)
    if make_cfg is not None:
        path = root / "trimbench" / "configs" / f"{config}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        cfg = make_cfg()
        path.write_text(json.dumps(cfg))
        bench["configs"].append({"name": config, "source": "https://x.org",
                                 "file": f"trimbench/configs/{config}.json",
                                 "reduced": cfg["reduced"], "why": "t"})
    if mix is not None:
        path = root / "trimbench" / "traffic" / f"{traffic}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(mix))
    bench["workloads"].append({"name": cell, "config": config,
                               "traffic": traffic, "chips": 1, "why": "t"})
    rate = next(e for e in bench["end_to_end"] if e["name"] == "bases_per_s")
    rate["workloads"].append(cell)
    return cell


def se_bench(tmp_path: pathlib.Path) -> dict:
    """The benchmark with the single-end cell ``SE`` added, its
    configuration file under ``tmp_path``, for runs in this process."""
    bench = catalog.benchmark()
    add_cell(bench, tmp_path, "se")
    entry = bench["configs"][-1]
    entry["file"] = str(tmp_path / entry["file"])
    return bench


def parts(cell: str):
    if cell == SE:
        cfg = se_config()
        cfg["qual_offset"] = catalog.QUAL_OFFSETS[cfg["qual_type"]]
        return None, cfg, catalog.traffic("plate")
    bench = catalog.benchmark()
    entry = catalog.workload(bench, cell)
    return bench, catalog.config(bench, entry["config"]), catalog.traffic(
        entry["traffic"])


def tiny_run(cell: str, trace: bool = False, seconds: float = 1.0,
             bench: Optional[dict] = None, device: str = "cpu",
             scale: float = 1.0) -> dict:
    """One run of ``cell`` at a test's size (``scale`` times it), on the
    CPU unless ``device`` says otherwise."""
    return run.run_cell(bench or catalog.benchmark(), cell, SEED, seconds,
                        trace, device, scale=scale * SCALE[cell])
