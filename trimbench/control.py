"""The control of the comparison: the reference put in the program's place,
with qualities carried at one bit fewer than the input needs.

``correct`` is decided by an exact comparison (``compare.py``), so its
limits are 0.  A comparison is only worth its limits if it fails what
should fail: here, the reference's own rule run on each Phred value rounded
down to an even one (``reference.cuts(drop_bit=True)``), the shortcut a
lossy quality wire would take.  This prints, per seed, the numbers the
comparison reads for one pass over every input file of a cell, at the
cell's size, against the reference at full precision:

    python3 -m trimbench.control --workload <cell> --seeds 3 [--first N]

It needs no program; it runs on ``cuda`` when there is a card, else on the
CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional

from . import catalog, compare, corpus, reference


def readings(cfg: dict, mix: dict, seed: int, device,
             scale: float = 1.0) -> Dict[str, int]:
    """``wrong_records`` and ``wrong_summaries`` of the control over one
    pass of every input file of the cell (``corpus.files``: a file set per
    sample, or one pooled set), ``se`` or ``pe`` as the configuration has
    mates."""
    numbers = {"wrong_records": 0, "wrong_summaries": 0}
    names = ["r1", "r2"][:corpus.mates(cfg)]
    for parts in corpus.files(cfg, mix, scale):
        want, counts = reference.expected(cfg, mix["flags"], seed, parts,
                                          device)
        got, lossy = reference.expected(cfg, mix["flags"], seed, parts,
                                        device, drop_bit=True)
        for w, g in zip(want, got):
            numbers["wrong_records"] += compare.wrong_records(g, w)
        numbers["wrong_summaries"] += (reference.summary_of(names, lossy)
                                       != reference.summary_of(names, counts))
    return numbers


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m trimbench.control")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=3)
    parser.add_argument("--first", type=int, default=2**31 + 7)
    args = parser.parse_args(argv)
    import torch

    device = "cuda" if torch.cuda.is_available() else "cpu"
    bench = catalog.benchmark()
    entry = catalog.workload(bench, args.workload)
    cfg = catalog.config(bench, entry["config"])
    mix = catalog.traffic(entry["traffic"])
    for seed in range(args.first, args.first + args.seeds):
        t0 = time.perf_counter()
        numbers = readings(cfg, mix, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "device": device, "control": numbers,
                          "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
