"""End-to-end bench of the port on the card: file -> trimmed file through
the CLI entry point, the counterpart of the JAX package's ``bench.py``.

Usage: python -m sickle_tpu_torch.tools.bench [--reads-scale F]
       [--passes N] [--out PATH]

What it measures: ``cli.main(argv, device=...)`` (what ``python -m
sickle_tpu_torch se|pe`` runs) over a whole file, page cache warm, output
written, every run with ``--metrics``.  The cells are seeded inputs from
``utils/corpus.py`` (their sizes times ``--reads-scale``):

- ``se_uniform``: 2,000,000 uniform 150 bp reads, in range (the band
  wire, uniform form);
- ``se_ragged``: 1,000,000 reads of 30-160 bp with chars out of range past
  the 3' cut (raw rows, generic form, the bad-quality flag);
- ``se_binned``: 1,000,000 NovaSeq-binned 150 bp reads (the rank wire);
- ``pe_two_file``: 1,000,000 pairs of 2x150 bp (raw rows, the combined
  mate batch);
- ``pe_interleaved_M``: 250,000 interleaved pairs of 30-160 bp, in range,
  ``-M`` (the band wire, generic form);
- ``se_bgzf``: the first 500,000 reads of ``se_uniform`` as BGZF (written
  with the port's ``BgzfWriter``).

All take Sanger, ``-q 20`` and the default compat: the flags of the port's
other card runs (``chip_smoke.py``), so the numbers compare with them.
The JAX bench's ``-q 60 --compat fork`` (``bench.py:194-197``) was set
for the sickle test fixture it read, a file this bench does not have; on
seeded Illumina-like reads ``-q 60`` would discard every read.

Each cell runs in four modes: ``auto`` (the default hybrid router),
``device`` (``--cuts device``), ``raw`` (``--cuts device`` with
``SICKLE_TPU_NO_PLANES=1``: raw rows, no wire) and ``host`` (``--cuts
host``, the indexed host kernel).  One unmeasured warm-up pass per mode,
then ``--passes`` measured passes (3 by default) in alternating order.
The gate, per cell: every run's outputs (SHA-256) and summary equal, and
the first 2,000 records (pairs) equal to the scalar oracle
(``oracle.py``).  A cell that fails it makes the bench exit 1.

Per mode: the best and median rate, every pass's rate, and from the
median pass H2D bytes per read, the router's split (its ``chunks_rescued``
counts the chunks the host took over from a stalled device) and the stage
totals.  Two more rows: the kernel's time per 65,536 x 152
batch per form with GB/s and the share of the bytes bound
(``kernel_verify.form_times``), and the wall of a fresh ``python -m
sickle_tpu_torch se`` process on the ``se_uniform`` file and of
``--version`` alone, start-up included.

Prints one JSON line, last: ``{"metric": "se_reads_per_s", "value": <auto
median on se_uniform>, "unit": "reads/s", "vs_host": <auto / host, same
call>, "extra_metrics": {...}}`` with the card's name and power limit.
Progress goes to standard error.  It runs on ``cuda`` and without a card
exits 1; ``main(argv, device="cpu")`` runs the same cells on the CPU
(each wrapper's plain version), where no kernel is timed.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import hashlib
import json
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch

from .. import cli, oracle
from ..constants import QualityType
from ..io.compression import BgzfWriter
from ..utils import timing
from ..utils.corpus import write_fastq, write_pairs
from . import kernel_verify

ROOT = str(pathlib.Path(__file__).resolve().parents[2])
ORACLE_RECORDS = 2000
MODES = {  # name: (CLI flags, environment; None removes the variable)
    "auto": ([], {"SICKLE_TPU_NO_PLANES": None, "SICKLE_TPU_CUTS": None}),
    "device": (["--cuts", "device"], {"SICKLE_TPU_NO_PLANES": None}),
    "raw": (["--cuts", "device"], {"SICKLE_TPU_NO_PLANES": "1"}),
    "host": (["--cuts", "host"], {"SICKLE_TPU_NO_PLANES": None}),
}
SE = ["-t", "sanger", "-q", "20"]


class BenchError(Exception):
    pass


def log(text):
    sys.stderr.write(f"[bench] {text}\n")
    sys.stderr.flush()


@contextlib.contextmanager
def mode_env(mode):
    """Within the block the environment is ``mode``'s (``MODES``); the
    variables it names get their values back after."""
    changes = MODES[mode][1]
    old = {k: os.environ.get(k) for k in changes}
    for k, v in changes.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _digest(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(1 << 24)
            if not block:
                return h.hexdigest()
            h.update(block)


def _head(path, n_lines):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return b"".join(f.readline() for _ in range(n_lines))


def _starts_with(path, data):
    with open(path, "rb") as f:
        return f.read(len(data)) == data


def metrics(stderr):
    """The summary a ``--metrics`` run printed last on standard error."""
    lines = [ln for ln in stderr.splitlines() if ln.startswith("metrics: ")]
    if not lines:
        raise BenchError("a --metrics run printed no metrics line")
    return json.loads(lines[-1][len("metrics: "):])


class Cell:
    """One input and its CLI arguments: ``argv(outs)`` builds the command
    for output paths ``outs``; ``oracle(outs)`` holds the first records
    of those outputs to the scalar oracle."""

    def __init__(self, name, n, unit, reads, what, write, argv, n_outs,
                 oracle):
        self.name, self.n, self.unit, self.reads = name, n, unit, reads
        self.what, self.write, self.argv = what, write, argv
        self.n_outs, self.oracle = n_outs, oracle


def _cells(workdir, scale):
    def k(n):
        return max(int(n * scale), 8)

    def path(name):
        return os.path.join(workdir, name)

    def se_oracle(src):
        def check(outs):
            head = _head(src, 4 * ORACLE_RECORDS)
            want, _ = oracle.trim_se(head, qualtype=QualityType.SANGER)
            return _starts_with(outs[0], want)
        return check

    def se_cell(name, n, what, write, src):
        return Cell(name, n, "reads/s", n, what, write,
                    lambda outs: ["se", "-f", src] + SE + ["-o", outs[0]], 1,
                    se_oracle(src))

    def se_file(name, what, seed, n, **kw):
        dst = path(f"{name}.fastq")

        def write():
            with open(dst, "wb") as f:
                write_fastq(f, seed, n, **kw)
        return se_cell(name, n, what, write, dst)

    n_uni, n_gz = k(2_000_000), k(500_000)
    uniform = path("se_uniform.fastq")
    gz = path("se_bgzf.fastq.gz")

    def write_bgzf():
        w = BgzfWriter(gz)
        w.write(_head(uniform, 4 * n_gz))
        w.close()

    r1, r2 = path("pe.1.fastq"), path("pe.2.fastq")
    n_pe = k(1_000_000)

    def write_two_file():
        with open(r1, "wb") as f1, open(r2, "wb") as f2:
            write_pairs(f1, f2, 4242, n_pe, length=150, bad_tail=0.001)

    def pe_oracle(outs):
        want = oracle.trim_pe(_head(r1, 4 * ORACLE_RECORDS),
                              _head(r2, 4 * ORACLE_RECORDS),
                              qualtype=QualityType.SANGER)
        return all(_starts_with(o, w) for o, w in zip(outs, want[:3]))

    ri = path("pe_interleaved.fastq")
    n_pm = k(250_000)

    def write_interleaved():
        with open(ri, "wb") as f:
            write_pairs(f, None, 4343, n_pm, length=(30, 160))

    def m_oracle(outs):
        want = oracle.trim_pe(_head(ri, 8 * ORACLE_RECORDS), interleaved=True,
                              n_record_mode=True, qualtype=QualityType.SANGER)
        return _starts_with(outs[0], want[0])

    return [
        se_file("se_uniform", "150 bp in range: band wire, uniform", 2024,
                n_uni, length=150),
        se_file("se_ragged", "30-160 bp, chars out of range past the 3' cut: "
                "raw rows, generic", 2025, k(1_000_000), length=(30, 160),
                bad_tail=0.001),
        se_file("se_binned", "NovaSeq-binned 150 bp: rank wire", 2026,
                k(1_000_000), length=150, binned=True),
        Cell("pe_two_file", n_pe, "pairs/s", 2 * n_pe,
             "2x150 bp, two files: raw rows, combined batch", write_two_file,
             lambda outs: ["pe", "-f", r1, "-r", r2] + SE
             + ["-o", outs[0], "-p", outs[1], "-s", outs[2]], 3, pe_oracle),
        Cell("pe_interleaved_M", n_pm, "pairs/s", 2 * n_pm,
             "interleaved 30-160 bp in range, -M: band wire, generic",
             write_interleaved,
             lambda outs: ["pe", "-c", ri] + SE + ["-M", outs[0]], 1,
             m_oracle),
        se_cell("se_bgzf", n_gz, "BGZF input: the first reads of se_uniform",
                write_bgzf, gz),
    ]


def _run(cell, mode, outs, device, oracle=False):
    """One CLI run of ``cell`` in ``mode``: (wall s, summary, digests,
    metrics, launches by form and path).  ``oracle``: hold the outputs'
    first records to the scalar oracle too."""
    before = kernel_verify.snapshot()
    with mode_env(mode):
        rc, so, se, wall = timing.run_cli(
            cli, cell.argv(outs) + ["--metrics"] + MODES[mode][0], device)
    if rc != 0:
        raise BenchError(f"{cell.name} {mode} exited {rc}: {se[-2000:]}")
    if oracle and not cell.oracle(outs):
        raise BenchError(f"{cell.name}: the first {ORACLE_RECORDS} records "
                         f"disagree with the oracle")
    digests = [_digest(o) for o in outs]
    for o in outs:  # so no run shares the disk with the last one's writeback
        os.unlink(o)
    return (wall, so, digests, metrics(se),
            kernel_verify.launches_since(before))


def _add_launches(total, by_path):
    """Add launches by form and load path into ``total`` (in place)."""
    for form, paths in by_path.items():
        for path, v in paths.items():
            total.setdefault(form, {}).setdefault(path, 0)
            total[form][path] += v


def _mode_row(cell, runs):
    """Rates and --metrics of one mode's measured runs."""
    rates = [cell.n / r[0] for r in runs]
    med = sorted(runs, key=lambda r: r[0])[len(runs) // 2]
    met = med[3]
    launches = {}
    for r in runs:
        _add_launches(launches, r[4])
    return {
        "best": max(rates), "median": statistics.median(rates),
        "passes": rates, "seconds": [r[0] for r in runs],
        "h2d_bytes_per_read": met["h2d_bytes"] / cell.reads,
        "chunks": met["chunks"], "routes": met["routes"],
        "hybrid": met.get("hybrid"),
        "stage_total_ms": {s: met[s]["total_ms"] for s in
                           ("pack", "prep", "dispatch", "fetch", "consume")},
        "engine_wall_ms": met["wall_ms"],
        "launches": launches,
    }


def run_cell(cell, workdir, device, passes):
    """The cell's runs in alternating mode order; its row (with the gate)
    and the main-path launches of every run."""
    t0 = time.perf_counter()
    cell.write()
    log(f"{cell.name}: {cell.n} {cell.unit.split('/')[0]} written in "
        f"{time.perf_counter() - t0:.1f} s")
    outs = [os.path.join(workdir, f"{cell.name}.out{k}.fastq")
            for k in range(cell.n_outs)]
    order = list(MODES)
    schedule = [(None, m) for m in order] + [
        (k, m) for k in range(passes)
        for m in (order if k % 2 == 0 else order[::-1])]
    runs = {m: [] for m in order}
    first = None
    launches = {}
    for k, mode in schedule:
        r = _run(cell, mode, outs, device, oracle=first is None)
        _add_launches(launches, r[4])
        if first is None:
            first = r
        elif (r[1], r[2]) != (first[1], first[2]):
            raise BenchError(f"{cell.name}: {mode} output or summary differs "
                             f"from the first run's")
        if k is not None:
            runs[mode].append(r)
        log(f"{cell.name} {mode} {'warm-up' if k is None else f'pass {k}'}: "
            f"{r[0]:.3f} s, {cell.n / r[0]:.0f} {cell.unit}")
    row = {"n": cell.n, "unit": cell.unit, "what": cell.what,
           "modes": {m: _mode_row(cell, rs) for m, rs in runs.items()}}
    med = {m: v["median"] for m, v in row["modes"].items()}
    row["vs_host"] = med["auto"] / med["host"]
    row["device_vs_host"] = med["device"] / med["host"]
    row["gate"] = {"outputs_equal": True, "oracle_records": min(
        ORACLE_RECORDS, cell.n), "oracle_equal": True,
        "summary": [ln for ln in first[1].splitlines()
                    if ln.startswith(("Total", "FastQ"))],
        "sha256": first[2]}
    return row, launches


def kernel_rows(dev):
    """ms per 65,536 x 152 batch per form (``kernel_verify.form_times``),
    with GB/s of the bytes the batch must move and the share of the bytes
    bound."""
    rows = {}
    for name, t in kernel_verify.form_times(kernel_verify.timing_batches(dev),
                                            log=log).items():
        rows[name] = dict(t, gb_per_s=t["bytes"] / t["ms"] / 1e6,
                          share_of_bound=t["bound_ms"] / t["ms"])
    return rows


def fresh_process(src, workdir, device, passes):
    """Walls of ``python -m sickle_tpu_torch se`` on ``src`` and of
    ``--version``, each a new process, start-up included (median of
    ``passes``).  On the CPU the se run takes ``--cuts host``, the mode
    that needs no card."""
    out = os.path.join(workdir, "fresh.fastq")
    se = [sys.executable, "-m", "sickle_tpu_torch", "se", "-f", src] + SE + [
        "-o", out] + (["--cuts", "host"] if device.type == "cpu" else [])
    version = [sys.executable, "-m", "sickle_tpu_torch", "--version"]
    env = dict(os.environ, PYTHONPATH=ROOT)
    walls = {"se": [], "version": []}
    for _ in range(passes):
        for name, cmd in (("se", se), ("version", version)):
            t0 = time.perf_counter()
            r = subprocess.run(cmd, env=env, capture_output=True, text=True,
                               timeout=600, cwd=workdir)
            walls[name].append(time.perf_counter() - t0)
            if r.returncode != 0:
                raise BenchError(f"fresh {name} process exited "
                                 f"{r.returncode}: {r.stderr[-2000:]}")
    digest = _digest(out)
    os.unlink(out)
    return {"se_s": statistics.median(walls["se"]),
            "version_s": statistics.median(walls["version"]),
            "se_passes_s": walls["se"], "version_passes_s": walls["version"],
            "se_mode": "host" if device.type == "cpu" else "auto",
            "se_output_sha256": digest}


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sickle_tpu_torch.tools.bench")
    ap.add_argument("--reads-scale", type=float, default=1.0,
                    help="multiply every cell's read count (default 1.0)")
    ap.add_argument("--passes", type=int, default=3,
                    help="measured passes per mode (default 3)")
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            log("no CUDA device is available; the bench measures the card")
            return 1
        if dev.index is None:
            dev = torch.device("cuda", 0)
    if args.passes < 1 or args.reads_scale <= 0:
        log("--passes must be >= 1 and --reads-scale > 0")
        return 1
    t_start = time.perf_counter()
    card = timing.card() if dev.type == "cuda" else "not measured (CPU run)"
    log(f"device {dev}, card {card}")
    workdir = tempfile.mkdtemp(prefix="sickle_bench_")
    cells, errors, launches = {}, {}, {}
    fresh = None
    try:
        for cell in _cells(workdir, args.reads_scale):
            try:
                cells[cell.name], la = run_cell(cell, workdir, dev, args.passes)
            except BenchError as e:
                log(f"FAILED: {e}")
                errors[cell.name] = str(e)
                continue
            _add_launches(launches, la)
        if "se_uniform" in cells:
            try:
                fresh = fresh_process(os.path.join(workdir, "se_uniform.fastq"),
                                      workdir, dev, args.passes)
                if [fresh["se_output_sha256"]] != cells["se_uniform"]["gate"]["sha256"]:
                    raise BenchError("the fresh process's output differs from "
                                     "the in-process runs'")
            except BenchError as e:
                log(f"FAILED: {e}")
                errors["fresh_process"] = str(e)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    kernels = kernel_rows(dev) if dev.type == "cuda" else "not measured (CPU run)"
    se = cells.get("se_uniform")
    line = {
        "metric": "se_reads_per_s",
        "value": se["modes"]["auto"]["median"] if se else None,
        "unit": "reads/s",
        "vs_host": se["vs_host"] if se else None,
        "extra_metrics": {
            "card": card,
            "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                       "kind": (torch.cuda.get_device_name(dev)
                                if dev.type == "cuda" else "cpu"),
                       "count": (torch.cuda.device_count()
                                 if dev.type == "cuda" else 0)},
            "reads_scale": args.reads_scale, "passes": args.passes,
            "flags": "se|pe -t sanger -q 20, default compat, --metrics",
            "value_best": se["modes"]["auto"]["best"] if se else None,
            "gate": not errors,
            "errors": errors,
            "cells": cells,
            "kernels": kernels,
            "fresh_process": fresh,
            "main_path_launches": launches,
            "seconds": time.perf_counter() - t_start,
        },
    }
    text = json.dumps(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0 if not errors else 1


if __name__ == "__main__":
    sys.exit(main())
