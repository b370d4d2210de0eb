"""Timing on the card, shared by ``chip_smoke.py``, the kernel-verify tool
and the bench, so each times a kernel the same way.

Kernel times come from CUDA events around many launches (the card idle
before the first); host times from ``time.perf_counter`` around work
that ends in a synchronise.  ``bound`` is the least time the card could
take for one cuts batch, from its published peaks.  None of these runs
without a card, except ``run_cli``.
"""

from __future__ import annotations

import contextlib
import io
import statistics
import subprocess
import time

import torch

# The card's peaks (NVIDIA H100 SXM data sheet, at 700 W): HBM bytes/s,
# and the rate outside the tensor cores (the cut math is integer adds and
# compares; the data sheet lists no integer rate outside them).
HBM_BYTES_S = 3.35e12
SCALAR_OPS_S = 67e12
# integer ops per position the cut math needs at least: the running
# prefix, the window test (two ops), the length and range compares (three)
OPS_PER_POSITION = 6


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them (first card)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def batch_bytes(B, row_bytes, L, seq=False):
    """Bytes one cuts batch must move: every input byte read once (the
    rows, seq rows under -n) and the 4 B code written once."""
    return B * (row_bytes + 4 + (L if seq else 0))


def bound(B, L, row_bytes, seq=False):
    """(least ms the card needs, "bytes" or "operations") for one batch:
    ``batch_bytes`` at the HBM rate against OPS_PER_POSITION ops per
    position at the scalar rate."""
    by = batch_bytes(B, row_bytes, L, seq) / HBM_BYTES_S * 1e3
    ops = B * L * OPS_PER_POSITION / SCALAR_OPS_S * 1e3
    return (by, "bytes") if by >= ops else (ops, "operations")


def time_ms(fn, bufs, reps=7, iters=20):
    """ms per call of ``fn`` over ``iters`` calls back to back, rotating
    through ``bufs`` (after one warm call on each), median of ``reps``."""
    for b in bufs:
        fn(b)
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            fn(bufs[i % len(bufs)])
        stop.record()
        stop.synchronize()
        samples.append(start.elapsed_time(stop) / iters)
    return statistics.median(samples)


def one_launch_ms(fn, big, per=16, reps=5):
    """ms per batch of one launch over ``per`` batches at once (more than
    L2 holds), median of ``reps``."""
    fn(big)
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(big)
        stop.record()
        stop.synchronize()
        samples.append(start.elapsed_time(stop) / per)
    return statistics.median(samples)


def host_ms(fn, x, reps=50):
    """Median host time of one call (the enqueue: checks, allocation,
    the ctypes call), the card idle before each."""
    samples = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(x)
        samples.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(samples)


def run_cli(cli, argv, device):
    """``cli.main(argv, device=device)`` in this process, its standard
    output and error captured: (rc, stdout, stderr, wall seconds)."""
    out = io.TextIOWrapper(io.BytesIO())
    err = io.TextIOWrapper(io.BytesIO())
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv, device=device)
    wall = time.perf_counter() - t0
    out.flush()
    err.flush()
    return rc, out.buffer.getvalue().decode(), err.buffer.getvalue().decode(), wall
