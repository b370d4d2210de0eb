#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sickle_tpu_torch``) on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):

1. Device: the card's name and power limit, and the cuts kernel built
   from ``sickle_tpu_torch/csrc/trim_cuts.cu`` with nvcc.
2. Kernel vs plain: the CUDA kernel against its plain PyTorch version on
   the same tensors on the card, exact equality (tolerance 0: integer
   outputs) of five, three, the bad-quality flag and the packed codes,
   over the nine trim configurations of the JAX package's kernel tests,
   three encodings, uniform 150 bp and ragged 30-160 bp batches of
   65,536 rows, out-of-range chars before and past the 3' cut, and 50 kbp
   rows (L >= 32766: the unpacked result).  Then the time per
   65,536 x 152 batch of both (CUDA events, median of repeats).
3. End to end: a seeded FASTQ of 2,000,000 uniform 150 bp reads plus
   250,000 ragged 30-160 bp reads is trimmed by the CLI entry point
   (``sickle_tpu_torch.cli.main``, what ``python -m sickle_tpu_torch se``
   runs) with the CUDA kernel and again with ``--cuts host``, in turns,
   all with ``--metrics``; the outputs must be byte-identical with equal
   summaries, the kernel must have been launched, and the first 2,000
   records of a device run must match the scalar oracle.  Each run's
   wall and stage totals are printed, then the device time by kind (H2D,
   kernel, D2H) from one more device run under ``--profile``.
4. pe end to end, through the same entry point (``sickle pe``):
   - two-file, 1,000,000 pairs of 2x150 bp (Sanger, ``-q 20``): the
     combined ``[2n, L]`` mate batch in the kernel's uniform form; runs
     in turns host, device, device, host, all with ``--metrics``; every
     ``-o/-p/-s`` output byte-identical with equal summaries, the first
     2,000 pairs of a device run equal to the scalar oracle;
   - interleaved ``-M``, 250,000 pairs of ragged 30-160 bp: one
     interleaved batch per chunk in the generic form; device == host;
   - two-file, mate-2 reads growing longer chunk by chunk, so every
     chunk overflows the shared row stride and ships as two batches (the
     split route); device == host;
   - a device two-file run with ``--checkpoint``: outputs equal the plain
     device run's, and the sidecar records every input record as done.
   Each device run must launch the kernel, on the route it names.

The last two lines of standard output are one JSON object per kernel
(``{"kernels": [...]}``) and the run's verdict (``{"ok": true, ...}``).
No CPU fallback: without a CUDA device the script exits 1 and prints no
result.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = "sickle_tpu_torch/csrc/trim_cuts.cu"
REPLACES = "sickle_tpu/ops/trim_pallas.py:343"
N_UNIFORM = 2_000_000  # uniform 150 bp reads in the end-to-end input
N_RAGGED = 250_000  # ragged 30-160 bp reads after them
N_PE_PAIRS = 1_000_000  # 2x150 bp pairs, two-file pe
N_PE_RAGGED = 250_000  # ragged 30-160 bp pairs, interleaved -M
PE_SPLIT_CHUNKS, PE_CHUNK = 6, 1 << 16  # split-route input: 6 chunks


class SmokeError(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def phase_device(torch, trim_cuda):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    trim_cuda.build(force=True)
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in trim_cuda.BUILD_LOG.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"build: {build_s:.2f} s with nvcc ({len(ptxas) // 2} kernel "
          f"instantiations); ptxas: {ptxas[:2]}", flush=True)
    from sickle_tpu_torch.io import native

    t0 = time.perf_counter()
    check(native.available(), "the host C++ library did not build")
    print(f"host library: ready in {time.perf_counter() - t0:.2f} s",
          flush=True)
    return card


def _configs(TrimParams, Compat, QualityType):
    S, I, X = QualityType.SANGER, QualityType.ILLUMINA, QualityType.SOLEXA
    return [
        # the five of the JAX package's Pallas kernel tests
        TrimParams(S, 60, 20, False, False, Compat.FORK),
        TrimParams(S, 20, 20, False, True, Compat.V133),
        TrimParams(I, 30, 30, True, False, Compat.V133),
        TrimParams(X, 20, 5, False, True, Compat.FORK),
        TrimParams(S, 0, 0, False, False, Compat.V133),
        # the four of its on-chip kernel verifier
        TrimParams(S, 60, compat=Compat.FORK),
        TrimParams(S, 20),
        TrimParams(S, 30, trunc_n=True),
        TrimParams(S, 40, no_fiveprime=True),
    ]


def phase_kernels(torch, trim_cuda, dev, B=65536):
    from sickle_tpu_torch.constants import QUALITY_CONSTANTS, Compat, QualityType
    from sickle_tpu_torch.ops.trim import (
        TrimParams, compute_cuts, derive_lengths, trim_codes)
    from sickle_tpu_torch.utils.corpus import make_reads

    import numpy as np

    corpora = {}

    def corpus(kind, qt):
        key = (kind, qt)
        if key not in corpora:
            seed = 11 + 7 * int(qt) + (100 if kind == "ragged" else 0)
            if kind == "uniform":
                s, q, n = make_reads(seed, B, length=150, qualtype=qt,
                                     width=152, n_rate=0.01, bad_tail=0.01,
                                     bad_head=0.002)
                ul = 150
            elif kind == "ragged":
                s, q, n = make_reads(seed, B, length=(30, 160), qualtype=qt,
                                     width=160, n_rate=0.01, bad_tail=0.01,
                                     bad_head=0.002)
                ul = None
            else:  # 50 kbp rows, unpacked result
                s, q, n = make_reads(seed, 16, length=(30000, 50000),
                                     qualtype=qt, width=50000, n_rate=1e-4,
                                     bad_tail=0.2)
                n[0] = 50000  # one row fills the width
                q[0] = np.random.default_rng(seed).integers(
                    qmin_of[qt] + 2, qmin_of[qt] + 40, 50000)
                s[0] = ord("A")
                ul = None
            tail = 1000 if kind != "long" else 2  # padding rows (length 0)
            s[-tail:], q[-tail:], n[-tail:] = 0, 0, 0
            corpora[key] = (torch.from_numpy(s).to(dev),
                            torch.from_numpy(q).to(dev),
                            torch.from_numpy(n).to(dev), ul)
        return corpora[key]

    qmin_of = {qt: QUALITY_CONSTANTS[qt][1] for qt in QualityType}
    n_cases = 0
    max_err = 0
    for p in _configs(TrimParams, Compat, QualityType):
        for kind in ("uniform", "ragged", "long"):
            if kind == "long" and p.qual_threshold not in (20, 60):
                continue
            seq, qual, lens, ul = corpus(kind, p.qualtype)
            ref_lens = derive_lengths(qual)
            check(torch.equal(ref_lens, lens), "corpus padding is not clean")
            five, three, bad = compute_cuts(seq, qual, lens, p)
            if ul is not None:  # the uniform form computes the same cuts
                fu, tu, _ = compute_cuts(seq, qual, lens, p, uniform_len=ul)
                check(torch.equal(fu, five) and torch.equal(tu, three),
                      f"plain uniform form disagrees ({p})")
            flag = (bad < lens).to(torch.int32)
            want = trim_codes(seq, qual, None, p)
            for form in ((None, ul) if ul is not None else (None,)):
                for explicit in (False, True):
                    got = trim_cuda.trim_cuts(
                        qual, p, lengths=lens if explicit else None,
                        seq=seq, uniform_len=form)
                    f, t, fl = _unpack(got)
                    err = max(int((got - want).abs().max()),
                              int((f - five).abs().max()),
                              int((t - three).abs().max()),
                              int((fl - flag).abs().max()))
                    max_err = max(max_err, err)
                    check(err == 0, f"kernel != plain: {kind} {p} "
                          f"uniform={form} explicit={explicit}")
                    n_cases += 1
    if dev.type == "cuda":
        torch.cuda.synchronize()
    print(f"kernel vs plain: {n_cases} cases equal (tolerance 0, max abs "
          f"err {max_err}), {trim_cuda.LAUNCHES} launches", flush=True)

    # time per 65,536 x 152 batch, main-path form (default params, lengths
    # derived in the kernel); rotating over more than L2 holds
    p = TrimParams()
    _, qual, _, _ = corpus("uniform", QualityType.SANGER)
    bufs = [qual.clone() for _ in range(8)]
    times = {}
    for name, fn in (
        ("kernel_uniform", lambda q: trim_cuda.trim_cuts(q, p, uniform_len=150)),
        ("kernel_generic", lambda q: trim_cuda.trim_cuts(q, p)),
        ("plain", lambda q: trim_codes(None, q, None, p, 150)),
    ):
        times[name] = _time_ms(torch, fn, bufs)
    print(f"time per 65,536 x 152 batch: kernel {times['kernel_uniform']:.4f} ms "
          f"(uniform form), {times['kernel_generic']:.4f} ms (generic form); "
          f"plain PyTorch {times['plain']:.4f} ms", flush=True)
    return max_err, times


def _unpack(codes):
    """(five, three, flag) from the kernel's packed or [3, B] result."""
    if codes.dim() == 2:
        return codes[0], codes[1], codes[2]
    return (codes >> 16) - 1, (codes & 0x7FFF) - 1, (codes >> 15) & 1


def _time_ms(torch, fn, bufs, reps=7, iters=20):
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


def _run_cli(cli, argv, device):
    out = io.TextIOWrapper(io.BytesIO())
    err = io.TextIOWrapper(io.BytesIO())
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv, device=device)
    wall = time.perf_counter() - t0
    out.flush()
    err.flush()
    return rc, out.buffer.getvalue().decode(), err.buffer.getvalue().decode(), wall


def phase_e2e(trim_cuda, card, device, workdir):
    from sickle_tpu_torch import cli, oracle
    from sickle_tpu_torch.constants import QualityType
    from sickle_tpu_torch.utils.corpus import write_fastq

    src = os.path.join(workdir, "reads.fastq")
    t0 = time.perf_counter()
    with open(src, "wb") as f:
        size = write_fastq(f, 2024, N_UNIFORM, length=150, bad_tail=0.001)
        size += write_fastq(f, 2025, N_RAGGED, first=N_UNIFORM,
                            length=(30, 160), bad_tail=0.001)
    n = N_UNIFORM + N_RAGGED
    print(f"e2e input: {n} reads, {size} bytes, written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # in turns (host, device, device, host) so neither mode gets the warm
    # page cache alone, all with the same flags; every output must equal
    # the first, and the first device run's output is held to the oracle
    base = ["se", "-f", src, "-t", "sanger", "-q", "20", "--metrics"]
    runs = {"host": [], "device": []}
    first = None
    dev_out = None
    launches = None
    for k, mode in enumerate(("host", "device", "device", "host")):
        out = os.path.join(workdir, f"out{k}.fastq")
        argv = base + ["-o", out] + (["--cuts", "host"] if mode == "host"
                                     else [])
        trim_cuda.LAUNCHES = 0
        rc, so, se, wall = _run_cli(cli, argv, device)
        check(rc == 0, f"{mode} run exited {rc}: {se[-2000:]}")
        if mode == "device":
            launches = trim_cuda.LAUNCHES
            check(launches > 0, "the main path never launched the cuts kernel")
        runs[mode].append((wall, _metrics(se)))
        if first is None:
            first = (out, so)
            check(f"Total FastQ records: {n}\n" in so, f"bad summary:\n{so}")
            continue
        check(so == first[1], f"summaries differ:\n{so}\n{first[1]}")
        check(_same_file(out, first[0]),
              f"{mode} output differs from the first run's")
        if mode == "device" and dev_out is None:
            dev_out = out
        else:
            os.unlink(out)

    # the first 2,000 records of a device run against the scalar oracle
    with open(src, "rb") as f:
        head = b"".join(f.readline() for _ in range(4 * 2000))
    want, counts = oracle.trim_se(head, qualtype=QualityType.SANGER,
                                  qual_threshold=20, length_threshold=20)
    with open(dev_out, "rb") as f:
        got = f.read(len(want))
    check(got == want, "first 2,000 records disagree with the oracle")
    print(f"oracle: first 2000 records of the device run agree "
          f"({counts.kept} kept, {counts.discarded} discarded)", flush=True)
    print("e2e summary: " + " | ".join(
        ln for ln in so.splitlines() if ln.startswith(("Total", "FastQ"))),
        flush=True)
    for mode in ("device", "host"):
        for wall, met in runs[mode]:
            print(f"e2e run, {mode}: {wall:.3f} s wall, {n / wall:.0f} "
                  f"reads/s; {met['chunks']} chunks; stage totals ms: pack "
                  f"{met['pack']['total_ms']}, "
                  f"dispatch {met['dispatch']['total_ms']} (max "
                  f"{met['dispatch']['max_ms']}), fetch "
                  f"{met['fetch']['total_ms']}, consume "
                  f"{met['consume']['total_ms']}", flush=True)
    best_d = min(w for w, _ in runs["device"])
    best_h = min(w for w, _ in runs["host"])
    h2d = runs["device"][0][1]["h2d_bytes"]
    print(f"e2e on {card}: device {n / best_d:.0f} reads/s (best of "
          f"{len(runs['device'])}: {best_d:.3f} s; {launches} kernel launches, "
          f"H2D {h2d / n:.1f} B/read); --cuts host {n / best_h:.0f} reads/s "
          f"({best_h:.3f} s); all outputs identical", flush=True)

    # one more device run under --profile: where the card's time goes
    trace_dir = os.path.join(workdir, "trace")
    out = os.path.join(workdir, "out_prof.fastq")
    rc, _, se, wall = _run_cli(
        cli, base + ["-o", out, "--profile", trace_dir], device)
    check(rc == 0, f"profiled run exited {rc}: {se[-2000:]}")
    check(_same_file(out, first[0]), "profiled output differs")
    print(f"e2e profiled device run ({wall:.3f} s wall): "
          f"{_device_busy(os.path.join(trace_dir, 'trace.json'))}",
          flush=True)
    return launches


def _stage_line(met: dict) -> str:
    return (f"{met['chunks']} chunks; stage totals ms: pack "
            f"{met['pack']['total_ms']}, dispatch {met['dispatch']['total_ms']} "
            f"(max {met['dispatch']['max_ms']}), fetch "
            f"{met['fetch']['total_ms']}, consume {met['consume']['total_ms']}")


def _pe_turns(trim_cuda, cli, device, argv_for, modes, n_pairs, route):
    """Run ``sickle pe`` once per mode in ``modes`` (all with --metrics);
    every run's outputs and summary must equal the first run's; outputs
    of the third run on are deleted once compared.  Returns
    ([(mode, wall, metrics, launches)], first run's output paths,
    summary)."""
    runs, first, launches_total = [], None, 0
    for k, mode in enumerate(modes):
        argv, outs = argv_for(k)
        argv = argv + ["--metrics"] + (["--cuts", "host"] if mode == "host"
                                       else [])
        trim_cuda.LAUNCHES = 0
        rc, so, se, wall = _run_cli(cli, argv, device)
        launches = trim_cuda.LAUNCHES
        check(rc == 0, f"pe {mode} run exited {rc}: {se[-2000:]}")
        met = _metrics(se)
        if mode == "device":
            check(launches > 0, "the pe path never launched the cuts kernel")
            check(set(met["routes"]) == {route},
                  f"pe device run took routes {met['routes']}, not {route}")
            launches_total += launches
        runs.append((mode, wall, met, launches))
        if first is None:
            first = (outs, so)
            check(f"({n_pairs} pairs)" in so, f"bad pe summary:\n{so}")
            continue
        check(so == first[1], f"pe summaries differ:\n{so}\n{first[1]}")
        for a, b in zip(outs, first[0]):
            check(_same_file(a, b), f"pe {mode} output {a} differs from {b}")
            if k > 1:  # runs 0 and 1 are kept for the caller
                os.unlink(a)
    return runs, first[0], first[1], launches_total


def _print_pe_runs(title, runs, n_pairs):
    for mode, wall, met, launches in runs:
        h2d = (f"H2D {met['h2d_bytes'] / (2 * n_pairs):.1f} B/read; "
               if mode == "device" else "")
        print(f"pe {title}, {mode}: {wall:.3f} s wall, {n_pairs / wall:.0f} "
              f"pairs/s; {_stage_line(met)}; kernel launches {launches}; "
              f"{h2d}routes {met['routes']}", flush=True)


def phase_pe(trim_cuda, card, device, workdir):
    from sickle_tpu_torch import cli, oracle
    from sickle_tpu_torch.constants import QualityType
    from sickle_tpu_torch.engine.checkpoint import TrimCheckpoint
    from sickle_tpu_torch.utils.corpus import write_pairs

    launches = 0
    # two-file 2x150: the combined batch, uniform form
    r1 = os.path.join(workdir, "pe.1.fastq")
    r2 = os.path.join(workdir, "pe.2.fastq")
    t0 = time.perf_counter()
    with open(r1, "wb") as f1, open(r2, "wb") as f2:
        size = write_pairs(f1, f2, 4242, N_PE_PAIRS, length=150,
                           bad_tail=0.001)
    print(f"pe input: {N_PE_PAIRS} pairs of 2x150 bp, {size} bytes over two "
          f"files, written in {time.perf_counter() - t0:.1f} s", flush=True)
    base = ["pe", "-f", r1, "-r", r2, "-t", "sanger", "-q", "20"]

    def two_file(tag):
        outs = [os.path.join(workdir, f"pe_{tag}.{k}.fastq") for k in "ops"]
        return base + [x for k, o in zip("ops", outs)
                       for x in (f"-{k}", o)], outs

    runs, outs, summary, n = _pe_turns(
        trim_cuda, cli, device, lambda k: two_file(k),
        ("host", "device", "device", "host"), N_PE_PAIRS, "combined")
    launches += n
    _print_pe_runs("two-file 2x150", runs, N_PE_PAIRS)
    dev_outs = [os.path.join(workdir, f"pe_1.{k}.fastq") for k in "ops"]
    with open(r1, "rb") as f1, open(r2, "rb") as f2:
        h1 = b"".join(f1.readline() for _ in range(4 * 2000))
        h2 = b"".join(f2.readline() for _ in range(4 * 2000))
    want = oracle.trim_pe(h1, h2, qualtype=QualityType.SANGER)
    # the oracle's outputs are prefixes of the device run's: pairs keep
    # their order in every output stream
    for path, w in zip(dev_outs, want[:3]):
        with open(path, "rb") as f:
            check(f.read(len(w)) == w,
                  f"first 2,000 pairs disagree with the oracle in {path}")
    c = want[3]
    print(f"pe oracle: first 2000 pairs of a device run agree ({c.kept_p // 2} "
          f"pairs kept, {c.kept_s1 + c.kept_s2} singles)", flush=True)
    print("pe summary: " + " | ".join(
        ln for ln in summary.splitlines() if ln.startswith(("Total", "FastQ"))),
        flush=True)
    best = {m: min(w for mm, w, _, _ in runs if mm == m)
            for m in ("device", "host")}
    print(f"pe e2e on {card}: device {N_PE_PAIRS / best['device']:.0f} pairs/s "
          f"(best of 2: {best['device']:.3f} s), --cuts host "
          f"{N_PE_PAIRS / best['host']:.0f} pairs/s ({best['host']:.3f} s); "
          f"device/host {best['host'] / best['device']:.3f}; all outputs "
          f"identical", flush=True)

    # --checkpoint on the same input: the same bytes, every record done
    ck = os.path.join(workdir, "pe.ck.json")
    argv, ck_outs = two_file("ck")
    trim_cuda.LAUNCHES = 0
    rc, so, se, wall = _run_cli(cli, argv + ["--checkpoint", ck], device)
    check(rc == 0, f"pe --checkpoint run exited {rc}: {se[-2000:]}")
    check(trim_cuda.LAUNCHES > 0, "the checkpointed pe run never launched")
    launches += trim_cuda.LAUNCHES
    check(so == summary, "the checkpointed pe run's summary differs")
    for a, b in zip(ck_outs, dev_outs):
        check(_same_file(a, b), f"checkpointed output {a} differs")
    done = TrimCheckpoint(ck).load().records_done
    check(done == 2 * N_PE_PAIRS, f"checkpoint records_done {done}")
    print(f"pe --checkpoint device run: {wall:.3f} s wall, outputs equal the "
          f"plain device run's, records_done {done}", flush=True)
    for path in [r1, r2] + outs + dev_outs + ck_outs:
        os.unlink(path)

    # interleaved -M, ragged 30-160 bp: the generic form
    ri = os.path.join(workdir, "pe.i.fastq")
    with open(ri, "wb") as f:
        write_pairs(f, None, 4343, N_PE_RAGGED, length=(30, 160),
                    bad_tail=0.001)

    def inter(k):
        out = os.path.join(workdir, f"pe_M{k}.fastq")
        return ["pe", "-c", ri, "-t", "sanger", "-M", out], [out]

    runs, outs, _, n = _pe_turns(trim_cuda, cli, device, inter,
                                 ("host", "device"), N_PE_RAGGED,
                                 "interleaved")
    launches += n
    _print_pe_runs("interleaved -M ragged 30-160", runs, N_PE_RAGGED)

    # two-file, mate 2 growing each chunk: every chunk takes the split route
    s1 = os.path.join(workdir, "split.1.fastq")
    s2 = os.path.join(workdir, "split.2.fastq")
    with open(s1, "wb") as f1, open(s2, "wb") as f2:
        for k in range(PE_SPLIT_CHUNKS):
            write_pairs(f1, f2, 4444 + k, PE_CHUNK, first=k * PE_CHUNK,
                        mate1=dict(length=40),
                        mate2=dict(length=(40, 64 + 24 * k)), bad_tail=0.001)
    n_split = PE_SPLIT_CHUNKS * PE_CHUNK

    def split(k):
        outs = [os.path.join(workdir, f"split{k}.{x}.fastq") for x in "ops"]
        return (["pe", "-f", s1, "-r", s2, "-t", "sanger"]
                + [a for x, o in zip("ops", outs) for a in (f"-{x}", o)], outs)

    runs, _, _, n = _pe_turns(trim_cuda, cli, device, split,
                              ("host", "device"), n_split, "split")
    check(runs[1][2]["routes"]["split"] == PE_SPLIT_CHUNKS,
          f"split routes {runs[1][2]['routes']}")
    launches += n
    _print_pe_runs("two-file split route", runs, n_split)
    return launches


def _metrics(stderr: str) -> dict:
    lines = [ln for ln in stderr.splitlines() if ln.startswith("metrics: ")]
    check(lines, "a --metrics run printed no metrics line")
    return json.loads(lines[-1][len("metrics: "):])


def _device_busy(trace_path: str) -> str:
    """Device time by kind from a --profile Chrome trace, against the span
    from the first to the last device event."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    kinds = {"H2D": [0.0, 0], "kernel": [0.0, 0], "D2H": [0.0, 0],
             "other": [0.0, 0]}
    lo, hi = float("inf"), 0.0
    for e in events:
        cat = e.get("cat", "")
        if cat not in ("kernel", "gpu_memcpy", "gpu_memset") or "dur" not in e:
            continue
        name = e.get("name", "")
        kind = ("kernel" if cat == "kernel" else "H2D" if "HtoD" in name
                else "D2H" if "DtoH" in name else "other")
        kinds[kind][0] += e["dur"]
        kinds[kind][1] += 1
        lo, hi = min(lo, e["ts"]), max(hi, e["ts"] + e["dur"])
    if hi <= lo:
        return "device time not measured (the trace holds no device events)"
    busy = sum(t for t, _ in kinds.values())
    span = hi - lo
    parts = ", ".join(f"{k} {t / 1e3:.3f} ms ({c} events)"
                      for k, (t, c) in kinds.items() if c)
    return (f"device busy {busy / 1e3:.3f} ms of a {span / 1e3:.3f} ms span "
            f"(idle {100 * (1 - busy / span):.1f}%): {parts}")


def _same_file(a, b, block=1 << 24):
    if os.path.getsize(a) != os.path.getsize(b):
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x, y = fa.read(block), fb.read(block)
            if x != y:
                return False
            if not x:
                return True


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "sickle_tpu_torch")):
        raise SmokeError("sickle_tpu_torch is not beside this script: run it "
                         "from a checkout of the repository")
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        raise SmokeError("torch.cuda.is_available() is false")
    from sickle_tpu_torch.ops import trim_cuda

    card = phase_device(torch, trim_cuda)
    dev = torch.device("cuda", 0)
    max_err, times = phase_kernels(torch, trim_cuda, dev)
    workdir = tempfile.mkdtemp(prefix="sickle_smoke_")
    try:
        launches = phase_e2e(trim_cuda, card, dev, workdir)
        launches += phase_pe(trim_cuda, card, dev, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({"kernels": [{
        "name": "trim_cuts", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": max_err,
        "ms": times["kernel_uniform"], "plain_ms": times["plain"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
