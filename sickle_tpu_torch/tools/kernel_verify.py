"""Kernel verification and timing on the card: the port's counterpart of
the JAX package's ``tools/tpu_kernel_verify.py``.

1. Equality.  The CUDA cuts kernel (``ops/trim_cuda.py``) against its plain
   PyTorch version (``ops/trim.py``: ``compute_cuts``, ``encode_codes``,
   ``wire_codes``) on the same tensors, at tolerance 0 (the outputs are
   integers) on five, three, the bad-quality flag and the packed code.
   The configs are that tool's four (q60 ``--compat fork``, q20, q30
   ``-n``, q40 ``-x``), each on the generic and the uniform (150) form and
   on the raw, band (p = 6) and rank (p = 3) sources; the wires take no
   ``-n``.  Seeded batches of 65,536 rows (``utils/corpus.py``) take the
   place of that tool's fixture file.
2. Timing.  Each form per 65,536 x 152 batch (``utils/timing.py``): 20
   calls back to back, one launch over 16 batches, and the host ms of one
   call, in turns with the direct kernel (the port's two load paths take
   the place of that tool's jnp and Pallas pair), beside the bound.
3. Device variants end to end.  Small seeded files through the CLI entry
   point (``cli.main``) with ``--cuts device`` and ``--cuts host`` on the
   same device: ``-n`` on reads with Ns, a NUL quality char inside reads
   (explicit lengths), 50 kbp reads (the unpacked result), and reads of
   30,000-32,700 and 32,800-33,000 bp (either side of ``MAX_PACKED_L``).
   Exit code, standard output and error, and output bytes must be equal.

Writes the JSON artifact (the card, its power limit, equality per config,
form and source, the times, the variants), prints it as the last line and
exits 1 on any inequality.  It runs on ``cuda``, and without a card exits
1; ``main(argv, device="cpu")`` runs the same checks where every wrapper
takes its plain version, and times nothing.

Usage: python -m sickle_tpu_torch.tools.kernel_verify [out.json]
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

from ..constants import QUALITY_CONSTANTS, Compat, QualityType
from ..ops import trim_cuda
from ..ops.trim import (TrimParams, compute_cuts, encode_codes, trim_codes,
                        wire_codes)
from ..utils import timing
from ..utils.corpus import edge_fastq, make_reads, write_fastq

DEFAULT_OUT = "KERNEL_VERIFY.json"
ROWS = 65536  # rows per batch, the engine's slice
L = 152  # row width of the 150 bp batches (a multiple of 8, for the wires)

# the JAX package's tools/tpu_kernel_verify.py configs
CONFIGS = (
    TrimParams(QualityType.SANGER, 60, compat=Compat.FORK),
    TrimParams(QualityType.SANGER, 20),
    TrimParams(QualityType.SANGER, 30, trunc_n=True),
    TrimParams(QualityType.SANGER, 40, no_fiveprime=True),
)


class VerifyError(Exception):
    pass


def _check(cond, msg):
    if not cond:
        raise VerifyError(msg)


def batch(kind: str, rows: int = ROWS, source: str = "raw"):
    """The seeded ``(seq, qual, lengths)`` numpy batch of ``kind``
    (``uniform``: 150 bp; ``ragged``: 30-152 bp), width 152, Sanger, the
    last 1/64 of the rows padding (length 0).  The raw source carries Ns
    and out-of-range chars (before and past the 3' cut); the band source
    is in range (its chars span Phred 0-41: the 6-bit band wire), the rank
    source NovaSeq-binned (4 levels: the 3-bit rank wire)."""
    seed = {"raw": 11, "band": 500, "rank": 600}[source] + (
        100 if kind == "ragged" else 0)
    extra = (dict(n_rate=0.01, bad_tail=0.01, bad_head=0.002)
             if source == "raw" else dict(binned=source == "rank"))
    s, q, n = make_reads(seed, rows, length=150 if kind == "uniform"
                         else (30, L), width=L, **extra)
    pad = max(rows // 64, 1)
    s[-pad:], q[-pad:], n[-pad:] = 0, 0, 0
    return s, q, n


def wire_args(qual: np.ndarray, rank: bool, qualtype: QualityType, p=None):
    """(wire rows, p, kernel args) of a qual matrix: the rank wire over
    its distinct chars, or the band wire above its smallest char minus 1
    (``io/fastq.qual_fields``), as the device step's plan builds them."""
    from ..io.fastq import qual_fields, qual_levels, qual_rank_fields

    offset = QUALITY_CONSTANTS[qualtype][0]
    levels = qual_levels(qual)
    if rank:
        p = p or levels.size.bit_length()
        lut = np.zeros(1 << p, np.int32)
        lut[1:1 + levels.size] = levels.astype(np.int32) - offset
        return qual_rank_fields(qual, levels, p), p, dict(lut=lut)
    bias = int(levels[0]) - 1
    p = p or (int(levels[-1]) - bias).bit_length()
    return qual_fields(qual, bias, p), p, dict(bias=bias - offset)


def unpack(codes: torch.Tensor):
    """(five, three, flag) from the kernel's packed or ``[3, B]`` result."""
    if codes.dim() == 2:
        return codes[0], codes[1], codes[2]
    return (codes >> 16) - 1, (codes & 0x7FFF) - 1, (codes >> 15) & 1


def _err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a - b).abs().max()) if a.numel() else 0


def launches_since(before):
    """Kernel launches by form and load path since the snapshot
    ``before`` (a copy of ``trim_cuda.LAUNCHES_BY_PATH``), forms with
    none left out."""
    now = trim_cuda.LAUNCHES_BY_PATH
    diff = {form: {k: now[form][k] - before[form][k] for k in now[form]}
            for form in now}
    return {form: v for form, v in diff.items() if sum(v.values())}


def snapshot():
    return {form: dict(v) for form, v in trim_cuda.LAUNCHES_BY_PATH.items()}


def timing_batches(dev: torch.device, rows: int = ROWS):
    """The main-path batches ``form_times`` takes, on ``dev``: 150 bp
    raw (seq, qual) rows, and the same reads' in-range quals on the band
    wire (p = 6) and binned quals on the rank wire (p = 3)."""
    out = {}
    for source in ("raw", "band", "rank"):
        s, q, _ = batch("uniform", rows, source)
        if source == "raw":
            out[source] = tuple(torch.from_numpy(x).to(dev) for x in (s, q))
        else:
            buf, pw, kw = wire_args(q, source == "rank", QualityType.SANGER)
            out[source] = (torch.from_numpy(buf).to(dev), pw, kw)
    return out


def equality(dev: torch.device, rows: int = ROWS):
    """Every config x form x source against the plain version on ``dev``:
    one record per case."""
    cases = []
    for source in ("raw", "band", "rank"):
        for kind in ("uniform", "ragged"):
            s, q, n = batch(kind, rows, source)
            seq, qual, lens = (torch.from_numpy(x).to(dev) for x in (s, q, n))
            wire = None
            if source != "raw":
                buf, pw, kw = wire_args(q, source == "rank", QualityType.SANGER)
                wire = (torch.from_numpy(buf).to(dev), pw, kw)
            for p in CONFIGS:
                if wire is not None and p.trunc_n:
                    continue  # the wire carries no seq rows
                for ul in ((None, 150) if kind == "uniform" else (None,)):
                    five, three, bad = compute_cuts(seq, qual, lens, p, ul)
                    want = encode_codes(five, three, bad, lens, L)
                    if wire is None:
                        runs = [trim_cuda.trim_cuts(qual, p, seq=seq,
                                                    uniform_len=ul),
                                trim_cuda.trim_cuts(qual, p, lengths=lens,
                                                    seq=seq, uniform_len=ul)]
                    else:
                        buf, pw, kw = wire
                        plain = wire_codes(buf, pw, L, p, uniform_len=ul, **kw)
                        runs = [trim_cuda.trim_cuts_wire(
                            buf, pw, L, p, uniform_len=ul, **kw)]
                        _check(torch.equal(plain, want),
                               f"plain wire step != plain cuts: {source} {p}")
                    err = 0
                    for got in runs:
                        f, t, fl = unpack(got)
                        err = max(err, _err(got, want), _err(f, five),
                                  _err(t, three),
                                  _err(fl, (bad < lens).to(torch.int32)))
                    cases.append({
                        "qual_threshold": p.qual_threshold,
                        "compat": p.compat.value, "trunc_n": p.trunc_n,
                        "no_fiveprime": p.no_fiveprime, "batch": kind,
                        "form": "uniform" if ul else "generic",
                        "source": source, "rows": rows, "max_abs_err": err,
                        "equal": err == 0})
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return cases


@contextlib.contextmanager
def direct_path():
    """Within the block every launch takes the direct kernel, the other
    load path, for an A/B in one call."""
    tile_rows, layout = trim_cuda.tile_rows, trim_cuda._wire_layout
    trim_cuda.tile_rows = lambda L, row_bytes, seq=False: 0
    trim_cuda._wire_layout = lambda p, L: layout(p, L)[:2] + (0,)
    try:
        yield
    finally:
        trim_cuda.tile_rows, trim_cuda._wire_layout = tile_rows, layout


def form_times(batches, log=print):
    """Each form's time per 65,536 x 152 batch three ways: 20 calls back
    to back over 8 rotating batches, one launch over 16 x 65,536 rows
    divided by 16, and the host time of one call; beside its plain
    version, its bound and share of bound.  The first two are taken in
    turns with the direct kernel on the same inputs (direct, tiled,
    tiled, direct; each the mean of its turns).  ``batches``: ``raw``
    (seq, qual) rows and the ``band``/``rank`` (wire rows, p, kernel
    args) of 65,536 uniform 150 bp reads."""
    p, pn = TrimParams(), TrimParams(trunc_n=True)
    seq, qual = batches["raw"]
    B = qual.shape[0]
    cases = {  # name: (kernel fn, plain fn, args, row bytes, -n)
        "raw_uniform": (lambda x: trim_cuda.trim_cuts(x[0], p, uniform_len=150),
                        lambda x: trim_codes(None, x[0], None, p, 150),
                        (qual,), L, False),
        "raw_generic": (lambda x: trim_cuda.trim_cuts(x[0], p),
                        lambda x: trim_codes(None, x[0], None, p),
                        (qual,), L, False),
        "raw_trunc_n": (lambda x: trim_cuda.trim_cuts(x[0], pn, seq=x[1]),
                        lambda x: trim_codes(x[1], x[0], None, pn),
                        (qual, seq), L, True),
        "raw_uniform_trunc_n": (
            lambda x: trim_cuda.trim_cuts(x[0], pn, seq=x[1], uniform_len=150),
            lambda x: trim_codes(x[1], x[0], None, pn, 150),
            (qual, seq), L, True),
    }
    for form in ("band", "rank"):
        buf, pw, kw = batches[form]
        cases[form] = (
            lambda x, pw=pw, kw=kw: trim_cuda.trim_cuts_wire(
                x[0], pw, L, p, uniform_len=150, **kw),
            lambda x, pw=pw, kw=kw: wire_codes(x[0], pw, L, p,
                                               uniform_len=150, **kw),
            (buf,), buf.shape[1], False)
    times = {}
    for name, (fn, plain, args, row_bytes, trunc) in cases.items():
        rot = [tuple(a.clone() for a in args) for _ in range(8)]
        big = tuple(a.repeat(16, 1) for a in args)
        want = fn(big)
        _check(torch.equal(want[:B], fn(args)), f"{name}: 16 batches at once "
               f"disagree with one")
        with direct_path():
            _check(torch.equal(fn(big), want), f"{name}: the direct kernel "
                   f"disagrees with the tiled one")
        turns = {"tiled": [], "direct": []}
        for path in ("direct", "tiled", "tiled", "direct"):
            with (direct_path() if path == "direct"
                  else contextlib.nullcontext()):
                turns[path].append((timing.time_ms(fn, rot),
                                    timing.one_launch_ms(fn, big)))
        mean = {k: [statistics.mean(x) for x in zip(*v)]
                for k, v in turns.items()}
        t = {"ms": mean["tiled"][0], "one_launch_ms": mean["tiled"][1],
             "direct_ms": mean["direct"][0],
             "direct_one_launch_ms": mean["direct"][1],
             "host_ms": timing.host_ms(fn, args),
             "plain_ms": timing.time_ms(plain, rot, reps=3, iters=5)}
        t["bound_ms"], t["bound_by"] = timing.bound(B, L, row_bytes, trunc)
        t["bytes"] = timing.batch_bytes(B, row_bytes, L, trunc)
        times[name] = t
        del big, want
        log(f"time per {B:,} x 152 batch, {name} ({row_bytes} B/row"
            f"{' + 152 B seq' if trunc else ''}): 20 calls {t['ms']:.4f} ms "
            f"(direct kernel {t['direct_ms']:.4f}), one launch over 16 "
            f"batches {t['one_launch_ms']:.4f} ms (direct "
            f"{t['direct_one_launch_ms']:.4f}), host {t['host_ms']:.4f} ms "
            f"per call; bound {t['bound_ms']:.5f} ms ({t['bound_by']}), "
            f"share of bound {100 * t['bound_ms'] / t['one_launch_ms']:.1f}% "
            f"(one launch), {100 * t['bound_ms'] / t['ms']:.1f}% (20 calls); "
            f"plain PyTorch {t['plain_ms']:.4f} ms")
    return times


def variant_files(workdir: str, scale: float = 1.0):
    """The device-variant inputs, written under ``workdir``: [(name, path,
    extra CLI flags)]."""
    def k(n):
        return max(int(n * scale), 2)

    specs = [
        ("trunc_n", ["-n"], lambda f: write_fastq(
            f, 71, k(20000), length=(30, 160), n_rate=0.02)),
        ("nul_in_read", [], lambda f: f.write(edge_fastq(
            "nul", 72, k(20000), length=(100, 160)))),
        ("reads_50kbp", [], lambda f: write_fastq(
            f, 73, k(64), chunk=8, length=(40000, 50000), bad_tail=0.1)),
        ("reads_30_32.7kbp", [], lambda f: write_fastq(
            f, 74, k(64), chunk=8, length=(30000, 32700), bad_tail=0.1)),
        ("reads_32.8_33kbp", [], lambda f: write_fastq(
            f, 75, k(64), chunk=8, length=(32800, 33000), bad_tail=0.1)),
    ]
    out = []
    for name, flags, write in specs:
        path = os.path.join(workdir, f"{name}.fastq")
        with open(path, "wb") as f:
            write(f)
        out.append((name, path, flags))
    return out


def device_variants(device: torch.device, scale: float = 1.0):
    """Each variant file through ``cli.main`` with ``--cuts device`` and
    ``--cuts host`` on ``device``: one record each, with whether the two
    runs agree and the device run's launches by form and load path."""
    from .. import cli

    workdir = tempfile.mkdtemp(prefix="sickle_verify_")
    out = []
    try:
        for name, path, flags in variant_files(workdir, scale):
            runs = {}
            for mode in ("device", "host"):
                dst = os.path.join(workdir, f"{name}.{mode}.out.fastq")
                before = snapshot()
                rc, so, se, wall = timing.run_cli(
                    cli, ["se", "-f", path, "-t", "sanger", "-o", dst,
                          "--cuts", mode] + flags, device)
                with open(dst, "rb") as f:
                    data = f.read()
                runs[mode] = ((rc, so, se, data), wall, launches_since(before))
            (want, host_wall, _), (got, dev_wall, launches) = (
                runs["host"], runs["device"])
            equal = got == want and want[0] == 0
            if device.type == "cuda":
                equal = equal and bool(launches)
            out.append({"name": name, "flags": flags, "equal": equal,
                        "rc": got[0], "output_bytes": len(got[3]),
                        "summary": [ln for ln in got[1].splitlines()
                                    if ln.startswith(("Total", "FastQ"))],
                        "launches": launches,
                        "device_s": dev_wall, "host_s": host_wall})
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return out


def main(argv=None, device=None, scale: float = 1.0) -> int:
    """Run the three parts and write the artifact (``argv``: its path,
    ``KERNEL_VERIFY.json`` by default).  ``scale`` shrinks the batches
    and the variant files (the CPU tests run at a small one)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) > 1 or (argv and argv[0].startswith("-")):
        sys.stderr.write("Usage: python -m sickle_tpu_torch.tools.kernel_verify "
                         "[out.json]\n")
        return 1
    out_path = argv[0] if argv else DEFAULT_OUT
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            sys.stderr.write("kernel_verify: no CUDA device is available; "
                             "it verifies the kernel on the card\n")
            return 1
        if dev.index is None:
            dev = torch.device("cuda", 0)
    rows = max(int(ROWS * scale) // 64 * 64, 64)
    t0 = time.perf_counter()
    try:
        cases = equality(dev, rows)
        times = (form_times(timing_batches(dev),
                            log=lambda s: print(s, flush=True))
                 if dev.type == "cuda" else None)
        variants = device_variants(dev, scale)
    except VerifyError as e:
        sys.stderr.write(f"kernel_verify: FAILED: {e}\n")
        return 1
    card = timing.card() if dev.type == "cuda" else "not measured (CPU run)"
    results = {
        "card": card,
        "device": str(dev),
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "batch": [rows, L],
        "configs": cases,
        "variants": variants,
        "equal": (all(c["equal"] for c in cases)
                  and all(v["equal"] for v in variants)),
        # ms per batch of `batch` rows; none on the CPU: the plain
        # versions' CPU times are not the card's
        "times": times if times is not None else "not measured (CPU run)",
        "seconds": time.perf_counter() - t0,
        "date": time.strftime("%Y-%m-%d"),
    }
    with open(out_path, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results), flush=True)
    if not results["equal"]:
        bad = ([c for c in cases if not c["equal"]]
               + [v["name"] for v in variants if not v["equal"]])
        sys.stderr.write(f"kernel_verify: FAILED: not equal: {bad}\n")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
