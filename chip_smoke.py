#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sickle_tpu_torch``) on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):

1. Device: the card's name and power limit; the cuts kernel built from
   ``sickle_tpu_torch/csrc/trim_cuts.cu`` with nvcc while g++ builds the
   host library from ``csrc/fastqio.cpp``; registers and spills of every
   kernel instantiation (``-Xptxas -v``).
2. Kernel vs plain: the CUDA kernel against its plain PyTorch versions on
   the same tensors on the card, exact equality (tolerance 0: integer
   outputs).  Raw rows: five, three, the bad-quality flag and the packed
   codes over the nine trim configurations of the JAX package's kernel
   tests, three encodings, uniform 150 bp and ragged 30-160 bp batches of
   65,536 rows, out-of-range chars before and past the 3' cut, and 50 kbp
   rows (L >= 32766: the unpacked result, the direct kernel).  The wires:
   the ``BAND`` and ``RANK`` prologue forms against ``wire_codes`` and
   against the raw-row kernel on the same chars, every config with -n
   off, three encodings, uniform and ragged 65,536-row batches, and every
   wire width (band p = 1-6, rank p = 1-3).  The tiled kernel's traps,
   each on the load path its shape asks for: B of 1, 7, 8, 9, 63, 65 and
   65,537 rows on every wire width, views at odd addresses, explicit
   lengths with non-zero bytes past them, -n in both forms, and rows
   just under (tiled) and just over (direct) the tile limit.  Then each
   form's time per 65,536 x 152 batch three ways (20 calls back to back;
   one launch over 16 batches; the host time of one call), the first two
   in turns with the direct kernel, beside its bound (bytes at 3.35 TB/s)
   and its plain version.
3. se end to end through the CLI entry point (``sickle_tpu_torch.cli.
   main``, what ``python -m sickle_tpu_torch se`` runs), all with
   ``--metrics``, launch counts set to 0 before each run:
   - a seeded FASTQ of 2,000,000 uniform 150 bp reads (in range: the
     band wire) plus 250,000 ragged 30-160 bp reads with out-of-range
     chars past the 3' cut (raw rows), in turns ``--cuts host`` (the
     indexed host kernel), ``--cuts device``, ``auto`` (the hybrid
     router) and ``--cuts device`` with ``SICKLE_TPU_NO_PLANES=1`` (raw
     rows); every output byte-identical with equal summaries, the first
     2,000 records equal to the scalar oracle; each run's H2D B/read,
     launches per form, stage totals and router counters printed; an
     auto run must send chunks to the card with no rescue;
   - a ``--cuts device`` and an ``auto`` run under ``--profile``: device
     time by kind (H2D, kernel, D2H) from the trace;
   - a rescue check: the router over a device step that sleeps 1 s per
     chunk, ``rescue_s`` 0.1: identical output, rescues counted, workers
     stopped by ``close()``;
   - 1,000,000 NovaSeq-binned 150 bp reads (the rank wire): host, device
     and auto identical.
4. pe end to end, through the same entry point (``sickle pe``):
   - two-file, 1,000,000 pairs of 2x150 bp (Sanger, ``-q 20``): the
     combined ``[2n, L]`` mate batch in the kernel's uniform form; runs
     in turns host, device, auto, device, host; every ``-o/-p/-s`` output
     byte-identical with equal summaries, the first 2,000 pairs of a
     device run equal to the scalar oracle;
   - interleaved ``-M``, 250,000 pairs of ragged 30-160 bp in range: one
     interleaved batch per chunk on the band wire, generic form; device
     == host;
   - two-file, mate-2 reads growing longer chunk by chunk, so every
     chunk overflows the shared row stride and ships as two batches (the
     split route); device == host;
   - a device two-file run with ``--checkpoint``: outputs equal the plain
     device run's, and the sidecar records every input record as done.
   Each device run must launch the kernel, on the route it names.
5. Across processes and devices (``--dist``, ``--devices``):
   - ``--dist`` in two processes, each ``python -m sickle_tpu_torch``
     with ``--cuts device --metrics`` on the card, gloo on 127.0.0.1:
     phase 3's se file, a BGZF copy of its first 500,000 reads (written
     with the port's ``BgzfWriter``), and phase 4's two-file 2x150 and
     interleaved ragged (``-M``) inputs.  The shards
     concatenated equal the single-process device run's outputs byte for
     byte, rank 0 prints its summary exactly, rank 1 prints nothing, and
     each rank's metrics show device chunks and H2D bytes; a serial gzip
     input makes both ranks exit 1 with the JAX package's text;
   - ``--devices 2`` on a one-card machine is clamped to the one card:
     identical bytes;
   - ``sharded_cuts_fn`` over ``[cuda:0] * 2`` and ``* 3`` (the padded
     case) gives the single-device fn's codes on every chunk of the se
     file, each piece launched as one block per shard.
   Wall times and rates are printed as records, not claims.
6. The repo's tools (``sickle_tpu_torch.entry``, ``tools.kernel_verify``,
   ``tools.bench``):
   - ``entry()``: the single-device step on its example batch, five and
     three equal to the plain version and the same ``first_bad <
     lengths``; ``dryrun_multichip(2)`` over ``[cuda:0] * 2`` (one block
     per shard, total == rows);
   - ``kernel_verify.main`` at its full size: the four configs x generic
     and uniform forms x raw, band and rank sources equal to the plain
     version, the form times, and the device-variant files (-n, a NUL in
     reads, 50 kbp, 30-33 kbp) equal under ``--cuts device`` and
     ``--cuts host``;
   - ``bench.main`` at ``--reads-scale 0.05 --passes 1``: its six cells in
     four modes, its gate, and its JSON line.
   The main-path launches of this phase are those of ``entry``, the dry
   run and the bench's CLI runs (the bench reports the count of each run,
   taken around it from the wrappers' counters); the verify tool's and
   the bench's kernel timing are comparisons.

Every main-path run must launch only the tiled kernel; launches are
counted by form and by load path.  The last two lines of standard output
are the kernels' JSON object (``{"kernels": [...]}``: the raw, band and
rank forms of the one kernel, each with the launches of the main-path
runs, by path too, its times and its bound) and the run's verdict
(``{"ok": true, ...}``).
No CPU fallback: without a CUDA device the script exits 1 and prints no
result.
"""

from __future__ import annotations

import json
import os
import shutil
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
N_BINNED = 1_000_000  # NovaSeq-binned 150 bp reads (the rank wire)
PE_SPLIT_CHUNKS, PE_CHUNK = 6, 1 << 16  # split-route input: 6 chunks
N_DIST_BGZF = 500_000  # reads of the se input copied to BGZF for --dist


class SmokeError(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def phase_device(torch, trim_cuda):
    from sickle_tpu_torch.utils.timing import card as card_of

    try:
        card = card_of()
    except RuntimeError as e:
        raise SmokeError(str(e))
    print(f"card: {card}", flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    import threading

    from sickle_tpu_torch.io import native

    # the two libraries build at once: nvcc for the kernel, g++ for the
    # host library (each from its own source in the checkout)
    host = {}

    def build_host():
        t0 = time.perf_counter()
        host["ok"] = native.available()
        host["s"] = time.perf_counter() - t0

    builder = threading.Thread(target=build_host)
    t0 = time.perf_counter()
    builder.start()
    try:
        trim_cuda.build(force=True)
    finally:
        builder.join()
    build_s = time.perf_counter() - t0
    check(host.get("ok"), "the host C++ library did not build")
    kernels = _ptxas_report(trim_cuda.BUILD_LOG)
    check(kernels, "nvcc printed no per-kernel report")
    print(f"build: {build_s:.2f} s for both libraries (nvcc, {len(kernels)} "
          f"kernel instantiations; g++ host library {host['s']:.2f} s)",
          flush=True)
    for name, regs, spills in kernels:
        print(f"  ptxas {name}: {regs} registers, spill stores/loads "
              f"{spills}", flush=True)
    return card


def _ptxas_report(log: str):
    """[(kernel and template arguments, registers, (spill store bytes,
    spill load bytes))] from nvcc's -Xptxas -v report."""
    import re

    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            mangled = m.group(1)
            kind = "tiled" if "trim_cuts_tiled" in mangled else "direct"
            targs = ",".join(re.findall(r"L[ib](\d+)E", mangled))
            cur = [f"{kind}<{targs}>", None, None]
            out.append(cur)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and cur:
            cur[2] = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur:
            cur[1] = int(m.group(1))
    return [tuple(k) for k in out]


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


def phase_kernels(torch, trim_cuda, dev, card, B=65536):
    from sickle_tpu_torch.constants import QUALITY_CONSTANTS, Compat, QualityType
    from sickle_tpu_torch.ops.trim import (
        TrimParams, compute_cuts, derive_lengths, trim_codes)
    from sickle_tpu_torch.tools.kernel_verify import form_times, unpack
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
                    f, t, fl = unpack(got)
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

    errs = {"raw": max_err}
    werrs, batches = _phase_wire(torch, trim_cuda, dev, B)
    errs.update(werrs)
    for form, err in _phase_traps(torch, trim_cuda, dev).items():
        errs[form] = max(errs[form], err)
    seq, qual, _, _ = corpus("uniform", QualityType.SANGER)
    batches["raw"] = (seq, qual)
    print(f"kernel times on {card}:", flush=True)
    return errs, form_times(batches, log=lambda s: print(s, flush=True))


def _phase_wire(torch, trim_cuda, dev, B):
    """The BAND and RANK prologue forms against their plain version
    (ops/trim.py::wire_codes) and against the raw-row kernel on the same
    chars, on every trim config with -n off.  Returns (max abs errors,
    {form: (wire rows, p, kernel args)} of the main-path shapes)."""
    import dataclasses

    from sickle_tpu_torch.constants import Compat, QualityType
    from sickle_tpu_torch.ops.trim import TrimParams, wire_codes
    from sickle_tpu_torch.tools.kernel_verify import wire_args
    from sickle_tpu_torch.utils.corpus import make_reads, wire_quals

    L = 152
    errs = {"band": 0, "rank": 0}
    n_cases = 0
    batches = {}
    for p in _configs(TrimParams, Compat, QualityType):
        p = dataclasses.replace(p, trunc_n=False)
        for form in ("band", "rank"):
            for kind in ("uniform", "ragged"):
                key = (form, kind, p.qualtype)
                if key not in batches:
                    seed = 500 + 7 * int(p.qualtype) + (50 if kind == "ragged" else 0)
                    _, q, _ = make_reads(
                        seed, B, qualtype=p.qualtype, binned=form == "rank",
                        length=150 if kind == "uniform" else (30, 152),
                        width=L)
                    q[-1000:] = 0  # padding rows
                    buf, pw, kw = wire_args(q, form == "rank", p.qualtype)
                    batches[key] = (torch.from_numpy(buf).to(dev),
                                    torch.from_numpy(q).to(dev), pw, kw,
                                    150 if kind == "uniform" else None)
                buf, q, pw, kw, ul = batches[key]
                for u in ((None, ul) if ul else (None,)):
                    want = wire_codes(buf, pw, L, p, uniform_len=u, **kw)
                    got = trim_cuda.trim_cuts_wire(buf, pw, L, p,
                                                   uniform_len=u, **kw)
                    raw = trim_cuda.trim_cuts(q, p, uniform_len=u)
                    err = max(int((got - want).abs().max()),
                              int((raw - want).abs().max()))
                    errs[form] = max(errs[form], err)
                    check(err == 0, f"{form} kernel != plain: {kind} {p} "
                          f"uniform={u}")
                    n_cases += 1
    # every wire width once, on the default config
    p = TrimParams()
    for form, widths in (("band", range(1, 7)), ("rank", range(1, 4))):
        for pw in widths:
            for ul in (None, 150):
                q = wire_quals(900 + pw, 8192, L, pw, rank=form == "rank",
                               uniform=ul)
                buf, _, kw = wire_args(q, form == "rank", p.qualtype, pw)
                buf = torch.from_numpy(buf).to(dev)
                want = wire_codes(buf, pw, L, p, uniform_len=ul, **kw)
                got = trim_cuda.trim_cuts_wire(buf, pw, L, p, uniform_len=ul,
                                               **kw)
                err = int((got - want).abs().max())
                errs[form] = max(errs[form], err)
                check(err == 0, f"{form} kernel != plain at p={pw} uniform={ul}")
                n_cases += 1
    torch.cuda.synchronize()
    print(f"wire kernels vs plain: {n_cases} cases equal (tolerance 0, max "
          f"abs err band {errs['band']}, rank {errs['rank']}); launches "
          f"{dict(trim_cuda.LAUNCHES_BY_FORM)}", flush=True)

    # the main-path shapes, for the times: uniform 150 bp Sanger quals
    # 0-41 on the 6-bit band wire, NovaSeq-binned on the 3-bit rank wire
    main = {}
    for form in ("band", "rank"):
        buf, _, pw, kw, _ = batches[(form, "uniform", QualityType.SANGER)]
        main[form] = (buf, pw, kw)
    return errs, main


TRAP_ROWS = (1, 7, 8, 9, 63, 65, 65537)  # a partly full tile; > 1 batch


def _path_of(trim_cuda, form, fn):
    """(fn's result, the load path its one launch of ``form`` took)."""
    before = dict(trim_cuda.LAUNCHES_BY_PATH[form])
    out = fn()
    after = trim_cuda.LAUNCHES_BY_PATH[form]
    taken = [k for k in after if after[k] != before[k]]
    check(len(taken) == 1 and sum(after.values()) == sum(before.values()) + 1,
          f"expected one {form} launch, counts {before} -> {after}")
    return out, taken[0]


def _unaligned(torch, x):
    """A copy of the uint8 rows ``x`` in a view that starts one byte past
    its allocation's start (a contiguous tensor at an odd address)."""
    flat = torch.zeros(x.numel() + 1, dtype=torch.uint8, device=x.device)
    view = flat[1:].view(x.shape)
    view.copy_(x)
    return view


def _tile_limit(trim_cuda, row_bytes_of, seq=False):
    """The largest L (a multiple of 8) whose rows still take tiles."""
    L = 8
    while trim_cuda.tile_rows(L + 8, row_bytes_of(L + 8), seq):
        L += 8
    return L


def _phase_traps(torch, trim_cuda, dev):
    """Where the tiled kernel's loads can go wrong, each case against the
    plain version on the same tensors at tolerance 0, and each on the load
    path its shape asks for: tiles partly full (B of 1 to 65,537 rows),
    wire rows that start off any 16-byte boundary (band p = 1-6, rank
    p = 1-3), views at odd addresses, explicit lengths with non-zero
    bytes past them, -n in the generic and uniform forms, and rows just
    under and just over the tile limit (tiled, then direct)."""
    import numpy as np

    from sickle_tpu_torch.constants import QualityType
    from sickle_tpu_torch.ops.trim import TrimParams, trim_codes, wire_codes
    from sickle_tpu_torch.tools.kernel_verify import wire_args
    from sickle_tpu_torch.utils.corpus import make_reads, wire_quals

    L = 152
    p = TrimParams()
    errs = {"raw": 0, "band": 0, "rank": 0}
    paths = {"tiled": 0, "direct": 0}
    t0 = time.perf_counter()

    def held(form, what, run, want, path="tiled"):
        got, taken = _path_of(trim_cuda, form, run)
        err = int((got - want).abs().max()) if got.numel() else 0
        errs[form] = max(errs[form], err)
        check(err == 0, f"{form} kernel != plain: {what}")
        check(taken == path, f"{form} {what} took the {taken} path")
        paths[taken] += 1

    # the wires: every width, every trap size, two views at odd addresses
    n = max(TRAP_ROWS)
    for form, widths in (("band", range(1, 7)), ("rank", range(1, 4))):
        for pw in widths:
            for ul in (None, 150):
                q = wire_quals(700 + pw + (50 if ul else 0), n + 1, L, pw,
                               rank=form == "rank", uniform=ul)[:n]
                buf, _, kw = wire_args(q, form == "rank", QualityType.SANGER,
                                       pw)
                buf = torch.from_numpy(buf).to(dev)
                views = [(f"B={b}", buf[:b]) for b in TRAP_ROWS]
                views += [("buf[1:66]", buf[1:66]),
                          ("odd address", _unaligned(torch, buf[100:163]))]
                for what, v in views:
                    held(form, f"p={pw} uniform={ul} {what}",
                         lambda: trim_cuda.trim_cuts_wire(
                             v, pw, L, p, uniform_len=ul, **kw),
                         wire_codes(v, pw, L, p, uniform_len=ul, **kw))

    # raw rows: -n in both forms, explicit lengths, odd addresses
    for ul in (None, 150):
        s, q, lens = make_reads(800 + (ul or 0), n, qualtype=QualityType.SANGER,
                                length=ul or (30, 152), width=L, n_rate=0.01,
                                bad_tail=0.01, bad_head=0.002)
        s[-100:], q[-100:], lens[-100:] = 0, 0, 0
        seq, qual, lens = (torch.from_numpy(a).to(dev) for a in (s, q, lens))
        for pn in (p, TrimParams(trunc_n=True),
                   TrimParams(qual_threshold=30, trunc_n=True,
                              no_fiveprime=True)):
            for b in TRAP_ROWS:
                held("raw", f"{pn} uniform={ul} B={b}",
                     lambda: trim_cuda.trim_cuts(qual[:b], pn, seq=seq[:b],
                                                 uniform_len=ul),
                     trim_codes(seq[:b], qual[:b], None, pn, ul))
            oq, os_ = (_unaligned(torch, x[5:68]) for x in (qual, seq))
            held("raw", f"{pn} uniform={ul} odd address",
                 lambda: trim_cuda.trim_cuts(oq, pn, seq=os_, uniform_len=ul),
                 trim_codes(os_, oq, None, pn, ul))
        # explicit lengths, every byte past them non-zero (and seq N)
        rng = np.random.default_rng(801)
        past = np.arange(L)[None, :] >= np.asarray(lens.cpu())[:, None]
        jq, js = q.copy(), s.copy()
        jq[past] = rng.integers(1, 256, int(past.sum()))
        js[past] = ord("N")
        jq, js = torch.from_numpy(jq).to(dev), torch.from_numpy(js).to(dev)
        for pn in (p, TrimParams(trunc_n=True)):
            held("raw", f"{pn} uniform={ul} junk past explicit lengths",
                 lambda: trim_cuda.trim_cuts(jq, pn, lengths=lens, seq=js,
                                             uniform_len=ul),
                 trim_codes(js, jq, lens, pn, ul))

    # rows just under and just over the tile limit, on every form
    limits = [("raw", False, lambda L: L, None), ("raw", True, lambda L: L, None),
              ("band", False, lambda L: 6 * L // 8, 6),
              ("rank", False, lambda L: 3 * L // 8, 3)]
    for form, trunc, rb, pw in limits:
        top = _tile_limit(trim_cuda, rb, trunc)
        for Lx, path in ((top, "tiled"), (top + 8, "direct")):
            pn = TrimParams(trunc_n=trunc)
            if form == "raw":
                s, q, _ = make_reads(900 + Lx, 300, length=(1, Lx), width=Lx,
                                     n_rate=0.01, bad_tail=0.02)
                seq, qual = torch.from_numpy(s).to(dev), torch.from_numpy(q).to(dev)
                held(form, f"L={Lx} -n={trunc}",
                     lambda: trim_cuda.trim_cuts(qual, pn, seq=seq),
                     trim_codes(seq, qual, None, pn), path)
            else:
                q = wire_quals(950 + Lx, 300, Lx, pw, rank=form == "rank")
                buf, _, kw = wire_args(q, form == "rank", QualityType.SANGER,
                                       pw)
                buf = torch.from_numpy(buf).to(dev)
                held(form, f"L={Lx} p={pw}",
                     lambda: trim_cuda.trim_cuts_wire(buf, pw, Lx, pn, **kw),
                     wire_codes(buf, pw, Lx, pn, **kw), path)
        print(f"tile limit, {form}{' -n' if trunc else ''}: L = {top} tiled, "
              f"L = {top + 8} direct; both equal the plain version",
              flush=True)
    torch.cuda.synchronize()
    print(f"trap cases: {sum(paths.values())} equal (tolerance 0, max abs "
          f"err {errs}); paths {paths}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    return errs


# main-path launches by form and load path, summed over every _run_mode
MAIN_PATHS = {form: {"tiled": 0, "direct": 0} for form in ("raw", "band", "rank")}


def _run_mode(trim_cuda, cli, argv, mode, device):
    """One CLI run in ``mode`` (the bench's ``--cuts`` modes: ``host``,
    ``device``, ``auto``, ``raw``) with --metrics, launch counts set to 0
    just before it; returns (rc, stdout, stderr, wall, metrics,
    launches)."""
    from sickle_tpu_torch.tools.bench import MODES, mode_env
    from sickle_tpu_torch.utils.timing import run_cli

    trim_cuda.reset_counts()
    with mode_env(mode):
        rc, so, se, wall = run_cli(cli, argv + ["--metrics"] + MODES[mode][0],
                                   device)
    launches = dict(trim_cuda.LAUNCHES_BY_FORM)
    for form, by_path in trim_cuda.LAUNCHES_BY_PATH.items():
        for path, k in by_path.items():
            MAIN_PATHS[form][path] += k
    check(rc == 0, f"{mode} run exited {rc}: {se[-2000:]}")
    met = _metrics(se)
    if mode != "host":
        check(sum(launches.values()) > 0,
              f"the {mode} run never launched the cuts kernel")
        # every main-path read is short: the tiled kernel carries it
        tiled = sum(v["tiled"] for v in trim_cuda.LAUNCHES_BY_PATH.values())
        check(tiled == sum(launches.values()),
              f"the {mode} run left the tiled kernel: "
              f"{trim_cuda.LAUNCHES_BY_PATH}")
    if mode in ("device", "raw"):
        check("hybrid" not in met, f"--cuts device ran the router: {met}")
    if mode == "raw":
        check(launches["band"] == launches["rank"] == 0,
              f"SICKLE_TPU_NO_PLANES run shipped a wire: {launches}")
    if mode == "host":
        hy = met.get("hybrid") or {}
        check(hy.get("chunks_device") == 0 and met["h2d_bytes"] == 0
              and sum(launches.values()) == 0,
              f"--cuts host touched the card: {met}, {launches}")
    if mode == "auto":
        hy = met["hybrid"]
        check(hy["chunks_device"] >= 1 and hy["chunks_rescued"] == 0,
              f"auto run: {hy} (no device chunk, or a rescue on a healthy "
              f"card)")
    return rc, so, se, wall, met, launches


def _hybrid_line(met):
    hy = met.get("hybrid")
    if not hy:
        return ""
    ewma = {k: (round(v, 3) if v is not None else None)
            for k, v in hy.items() if k.startswith("ewma")}
    return (f"; router: device {hy['chunks_device']}, host "
            f"{hy['chunks_host']}, rescued {hy['chunks_rescued']}, drained "
            f"{hy['chunks_drained']}, probes {hy['chunks_probe']}, EWMA ms "
            f"{ewma}")


def _se_turns(trim_cuda, cli, device, src, workdir, n, modes, tag):
    """``sickle se`` on ``src`` once per mode, every output and summary
    equal to the first run's; returns ({mode: [(wall, metrics,
    launches)]}, first output path, summary)."""
    base = ["se", "-f", src, "-t", "sanger", "-q", "20"]
    runs = {m: [] for m in modes}
    first = None
    for k, mode in enumerate(modes):
        out = os.path.join(workdir, f"{tag}{k}.fastq")
        rc, so, se, wall, met, launches = _run_mode(
            trim_cuda, cli, base + ["-o", out], mode, device)
        runs[mode].append((wall, met, launches))
        print(f"{tag} run {k}, {mode}: {wall:.3f} s wall, {n / wall:.0f} "
              f"reads/s; H2D {met['h2d_bytes'] / n:.1f} B/read; launches "
              f"{launches}; {_stage_line(met)}{_hybrid_line(met)}",
              flush=True)
        if first is None:
            first = (out, so)
            check(f"Total FastQ records: {n}\n" in so, f"bad summary:\n{so}")
            continue
        check(so == first[1], f"summaries differ:\n{so}\n{first[1]}")
        check(_same_file(out, first[0]),
              f"{tag} {mode} output differs from the first run's")
        os.unlink(out)
    return runs, first[0], first[1]


def phase_e2e(trim_cuda, card, device, workdir):
    from sickle_tpu_torch import cli, oracle
    from sickle_tpu_torch.constants import QualityType
    from sickle_tpu_torch.utils.corpus import write_fastq

    launches = {"raw": 0, "band": 0, "rank": 0}

    def add(runs):
        for mode, rs in runs.items():
            if mode != "host":
                for _, _, la in rs:
                    for k, v in la.items():
                        launches[k] += v

    src = os.path.join(workdir, "reads.fastq")
    t0 = time.perf_counter()
    with open(src, "wb") as f:
        # the uniform part is in range (it rides the band wire); the
        # ragged part carries out-of-range chars past the 3' cut (raw rows
        # and the device's bad-quality flag)
        size = write_fastq(f, 2024, N_UNIFORM, length=150)
        size += write_fastq(f, 2025, N_RAGGED, first=N_UNIFORM,
                            length=(30, 160), bad_tail=0.001)
    n = N_UNIFORM + N_RAGGED
    print(f"e2e input: {n} reads, {size} bytes, written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # in turns, so no mode gets the warm page cache alone, all with the
    # same flags; every output must equal the first (host) run's
    modes = ("host", "device", "auto", "raw", "raw", "auto", "device", "host")
    runs, first_out, so = _se_turns(trim_cuda, cli, device, src, workdir, n,
                                    modes, "se")
    add(runs)
    for _, met, la in runs["device"] + runs["auto"]:
        check(la["band"] > 0, f"no band-wire launch in a device run: {la}")
    h2d = {m: runs[m][0][1]["h2d_bytes"] / n for m in ("device", "raw")}
    check(110 <= h2d["device"] <= 125,
          f"device run shipped {h2d['device']:.1f} B/read, not the wire's")

    # the first 2,000 records against the scalar oracle
    with open(src, "rb") as f:
        head = b"".join(f.readline() for _ in range(4 * 2000))
    want, counts = oracle.trim_se(head, qualtype=QualityType.SANGER,
                                  qual_threshold=20, length_threshold=20)
    with open(first_out, "rb") as f:
        got = f.read(len(want))
    check(got == want, "first 2,000 records disagree with the oracle")
    print(f"oracle: first 2000 records of the outputs agree "
          f"({counts.kept} kept, {counts.discarded} discarded)", flush=True)
    print("e2e summary: " + " | ".join(
        ln for ln in so.splitlines() if ln.startswith(("Total", "FastQ"))),
        flush=True)
    best = {m: min(w for w, _, _ in runs[m]) for m in runs}
    print(f"e2e on {card}: " + "; ".join(
        f"{m} {n / best[m]:.0f} reads/s (best of {len(runs[m])}: "
        f"{best[m]:.3f} s)" for m in ("device", "auto", "raw", "host"))
        + f"; H2D device {h2d['device']:.1f} B/read, raw "
        f"{h2d['raw']:.1f} B/read; all outputs identical", flush=True)

    # device, auto and raw-row runs under --profile: where the card's
    # time goes, and that the profiler sees launches from the router's
    # worker
    for mode in ("device", "auto", "raw"):
        trace_dir = os.path.join(workdir, f"trace_{mode}")
        out = os.path.join(workdir, f"out_prof_{mode}.fastq")
        base = ["se", "-f", src, "-t", "sanger", "-q", "20"]
        rc, _, se, wall, met, la = _run_mode(
            trim_cuda, cli, base + ["-o", out, "--profile", trace_dir], mode,
            device)
        add({mode: [(wall, met, la)]})
        check(_same_file(out, first_out), f"profiled {mode} output differs")
        os.unlink(out)
        busy = _device_busy(os.path.join(trace_dir, "trace.json"))
        check(" kernel " in busy, f"the {mode} trace holds no kernel: {busy}")
        print(f"e2e profiled {mode} run ({wall:.3f} s wall): {busy}",
              flush=True)

    # a stalled device: every device chunk sleeps 1 s, rescue_s 0.1 s; the
    # host recomputes the stalled chunks and the output stays identical
    _rescue_check(trim_cuda, device, src, first_out, n)
    os.unlink(first_out)

    # binned NovaSeq-style quals: the rank wire
    bsrc = os.path.join(workdir, "binned.fastq")
    with open(bsrc, "wb") as f:
        write_fastq(f, 2026, N_BINNED, length=150, binned=True)
    runs, bout, _ = _se_turns(trim_cuda, cli, device, bsrc, workdir,
                              N_BINNED, ("host", "device", "auto"), "binned")
    add(runs)
    _, met, la = runs["device"][0]
    b_h2d = met["h2d_bytes"] / N_BINNED
    check(la["rank"] > 0, f"no rank-wire launch on the binned input: {la}")
    check(55 <= b_h2d <= 62, f"binned device run shipped {b_h2d:.1f} B/read")
    print(f"binned e2e on {card}: device {N_BINNED / runs['device'][0][0]:.0f}"
          f", auto {N_BINNED / runs['auto'][0][0]:.0f}, host "
          f"{N_BINNED / runs['host'][0][0]:.0f} reads/s; H2D {b_h2d:.1f} "
          f"B/read; outputs identical", flush=True)
    for path in (bsrc, bout):
        os.unlink(path)
    return launches, src  # the se input stays for phase 5


def _rescue_check(trim_cuda, device, src, want_out, n):
    """run_se through the router over a device step that sleeps 1 s before
    every chunk, with rescue_s 0.1: output identical, rescues counted,
    and close() stops the workers."""
    from sickle_tpu_torch.engine import run_se
    from sickle_tpu_torch.engine.hybrid import HybridCutsFn
    from sickle_tpu_torch.engine.pipeline import _cuda_cuts_fn
    from sickle_tpu_torch.ops.trim import TrimParams

    p = TrimParams(qual_threshold=20)
    dev = _cuda_cuts_fn(p, device)

    def stalled(seq, qual, lengths, qual_clean=False, wire=None):
        time.sleep(1.0)
        return dev(seq, qual, lengths, qual_clean=qual_clean, wire=wire)

    stalled.prepare = dev.prepare
    stalled.device = dev.device
    stalled.lazy = True
    fn = HybridCutsFn(p, stalled, rescue_s=0.1)
    out = os.path.join(os.path.dirname(want_out), "rescued.fastq")
    t0 = time.perf_counter()
    try:
        with open(src, "rb") as fin, open(out, "wb") as fout:
            c = run_se(fin, fout, p, cuts_fn=fn)
    finally:
        closed = fn.close()
    wall = time.perf_counter() - t0
    check(closed, "close() left a router worker running")
    check(c.total == n and _same_file(out, want_out),
          "the rescued run's output differs")
    check(fn.n_rescued >= 1, f"no rescue: {fn.n_rescued}")
    os.unlink(out)
    print(f"rescue check: device stalled 1 s per chunk, rescue_s 0.1: "
          f"{wall:.3f} s wall; device {fn.n_device}, host {fn.n_host}, "
          f"rescued {fn.n_rescued}, drained {fn.n_drained}; output "
          f"identical, workers stopped", flush=True)


def _stage_line(met: dict) -> str:
    return (f"{met['chunks']} chunks; stage totals ms: pack "
            f"{met['pack']['total_ms']}, wire prep {met['prep']['total_ms']}, "
            f"dispatch {met['dispatch']['total_ms']} "
            f"(max {met['dispatch']['max_ms']}), fetch "
            f"{met['fetch']['total_ms']}, consume {met['consume']['total_ms']}")


def _pe_turns(trim_cuda, cli, device, argv_for, modes, n_pairs, route,
              launches):
    """Run ``sickle pe`` once per mode in ``modes`` (all with --metrics);
    every run's outputs and summary must equal the first run's; outputs
    of the third run on are deleted once compared.  A device run must
    take ``route`` only; an auto run ``route`` or ``indexed`` (chunks the
    router sent to the host kernel unpacked).  Kernel launches of the
    runs are added to ``launches``.  Returns ([(mode, wall, metrics,
    launches)], first run's output paths, summary)."""
    runs, first = [], None
    for k, mode in enumerate(modes):
        argv, outs = argv_for(k)
        rc, so, se, wall, met, la = _run_mode(trim_cuda, cli, argv, mode,
                                              device)
        if mode != "host":
            allowed = {route} | ({"indexed"} if mode == "auto" else set())
            check(set(met["routes"]) <= allowed and met["routes"],
                  f"pe {mode} run took routes {met['routes']}, not {route}")
            for f, v in la.items():
                launches[f] += v
        runs.append((mode, wall, met, la))
        if first is None:
            first = (outs, so)
            check(f"({n_pairs} pairs)" in so, f"bad pe summary:\n{so}")
            continue
        check(so == first[1], f"pe summaries differ:\n{so}\n{first[1]}")
        for a, b in zip(outs, first[0]):
            check(_same_file(a, b), f"pe {mode} output {a} differs from {b}")
            if k > 1:  # runs 0 and 1 are kept for the caller
                os.unlink(a)
    return runs, first[0], first[1]


def _print_pe_runs(title, runs, n_pairs):
    for mode, wall, met, la in runs:
        h2d = (f"H2D {met['h2d_bytes'] / (2 * n_pairs):.1f} B/read; "
               if mode != "host" else "")
        print(f"pe {title}, {mode}: {wall:.3f} s wall, {n_pairs / wall:.0f} "
              f"pairs/s; {_stage_line(met)}; kernel launches {la}; "
              f"{h2d}routes {met['routes']}{_hybrid_line(met)}", flush=True)


def phase_pe(trim_cuda, card, device, workdir):
    from sickle_tpu_torch import cli, oracle
    from sickle_tpu_torch.constants import QualityType
    from sickle_tpu_torch.engine.checkpoint import TrimCheckpoint
    from sickle_tpu_torch.utils.corpus import write_pairs

    launches = {"raw": 0, "band": 0, "rank": 0}
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

    runs, outs, summary = _pe_turns(
        trim_cuda, cli, device, lambda k: two_file(k),
        ("host", "device", "auto", "device", "host"), N_PE_PAIRS, "combined",
        launches)
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
            for m in ("device", "auto", "host")}
    print(f"pe e2e on {card}: device {N_PE_PAIRS / best['device']:.0f} pairs/s "
          f"(best of 2: {best['device']:.3f} s), auto "
          f"{N_PE_PAIRS / best['auto']:.0f} pairs/s ({best['auto']:.3f} s), "
          f"--cuts host {N_PE_PAIRS / best['host']:.0f} pairs/s "
          f"({best['host']:.3f} s); device/host "
          f"{best['host'] / best['device']:.3f}; all outputs identical",
          flush=True)

    # --checkpoint on the same input: the same bytes, every record done
    ck = os.path.join(workdir, "pe.ck.json")
    argv, ck_outs = two_file("ck")
    _, so, _, wall, _, la = _run_mode(trim_cuda, cli,
                                      argv + ["--checkpoint", ck], "device",
                                      device)
    for f, v in la.items():
        launches[f] += v
    check(so == summary, "the checkpointed pe run's summary differs")
    for a, b in zip(ck_outs, dev_outs):
        check(_same_file(a, b), f"checkpointed output {a} differs")
    done = TrimCheckpoint(ck).load().records_done
    check(done == 2 * N_PE_PAIRS, f"checkpoint records_done {done}")
    print(f"pe --checkpoint device run: {wall:.3f} s wall, outputs equal the "
          f"plain device run's, records_done {done}", flush=True)
    for path in outs + dev_outs + ck_outs:  # the inputs stay for phase 5
        os.unlink(path)

    # interleaved -M, ragged 30-160 bp, all chars in range: the generic
    # form of the band wire
    ri = os.path.join(workdir, "pe.i.fastq")
    with open(ri, "wb") as f:
        write_pairs(f, None, 4343, N_PE_RAGGED, length=(30, 160))

    def inter(k):
        out = os.path.join(workdir, f"pe_M{k}.fastq")
        return ["pe", "-c", ri, "-t", "sanger", "-M", out], [out]

    band = launches["band"]
    runs, outs, _ = _pe_turns(trim_cuda, cli, device, inter,
                              ("host", "device"), N_PE_RAGGED,
                              "interleaved", launches)
    check(launches["band"] > band, "interleaved pe never rode the band wire")
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

    runs, _, _ = _pe_turns(trim_cuda, cli, device, split,
                           ("host", "device"), n_split, "split", launches)
    check(runs[1][2]["routes"]["split"] == PE_SPLIT_CHUNKS,
          f"split routes {runs[1][2]['routes']}")
    _print_pe_runs("two-file split route", runs, n_split)
    return launches, (r1, r2, ri)


SERIAL_GZIP_ERROR = (
    "****Error: multi-host runs need plain or BGZF (block-splittable) "
    "input; serial gzip inputs must be pre-sharded per host ('{}').\n\n")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dist_start(argv, workdir, n=2):
    """Start ``python -m sickle_tpu_torch <argv> --dist`` in ``n``
    processes on the card (gloo on 127.0.0.1); returns (processes, start
    time) for ``_dist_wait``."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=HERE)
    t0 = time.perf_counter()
    return [subprocess.Popen(
        [sys.executable, "-m", "sickle_tpu_torch", *argv, "--dist",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(n),
         "--process-id", str(rank)], cwd=workdir, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(n)], t0


def _dist_run(argv, workdir, n=2, timeout=300):
    """A --dist cluster run (``_dist_start``) to its end."""
    return _dist_wait(*_dist_start(argv, workdir, n), argv, timeout)


def _dist_wait(procs, t0, argv, timeout=300):
    """([(rc, stdout, stderr)] by rank, wall seconds from the first start
    to the last exit).  A process still running at ``timeout`` is killed
    and fails the phase."""
    res = []
    try:
        for p in procs:
            try:
                out, err = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                raise SmokeError(f"a --dist process ran past {timeout} s: "
                                 f"{argv}")
            res.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return res, time.perf_counter() - t0


def _same_concat(parts, whole, block=1 << 24):
    """The files ``parts``, concatenated in order, equal the file ``whole``."""
    if sum(os.path.getsize(p) for p in parts) != os.path.getsize(whole):
        return False
    with open(whole, "rb") as fw:
        for p in parts:
            with open(p, "rb") as fp:
                while True:
                    x = fp.read(block)
                    if not x:
                        break
                    if fw.read(len(x)) != x:
                        return False
    return True


def _dist_check(trim_cuda, cli, device, workdir, tag, argv, out_flags,
                n_items, unit, launches):
    """One --dist case: the single-process ``--cuts device`` run in this
    process, then the same command as a two-process cluster.  The shards
    concatenated must equal the single run's outputs byte for byte, rank
    0's stdout its summary exactly, rank 1's stdout must be empty, and
    each rank's --metrics must show device chunks and H2D bytes."""
    def outs(kind):
        return [os.path.join(workdir, f"{tag}.{kind}.{f[1]}.fastq")
                for f in out_flags]

    def with_outs(kind):
        return argv + [x for f, o in zip(out_flags, outs(kind))
                       for x in (f, o)]

    rc, so, _, wall1, met1, la = _run_mode(trim_cuda, cli, with_outs("one"),
                                           "device", device)
    for f, v in la.items():
        launches[f] += v
    res, wall = _dist_run(with_outs("dist") + ["--cuts", "device",
                                               "--metrics"], workdir)
    for rank, (rc, out, err) in enumerate(res):
        check(rc == 0, f"--dist {tag} rank {rank} exited {rc}: {err[-3000:]}")
    check(res[0][1] == so, f"--dist {tag} rank 0 stdout differs from the "
          f"single-process summary:\n{res[0][1]!r}\n{so!r}")
    check(res[1][1] == "", f"--dist {tag} rank 1 wrote stdout: {res[1][1]!r}")
    mets = [_metrics(err) for _, _, err in res]
    for rank, met in enumerate(mets):
        check(met["chunks"] > 0 and met["h2d_bytes"] > 0,
              f"--dist {tag} rank {rank} ran no device chunk: {met}")
    for one, dist in zip(outs("one"), outs("dist")):
        shards = [f"{dist}.shard{r}" for r in range(2)]
        check(not os.path.exists(dist) and _same_concat(shards, one),
              f"--dist {tag}: the shards of {dist} differ from {one}")
        for path in shards + [one]:
            os.unlink(path)
    print(f"dist {tag}: 2 processes {wall:.3f} s wall ({n_items / wall:.0f} "
          f"{unit}/s, process start-up included), single process "
          f"{wall1:.3f} s ({n_items / wall1:.0f} {unit}/s); per rank "
          + "; ".join(f"rank {r}: {m['records']} records, {m['chunks']} "
                      f"chunks, H2D {m['h2d_bytes']} B, engine wall "
                      f"{m['wall_ms']} ms" for r, m in enumerate(mets))
          + "; shards identical, rank 0 summary exact, rank 1 silent",
          flush=True)


def _sharded_check(trim_cuda, device, src):
    """sharded_cuts_fn over [cuda:0] * 2 and * 3 against the single-device
    fn on every chunk of the se file (through run_se), each piece launched
    as one block per shard.  These launches are comparisons, not main-path
    launches."""
    import numpy as np

    from sickle_tpu_torch.engine import run_se
    from sickle_tpu_torch.engine.pipeline import _cuda_cuts_fn
    from sickle_tpu_torch.ops.trim import TrimParams
    from sickle_tpu_torch.parallel import sharded_cuts_fn

    p = TrimParams(qual_threshold=20)
    single = _cuda_cuts_fn(p, device)
    meshes = {n: sharded_cuts_fn(p, [device] * n) for n in (2, 3)}
    blocks = {n: 0 for n in meshes}
    chunks = [0]

    def compare(seq, qual, lengths, qual_clean=False, wire=None):
        want = single(seq, qual, lengths, qual_clean=qual_clean,
                      wire=wire).materialize()
        for n, fn in meshes.items():
            before = trim_cuda.LAUNCHES
            got = fn(seq, qual, lengths, qual_clean=qual_clean).materialize()
            launched = trim_cuda.LAUNCHES - before
            check(launched >= n and launched % n == 0,
                  f"sharded fn over {n} launched {launched} blocks")
            blocks[n] += launched
            for a, b in zip(got, want):
                check(np.array_equal(a, b),
                      f"sharded fn over [cuda:0] * {n} != single-device fn "
                      f"on chunk {chunks[0]}")
        chunks[0] += 1
        return want

    compare.prepare = single.prepare
    t0 = time.perf_counter()
    with open(src, "rb") as fin, open(os.devnull, "wb") as fout:
        run_se(fin, fout, p, cuts_fn=compare)
    print(f"sharded fn: [cuda:0] * 2 and * 3 equal the single-device fn on "
          f"all {chunks[0]} chunks of the se file ({blocks[2]} and "
          f"{blocks[3]} block launches; {time.perf_counter() - t0:.1f} s)",
          flush=True)


def phase_dist(trim_cuda, card, device, workdir, src, pe_inputs):
    """Phase 5: --dist across two processes on the card, --devices 2 on a
    one-card machine, and the sharded fn over one card's blocks.  The
    inputs are phase 3's se file and phase 4's pe files, plus a BGZF and
    a serial-gzip copy of part of the se file."""
    import gzip

    import torch

    from sickle_tpu_torch import cli
    from sickle_tpu_torch.io.compression import BgzfWriter

    launches = {"raw": 0, "band": 0, "rank": 0}
    n_se = N_UNIFORM + N_RAGGED
    se = ["se", "-f", src, "-t", "sanger", "-q", "20"]
    _dist_check(trim_cuda, cli, device, workdir, "se", se, ["-o"], n_se,
                "reads", launches)

    # --devices 2 with one card: clamped to the one device, same bytes
    one = os.path.join(workdir, "devices1.fastq")
    two = os.path.join(workdir, "devices2.fastq")
    for out, extra in ((one, []), (two, ["--devices", "2"])):
        _, so, _, wall, _, la = _run_mode(trim_cuda, cli, se + ["-o", out]
                                          + extra, "device", device)
        for f, v in la.items():
            launches[f] += v
    check(_same_file(one, two), "--devices 2 output differs on one card")
    print(f"--devices 2 on {torch.cuda.device_count()} card(s): clamped, output "
          f"identical ({wall:.3f} s wall)", flush=True)
    for path in (one, two):
        os.unlink(path)
    _sharded_check(trim_cuda, device, src)

    # a BGZF copy of the first N_DIST_BGZF reads (sharded in uncompressed
    # space through its block index)
    gz = os.path.join(workdir, "reads.fastq.gz")
    t0 = time.perf_counter()
    with open(src, "rb") as f:
        head = b"".join(f.readline() for _ in range(4 * N_DIST_BGZF))
    w = BgzfWriter(gz)
    w.write(head)
    w.close()
    print(f"dist BGZF input: {N_DIST_BGZF} reads, {len(head)} bytes -> "
          f"{os.path.getsize(gz)} bytes, written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # serial gzip cannot be split: both ranks exit 1 with the JAX text.
    # This cluster runs while the BGZF case does (start-up is most of
    # either's wall).
    serial = os.path.join(workdir, "serial.fastq.gz")
    with gzip.open(serial, "wb", compresslevel=1) as g:
        g.write(head[: len(head) // 50])
    serial_argv = ["se", "-f", serial, "-t", "sanger", "-o",
                   os.path.join(workdir, "serial.out.fastq"), "--cuts",
                   "device"]
    started = _dist_start(serial_argv, workdir)
    try:
        _dist_check(trim_cuda, cli, device, workdir, "se_bgzf",
                    ["se", "-f", gz, "-t", "sanger", "-q", "20"], ["-o"],
                    N_DIST_BGZF, "reads", launches)
    finally:
        res, _ = _dist_wait(*started, serial_argv)
    for rank, (rc, out, err) in enumerate(res):
        check(rc == 1 and out == "" and SERIAL_GZIP_ERROR.format(serial) in err,
              f"serial gzip --dist rank {rank}: rc {rc}, {err[-2000:]}")
    print("dist serial gzip (alongside the BGZF case): both ranks exit 1 "
          "with the JAX package's text", flush=True)
    for path in (gz, serial, src):
        os.unlink(path)

    # pe: phase 4's two-file 2x150 and interleaved ragged 30-160 (-M)
    r1, r2, ri = pe_inputs
    _dist_check(trim_cuda, cli, device, workdir, "pe_two_file",
                ["pe", "-f", r1, "-r", r2, "-t", "sanger", "-q", "20"],
                ["-o", "-p", "-s"], N_PE_PAIRS, "pairs", launches)
    _dist_check(trim_cuda, cli, device, workdir, "pe_interleaved_M",
                ["pe", "-c", ri, "-t", "sanger"], ["-M"], N_PE_RAGGED,
                "pairs", launches)
    for path in (r1, r2, ri):
        os.unlink(path)
    print(f"card: {card}", flush=True)
    return launches


def _tiled_only(trim_cuda, what, by_path):
    """Add one phase-6 run's launches (by form and load path) to the
    main-path counts; each must have taken the tiled kernel."""
    for form, paths in by_path.items():
        check(paths.get("direct", 0) == 0, f"{what} left the tiled kernel: "
              f"{by_path}")
        for path, k in paths.items():
            MAIN_PATHS[form][path] += k
    return {form: sum(paths.values()) for form, paths in by_path.items()}


def phase_tools(trim_cuda, device, workdir):
    """Phase 6: the single-device step and the multi-device dry run
    (``entry``), the kernel-verify tool at full size and the bench at a
    small scale, each through the function a user's ``python -m`` runs."""
    import contextlib
    import io

    import torch

    from sickle_tpu_torch import entry as entry_mod
    from sickle_tpu_torch.ops.trim import compute_cuts
    from sickle_tpu_torch.tools import bench, kernel_verify

    launches = {"raw": 0, "band": 0, "rank": 0}

    def add(counts):
        for form, k in counts.items():
            launches[form] += k

    def by_path():
        return {f: dict(v) for f, v in trim_cuda.LAUNCHES_BY_PATH.items()
                if sum(v.values())}

    t0 = time.perf_counter()
    trim_cuda.reset_counts()
    fn, args = entry_mod.entry(device)
    five, three, bad = fn(*args)
    torch.cuda.synchronize()
    counts = _tiled_only(trim_cuda, "entry()", by_path())
    check(counts == {"raw": 1}, f"entry() launched {counts}")
    add(counts)
    seq, qual, lens = args
    pf, pt, pb = compute_cuts(seq, qual, lens, entry_mod.PARAMS)
    check(torch.equal(five, pf) and torch.equal(three, pt)
          and torch.equal(bad < lens, pb < lens),
          "entry() disagrees with the plain version")
    trim_cuda.reset_counts()
    entry_mod.dryrun_multichip(2, device)
    counts = _tiled_only(trim_cuda, "dryrun_multichip(2)", by_path())
    check(counts == {"raw": 2}, f"dryrun_multichip(2) launched {counts}")
    add(counts)
    print(f"entry: {tuple(five.shape)} rows equal the plain version "
          f"({int((three >= 0).sum())} kept); dryrun_multichip(2) over "
          f"[{device}] * 2: one block per shard, total == rows "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    t0 = time.perf_counter()
    kv_path = os.path.join(workdir, "kernel_verify.json")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = kernel_verify.main([kv_path], device=device)
    check(rc == 0, f"kernel_verify exited {rc}: {out.getvalue()[-3000:]}")
    with open(kv_path) as f:
        kv = json.load(f)
    check(kv["equal"] and all(c["max_abs_err"] == 0 for c in kv["configs"]),
          "kernel_verify: a case is not equal")
    for v in kv["variants"]:
        check(v["equal"] and v["launches"], f"kernel_verify variant {v}")
    print(f"kernel_verify: {len(kv['configs'])} config x form x source cases "
          f"equal (tolerance 0); variants "
          + "; ".join(f"{v['name']} device {v['device_s']:.3f} s, host "
                      f"{v['host_s']:.3f} s, launches {v['launches']}"
                      for v in kv["variants"])
          + f"; all equal under --cuts device and host "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    for name, t in kv["times"].items():
        print(f"  kernel_verify {name}: {t['ms']:.4f} ms (direct "
              f"{t['direct_ms']:.4f}), one launch {t['one_launch_ms']:.4f}, "
              f"host {t['host_ms']:.4f} ms, bound {t['bound_ms']:.5f}",
              flush=True)

    t0 = time.perf_counter()
    trim_cuda.reset_counts()
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = bench.main(["--reads-scale", "0.05", "--passes", "1"],
                        device=device)
    check(rc == 0, f"bench exited {rc}: {err.getvalue()[-3000:]}")
    line = json.loads(out.getvalue().splitlines()[-1])
    em = line["extra_metrics"]
    check(line["metric"] == "se_reads_per_s" and line["value"] > 0
          and em["gate"] and len(em["cells"]) == 6,
          f"bench line: {out.getvalue()[-2000:]}")
    counts = _tiled_only(trim_cuda, "the bench", em["main_path_launches"])
    for form, paths in em["main_path_launches"].items():
        for path, k in paths.items():
            check(k <= trim_cuda.LAUNCHES_BY_PATH[form][path],
                  "the bench reports more launches than were counted")
    check(all(counts.get(f) for f in launches),
          f"the bench did not launch every form: {counts}")
    add(counts)
    print(f"bench (reads-scale 0.05, 1 pass): se_uniform auto "
          f"{line['value']:.0f} reads/s, vs host {line['vs_host']:.3f}; "
          + "; ".join(f"{c} auto {r['modes']['auto']['median']:.0f} "
                      f"{r['unit']}" for c, r in em["cells"].items())
          + f"; fresh se process {em['fresh_process']['se_s']:.3f} s, "
          f"--version {em['fresh_process']['version_s']:.3f} s; gate held; "
          f"launches {counts} ({time.perf_counter() - t0:.1f} s)", flush=True)
    return launches


def _metrics(stderr: str) -> dict:
    from sickle_tpu_torch.tools.bench import BenchError, metrics

    try:
        return metrics(stderr)
    except BenchError as e:
        raise SmokeError(str(e))


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

    t_start = time.perf_counter()
    marks = [t_start]

    def mark(phase):
        marks.append(time.perf_counter())
        print(f"phase {phase}: {marks[-1] - marks[-2]:.1f} s", flush=True)

    card = phase_device(torch, trim_cuda)
    mark(1)
    dev = torch.device("cuda", 0)
    errs, times = phase_kernels(torch, trim_cuda, dev, card)
    mark(2)
    workdir = tempfile.mkdtemp(prefix="sickle_smoke_")
    try:
        launches, se_src = phase_e2e(trim_cuda, card, dev, workdir)
        mark(3)
        pe_launches, pe_inputs = phase_pe(trim_cuda, card, dev, workdir)
        mark(4)
        for form, n in pe_launches.items():
            launches[form] += n
        for form, n in phase_dist(trim_cuda, card, dev, workdir, se_src,
                                  pe_inputs).items():
            launches[form] += n
        mark(5)
        for form, n in phase_tools(trim_cuda, dev, workdir).items():
            launches[form] += n
        mark(6)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for form in ("raw", "band", "rank"):
        check(launches[form] > 0, f"the main path never launched the "
              f"{form} form: {launches}")
        check(sum(MAIN_PATHS[form].values()) == launches[form],
              f"launch counts by path {MAIN_PATHS} != by form {launches}")
    print(f"main-path launches by form and path: {MAIN_PATHS}", flush=True)
    print(f"smoke: all phases passed in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(f"card: {card}", flush=True)
    entries = []
    for name, form, timed, replaces in (
            ("trim_cuts", "raw", "raw_uniform", REPLACES),
            ("trim_cuts[band]", "band", "band", "sickle_tpu/ops/trim.py:93"),
            ("trim_cuts[rank]", "rank", "rank", "sickle_tpu/ops/trim.py:153")):
        t = times[timed]
        entries.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": launches[form],
            "launches_by_path": MAIN_PATHS[form],
            "max_abs_err": errs[form], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "one_launch_ms": t["one_launch_ms"], "host_ms": t["host_ms"],
            "direct_ms": t["direct_ms"],
            "direct_one_launch_ms": t["direct_one_launch_ms"]})
    print(json.dumps({"kernels": entries}))
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
