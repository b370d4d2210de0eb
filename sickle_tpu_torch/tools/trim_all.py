"""Directory batch tool: trim every FASTQ in a directory.

Port of the JAX package's ``tools/trim_all.py`` (itself capability
parity with the reference's 110-line subprocess script): walks an input
directory, pairs mate files by ``.1/.2`` or ``_1/_2`` suffix, skips
outputs that already exist (resume), shows progress, and reports
per-file timing.

Files are processed IN-PROCESS through the port's CLI on one torch
device (``cuda`` by default), so the CUDA kernel library is built and
the CUDA context created once for every file; each file's cuts fn is
closed (router workers stopped) before the next starts.

Usage:
    python -m sickle_tpu_torch.tools.trim_all [se|pe] [solexa|illumina|sanger] \
        input_dir/ output_dir/ [threads] [batch_mb]
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Optional, Tuple

import torch

from ..cli import _finish, pe_main, se_main

USAGE = (
    "How to use: python -m sickle_tpu_torch.tools.trim_all [se|pe] "
    "[solexa|illumina|sanger] input_dir/ output_dir/ [threads] [batch_mb]"
)


def _fastqs(d: str) -> List[str]:
    return sorted(
        f for f in os.listdir(d) if f.endswith((".fq", ".fastq"))
    )


def _mate1_files(d: str) -> Tuple[str, List[str]]:
    """Find mate-1 files; returns (separator, files)."""
    for sep in (".", "_"):
        files = sorted(
            f for f in os.listdir(d)
            if f.endswith((sep + "1.fq", sep + "1.fastq"))
        )
        if len(files) >= 1:
            return sep, files
    return ".", []


def _strip_ext(name: str) -> str:
    return name.rsplit(".", 1)[0] if "." in name else name


def _progress(i: int, n: int, name: str) -> None:
    sys.stderr.write(f"[{i + 1}/{n}] {name}\n")


def run_se_dir(qual_type: str, input_dir: str, output_dir: str,
               extra: Optional[List[str]] = None,
               device: torch.device = torch.device("cuda")) -> int:
    files = _fastqs(input_dir)
    print("Running sickle se for the following files:\n" + "\n".join(files))
    for i, f in enumerate(files):
        out = os.path.join(output_dir, _strip_ext(f) + ".trim.fastq")
        if os.path.exists(out):
            print(f"{out} already exists, skipping it.")
            continue
        _progress(i, len(files), f)
        t0 = time.perf_counter()
        rc = _finish(se_main(
            ["-t", qual_type, "-f", os.path.join(input_dir, f), "-o", out]
            + (extra or []), device))
        sys.stderr.write(f"    {time.perf_counter() - t0:.2f}s\n")
        if rc != 0:
            return rc
    return 0


def run_pe_dir(qual_type: str, input_dir: str, output_dir: str,
               extra: Optional[List[str]] = None,
               device: torch.device = torch.device("cuda")) -> int:
    sep, files = _mate1_files(input_dir)
    print("Running sickle pe for the following files:\n" + "\n".join(files))
    for i, f1 in enumerate(files):
        ext = ".fastq" if f1.endswith(".fastq") else ".fq"
        f2 = f1[: -len(sep + "1" + ext)] + sep + "2" + ext
        in1 = os.path.join(input_dir, f1)
        in2 = os.path.join(input_dir, f2)
        if not os.path.exists(in2):
            print(f"Input {in2} doesn't exist, finishing.")
            return 1
        o1 = os.path.join(output_dir, f1.replace(ext, ".trim.fastq"))
        o2 = os.path.join(output_dir, f2.replace(ext, ".trim.fastq"))
        singles = o2.replace(sep + "2.trim.fastq", sep + "s.trim.fastq")
        if any(os.path.exists(p) for p in (o1, o2, singles)):
            print(f"{o1} already exists, skipping it.")
            continue
        _progress(i, len(files), f1)
        t0 = time.perf_counter()
        rc = _finish(pe_main(
            ["-t", qual_type, "-f", in1, "-r", in2,
             "-o", o1, "-p", o2, "-s", singles] + (extra or []), device))
        sys.stderr.write(f"    {time.perf_counter() - t0:.2f}s\n")
        if rc != 0:
            return rc
    return 0


def main(argv: Optional[List[str]] = None, device=None) -> int:
    """``device``: where each file's device step runs (a ``torch.device``
    or its name); default ``cuda``."""
    device = torch.device(device if device is not None else "cuda")
    argv = list(sys.argv[1:] if argv is None else argv)
    print(USAGE)
    if len(argv) < 4:
        return 1
    mode, qual_type, input_dir, output_dir = argv[:4]
    extra: List[str] = []
    if len(argv) >= 5:
        extra += ["-a", argv[4]]
    if len(argv) >= 6:
        extra += ["-b", argv[5]]
    os.makedirs(output_dir, exist_ok=True)
    if mode == "se":
        return run_se_dir(qual_type, input_dir, output_dir, extra, device)
    if mode == "pe":
        return run_pe_dir(qual_type, input_dir, output_dir, extra, device)
    print(f"There is no '{mode}' mode available")
    return 1


if __name__ == "__main__":
    sys.exit(main())
