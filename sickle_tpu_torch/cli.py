"""Drop-in ``sickle se|pe`` command-line interface on the CUDA port.

The same flags, usage text, summaries, error text and exit codes as the
JAX package's CLI (``sickle_tpu/cli.py``), which is flag-compatible with
the reference (src/sickle.cpp:41-84, src/trim_single.cpp:83-211,
src/trim_paired.cpp:109-263).  The device is an explicit ``torch.device``
handed to ``main``.  Compute placement (``--cuts``) follows the JAX
package's default on one accelerator: ``auto`` and ``hybrid`` run the
hybrid router (``engine/hybrid.py``) over the CUDA cuts kernel on that
device, with the C++ host kernel taking overflow and stalls; ``device``
runs the CUDA kernel alone; ``host`` the indexed C++ host kernel alone
(rows are never packed).  ``--checkpoint`` makes se and pe runs
restartable.  ``--devices N`` shards each batch row-wise over N local
GPUs (``parallel/mesh.py``); ``--dist`` makes the run one process of a
gloo process group (``parallel/dist.py``) that trims its record-aligned
shard of the input into ``<output>.shard<i>``, rank 0 printing the
merged summary.  Each process of a ``--dist`` run uses the device it is
given (``cuda``: the current device; pin one GPU per process with
``CUDA_VISIBLE_DEVICES``).
"""

from __future__ import annotations

import dataclasses
import getopt
import os
import sys
import time
from typing import List, Optional

import torch

from .constants import (
    AUTHORS,
    CLI_QUALITY_TYPES,
    Compat,
    PROGRAM_NAME,
    VERSION,
)
from .engine import EngineConfig, run_pe, run_se
from .io import native
from .io.compression import open_input, open_output
from .oracle import PECounters, SECounters, SickleError
from .ops import TrimParams
from .utils import metrics as _metrics
from .utils.metrics import Metrics


def _merge_counters(counters):
    """Sum counters across processes in a --dist run (one gloo
    all_reduce); unchanged with one process.  The printed summary then
    reports GLOBAL totals.  None (the error written to stderr) when a
    peer process left the run before the merge: gloo reports the closed
    connection instead of waiting out its timeout."""
    from .parallel.dist import allreduce_host_counters

    se = isinstance(counters, SECounters)
    vals = ([counters.total, counters.kept, counters.discarded] if se else [
        counters.total, counters.kept_p, counters.kept_s1, counters.kept_s2,
        counters.discard_p, counters.discard_s1, counters.discard_s2,
    ])
    try:
        vals = allreduce_host_counters(vals)
    except RuntimeError as e:
        first = str(e).strip().splitlines()[0] if str(e).strip() else ""
        sys.stderr.write("****Error: the --dist run lost a peer process "
                         f"before the counter merge ({first}).\n\n")
        return None
    return SECounters(*vals) if se else PECounters(*vals)


class _Dist:
    """Multi-host run context (--dist).

    Joins the gloo process group (``parallel.dist.init_distributed``),
    after which the CLI shards plain and BGZF inputs by record-aligned
    byte ranges (parallel.dist), gives each process its own
    ``<output>.shard<i>`` (concatenating shards in shard order reproduces
    the single-process bytes; gzip shards concatenate into a valid
    multi-member stream too), and prints the merged GLOBAL summary on
    rank 0 only.
    """

    def __init__(self, enabled: bool, coordinator: Optional[str],
                 num_processes: Optional[int], process_id: Optional[int]):
        self.pid, self.nproc = 0, 1
        if not enabled:
            return
        import torch.distributed as dist

        from .parallel.dist import init_distributed

        init_distributed(coordinator, num_processes, process_id)
        self.pid = dist.get_rank()
        self.nproc = dist.get_world_size()

    @property
    def active(self) -> bool:
        return self.nproc > 1

    def shard_path(self, path: Optional[str]) -> Optional[str]:
        if path is None or not self.active:
            return path
        return f"{path}.shard{self.pid}"

    @property
    def trace_name(self) -> str:
        """--profile's file in the trace directory: one per process."""
        return f"trace.rank{self.pid}.json" if self.active else "trace.json"

    def check_splittable(self, *paths) -> Optional[str]:
        """Error text if any input cannot be byte-split across hosts.

        Plain files split by record-aligned byte ranges; BGZF gzip
        (blocked — bgzip/samtools output and this framework's own ``-g``
        output) splits in uncompressed space via its block index.  Only
        SERIAL gzip is rejected: it has no splittable address space.
        """
        if not self.active:
            return None
        from .io.compression import BgzfReader

        for fp in paths:
            if fp is None:
                continue
            try:
                with open(fp, "rb") as f:
                    if f.read(2) != b"\x1f\x8b":
                        continue
                if native.available() and BgzfReader.try_open(fp) is not None:
                    continue  # block-splittable; sharded in u-space
                return (
                    "****Error: multi-host runs need plain or BGZF "
                    "(block-splittable) input; serial gzip inputs must "
                    f"be pre-sharded per host ('{fp}').\n\n"
                )
            except FileNotFoundError:
                pass  # open_input reports missing files with parity text
            # other OSErrors (permissions, IO) propagate: downstream opens
            # would hit them anyway, and swallowing here would silently
            # disable the splittability check
        return None


DEFAULT_RECORDS_PER_CHUNK = 1 << 16


def _msg(debug: bool, text: str) -> None:
    if debug:
        from .utils import set_debug
        from .utils.logging import msg as _log_msg

        set_debug(True)
        _log_msg(text)


def _reader_msg(debug: bool, compat: Compat, path) -> None:
    """Stdout parity for "Building reader for <path>".

    The fork prints this line UNCONDITIONALLY from the reader ctor
    (the reference's src/GZReader.cpp:12 — a bare std::cout, not gated on
    _DEBUGMODE_), so even a debug-disabled fork build emits it on every
    clean run (it is in the recorded goldens' stdout).  --compat fork
    therefore always prints it; upstream 1.33 has no such line, so the
    default compat stays quiet unless -d."""
    if compat == Compat.FORK:
        sys.stdout.write(f"Building reader for {path}\n")
        sys.stdout.flush()
    else:
        _msg(debug, f"Building reader for {path}")


def main_usage(status: int) -> int:
    sys.stdout.write(
        f"\nUsage: {PROGRAM_NAME} <command> [options]\n\n"
        "Command:\n"
        "pe\tpaired-end sequence trimming\n"
        "se\tsingle-end sequence trimming\n\n"
        "--help, display this help and exit\n"
        "--version, output version information and exit\n\n"
    )
    return status


def version_text() -> str:
    return (
        f"{PROGRAM_NAME} version {VERSION}\n"
        "Copyright (c) 2011 The Regents of University of California, Davis Campus.\n"
        f"{PROGRAM_NAME} is free software and comes with ABSOLUTELY NO WARRANTY.\n"
        "Distributed under the MIT License.\n\n"
        f"Written by {AUTHORS}"
        "CUDA port: sickle-tpu-torch (PyTorch/CUDA).\n"
    )


SE_USAGE = f"""
Usage: {PROGRAM_NAME} se [options] -f <fastq sequence file> -t <quality type> -o <trimmed fastq file>

Options:
-f, --fastq-file, Input fastq file (required)
-t, --qual-type, Type of quality values (solexa (CASAVA < 1.3), illumina (CASAVA 1.3 to 1.7), sanger (which is CASAVA >= 1.8)) (required)
-o, --output-file, Output trimmed fastq file (required)
-q, --qual-threshold, Threshold for trimming based on average quality in a window. Default 20.
-l, --length-threshold, Threshold to keep a read based on length after trimming. Default 20.
-x, --no-fiveprime, Don't do five prime trimming.
-n, --trunc-n, Truncate sequences at position of first N.
-g, --gzip-output, Output gzipped files.
-a, --threads, Number of host worker threads.
-b, --batch, maximum MB of data to read from the input file at each cycle.
--compat, Behavior where the fork and sickle 1.33 disagree: '1.33' (default, '+' comment rewrite) or 'fork' (comment verbatim).
--devices, Number of accelerator chips to shard each batch over. Default: all.
--profile, Write a JAX profiler trace to the given directory.
--metrics, Print per-chunk pipeline stage timings (pack/dispatch/fetch/write) to stderr at exit.
--checkpoint, Sidecar file making the run restartable (re-run the same command to resume; gzip output resumes at BGZF member boundaries).
--strict, Error on ANY out-of-range quality char (default: only chars the trimming scan touches error, matching sickle 1.33).
--cuts, Compute placement: 'auto' (default: accelerator + host failover/assist), 'hybrid', 'device' (accelerator only), or 'host' (C++ host kernel only, no JAX).
--dist, Join a multi-host run (jax.distributed); each host trims its record-aligned shard of the input into <output>.shard<i> and host 0 prints the merged global summary.
--coordinator, host:port of the jax.distributed coordinator (with --dist; omit on TPU pods for auto-detection).
--num-processes, Total hosts in the --dist run (omit on TPU pods).
--process-id, This host's index in the --dist run (omit on TPU pods).
--quiet, Don't print out any trimming information
--help, display this help and exit
--version, output version information and exit

"""

PE_USAGE = f"""
If you have separate files for forward and reverse reads:
Usage: {PROGRAM_NAME} pe [options] -f <paired-end forward fastq file> -r <paired-end reverse fastq file> -t <quality type> -o <trimmed PE forward file> -p <trimmed PE reverse file> -s <trimmed singles file>

If you have one file with interleaved forward and reverse reads:
Usage: {PROGRAM_NAME} pe [options] -c <interleaved input file> -t <quality type> -m <interleaved trimmed paired-end output> -s <trimmed singles file>

If you have one file with interleaved reads as input and you want ONLY one interleaved file as output:
Usage: {PROGRAM_NAME} pe [options] -c <interleaved input file> -t <quality type> -m <interleaved trimmed output>

Options:
Paired-end separated reads
--------------------------
-f, --pe-file1, Input paired-end forward fastq file (Input files must have same number of records)
-r, --pe-file2, Input paired-end reverse fastq file
-o, --output-pe1, Output trimmed forward fastq file
-p, --output-pe2, Output trimmed reverse fastq file. Must use -s option.

Paired-end interleaved reads
----------------------------
-c, --pe-interleaved, Combined (interleaved) input paired-end fastq
-m, --output-interleaved, Output combined (interleaved) paired-end fastq file. Must use -s option.
-M, --output-n, Output combined (interleaved) file with any discarded read written as a single 'N' record, preserving pairing. Cannot be used with -m or -s.
--------------
-t, --qual-type, Type of quality values (solexa (CASAVA < 1.3), illumina (CASAVA 1.3 to 1.7), sanger (which is CASAVA >= 1.8)) (required)
-s, --output-single, Output trimmed singles fastq file
-q, --qual-threshold, Threshold for trimming based on average quality in a window. Default 20.
-l, --length-threshold, Threshold to keep a read based on length after trimming. Default 20.
-x, --no-fiveprime, Don't do five prime trimming.
-n, --truncate-n, Truncate sequences at position of first N.
-a, --threads, Number of host worker threads.
-b, --batch, maximum MB of data to read from the input file at each cycle.
--compat, Behavior where the fork and sickle 1.33 disagree: '1.33' (default) or 'fork'.
--devices, Number of accelerator chips to shard each batch over. Default: all.
--profile, Write a JAX profiler trace to the given directory.
--metrics, Print per-chunk pipeline stage timings (pack/dispatch/fetch/write) to stderr at exit.
--checkpoint, Sidecar file making the run restartable (re-run the same command to resume; gzip output resumes at BGZF member boundaries).
--strict, Error on ANY out-of-range quality char (default: only chars the trimming scan touches error, matching sickle 1.33).
--cuts, Compute placement: 'auto' (default: accelerator + host failover/assist), 'hybrid', 'device' (accelerator only), or 'host' (C++ host kernel only, no JAX).
--dist, Join a multi-host run (jax.distributed); each host trims its record-aligned shard of the input into <output>.shard<i> and host 0 prints the merged global summary.
--coordinator, host:port of the jax.distributed coordinator (with --dist; omit on TPU pods for auto-detection).
--num-processes, Total hosts in the --dist run (omit on TPU pods).
--process-id, This host's index in the --dist run (omit on TPU pods).
-g, --gzip-output, Output gzipped files.
--quiet, do not output trimming info
--help, display this help and exit
--version, output version information and exit

"""


def _usage_exit(text: str, status: int, msg: Optional[str] = None) -> int:
    sys.stderr.write(text)
    if msg:
        sys.stderr.write(f"{msg}\n\n")
    return status


def _parse_qualtype(optarg: str):
    qt = CLI_QUALITY_TYPES.get(optarg)
    if qt is None:
        sys.stderr.write(f"Error: Quality type '{optarg}' is not a valid type.\n")
    return qt


def _records_per_chunk(batch_mb: Optional[int]) -> int:
    """Map the reference's -b (MB per cycle) to a record count.

    Assumes ~256 bytes/record (150bp reads); clamped so device batches stay
    in a practical range.  The shapes are fixed per run regardless.
    """
    if batch_mb is None:
        return DEFAULT_RECORDS_PER_CHUNK
    recs = (max(batch_mb, 1) << 20) // 256
    return max(4096, min(recs, 1 << 18))


CUTS_MODES = ("auto", "hybrid", "device", "host")


def _resolve_cuts_mode(mode: str) -> str:
    """``--cuts auto`` (given or by default) becomes ``host`` when the
    environment sets ``SICKLE_TPU_CUTS=host``, as in the JAX package
    (``sickle_tpu/cli.py::_build_cuts_fn``); ``--cuts device``,
    ``hybrid`` and ``host`` are taken as given."""
    if mode == "auto" and os.environ.get("SICKLE_TPU_CUTS") == "host":
        return "host"
    return mode


def _refused(cuts_mode: str, device: torch.device) -> Optional[int]:
    """Exit code 1 when the run needs a CUDA device that is absent, else
    None.  No CPU fallback."""
    if (cuts_mode != "host" and device.type == "cuda"
            and not torch.cuda.is_available()):
        sys.stderr.write(
            "****Error: no CUDA device is available for the cuts kernel "
            "(use --cuts host).\n\n")
        return 1
    return None


_ACTIVE_CUTS_FN = None  # last built cuts fn; its workers stop in _finish
_REPORT = None  # the call's --metrics recorder, reported in _finish


def _build_cuts_fn(params: TrimParams, mode: str, device: torch.device,
                   cfg: EngineConfig, devices: Optional[int] = None):
    """The cuts fn for ``--cuts`` (the JAX package's ``default_cuts_fn``):

    * host: the hybrid fn with no device (every chunk takes the indexed
      host kernel, rows never packed), or the row-packed host kernel when
      the native library is missing;
    * device: the CUDA kernel on ``device`` alone;
    * auto/hybrid: the hybrid router over the CUDA kernel when the native
      library is there (``auto`` unless ``SICKLE_TPU_HYBRID`` turns it
      off), else the CUDA kernel alone.

    ``devices`` (``--devices``, default: all) shards the device step over
    ``n = min(devices or count, count)`` local devices, ``count`` being
    ``torch.cuda.device_count()`` on a CUDA device; a CPU device has as
    many copies as asked for (one by default), so the shard path runs
    without a card.  For ``n > 1`` the chunk size is rounded up to a
    multiple of ``max(n, 8)`` (``cfg.records_per_chunk``).

    A CPU ``device`` runs the kernel's plain PyTorch version.  Building
    the device fn builds the kernel library and creates the CUDA context,
    so the first chunk does not pay them."""
    global _ACTIVE_CUTS_FN
    from .engine.hybrid import HybridCutsFn, hybrid_enabled

    if mode == "host":
        if native.available():
            fn = HybridCutsFn(params, None)
        else:
            from .ops.trim_host import host_cuts_fn

            fn = host_cuts_fn(params)
    else:
        count = (torch.cuda.device_count() if device.type == "cuda"
                 else devices or 1)
        n = min(devices or count, count)
        if n <= 1:
            from .engine.pipeline import _cuda_cuts_fn

            fn = _cuda_cuts_fn(params, device, cfg.slice_rows)
        else:
            from .parallel import data_mesh, sharded_cuts_fn

            mult = max(n, 8)
            cfg.records_per_chunk = -(-cfg.records_per_chunk // mult) * mult
            fn = sharded_cuts_fn(params, data_mesh(n, device.type),
                                 cfg.slice_rows)
        if mode != "device" and native.available() and hybrid_enabled(
                True if mode == "hybrid" else None):
            fn = HybridCutsFn(params, fn)
    _ACTIVE_CUTS_FN = fn
    return fn


def _open_resumable(path: str, gzip_out: bool = False):
    """Open an output for checkpointed writing (create if missing).

    gzip outputs open as a resumable BgzfWriter: flushes land on member
    boundaries, so checkpointed sizes are valid truncation points."""
    if gzip_out:
        from .io.compression import BgzfWriter

        return BgzfWriter(path, resumable=True)
    if native.available() and not os.environ.get("SICKLE_TPU_NO_MMAP_OUT"):
        # MmapWriter supports the resume protocol (truncate/seek/tell)
        # and gives checkpointed plain outputs the zero-copy emit path;
        # existing content is KEPT (r+b semantics) for resume_outputs
        from .io.output import MmapWriter

        w = MmapWriter.open_regular(path)
        if w is not None:
            return w
    try:
        return open(path, "r+b")
    except FileNotFoundError:
        return open(path, "w+b")


_GZIP_CHECKPOINT_ERROR = (
    "****Error: --checkpoint with -g needs the native BGZF codec (serial "
    "gzip has no member-aligned truncation points).\n\n")


def _checkpoint_path(base: str) -> str:
    """Per-process checkpoint file in multi-host runs (independent input
    shards advance independently); ``base`` itself with one process."""
    from .parallel.dist import _rank_and_size

    rank, size = _rank_and_size()
    if size > 1:
        return f"{base}.host{rank}"
    return base


class _Profile:
    """--profile DIR: a torch.profiler trace of the run, written as
    ``DIR/<name>`` (Chrome trace format): ``trace.json``, or
    ``trace.rank<i>.json`` in each process of a --dist run.  It records
    every thread the run starts, so with --metrics the engine's spans
    land on their threads."""

    def __init__(self, trace_dir: Optional[str], device: torch.device,
                 name: str = "trace.json"):
        self.trace_dir = trace_dir
        self.device = device
        self.name = name
        self._prof = None

    def __enter__(self):
        if self.trace_dir:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            try:
                from torch.profiler import _ExperimentalConfig

                config = _ExperimentalConfig(profile_all_threads=True)
            except (ImportError, TypeError):  # a torch without the option
                config = None
            self._prof = profile(activities=acts, experimental_config=config)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
            os.makedirs(self.trace_dir, exist_ok=True)
            self._prof.export_chrome_trace(
                os.path.join(self.trace_dir, self.name))
        return False


def _call(body, argv: List[str], device: torch.device) -> int:
    """Run one CLI call's ``body``; its --metrics recorder is the slot's
    (``utils.metrics.install``) for the duration of the call."""
    global _REPORT
    _REPORT = None
    try:
        return body(argv, device, time.perf_counter_ns())
    finally:
        _metrics.install(None)


def _start_metrics(cfg: EngineConfig, t0: int, t_parsed: int) -> None:
    """--metrics: the call's recorder, with the spans it missed."""
    cfg.metrics = mtr = Metrics()
    mtr.add_span("call.parse", t0, t_parsed)
    mtr.add_span("call.build_cuts_fn", t_parsed, time.perf_counter_ns())
    _metrics.install(mtr)


def _end_metrics(cfg: EngineConfig) -> None:
    """The call is done: report once ``_finish`` has stopped the router."""
    global _REPORT
    if cfg.metrics is not None:
        cfg.metrics.stop()
        _REPORT = cfg.metrics


def se_main(argv: List[str], device: torch.device) -> int:
    return _call(_se_main, argv, device)


def pe_main(argv: List[str], device: torch.device) -> int:
    return _call(_pe_main, argv, device)


def _se_main(argv: List[str], device: torch.device, t0: int) -> int:
    longopts = [
        "fastq-file=", "output-file=", "qual-type=", "qual-threshold=",
        "length-threshold=", "no-fiveprime", "discard-n", "gzip-output",
        "quiet", "threads=", "batch=", "compat=", "devices=", "profile=",
        "metrics", "checkpoint=", "strict", "cuts=", "dist", "coordinator=",
        "num-processes=", "process-id=", "help", "version",
    ]
    try:
        opts, extra = getopt.gnu_getopt(argv, "df:t:o:q:a:b:l:zxng", longopts)
    except getopt.GetoptError as e:
        sys.stderr.write(f"{e}\n")
        return _usage_exit(SE_USAGE, 1)

    infn = outfn = None
    qualtype = None
    q_thresh, l_thresh = 20, 20
    no_five = trunc_n = gzip_out = quiet = debug = strict = False
    dist_on, coordinator, n_procs, proc_id = False, None, None, None
    cuts_mode = "auto"
    batch_mb = None
    devices = None
    compat = Compat.V133
    profile = None
    metrics_on = False
    ckfn = None

    for o, a in opts:
        if o in ("-f", "--fastq-file"):
            infn = a
        elif o in ("-o", "--output-file"):
            outfn = a
        elif o in ("-t", "--qual-type"):
            qualtype = _parse_qualtype(a)
            if qualtype is None:
                return _usage_exit(SE_USAGE, 1)
        elif o in ("-q", "--qual-threshold"):
            q_thresh = int(a)
            if q_thresh < 0:
                sys.stderr.write("Quality threshold must be >= 0\n")
                return 1
        elif o in ("-l", "--length-threshold"):
            l_thresh = int(a)
            if l_thresh < 0:
                sys.stderr.write("Length threshold must be >= 0\n")
                return 1
        elif o in ("-x", "--no-fiveprime"):
            no_five = True
        elif o == "--strict":
            strict = True
        elif o == "--cuts":
            cuts_mode = a.strip().lower()
            if cuts_mode not in CUTS_MODES:
                sys.stderr.write(
                    f"****Error: --cuts must be auto, hybrid, device or host, got '{a}'.\n\n")
                return 1
        elif o == "--dist":
            dist_on = True
        elif o == "--coordinator":
            coordinator = a
        elif o == "--num-processes":
            n_procs = int(a)
        elif o == "--process-id":
            proc_id = int(a)
        elif o in ("-n", "--discard-n"):
            trunc_n = True
        elif o in ("-g", "--gzip-output"):
            gzip_out = True
        elif o in ("-z", "--quiet"):
            quiet = True
        elif o == "-d":
            debug = True
        elif o in ("-a", "--threads"):
            native.set_threads(int(a))
        elif o in ("-b", "--batch"):
            batch_mb = int(a)
        elif o == "--compat":
            compat = Compat(a) if a != "1.33" else Compat.V133
        elif o == "--devices":
            devices = int(a)
        elif o == "--profile":
            profile = a
        elif o == "--metrics":
            metrics_on = True
        elif o == "--checkpoint":
            ckfn = a
        elif o == "--help":
            sys.stdout.write(SE_USAGE)
            return 0
        elif o == "--version":
            sys.stdout.write(version_text())
            return 0

    if qualtype is None or infn is None or outfn is None:
        return _usage_exit(
            SE_USAGE, 1,
            "****Error: Must have quality type, input file, and output file.",
        )
    if infn == outfn:
        sys.stderr.write("****Error: Input file is same as output file.\n\n")
        return 1
    cuts_mode = _resolve_cuts_mode(cuts_mode)
    rc = _refused(cuts_mode, device)
    if rc is not None:
        return rc

    _msg(debug, "Setting se trimming params")
    params = TrimParams(
        qualtype=qualtype,
        qual_threshold=q_thresh,
        length_threshold=l_thresh,
        no_fiveprime=no_five,
        trunc_n=trunc_n,
        compat=compat,
        strict=strict,
    )
    dist = _Dist(dist_on, coordinator, n_procs, proc_id)
    cfg = EngineConfig(records_per_chunk=_records_per_chunk(batch_mb),
                       compat=compat)
    t_parsed = time.perf_counter_ns()
    cuts_fn = _build_cuts_fn(params, cuts_mode, device, cfg, devices)
    if metrics_on:
        _start_metrics(cfg, t0, t_parsed)
    in_off = 0
    if dist.active:
        err = dist.check_splittable(infn)
        if err:
            sys.stderr.write(err)
            return 1
        from .parallel.dist import shard_record_ranges

        in_off, cfg.byte_limit = shard_record_ranges(infn, dist.nproc)[dist.pid]
        outfn = dist.shard_path(outfn)

    counters_in = None
    ck = None
    if ckfn:
        if gzip_out and not native.available():
            sys.stderr.write(_GZIP_CHECKPOINT_ERROR)
            return 1
        from .engine.checkpoint import TrimCheckpoint, progress_saver, resume_outputs

        ck = TrimCheckpoint(_checkpoint_path(ckfn))
        st = ck.load()

    _msg(debug, "trim_main()")
    _reader_msg(debug, compat, infn)
    try:
        with open_input(infn) as fin:
            if in_off:
                fin.seek(in_off)
            if ck is not None:
                with _metrics.span("call.open_outputs"):
                    out = _open_resumable(outfn, gzip_out)
                if st is not None:
                    resume_outputs(st, {outfn: out})
                    counters_in = SECounters(**st.counters)
                    cfg.skip_records = st.records_done
                    _msg(debug, f"Resuming at record {st.records_done}")
                cfg.progress_cb = progress_saver(
                    ck, dataclasses.asdict, {outfn: out}
                )
            else:
                with _metrics.span("call.open_outputs"):
                    out = open_output(outfn, gzip_out)
            try:
                with (_Profile(profile, device, dist.trace_name),
                      _metrics.span("engine")):
                    counters = run_se(fin, out, params, cfg=cfg,
                                      cuts_fn=cuts_fn, counters=counters_in)
            finally:
                if out is not sys.stdout.buffer:
                    with _metrics.span("call.close_outputs"):
                        out.close()
    except FileNotFoundError:
        sys.stderr.write(f"****Error: Could not open input file '{infn}'.\n\n")
        return 1
    except SickleError as e:
        sys.stderr.write(e.message + "\n")
        return e.exit_code

    _end_metrics(cfg)
    counters = _merge_counters(counters)
    if counters is None:
        return 1
    if not quiet and dist.pid == 0:
        sys.stdout.write(
            f"\nSE input file: {infn}\n\n"
            f"Total FastQ records: {counters.total}\n"
            f"FastQ records kept: {counters.kept}\n"
            f"FastQ records discarded: {counters.discarded}\n\n"
        )
    return 0


def _pe_main(argv: List[str], device: torch.device, t0: int) -> int:
    longopts = [
        "qual-type=", "pe-file1=", "pe-file2=", "pe-interleaved=",
        "output-pe1=", "output-pe2=", "output-single=", "output-interleaved=",
        "output-n=", "qual-threshold=", "length-threshold=", "no-fiveprime",
        "truncate-n", "gzip-output", "quiet", "threads=", "batch=",
        "compat=", "devices=", "profile=", "metrics", "checkpoint=",
        "strict", "cuts=", "dist", "coordinator=", "num-processes=",
        "process-id=", "help", "version",
    ]
    try:
        opts, extra = getopt.gnu_getopt(argv, "df:r:c:t:o:p:m:M:s:q:a:b:l:xng", longopts)
    except getopt.GetoptError as e:
        sys.stderr.write(f"{e}\n")
        return _usage_exit(PE_USAGE, 1)

    infn = infn2 = infnc = None
    outfn = outfn2 = outfnc = sfn = None
    n_record_mode = False
    qualtype = None
    q_thresh, l_thresh = 20, 20
    no_five = trunc_n = gzip_out = quiet = debug = strict = False
    dist_on, coordinator, n_procs, proc_id = False, None, None, None
    cuts_mode = "auto"
    batch_mb = None
    devices = None
    compat = Compat.V133
    profile = None
    metrics_on = False
    ckfn = None

    for o, a in opts:
        if o in ("-f", "--pe-file1"):
            infn = a
        elif o in ("-r", "--pe-file2"):
            infn2 = a
        elif o in ("-c", "--pe-interleaved"):
            infnc = a
        elif o in ("-o", "--output-pe1"):
            outfn = a
        elif o in ("-p", "--output-pe2"):
            outfn2 = a
        elif o in ("-m", "--output-interleaved"):
            outfnc = a
        elif o in ("-M", "--output-n"):
            outfnc = a
            n_record_mode = True
        elif o in ("-s", "--output-single"):
            sfn = a
        elif o in ("-t", "--qual-type"):
            qualtype = _parse_qualtype(a)
            if qualtype is None:
                return _usage_exit(PE_USAGE, 1)
        elif o in ("-q", "--qual-threshold"):
            q_thresh = int(a)
            if q_thresh < 0:
                sys.stderr.write("Quality threshold must be >= 0\n")
                return 1
        elif o in ("-l", "--length-threshold"):
            l_thresh = int(a)
            if l_thresh < 0:
                sys.stderr.write("Length threshold must be >= 0\n")
                return 1
        elif o in ("-x", "--no-fiveprime"):
            no_five = True
        elif o == "--strict":
            strict = True
        elif o == "--cuts":
            cuts_mode = a.strip().lower()
            if cuts_mode not in CUTS_MODES:
                sys.stderr.write(
                    f"****Error: --cuts must be auto, hybrid, device or host, got '{a}'.\n\n")
                return 1
        elif o == "--dist":
            dist_on = True
        elif o == "--coordinator":
            coordinator = a
        elif o == "--num-processes":
            n_procs = int(a)
        elif o == "--process-id":
            proc_id = int(a)
        elif o in ("-n", "--truncate-n"):
            trunc_n = True
        elif o in ("-g", "--gzip-output"):
            gzip_out = True
        elif o == "--quiet":
            quiet = True
        elif o == "-d":
            debug = True
        elif o in ("-a", "--threads"):
            native.set_threads(int(a))
        elif o in ("-b", "--batch"):
            batch_mb = int(a)
        elif o == "--compat":
            compat = Compat(a) if a != "1.33" else Compat.V133
        elif o == "--devices":
            devices = int(a)
        elif o == "--profile":
            profile = a
        elif o == "--metrics":
            metrics_on = True
        elif o == "--checkpoint":
            ckfn = a
        elif o == "--help":
            sys.stdout.write(PE_USAGE)
            return 0
        elif o == "--version":
            sys.stdout.write(version_text())
            return 0

    if qualtype is None:
        return _usage_exit(PE_USAGE, 1, "****Error: Quality type is required.")
    if not infn and not infnc:
        return _usage_exit(
            PE_USAGE, 1, "****Error: Must have either -f OR -c argument."
        )
    if infnc:
        if infn or infn2 or outfn or outfn2:
            return _usage_exit(
                PE_USAGE, 1,
                "****Error: Cannot have -f, -r, -o, or -p options with -c.",
            )
        if not outfnc:
            return _usage_exit(
                PE_USAGE, 1,
                "****Error: Interleaved input requires -m or -M output.",
            )
        if n_record_mode and sfn:
            return _usage_exit(
                PE_USAGE, 1, "****Error: Cannot use -M with -s."
            )
        # -m without -s is the "only one interleaved output" mode: singles
        # are counted but not written (reference writes them only if sfn,
        # src/trim_paired.cpp:712-726)
    else:
        if not infn2 or not outfn or not outfn2 or not sfn:
            return _usage_exit(
                PE_USAGE, 1,
                "****Error: Using the -f option means you must have the -r, -o, -p, and -s options.",
            )
        if outfnc or n_record_mode:
            return _usage_exit(
                PE_USAGE, 1,
                "****Error: The -f option cannot be used in combination with -c, -m, or -M.",
            )
    cuts_mode = _resolve_cuts_mode(cuts_mode)
    rc = _refused(cuts_mode, device)
    if rc is not None:
        return rc

    params = TrimParams(
        qualtype=qualtype,
        qual_threshold=q_thresh,
        length_threshold=l_thresh,
        no_fiveprime=no_five,
        trunc_n=trunc_n,
        compat=compat,
        strict=strict,
    )
    dist = _Dist(dist_on, coordinator, n_procs, proc_id)
    cfg = EngineConfig(records_per_chunk=_records_per_chunk(batch_mb),
                       compat=compat)
    t_parsed = time.perf_counter_ns()
    cuts_fn = _build_cuts_fn(params, cuts_mode, device, cfg, devices)
    if metrics_on:
        _start_metrics(cfg, t0, t_parsed)
    in_off = in_off2 = 0
    if dist.active:
        err = dist.check_splittable(infnc, infn, infn2)
        if err:
            sys.stderr.write(err)
            return 1
        if infnc:
            from .parallel.dist import shard_record_ranges

            in_off, cfg.byte_limit = shard_record_ranges(
                infnc, dist.nproc, align=2
            )[dist.pid]
        else:
            from .parallel.dist import shard_paired_ranges

            (r1, r2) = shard_paired_ranges(infn, infn2, dist.nproc)[dist.pid]
            in_off, cfg.byte_limit = r1
            in_off2, cfg.byte_limit2 = r2
        outfn = dist.shard_path(outfn)
        outfn2 = dist.shard_path(outfn2)
        outfnc = dist.shard_path(outfnc)
        sfn = dist.shard_path(sfn)

    counters_in = None
    ck = None
    if ckfn:
        if gzip_out and not native.available():
            sys.stderr.write(_GZIP_CHECKPOINT_ERROR)
            return 1
        from .engine.checkpoint import TrimCheckpoint, progress_saver, resume_outputs

        ck = TrimCheckpoint(_checkpoint_path(ckfn))
        st = ck.load()

    outs = []
    ck_streams = {}

    def out_stream(path):
        if ck is not None:
            s = _open_resumable(path, gzip_out)
            ck_streams[path] = s
        else:
            s = open_output(path, gzip_out)
        outs.append(s)
        return s

    def apply_resume():
        if ck is None:
            return
        nonlocal counters_in
        if st is not None:
            resume_outputs(st, ck_streams)
            counters_in = PECounters(**st.counters)
            cfg.skip_records = st.records_done
            _msg(debug, f"Resuming at record {st.records_done}")
        cfg.progress_cb = progress_saver(ck, dataclasses.asdict, ck_streams)

    try:
        if infnc:
            _reader_msg(debug, compat, infnc)
            with open_input(infnc) as fin:
                if in_off:
                    fin.seek(in_off)
                with _metrics.span("call.open_outputs"):
                    o1 = out_stream(outfnc)
                    so = out_stream(sfn) if sfn else None
                apply_resume()
                with (_Profile(profile, device, dist.trace_name),
                      _metrics.span("engine")):
                    counters = run_pe(
                        fin, None, interleaved=True,
                        out1=o1,
                        singles_out=so,
                        n_record_mode=n_record_mode,
                        params=params, cfg=cfg, cuts_fn=cuts_fn,
                        counters=counters_in,
                    )
        else:
            _reader_msg(debug, compat, infn)
            _reader_msg(debug, compat, infn2)
            with open_input(infn) as f1, open_input(infn2) as f2:
                if in_off:
                    f1.seek(in_off)
                if in_off2:
                    f2.seek(in_off2)
                with _metrics.span("call.open_outputs"):
                    o1 = out_stream(outfn)
                    o2 = out_stream(outfn2)
                    so = out_stream(sfn)
                apply_resume()
                with (_Profile(profile, device, dist.trace_name),
                      _metrics.span("engine")):
                    counters = run_pe(
                        f1, f2, interleaved=False,
                        out1=o1,
                        out2=o2,
                        singles_out=so,
                        params=params, cfg=cfg, cuts_fn=cuts_fn,
                        counters=counters_in,
                    )
    except FileNotFoundError as e:
        sys.stderr.write(f"****Error: Could not open input file '{e.filename}'.\n\n")
        return 1
    except SickleError as e:
        sys.stderr.write(e.message + "\n")
        return e.exit_code
    finally:
        with _metrics.span("call.close_outputs"):
            for s in outs:
                if s is not sys.stdout.buffer:
                    s.close()

    _end_metrics(cfg)
    counters = _merge_counters(counters)
    if counters is None:
        return 1
    if not quiet and dist.pid == 0:
        c = counters
        if infn and infn2:
            sys.stdout.write(f"\nPE forward file: {infn}\nPE reverse file: {infn2}\n")
        if infnc:
            sys.stdout.write(f"\nPE interleaved file: {infnc}\n")
        sys.stdout.write(
            f"\nTotal input FastQ records: {c.total} ({c.total // 2} pairs)\n"
        )
        sys.stdout.write(
            f"\nFastQ paired records kept: {c.kept_p} ({c.kept_p // 2} pairs)\n"
        )
        if infnc:
            sys.stdout.write(f"FastQ single records kept: {c.kept_s1 + c.kept_s2}\n")
        else:
            sys.stdout.write(
                f"FastQ single records kept: {c.kept_s1 + c.kept_s2} "
                f"(from PE1: {c.kept_s1}, from PE2: {c.kept_s2})\n"
            )
        sys.stdout.write(
            f"FastQ paired records discarded: {c.discard_p} ({c.discard_p // 2} pairs)\n"
        )
        if infnc:
            sys.stdout.write(
                f"FastQ single records discarded: {c.discard_s1 + c.discard_s2}\n\n"
            )
        else:
            sys.stdout.write(
                f"FastQ single records discarded: {c.discard_s1 + c.discard_s2} "
                f"(from PE1: {c.discard_s1}, from PE2: {c.discard_s2})\n\n"
            )
    return 0


def main(argv: Optional[List[str]] = None, device=None) -> int:
    """The ``sickle`` CLI.  ``device``: where the device step runs (a
    ``torch.device`` or its name); default ``cuda``."""
    device = torch.device(device if device is not None else "cuda")
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in ("pe", "se", "--version", "--help"):
        return main_usage(1)
    if argv[0] == "--version":
        sys.stdout.write(version_text())
        return 0
    if argv[0] == "--help":
        return main_usage(0)
    if argv[0] == "pe":
        return _finish(pe_main(argv[1:], device))
    return _finish(se_main(argv[1:], device))


def _finish(rc: int) -> int:
    """Stop the hybrid fn's workers, print the --metrics report, then
    leave the --dist process group, before interpreter teardown.  If a
    worker is WEDGED in a device call that never returns, exit hard with
    the real return code: all user-visible output is already flushed."""
    global _ACTIVE_CUTS_FN, _REPORT
    fn, _ACTIVE_CUTS_FN = _ACTIVE_CUTS_FN, None
    mtr, _REPORT = _REPORT, None
    close = getattr(fn, "close", None)
    with _metrics.span("call.close_cuts_fn", mtr):
        closed = close is None or close() is not False
    if mtr is not None:
        mtr.report()
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    if not closed:
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(rc)
    return rc


if __name__ == "__main__":
    sys.exit(main())
