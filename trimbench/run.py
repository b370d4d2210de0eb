"""Runs one cell of the benchmark once and prints its result line.

    python3 -m trimbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, this folder and
the port (``sickle_tpu_torch``).  A run:

1. starts up: torch, the port's CLI, its native libraries and the CUDA
   context (``startup_s``, from the process's start);
2. makes the configuration's samples on the card from the seed and writes
   them as the cell's traffic says (plain, or BGZF as ``bgzip`` writes
   them) under ``TMPDIR``, synced to disk: a mate file per mate (two for
   a paired-end configuration, one for a single-end one), one set per
   sample, or with the traffic's ``pool`` every sample in one set;
3. warms up: trims a warm-up file set of ``WARMUP_PAIRS`` pairs, made
   and written as the samples are, once: a full chunk and a partial one,
   at the cell's read lengths and through its reader, writer and pipes
   (``setup_s`` ends here);
4. for ``--seconds``, trims one file set after another in the seeded
   plate order, each a call of ``sickle_tpu_torch.cli.main`` in this
   process on ``cuda`` (``pe`` on two mate files, ``se`` on one), its
   ``-g`` outputs (``pe``'s three, ``se``'s one) written into named pipes
   that a drain process reads (``trimbench/drain.py``); the window ends
   when the call in flight at ``--seconds`` returns.  ``--trace 1`` adds
   ``--metrics`` to each call and profiles the window;
5. reads the card's memory peak, checks that no JAX module was loaded,
   works out every file set of the window again with the plain reference
   (``trimbench/reference.py``), a pooled one as its samples one after
   another, and holds each call's outputs and summary to it
   (``trimbench/compare.py``);
6. prints the compared numbers with their limits as the last lines of
   standard error, and one JSON line: ``correct``, ``attempted``,
   ``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
   and ``checks`` last.

The drain runs on the last core this process may use and the program on
the others, so the drain never preempts one of the program's parallel
loops; every call passes ``-a`` with the program's number of cores, as a
pipeline passes ``-a $(nproc)``.  A fixed deflate, timed before and after
the window, shows on standard error whether the host's speed drifted.

The run writes only its input to disk, and removes it.  It exits 2 without
a result when the cell's cards are not there, and 1 when a JAX module was
loaded or the port is missing.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import errno
import hashlib
import io
import json
import os
import pathlib
import random
import select
import shutil
import stat
import subprocess
import sys
import tempfile
import time
import traceback
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, NamedTuple, Optional

from . import (bgzf, catalog, compare, corpus, devtrace, readers, reference,
               roofline)
from .drain import gunzip

ROOT = catalog.ROOT
FORBIDDEN = ("jax", "jaxlib", "flax", "sickle_tpu")
CACHE = ROOT / ".trimbench_cache"
DRAIN_TIMEOUT_S = 120.0
# more than one of the engine's chunks of 65,536 records, so the warm-up
# call runs a full chunk and a partial one
WARMUP_PAIRS = 100_000


def process_age_s() -> float:
    """Seconds since this process started (``/proc/self/stat``)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - started


def split_cores() -> tuple:
    """``(program, drain)``: the cores this process may use, the last for
    the drain and the others for the program; all of them for both where
    there is only one."""
    cores = sorted(os.sched_getaffinity(0))
    return (cores[:-1], cores[-1:]) if len(cores) > 1 else (cores, cores)


def host_probe_s() -> float:
    """Seconds one core takes to deflate a fixed 4 MiB of bases at level 4:
    the host's speed, apart from the program's."""
    data = random.Random(0).randbytes(1 << 22).translate(bytes(b"ACGT") * 64)
    t0 = time.perf_counter()
    zlib.compress(data, 4)
    return time.perf_counter() - t0


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Sink:
    """The named pipes of each call and the drain process that reads them."""

    def __init__(self, work: pathlib.Path, cores: List[int]):
        self.dir = work / "pipes"
        self.dir.mkdir()
        self.paths: List[str] = []
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "trimbench.drain",
             ",".join(map(str, cores))], cwd=ROOT,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE)

    def _send(self, msg: dict) -> None:
        self.proc.stdin.write((json.dumps(msg) + "\n").encode())
        self.proc.stdin.flush()

    def call(self, call_id: str, outputs: int) -> List[str]:
        """The pipes of a call's first ``outputs`` of ``-o``, ``-p``, ``-s``."""
        paths = [str(self.dir / f"{call_id}.{out}")
                 for out in ("o", "p", "s")[:outputs]]
        for path in paths:
            os.mkfifo(path, 0o600)
        self.paths += paths
        self._send({"call": call_id, "paths": paths})
        return paths

    def _release(self, deadline: float) -> None:
        """Opens and closes, as a writer, each pipe the drain still waits
        on: the outputs a failed call never opened end empty."""
        waiting = list(self.paths)
        while waiting and time.monotonic() < deadline:
            still = []
            for path in waiting:
                try:
                    if not stat.S_ISFIFO(os.stat(path).st_mode):
                        continue  # the drain has read it, and a file took it
                    os.close(os.open(path, os.O_WRONLY | os.O_NONBLOCK))
                except FileNotFoundError:
                    continue  # drained and removed
                except OSError as e:
                    if e.errno != errno.ENXIO:
                        raise
                still.append(path)  # its reader has not come yet, or reads
            waiting = still
            time.sleep(0.01)

    def _line(self, deadline: float) -> Optional[bytes]:
        ready, _, _ = select.select([self.proc.stdout], [], [],
                                    max(0.0, deadline - time.monotonic()))
        return self.proc.stdout.readline() if ready else None

    def finish(self) -> Optional[dict]:
        """The drain's report once every call's pipes have ended."""
        deadline = time.monotonic() + DRAIN_TIMEOUT_S
        self._send({"end": True})
        self._release(deadline)
        line = self._line(deadline)
        return json.loads(line) if line else None

    def fetch(self, digests: List[str]) -> Dict[str, bytes]:
        self._send({"want": digests})
        blobs = {}
        for _ in digests:
            head = json.loads(self.proc.stdout.readline())
            blobs[head["digest"]] = self.proc.stdout.read(head["size"])
        return blobs

    def stop(self) -> None:
        if self.proc.poll() is None:
            with contextlib.suppress(OSError):
                self.proc.stdin.close()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


class InputFiles(NamedTuple):
    """The mate files of one call: ``paths`` one per mate, holding the
    ``(sample, pairs)`` of ``parts`` one after another."""

    label: str
    paths: List[str]
    parts: List[tuple]

    @property
    def pairs(self) -> int:
        return sum(n for _, n in self.parts)


def write_inputs(cfg: dict, mix: dict, seed: int, work: pathlib.Path,
                 device, scale: float):
    """Writes the mate files of each of the cell's calls
    (``corpus.files``), and the warm-up's, synced; returns ``(files,
    warmup, bytes_written, distinct_quality_symbols, sync_s)``, each file
    set and the warm-up an ``InputFiles``, and ``sync_s`` the seconds the
    syncs took."""
    import torch

    gz = mix["input"] == "bgzf"
    suffix = ".fastq.gz" if gz else ".fastq"
    mates = range(1, corpus.mates(cfg) + 1)
    symbols = set()
    files = []
    written = 0
    sync_s = 0.0
    layout = corpus.files(cfg, mix, scale)
    layout.append([(corpus.WARMUP, max(1, round(WARMUP_PAIRS * scale)))])
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        for parts in layout:
            stem = parts[0][0] if len(parts) == 1 else "pool"
            paths = [str(work / f"{stem}_R{mate}{suffix}") for mate in mates]
            with contextlib.ExitStack() as stack:
                fs = [stack.enter_context(open(p, "wb")) for p in paths]
                sinks = ([bgzf.Writer(f, mix["bgzf_level"], pool)
                          for f in fs] if gz else fs)
                for sample, total in parts:
                    for b in corpus.blocks(total):
                        block = corpus.pair_block(cfg, seed, sample, b, total,
                                                  device)
                        for mate, sink in zip(mates, sinks):
                            text = corpus.fastq_text(block[f"name{mate}"],
                                                     block[f"seq{mate}"],
                                                     block[f"qual{mate}"])
                            sink.write(text.cpu().numpy())
                            symbols.update(
                                torch.unique(block[f"qual{mate}"]).tolist())
                for sink, f in zip(sinks, fs):
                    if gz:
                        sink.close()
                    f.flush()
                    t0 = time.perf_counter()
                    os.fsync(f.fileno())
                    sync_s += time.perf_counter() - t0
            written += sum(os.path.getsize(p) for p in paths)
            label = f"sample {stem}" if len(parts) == 1 else "pool"
            files.append(InputFiles(label, paths, parts))
    return files[:-1], files[-1], written, len(symbols), sync_s


def _metrics_summary(err: str) -> Optional[dict]:
    for line in reversed(err.splitlines()):
        if line.startswith("metrics: "):
            return json.loads(line[len("metrics: "):])
    return None


def trim(sink: Sink, call_id: str, argv: List[str], inputs: InputFiles,
         device) -> tuple:
    """One ``cli.main`` call on ``inputs``, ``pe`` on two mate files and
    ``se`` on one (``argv`` names which): ``(rc, wall_s, stdout,
    stderr)``; ``rc`` is None where the call raised."""
    from sickle_tpu_torch import cli

    if len(inputs.paths) == 1:
        (out1,) = sink.call(call_id, 1)
        files = ["-f", inputs.paths[0], "-o", out1]
    else:
        out1, out2, singles = sink.call(call_id, 3)
        files = ["-f", inputs.paths[0], "-r", inputs.paths[1], "-o", out1,
                 "-p", out2, "-s", singles]
    # text streams with a .buffer, as the CLI expects of sys.stdout
    out, err = (io.TextIOWrapper(io.BytesIO(), write_through=True)
                for _ in range(2))
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(argv + files, device=device)
    except Exception:  # the run goes on; the call counts as failed
        rc = None
        err.write(traceback.format_exc())
    wall = time.perf_counter() - t0
    return rc, wall, *(s.buffer.getvalue().decode() for s in (out, err))


def check(cfg: dict, mix: dict, seed: int, files: List[InputFiles],
          calls: List[tuple], drained: Optional[dict], sink: Sink,
          device) -> Dict[str, int]:
    """The compared numbers: every call of the window against the
    reference.  ``calls`` holds ``(call_id, file index, rc, stdout)``."""
    numbers = {"wrong_records": 0, "wrong_summaries": 0,
               "failed_calls": sum(rc != 0 for _, _, rc, _ in calls)}
    drained = (drained or {}).get("calls", {})
    diffs = collections.defaultdict(list)  # file -> (output, digest)
    for index in sorted({f for _, f, _, _ in calls}):
        inputs = files[index]
        want, counts = reference.expected(cfg, mix["flags"], seed,
                                          inputs.parts, device)
        digests = [hashlib.sha256(w).hexdigest() for w in want]
        text = reference.summary_of(inputs.paths, counts)
        for call_id, f, _, stdout in calls:
            if f != index:
                continue
            numbers["wrong_summaries"] += stdout != text
            outs = drained.get(call_id) or [None] * len(want)
            for i, got in enumerate(outs[:len(want)]):
                if got is None or got[0] is None:
                    numbers["wrong_records"] += want[i].count(b"\n") // 4
                elif got[0] != digests[i]:
                    diffs[index].append((i, got[0]))
    if not diffs:
        return numbers
    blobs = sink.fetch(sorted({d for pairs_ in diffs.values()
                               for _, d in pairs_}))
    for index, wrong in diffs.items():
        want, _ = reference.expected(cfg, mix["flags"], seed,
                                     files[index].parts, device)
        for i, digest in wrong:
            numbers["wrong_records"] += compare.wrong_records(
                gunzip(blobs[digest]), want[i])
    return numbers


def power_limit() -> str:
    try:
        done = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return done.stdout.strip() or done.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"


def _start(device) -> tuple:
    """Imports the port from this checkout, loads its libraries and makes
    the CUDA context: ``(card, startup_s)``."""
    import torch

    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from sickle_tpu_torch import cli

    if not pathlib.Path(cli.__file__).absolute().is_relative_to(ROOT):
        raise RuntimeError(f"the port was imported from {cli.__file__}, "
                           "not from this checkout")
    if device.type != "cuda":
        return "cpu", process_age_s()
    from sickle_tpu_torch.io import native
    from sickle_tpu_torch.ops import trim_cuda

    native.get_lib()
    trim_cuda.build()
    torch.zeros(1, device=device)
    torch.cuda.synchronize(device)
    return torch.cuda.get_device_name(device), process_age_s()


def _window(sink: Sink, files: List[InputFiles], order: List[int],
            argv: List[str], seconds: float, trace: bool, work: pathlib.Path,
            device, lengths: int, mates: int) -> tuple:
    """The measured window: ``(calls, records, window_s, reduced trace)``,
    ``calls`` as ``check`` takes them, ``records`` as the readers do."""
    prof = None
    mark = lambda name: contextlib.nullcontext()  # noqa: E731
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        mark = record_function
    calls, records = [], []
    t0 = time.perf_counter()
    with mark(devtrace.WINDOW):
        while True:
            index = order[len(calls) % len(order)]
            inputs = files[index]
            call_id = f"c{len(calls)}"
            with mark(f"{devtrace.CALL}{inputs.label}"):
                rc, wall, out, err = trim(sink, call_id, argv, inputs, device)
            calls.append((call_id, index, rc, out))
            records.append(readers.Call(
                index, inputs.pairs, inputs.pairs * lengths, wall, rc,
                _metrics_summary(err) if trace else None, mates))
            if rc != 0:
                print(f"call {call_id} ({inputs.label}) rc {rc}:\n"
                      f"{err[-2000:]}", file=sys.stderr)
            if time.perf_counter() - t0 >= seconds:
                break
    window_s = time.perf_counter() - t0
    print("call walls, s: " + " ".join(f"{r.wall_s:.3f}" for r in records),
          file=sys.stderr)
    reduced = None
    if prof is not None:
        prof.__exit__(None, None, None)
        path = str(work / "trace.json")
        prof.export_chrome_trace(path)
        reduced = devtrace.reduce(path)
        os.unlink(path)
    return calls, records, window_s, reduced


def run_cell(bench: dict, cell: str, seed: int, seconds: float, trace: bool,
             device, scale: float = 1.0,
             cores: Optional[tuple] = None) -> Optional[dict]:
    """One run of ``cell``; the result line as a dict, or None where a
    forbidden module was loaded.  ``scale`` shrinks every sample (tests);
    ``cores`` is ``split_cores()`` as it was before this process was
    pinned to the program's."""
    import torch

    device = torch.device(device)
    entry = catalog.workload(bench, cell)
    cfg = catalog.config(bench, entry["config"])
    mix = catalog.traffic(entry["traffic"])
    program_cores, drain_cores = cores or split_cores()
    card, startup_s = _start(device)
    mates = corpus.mates(cfg)
    argv = (["se" if mates == 1 else "pe", "-t", cfg["qual_type"], "-a",
             str(len(program_cores))] + mix["flags"])
    if trace:
        argv.append("--metrics")
    work = pathlib.Path(tempfile.mkdtemp(prefix="trimbench-"))
    sink = None
    try:
        t0 = time.perf_counter()
        files, warmup, written, symbols, sync_s = write_inputs(
            cfg, mix, seed, work, device, scale)
        print(f"input: {len(files)} sets of {mates} mate file(s) and a "
              f"warm-up set, {written} bytes written under {work} in "
              f"{time.perf_counter() - t0:.3f} s, {sync_s:.3f} s of it "
              "syncing", file=sys.stderr)
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        sink = Sink(work, drain_cores)
        order = corpus.plate_order(len(files), seed)
        rc, wall, _, err = trim(sink, "warmup", argv, warmup, device)
        print(f"warm-up: {warmup.pairs} pairs, rc {rc}, {wall:.3f} s",
              file=sys.stderr)
        if rc != 0:
            print(err[-2000:], file=sys.stderr)
        setup_s = process_age_s()
        probe = [host_probe_s()]
        calls, records, window_s, reduced = _window(
            sink, files, order, argv, seconds, trace, work, device,
            sum(cfg["read_length"]), mates)
        probe.append(host_probe_s())
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        found = forbidden_modules()
        if found:
            print(f"loaded in the run's process: {', '.join(found)}",
                  file=sys.stderr)
            return None
        t_check = time.perf_counter()
        drained = sink.finish()
        if drained is None:
            print("the drain gave no report", file=sys.stderr)
        else:
            print(f"drain: {drained['window_cpu_s']:.3f} CPU seconds while "
                  f"the pipes ran, {drained['cpu_s']:.3f} in all",
                  file=sys.stderr)
        numbers = check(cfg, mix, seed, files, calls, drained, sink, device)
        print(f"check: {time.perf_counter() - t_check:.3f} s",
              file=sys.stderr)
    finally:
        if sink is not None:
            sink.stop()
        shutil.rmtree(work, ignore_errors=True)

    run = readers.Run(card=card, startup_s=startup_s, setup_s=setup_s,
                      window_s=window_s,
                      bits_per_base=roofline.bits_per_base(symbols),
                      calls=records, trace=reduced)
    metrics = {}
    for e in catalog.cell_metrics(bench, cell, trace):
        value = catalog.metric(e["name"]).read(run)
        if value is not None:
            metrics[e["name"]] = {"value": value, "unit": e["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": card, "count": entry["chips"], "memory_peak_bytes": peak}
    result = {"correct": compare.verdict(numbers) and bool(calls),
              "attempted": len(calls),
              "failed": numbers["failed_calls"],
              "metrics": metrics, "device": dev}
    if reduced is not None:
        dev["busy_s"] = reduced["busy_s"]
        dev["window_s"] = reduced["window_s"]
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in reduced["ops"][:devtrace.TOP]],
            "idle_gaps": [[n, s] for n, s in reduced["gaps"]]}
    result["checks"] = compare.as_json(numbers)
    if device.type == "cuda":
        print(f"card: {power_limit()}", file=sys.stderr)
    print(f"host probe: {probe[0]:.4f} s before the window, {probe[1]:.4f} s "
          "after it", file=sys.stderr)
    print(f"window: {len(calls)} calls in {window_s:.3f} s; start-up "
          f"{startup_s:.3f} s, set-up {setup_s:.3f} s; quality symbols "
          f"{symbols} ({run.bits_per_base} bits a base)", file=sys.stderr)
    for line in compare.lines(numbers):
        print(line, file=sys.stderr)
    return result


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m trimbench.run")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cores = split_cores()
    os.sched_setaffinity(0, cores[0])  # before torch starts a thread
    # every build and kernel cache at a fixed place inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
    import torch

    bench = catalog.benchmark()
    chips = catalog.workload(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    if not (ROOT / "sickle_tpu_torch").is_dir():
        print(f"the port (sickle_tpu_torch) is not in {ROOT}", file=sys.stderr)
        return 1
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", cores=cores)
    if result is None:
        return 1
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
