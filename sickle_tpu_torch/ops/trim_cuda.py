"""The CUDA cuts kernel (``csrc/trim_cuts.cu``) and its wrappers.

Port of ``sickle_tpu/ops/trim_pallas.py``: the four Pallas kernels
(generic and uniform-window, each with and without the ``-n`` seq
operand) become one templated CUDA kernel, which also fuses the JAX
device step's length derivation and wire decoders (``decode_fields``,
``apply_rank_lut``: the load prologue) and result packing (epilogue).
It comes in two load paths: the tiled kernel stages tiles of rows in
shared memory (every row short enough for one, see ``tile_rows``), the
direct kernel reads long rows in device memory.  The library is built
with ``nvcc`` at first use into a plain-C shared library under the
package's git-ignored ``_build/cuda`` directory and bound with ctypes —
no PyTorch headers, so the build takes seconds.

``trim_cuts`` (raw quality rows) and ``trim_cuts_wire`` (a field- or
rank-wire chunk) take tensors: on a CUDA tensor they launch the kernel or
raise; on a CPU tensor they run the plain PyTorch version
(``ops/trim.py::trim_codes`` / ``wire_codes``), which is also what the
kernel is held against on the card.
"""

from __future__ import annotations

import ctypes
import functools
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Optional

import torch

from ..constants import Compat, QUALITY_CONSTANTS
from ..io.fastq import field_widths
from ..utils import metrics as _metrics
from .trim import MAX_PACKED_L, TrimParams, trim_codes, wire_codes

_PKG = pathlib.Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "trim_cuts.cu"
_BUILD_DIR = _PKG / "_build" / "cuda"
_LIB_PATH = _BUILD_DIR / "libtrim_cuts.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# kernel launches (one per call on a CUDA tensor): in all, by the row's
# source form (raw rows, the band wire, the rank wire), and by form and
# load path (the tiled or the direct kernel)
LAUNCHES = 0
LAUNCHES_BY_FORM = {"raw": 0, "band": 0, "rank": 0}
LAUNCHES_BY_PATH = {form: {"tiled": 0, "direct": 0}
                    for form in LAUNCHES_BY_FORM}
# the compiler's report (registers, spills) from the last build, or ""
BUILD_LOG = ""

_lock = threading.Lock()
_lib = None

# The tiled kernel's shared memory per block: for each of its 8 warps, its
# quality rows as they lie in device memory, under -n its seq rows, on a
# wire its rows decoded.  Within this budget a block needs no opt-in and
# several share an SM.
TILE_SMEM_BUDGET = 48 * 1024
# rows per tile, tried in turn: multiples of the 8 warps, 3 rows a warp
# first (of the sizes tried on the H100, 8-64 rows, the fastest at the
# main path's shapes)
TILE_ROWS = (24, 16, 8)
WARPS = 8


def _stage_bytes(rows: int, row_bytes: int) -> int:
    # the rows, the up to 15 bytes by which they start past a 16-byte
    # boundary, rounded up to 16
    return (rows * row_bytes + 30) // 16 * 16


def tile_smem_bytes(rows: int, L: int, row_bytes: int,
                    seq: bool = False) -> int:
    """Shared memory of one tiled block of ``rows`` rows, ``rows / 8`` per
    warp (``csrc/trim_cuts.cu::warp_smem`` times 8): ``row_bytes == L``
    are raw rows (``seq``: with -n's seq rows), fewer bytes a wire, whose
    rows are also decoded to ``L`` bytes each."""
    per = rows // WARPS
    return WARPS * (_stage_bytes(per, row_bytes)
                    + (_stage_bytes(per, L) if seq else 0)
                    + ((per * L + 15) // 16 * 16 if row_bytes < L else 0))


def tile_rows(L: int, row_bytes: int, seq: bool = False) -> int:
    """Rows per shared-memory tile for rows of ``L`` positions held in
    ``row_bytes`` bytes (see ``tile_smem_bytes``): the first of TILE_ROWS
    within TILE_SMEM_BUDGET, or 0 for the direct kernel, which takes rows
    whose tile of 8 would not fit and rows of ``L >= MAX_PACKED_L``
    (unpacked results).  A function of the shape alone."""
    if L >= MAX_PACKED_L:
        return 0
    for rows in TILE_ROWS:
        if tile_smem_bytes(rows, L, row_bytes, seq) <= TILE_SMEM_BUDGET:
            return rows
    return 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def build(force: bool = False) -> ctypes.CDLL:
    """Compile (if stale) and load the kernel library; raises on failure.
    The first load is the process's ``load.cuts_kernel`` span (``built``:
    nvcc ran)."""
    global _lib, BUILD_LOG
    with _lock:
        if _lib is not None and not force:
            return _lib
        t0 = time.perf_counter_ns()
        built = False
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        if (force or not _LIB_PATH.exists()
                or _LIB_PATH.stat().st_mtime < SOURCE.stat().st_mtime):
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
            os.close(fd)
            try:
                r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                                   capture_output=True, text=True)
                if r.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({r.returncode}) on {SOURCE}:\n{r.stderr}")
                BUILD_LOG = r.stderr
                os.replace(tmp, _LIB_PATH)
                built = True
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(str(_LIB_PATH))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.sk_trim_cuts.restype = ci
        lib.sk_trim_cuts.argtypes = [vp, vp, vp, vp, ctypes.c_longlong,
                                     ci, ci, ci, ci, ci, ci, ci, ci, ci,
                                     ci, ci, ci, vp]
        lib.sk_trim_cuts_wire.restype = ci
        lib.sk_trim_cuts_wire.argtypes = [vp, vp, ctypes.c_longlong, ci, ci,
                                          ci, ci, ctypes.POINTER(ci), ci,
                                          ctypes.c_ulonglong, ci, ci, ci, ci,
                                          ci, vp]
        _lib = lib
        _metrics.record_process("load.cuts_kernel", t0, built=built)
        return _lib


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def trim_cuts(qual: torch.Tensor, params: TrimParams, *,
              lengths: Optional[torch.Tensor] = None,
              seq: Optional[torch.Tensor] = None,
              uniform_len: Optional[int] = None) -> torch.Tensor:
    """The device step for one ``[B, L]`` batch of quality rows.

    ``lengths`` (int32[B]) is None when the packer proved the zero-padding
    invariant: the kernel then derives each length from the first zero
    byte.  ``seq`` is required under ``params.trunc_n``.  ``uniform_len``:
    every non-padding row has this length, so the window is one constant.

    Returns packed int32[B] codes — (five+1)<<16 | bad<<15 | (three+1) —
    or, for ``L >= MAX_PACKED_L``, the int32[3, B] stack (five, three,
    bad); see ``ops/trim.py::encode_codes``.
    """
    if qual.device.type == "cpu":
        return trim_codes(seq if params.trunc_n else None, qual, lengths,
                          params, uniform_len)
    if qual.device.type != "cuda":
        raise ValueError(f"trim_cuts runs on cuda or cpu tensors, got {qual.device}")
    if qual.dim() != 2:
        raise ValueError(f"qual must be [B, L], got shape {tuple(qual.shape)}")
    B, L = qual.shape
    dev = qual.device
    _check("qual", qual, torch.uint8, (B, L), dev)
    if lengths is not None:
        _check("lengths", lengths, torch.int32, (B,), dev)
    if params.trunc_n:
        if seq is None:
            raise ValueError("params.trunc_n needs the seq rows")
        _check("seq", seq, torch.uint8, (B, L), dev)
    if uniform_len is not None and uniform_len <= 0:
        raise ValueError(f"uniform_len must be positive, got {uniform_len}")
    packed = L < MAX_PACKED_L
    out = torch.empty((B,) if packed else (3, B), dtype=torch.int32, device=dev)
    if B == 0:
        return out
    lib = build()
    offset, qmin, qmax = QUALITY_CONSTANTS[params.qualtype]
    w = 0 if uniform_len is None else (uniform_len // 10 or uniform_len)
    tile = tile_rows(L, L, params.trunc_n)
    with torch.cuda.device(dev):
        rc = lib.sk_trim_cuts(
            seq.data_ptr() if params.trunc_n else None,
            qual.data_ptr(),
            lengths.data_ptr() if lengths is not None else None,
            out.data_ptr(), B, L, offset, qmin, qmax,
            params.qual_threshold, params.length_threshold,
            int(params.no_fiveprime), int(params.trunc_n),
            int(params.compat != Compat.V133), w, int(packed), tile,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"trim_cuts kernel launch failed: CUDA error {rc}")
    _count("raw", tile)
    return out


def reset_counts() -> None:
    """Set every launch count to 0."""
    global LAUNCHES
    LAUNCHES = 0
    for form in LAUNCHES_BY_FORM:
        LAUNCHES_BY_FORM[form] = 0
        LAUNCHES_BY_PATH[form].update(tiled=0, direct=0)


def _count(form: str, tile: int) -> None:
    global LAUNCHES
    LAUNCHES += 1
    LAUNCHES_BY_FORM[form] += 1
    LAUNCHES_BY_PATH[form]["tiled" if tile else "direct"] += 1


def _lut_word(lut, p: int) -> int:
    """The rank wire's LUT (``1 << p`` int32 entries, each in int8 range)
    as the 64-bit word the kernel takes by value: entry k in byte k."""
    vals = [int(x) for x in (lut.tolist() if hasattr(lut, "tolist") else lut)]
    if len(vals) != 1 << p:
        raise ValueError(f"the rank wire's LUT has {len(vals)} entries, "
                         f"expected {1 << p}")
    if any(not -128 <= x <= 127 for x in vals):
        raise ValueError(f"rank LUT entries must fit a signed byte: {vals}")
    return sum((x & 0xFF) << (8 * k) for k, x in enumerate(vals))


@functools.lru_cache(maxsize=None)
def _wire_layout(p: int, L: int):
    """(the wire's subfield triples as a ctypes int array, their count,
    rows per tile) for a ``p``-bit wire of ``L`` positions; built once
    per shape."""
    fields = [(w.bit_length() - 1, sh, int(colf * L))
              for w, sh, colf in field_widths(p)]
    flat = (ctypes.c_int * 9)(*[x for f in fields for x in f])
    return flat, len(fields), tile_rows(L, p * L // 8)


def trim_cuts_wire(buf: torch.Tensor, p: int, L: int, params: TrimParams, *,
                   bias: Optional[int] = None, lut=None,
                   uniform_len: Optional[int] = None) -> torch.Tensor:
    """The device step for one ``[B, p*L/8]`` wire batch (the field wire
    of ``io/fastq.qual_fields`` with ``bias``, or the rank wire of
    ``qual_rank_fields`` with ``lut``, ``1 << p`` entries, ``p <= 3``).

    The kernel decodes the wire (the ``BAND`` / ``RANK`` prologue: once
    per tile on the tiled path, at each read on the direct one), derives
    lengths from the first ``v == 0`` and returns packed int32[B] codes
    ``(five+1) << 16 | (three+1)``; see ``ops/trim.py::wire_codes``, the
    plain version.
    """
    if buf.device.type == "cpu":
        return wire_codes(buf, p, L, params, bias=bias, lut=lut,
                          uniform_len=uniform_len)
    if buf.device.type != "cuda":
        raise ValueError(f"trim_cuts_wire runs on cuda or cpu tensors, got {buf.device}")
    if params.trunc_n:
        raise ValueError("the wire carries no seq rows: -n takes raw rows")
    if (bias is None) == (lut is None):
        raise ValueError("give exactly one of bias (band wire) and lut (rank wire)")
    if not 1 <= p <= 7 or (lut is not None and p > 3):
        raise ValueError(f"no wire of {p} bits{' with a LUT' if lut is not None else ''}")
    if L % 8 or not 0 < L < MAX_PACKED_L:
        raise ValueError(f"wire rows need L % 8 == 0 and L < {MAX_PACKED_L}, got {L}")
    if buf.dim() != 2:
        raise ValueError(f"buf must be [B, p*L/8], got shape {tuple(buf.shape)}")
    B = buf.shape[0]
    _check("buf", buf, torch.uint8, (B, p * L // 8), buf.device)
    if uniform_len is not None and uniform_len <= 0:
        raise ValueError(f"uniform_len must be positive, got {uniform_len}")
    lut_word = _lut_word(lut, p) if lut is not None else 0
    out = torch.empty((B,), dtype=torch.int32, device=buf.device)
    if B == 0:
        return out
    fields, n_fields, tile = _wire_layout(p, L)
    lib = build()
    w = 0 if uniform_len is None else (uniform_len // 10 or uniform_len)
    with torch.cuda.device(buf.device):
        rc = lib.sk_trim_cuts_wire(
            buf.data_ptr(), out.data_ptr(), B, L, p * L // 8,
            int(lut is not None), n_fields, fields,
            0 if bias is None else int(bias), lut_word,
            params.qual_threshold, params.length_threshold,
            int(params.no_fiveprime), w, tile,
            torch.cuda.current_stream(buf.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"trim_cuts_wire kernel launch failed: CUDA error {rc}")
    _count("rank" if lut is not None else "band", tile)
    return out
