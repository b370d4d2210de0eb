"""ctypes binding + build for the native host-I/O fast path.

The C++ source is this package's own ``csrc/fastqio.cpp`` (a copy of the
JAX package's ``sickle_tpu/io/_fastqio.cpp``, equal but for two comments,
so the two packages' host paths stay equal).  The library goes to this
package's own git-ignored ``_build/`` directory, built at first use with
g++ (plain C ABI via ctypes).  Falls back to the numpy path in
``fastq.py`` when unavailable (set SICKLE_TPU_NO_NATIVE=1 to force the
fallback).

Also applies glibc malloc tuning: first-touch page faults can cost
~400us each on some hosts, making FRESH allocations ~300x slower than
warm ones.  ``mallopt(M_MMAP_MAX, 0)`` + ``mallopt(M_TRIM_THRESHOLD, -1)``
keep freed memory in the heap so steady-state buffers stay warm.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import tempfile
import threading
import time

from ..utils import metrics as _metrics

_HERE = pathlib.Path(__file__).resolve().parent
_SRC = _HERE.parent / "csrc" / "fastqio.cpp"
_BUILD_DIR = _HERE.parent / "_build"
_SO = _BUILD_DIR / "_fastqio.so"

_lock = threading.Lock()
_lib = None
_tried = False

N_THREADS = max(1, (os.cpu_count() or 2))


def set_threads(n: int) -> None:
    """Set the host worker-thread count (the CLI's -a/--threads; reference
    src/trim_single.cpp:163 semantics mapped to our intra-op parallelism)."""
    global N_THREADS
    N_THREADS = max(1, int(n))


def tune_malloc() -> None:
    """Keep freed memory in the process heap (see module docstring)."""
    try:
        libc = ctypes.CDLL(None)
        M_TRIM_THRESHOLD, M_MMAP_MAX = -1, -4
        libc.mallopt(M_TRIM_THRESHOLD, ctypes.c_int(-1).value)
        libc.mallopt(M_MMAP_MAX, 0)
    except Exception:
        pass


def _build():
    """True when g++ built the library, False when a built one is
    current, None when there is none."""
    if not _SRC.exists():
        return None
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if _SO.exists() and _SO.stat().st_mtime >= _SRC.stat().st_mtime:
        return False
    # compile to a private name, then rename into place: concurrent
    # first-use builds (test workers) never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        "-pthread", str(_SRC), "-o", tmp, "-lz", "-ldl",
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return True
    except Exception:
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib():
    """The loaded native library, or None if unavailable.  The first load
    is the process's ``load.native`` span (``built``: g++ ran)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("SICKLE_TPU_NO_NATIVE"):
            return None
        t0 = time.perf_counter_ns()
        built = _build()
        if built is None:
            return None
        lib = ctypes.CDLL(str(_SO))
        i64, i32, u8 = ctypes.c_int64, ctypes.c_int32, ctypes.c_uint8
        p64 = ctypes.POINTER(i64)
        p32 = ctypes.POINTER(i32)
        pu8 = ctypes.POINTER(u8)
        lib.sk_count_lines.restype = i64
        lib.sk_count_lines.argtypes = [pu8, i64]
        lib.sk_count_newlines.restype = i64
        lib.sk_count_newlines.argtypes = [pu8, i64]
        lib.sk_kth_newline.restype = i64
        lib.sk_kth_newline.argtypes = [pu8, i64, i64]
        lib.sk_parse_pack2.restype = ctypes.c_int
        lib.sk_parse_pack2.argtypes = [
            pu8, i64, i64, i64, i64, p64, p32, pu8, pu8, p32, p64, p64, p64,
            p64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.sk_assemble.restype = None
        lib.sk_assemble.argtypes = [
            pu8, i64, p64, p32, p64, p64, p32, p64, p32, p32, pu8,
            ctypes.c_int, u8, p64, pu8, ctypes.c_int,
        ]
        ci = ctypes.c_int
        lib.sk_cuts.restype = None
        lib.sk_cuts.argtypes = [
            pu8, pu8, p32, i64, i64, ci, ci, ci, ci, ci, ci, ci, ci, ci,
            p32, p32, p32, ci,
        ]
        lib.sk_cuts_indexed.restype = None
        lib.sk_cuts_indexed.argtypes = [
            pu8, i64, p64, p32, i64, ci, ci, ci, ci, ci, ci, ci, ci, ci,
            p32, p32, p32, ci,
        ]
        lib.sk_qual_minmax.restype = ctypes.c_int
        lib.sk_qual_minmax.argtypes = [pu8, i64, pu8, pu8, ctypes.c_int]
        lib.sk_qual_levels.restype = ctypes.c_int
        lib.sk_qual_levels.argtypes = [pu8, i64, pu8, ctypes.c_int]
        lib.sk_plan_assemble.restype = i64
        lib.sk_plan_assemble.argtypes = [pu8, p64, p32, p32, p32, i64,
                                         ctypes.c_int, pu8, p64, ctypes.c_int]
        lib.sk_fieldpack.restype = ctypes.c_int
        lib.sk_fieldpack.argtypes = [pu8, i64, i64, u8, pu8, ctypes.c_int,
                                     ctypes.c_int, pu8, ctypes.c_int]
        lib.sk_bgzf_scan.restype = i64
        lib.sk_bgzf_scan.argtypes = [pu8, i64, p64, p64, p64, i64]
        lib.sk_bgzf_inflate.restype = i64
        lib.sk_bgzf_inflate.argtypes = [pu8, p64, p64, p64, p64, i64, pu8,
                                        ctypes.c_int]
        lib.sk_bgzf_compress.restype = i64
        lib.sk_bgzf_compress.argtypes = [pu8, i64, ctypes.c_int,
                                         ctypes.c_int, pu8, ctypes.c_int]
        _lib = lib
        _metrics.record_process("load.native", t0, built=built)
        return _lib


def available() -> bool:
    return get_lib() is not None


def ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))
