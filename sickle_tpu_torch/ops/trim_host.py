"""Host (CPU/SIMD) cuts kernel — the engine's non-device compute path.

Same contract as the device kernels (``ops.trim.compute_cuts``): packed
``[B, L]`` rows in, ``(five, three, first_bad)`` int32 arrays out, with
``(-1, -1)`` = discard and ``first_bad`` = first quality position the
reference's scan would flag (else BIG).  Three uses:

* the HYBRID dispatcher: chunks the metered TPU link cannot carry are
  computed host-side so a wire-bound pass runs at wire rate PLUS host
  rate (engine/pipeline.py);
* ``--backend host``: the whole pipeline without JAX — the fair
  same-silicon comparison against the reference's pthreads C++ loop
  (the reference's src/trim_single.cpp:239-345), which it beats by
  vectorized packing + parallel scalar cuts;
* a fast exact resolver for any future approximate wire format.

The C++ core (csrc/fastqio.cpp sk_cuts) transcribes the oracle semantics
(SURVEY.md §2.3) including LAZY quality-range checking; the numpy-less
fallback is the scalar oracle itself.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..constants import QUALITY_CONSTANTS, Compat
from ..io import native
from .trim import BIG, TrimParams


def compute_cuts_host(
    seq: Optional[np.ndarray],
    qual: np.ndarray,
    lengths: np.ndarray,
    params: TrimParams,
    n_threads: Optional[int] = None,
):
    """(five, three, first_bad) int32[B] for a packed row matrix.

    ``seq`` may be None when ``params.trunc_n`` is False (never read).
    Releases the GIL for the whole computation (ctypes), so the hybrid
    worker thread runs concurrently with pack/assemble.
    """
    B, L = qual.shape
    offset, qmin, qmax = QUALITY_CONSTANTS[params.qualtype]
    lib = native.get_lib()
    lengths = np.ascontiguousarray(lengths[:B], np.int32)
    if lib is not None and qual.flags.c_contiguous:
        import ctypes

        five = np.empty(B, np.int32)
        three = np.empty(B, np.int32)
        bad = np.empty(B, np.int32)
        if params.trunc_n:
            assert seq is not None and seq.flags.c_contiguous
            seq_ptr = native.ptr(seq, ctypes.c_uint8)
        else:
            seq_ptr = ctypes.POINTER(ctypes.c_uint8)()
        lib.sk_cuts(
            seq_ptr, native.ptr(qual, ctypes.c_uint8),
            native.ptr(lengths, ctypes.c_int32), B, L,
            offset, qmin, qmax,
            params.qual_threshold, params.length_threshold,
            1 if params.no_fiveprime else 0,
            1 if params.trunc_n else 0,
            1 if params.compat != Compat.V133 else 0,  # fork: 'n' first
            1 if params.strict else 0,
            native.ptr(five, ctypes.c_int32),
            native.ptr(three, ctypes.c_int32),
            native.ptr(bad, ctypes.c_int32),
            n_threads if n_threads is not None else native.N_THREADS,
        )
        return five, three, bad

    # lib-less fallback: the scalar oracle row by row (slow, exact)
    from ..oracle import QualityRangeError, sliding_window_cuts

    five = np.full(B, -1, np.int32)
    three = np.full(B, -1, np.int32)
    bad = np.full(B, BIG, np.int32)
    for r in range(B):
        ln = int(lengths[r])
        if ln <= 0:
            continue
        srow = bytes(seq[r, :ln]) if seq is not None else b"A" * ln
        try:
            f, t3 = sliding_window_cuts(
                srow, bytes(qual[r, :ln]),
                qualtype=params.qualtype,
                qual_threshold=params.qual_threshold,
                length_threshold=params.length_threshold,
                no_fiveprime=params.no_fiveprime,
                trunc_n=params.trunc_n,
                compat=params.compat,
                strict_quality=params.strict,
            )
            five[r], three[r] = f, t3
        except QualityRangeError:
            bad[r] = 0  # any value < length re-triggers the exact scalar
            # re-scan in engine._check_quality, which raises the message
    return five, three, bad


def compute_cuts_indexed(
    data: np.ndarray,
    starts4: np.ndarray,
    lens4: np.ndarray,
    n_records: int,
    params: TrimParams,
    n_threads: Optional[int] = None,
):
    """Indexed host cuts: records are read straight from the source
    buffer via the parse line index (no packed row matrix — skips ~2
    bytes of memory traffic per input byte; see sk_cuts_indexed).
    Returns (five, three, first_bad) int32[n_records]."""
    import ctypes

    lib = native.get_lib()
    assert lib is not None, "indexed cuts require the native library"
    offset, qmin, qmax = QUALITY_CONSTANTS[params.qualtype]
    five = np.empty(n_records, np.int32)
    three = np.empty(n_records, np.int32)
    bad = np.empty(n_records, np.int32)
    lib.sk_cuts_indexed(
        native.ptr(data, ctypes.c_uint8), data.size,
        native.ptr(starts4, ctypes.c_int64),
        native.ptr(lens4, ctypes.c_int32),
        n_records, offset, qmin, qmax,
        params.qual_threshold, params.length_threshold,
        1 if params.no_fiveprime else 0,
        1 if params.trunc_n else 0,
        1 if params.compat != Compat.V133 else 0,
        1 if params.strict else 0,
        native.ptr(five, ctypes.c_int32),
        native.ptr(three, ctypes.c_int32),
        native.ptr(bad, ctypes.c_int32),
        n_threads if n_threads is not None else native.N_THREADS,
    )
    return five, three, bad


def host_cuts_fn(params: TrimParams, n_threads: Optional[int] = None):
    """Engine cuts-fn adapter over :func:`compute_cuts_host`."""

    def fn(seq, qual, lengths):
        return compute_cuts_host(
            seq if params.trunc_n else None, qual, lengths, params, n_threads
        )

    return fn
