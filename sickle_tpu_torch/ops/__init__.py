"""Device compute: the sliding-window trimming step.

``trim`` is the plain PyTorch formulation (the reference the kernel is
held against, and the path for CPU tensors); ``trim_cuda`` wraps the
hand-written CUDA kernel that computes the same cuts on the card.
"""

from .trim import (
    BIG,
    MAX_PACKED_L,
    TrimParams,
    compute_cuts,
    decode_check,
    encode_codes,
    trim_codes,
)

__all__ = ["BIG", "MAX_PACKED_L", "TrimParams", "compute_cuts",
           "decode_check", "encode_codes", "trim_codes"]
