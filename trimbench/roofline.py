"""The yardstick of the cuts kernel: the least bytes its work needs, and the
card's peak rate of moving them.

Per read the kernel must read each base's quality once and write one
4-byte result.  A quality needs ``ceil(log2(distinct quality symbols in
the input))`` bits, so 2 for NovaSeq's four bins and 6 for Phred 0-41:
the fewest any lossless representation of the input can ship, whatever
the program ships today.  The least time is those bytes at the card's peak
memory bandwidth, and the share of the roofline that least time over the
kernels' device time.
"""

from __future__ import annotations

import math
from typing import Optional

# peak memory bandwidth, bytes/s, by ``torch.cuda.get_device_name()``:
# NVIDIA's H100 SXM data sheet, 3.35 TB/s of HBM3 at the 700 W limit
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}
RESULT_BYTES = 4


def bits_per_base(symbols: int) -> int:
    return max(1, math.ceil(math.log2(max(symbols, 2))))


def least_bytes(bases: float, reads: float, bits: int) -> float:
    return bases * bits / 8 + RESULT_BYTES * reads


def share_pct(least: float, kernel_s: float, card: str) -> Optional[float]:
    """The kernels' share of their roofline, %, or None where the card's
    peak is not in the table or no kernel ran."""
    peak = PEAK_BYTES_PER_S.get(card)
    if peak is None or kernel_s <= 0 or least <= 0:
        return None
    return 100.0 * least / peak / kernel_s
