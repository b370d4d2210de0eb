"""Batching pipeline: chunked streaming read -> device -> ordered write.

The reference's per-batch fork/join orchestration with a detached writer
thread becomes a three-stage pipeline with deterministic, order-preserving
output: a prefetch thread packs record-aligned chunks, the main thread
dispatches the device step (H2D + one CUDA kernel launch per piece), and
a single writer thread materializes results in dispatch order.
"""

from .chunker import iter_record_chunks
from .pipeline import EngineConfig, run_pe, run_se

__all__ = ["EngineConfig", "iter_record_chunks", "run_pe", "run_se"]
