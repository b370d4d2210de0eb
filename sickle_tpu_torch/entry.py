"""Entry points: a single-device step and a multi-device dry run.

The port's counterpart of the JAX package's ``__graft_entry__.py``, on
the CUDA cuts kernel: ``entry`` gives the se trimming step and an example
batch, ``dryrun_multichip`` runs the full sharded step once on tiny
shapes.  Both run on ``cuda`` unless the caller passes ``device="cpu"``.

Run on the card: python -m sickle_tpu_torch.entry
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .ops.trim import BIG, TrimParams

PARAMS = TrimParams(qual_threshold=20, length_threshold=20)


def _example_batch(b: int, l: int = 256):
    rng = np.random.default_rng(0)
    seq = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=(b, l))
    qual = rng.integers(33, 74, size=(b, l), dtype=np.uint8)  # sanger range
    lengths = np.full(b, 150, np.int32)
    lengths[-1] = 37  # one ragged row
    return seq, qual, lengths


def _device(device) -> torch.device:
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the step's plain version")
    return dev


def entry(device=None):
    """``(fn, example_args)``: the forward step of the cuts kernel, the
    batched sliding-window cut computation of se trimming, and an example
    batch on ``device``.  ``fn(seq, qual, lengths)`` returns int32
    ``(five, three, first_bad)``; the kernel reports a bad-quality flag,
    not its position, so ``first_bad`` is 0 for a flagged read and ``BIG``
    for the rest (``first_bad < lengths`` is the JAX step's)."""
    from .ops.trim_cuda import trim_cuts

    dev = _device(device)

    def fn(seq, qual, lengths):
        codes = trim_cuts(qual, PARAMS, lengths=lengths,
                          seq=seq if PARAMS.trunc_n else None)
        five, three = (codes >> 16) - 1, (codes & 0x7FFF) - 1
        first_bad = torch.where(((codes >> 15) & 1).bool(), 0, BIG)
        return five, three, first_bad.to(torch.int32)

    args = tuple(torch.from_numpy(x).to(dev) for x in _example_batch(256))
    return fn, args


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run the FULL sharded trimming step (one row block per device, the
    counters summed over the blocks: ``parallel.dist.sharded_trim_step``)
    over ``n_devices`` copies of ``device`` on tiny shapes.  Reads are
    embarrassingly parallel, so the row split is the whole parallelism
    story.  The device list is given explicitly: on a machine with one
    card, ``data_mesh(n)`` would return that card once and dry-run one
    shard."""
    from .parallel.dist import sharded_trim_step

    dev = _device(device)
    step = sharded_trim_step(PARAMS, [dev] * n_devices)
    b = 8 * n_devices
    seq, qual, lengths = _example_batch(b, 128)
    five, three, first_bad, total, kept = step(seq, qual, lengths)
    if total != b or five.shape != (b,):
        raise RuntimeError(f"dry run over {n_devices} devices: total {total} "
                           f"of {b} rows, five {five.shape}")


def main() -> int:
    try:
        fn, args = entry()
    except RuntimeError as e:
        sys.stderr.write(f"entry: {e}\n")
        return 1
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry ok:", [tuple(o.shape) for o in out])
    n = max(1, torch.cuda.device_count())
    dryrun_multichip(n)
    print(f"dryrun_multichip({n}) ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
