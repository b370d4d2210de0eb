"""Local devices and the row-sharded device step (``--devices N``).

Port of the JAX package's ``parallel/mesh.py``.  Each device computes
the cuts of its row block of every piece; the kernel is row-local, so no
collective runs and the host concatenates the blocks' codes in order.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

from ..ops.trim import TrimParams


def data_mesh(n_devices: Optional[int] = None,
              devices: Union[Sequence, str, torch.device, None] = None
              ) -> List[torch.device]:
    """The first ``n_devices`` LOCAL devices, as a list.

    ``devices``: an explicit list (``[cuda:0, cuda:0]`` shards over one
    card twice), or the device type: ``cuda`` (the default) lists
    ``cuda:0 .. device_count() - 1``; ``cpu`` gives ``n_devices`` copies
    of the CPU device (one by default), so the shard path runs on a
    machine without a card.  Local, not global: in a multi-host run every
    process streams its own input shard and shards batches only over its
    own devices.
    """
    if devices is None or isinstance(devices, (str, torch.device)):
        kind = torch.device(devices if devices is not None else "cuda")
        if kind.type == "cuda":
            devs = [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
        else:
            devs = [kind] * (n_devices or 1)
    else:
        devs = [torch.device(d) for d in devices]
    if n_devices is not None:
        devs = devs[:n_devices]
    return devs


def sharded_cuts_fn(params: TrimParams, devices: Sequence,
                    slice_rows: Optional[int] = None):
    """The device step sharded row-wise over ``devices``, with the same
    wire discipline as one device: the field/rank wire or qual-only raw
    rows H2D, lengths derived in the kernel, the packed 4 B/read codes
    back, deferred fetch.  ``slice_rows`` (default 65,536) is rounded up
    to a multiple of the device count; see ``engine.pipeline.
    _cuda_cuts_fn`` for the padding and piece rules."""
    from ..engine.pipeline import _cuda_cuts_fn

    return _cuda_cuts_fn(params, list(devices),
                         1 << 16 if slice_rows is None else slice_rows)
