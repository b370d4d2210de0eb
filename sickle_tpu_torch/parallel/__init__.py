"""Multi-GPU / multi-host data parallelism.

The reference's only parallelism is pthreads round-robin over queues in
one process (SURVEY.md §2.2).  Here read batches are sharded row-wise
over the local GPUs (``mesh``: no traffic between devices on the read
path, by construction), processes each stream a record-aligned shard of
the input, and only scalar counters are combined, by one gloo
``all_reduce`` (``dist``).
"""

from .mesh import data_mesh, sharded_cuts_fn

__all__ = ["data_mesh", "sharded_cuts_fn"]
