"""One intra-op thread per test process: the tests run several processes
side by side, and torch's CPU thread pools, each as wide as the machine,
would otherwise contend on small tensors."""

import os

os.environ.setdefault("OMP_NUM_THREADS", "1")

import torch  # noqa: E402

torch.set_num_threads(1)
