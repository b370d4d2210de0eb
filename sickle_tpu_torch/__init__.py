"""sickle-tpu-torch: the PyTorch + CUDA port of sickle-tpu.

The same drop-in ``sickle se|pe`` trimmer as the JAX package beside it
(``sickle_tpu``), with the device step rebuilt as a hand-written CUDA
kernel for Hopper (``csrc/trim_cuts.cu``).  The host layers (C++ parse /
pack / emit, the record model, the three-stage engine) keep the JAX
package's module names and layout.  Nothing here imports JAX.
"""

from .constants import Compat, QualityType

# keep freed memory in-heap: fresh page faults are pathologically slow in
# on some hosts (~400us each); warm reuse is the universal win (io/native.py)
from .io.native import tune_malloc as _tune_malloc

_tune_malloc()

__version__ = "1.33.0"

__all__ = ["Compat", "QualityType", "__version__"]
