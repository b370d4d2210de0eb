"""``python -m sickle_tpu_torch`` == the ``sickle`` CLI on the CUDA port."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
