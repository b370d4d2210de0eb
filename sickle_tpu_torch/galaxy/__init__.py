"""The Galaxy wrapper of the port (``sickle_tpu_torch.xml``) and the
inputs of its ``<tests>``.

The inputs in ``test-data/`` are small seeded FASTQ files (at most 200
records each) that ``write_test_inputs`` writes again from their seeds;
the expected outputs beside them were written by the JAX package's CLI
(``python -m sickle_tpu``) with the arguments each test's command gives.
"""

from __future__ import annotations

import os

from ..utils.corpus import write_fastq, write_pairs

# file name: how it is made
TEST_INPUTS = {
    "se.fastq": "200 reads of 30-160 bp, Ns, chars out of range past the 3' cut",
    "pe.1.fastq": "mate 1 of 100 pairs of 30-160 bp",
    "pe.2.fastq": "mate 2 of the same pairs",
    "pe_interleaved.fastq": "100 pairs of 30-160 bp, interleaved",
}


def write_test_inputs(dirpath: str) -> None:
    """Write every file of ``TEST_INPUTS`` into ``dirpath``."""
    def path(name):
        return os.path.join(dirpath, name)

    with open(path("se.fastq"), "wb") as f:
        write_fastq(f, 9101, 200, length=(30, 160), n_rate=0.02,
                    bad_tail=0.05)
    with open(path("pe.1.fastq"), "wb") as f1, \
            open(path("pe.2.fastq"), "wb") as f2:
        write_pairs(f1, f2, 9102, 100, length=(30, 160), n_rate=0.01)
    with open(path("pe_interleaved.fastq"), "wb") as f:
        write_pairs(f, None, 9103, 100, length=(30, 160))
