"""Host-side FASTQ ingestion, packing, and emission.

The reference's native I/O layer (GZReader/Batch/FQEntry + the output
serializers, the reference's src/GZReader.cpp, Batch.cpp, FQEntry.cpp,
trim_single.cpp:374-427, trim_paired.cpp:515-624) maps here to:

* ``fastq``   — vectorized numpy parse / pack into fixed-shape device-ready
               arrays and the reverse ragged-gather output assembly.
* ``native``  — optional C++ fast path (ctypes) for the same operations.
* ``compression`` — transparent plain/gzip streams (gzwrite semantics, never
               the reference's broken gzprintf, SURVEY.md §2.4.6).
"""

from .fastq import (
    PackedReads,
    assemble_records,
    pack_fastq,
    read_fastq_bytes,
)

__all__ = [
    "PackedReads",
    "assemble_records",
    "pack_fastq",
    "read_fastq_bytes",
]
