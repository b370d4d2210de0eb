"""The benchmark's own BGZF writer, for inputs made as ``bgzip`` makes them.

BGZF (the SAM specification's blocked gzip) is a series of gzip members,
each holding at most 64 KiB and naming its own size in a ``BC`` extra
field, closed by an empty member.  Blocks are independent, so they are
deflated on a pool of threads (zlib releases the interpreter lock).
"""

from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

BLOCK_BYTES = 65280  # bgzip's uncompressed block size
EOF_BLOCK = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
_HEADER = struct.Struct("<BBBBIBBHBBHH")  # gzip header with the BC subfield


def block(data: bytes, level: int) -> bytes:
    """One BGZF member holding ``data`` (at most BLOCK_BYTES)."""
    comp = zlib.compressobj(level, zlib.DEFLATED, -zlib.MAX_WBITS)
    body = comp.compress(data) + comp.flush()
    size = _HEADER.size + len(body) + 8
    if size > 1 << 16:
        raise ValueError("a BGZF block does not fit its 64 KiB size field")
    head = _HEADER.pack(31, 139, 8, 4, 0, 0, 255, 6, 66, 67, 2, size - 1)
    return head + body + struct.pack("<II", zlib.crc32(data), len(data))


class Writer:
    """Appends BGZF members to a binary file, deflating the blocks of each
    write on ``pool``; ``close`` adds the EOF block."""

    def __init__(self, f, level: int, pool: ThreadPoolExecutor):
        self.f = f
        self.level = level
        self.pool = pool

    def write(self, data) -> None:
        view = memoryview(data)
        parts = [view[i:i + BLOCK_BYTES]
                 for i in range(0, len(view), BLOCK_BYTES)]
        for member in self.pool.map(lambda p: block(p, self.level), parts):
            self.f.write(member)

    def close(self) -> None:
        self.f.write(EOF_BLOCK)
