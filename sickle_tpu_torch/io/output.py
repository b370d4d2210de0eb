"""Memory-mapped output writer: the zero-copy emission path.

The reference serializes each batch into a ``stringstream`` and pushes it
through ``ofstream``/``gzprintf`` (the reference's src/trim_single.cpp:
390-419) — one full copy of every output byte through a userspace buffer
plus a second copy into the page cache inside ``write(2)``.  On this
host the ``write`` copy alone costs ~85 ms per 124 MB chunk stream.

:class:`MmapWriter` removes both copies: the output file is truncated
ahead of the logical end and mapped writable, and the assembly kernel
(``sk_assemble``) scatters trimmed records *directly into the page
cache* via the mapping.  The engine uses the ``reserve``/``commit``
protocol; everything else (checkpointing, the CLI close path) sees an
ordinary seekable binary stream (``write``/``tell``/``seek``/
``truncate``/``flush``/``close``).

Growth never moves live data: the file is extended with ``ftruncate``
and a NEW mapping generation is created; old generations stay alive
(address space only) until ``close`` so earlier numpy views can never
dangle.
"""

from __future__ import annotations

import mmap
import os
from typing import Optional, Tuple

import numpy as np

_MIN_CAP = 1 << 26  # 64 MB first mapping


class MmapWriter:
    """Sequential file writer backed by a growable writable mapping."""

    def __init__(self, path, initial_cap: int = _MIN_CAP,
                 truncate: bool = False):
        self.name = os.fspath(path)
        self._fd = os.open(self.name, os.O_RDWR | os.O_CREAT, 0o644)
        self._cap = 0  # mapped/truncated capacity
        self._off = 0  # current write position
        self._end = 0  # logical file size (write high-water / truncate)
        self._mm: Optional[mmap.mmap] = None
        self._view: Optional[np.ndarray] = None
        self._old: list = []  # older mapping generations (kept alive)
        self._initial_cap = max(int(initial_cap), 1 << 16)
        self._closed = False
        if truncate:
            # 'wb' semantics: drop any prior content at OPEN, so a
            # crashed run can never leave a mix of new and stale records
            try:
                os.ftruncate(self._fd, 0)
            except OSError:
                os.close(self._fd)  # non-regular path: don't leak the fd
                raise

    @classmethod
    def open_regular(cls, path, truncate: bool = False):
        """A writer for ``path`` if it is (or can be created as) a
        REGULAR file, else None — pipes/devices can't be mapped.  The
        shared probe for open_output and the CLI's resumable opener."""
        import stat

        try:
            w = cls(path, truncate=truncate)
        except OSError:
            return None
        try:
            if stat.S_ISREG(os.fstat(w._fd).st_mode):
                return w
        except OSError:
            pass
        w._off = 0
        try:
            w.close()
        except OSError:
            pass
        return None

    # --- fast path (engine) ------------------------------------------------
    def reserve(self, n: int) -> Tuple[np.ndarray, int]:
        """Ensure capacity for ``n`` more bytes; returns (whole-file numpy
        view, write offset).  The caller writes [offset, offset+n) into
        the view and then calls :meth:`commit`."""
        need = self._off + int(n)
        if need > self._cap or self._view is None:
            self._grow(need)
        return self._view, self._off

    def commit(self, n: int) -> None:
        self._off += int(n)
        if self._off > self._end:
            self._end = self._off

    def _grow(self, need: int) -> None:
        new_cap = max(self._cap * 2, need, self._initial_cap)
        os.ftruncate(self._fd, new_cap)
        if self._mm is not None:
            self._old.append((self._mm, self._view))
        self._mm = mmap.mmap(self._fd, new_cap)
        self._view = np.frombuffer(memoryview(self._mm), dtype=np.uint8)
        self._cap = new_cap

    # --- stream interface --------------------------------------------------
    def write(self, b) -> int:
        mv = memoryview(b)
        n = mv.nbytes
        if n:
            view, start = self.reserve(n)
            view[start:start + n] = np.frombuffer(mv, dtype=np.uint8)
            self.commit(n)
        return n

    def tell(self) -> int:
        return self._off

    def seek(self, pos: int, whence: int = os.SEEK_SET) -> int:
        if whence == os.SEEK_CUR:
            pos = self._off + pos
        elif whence == os.SEEK_END:
            pos = self._end + pos
        self._off = int(pos)
        return self._off

    def truncate(self, size: Optional[int] = None) -> int:
        size = self._off if size is None else int(size)
        if size > self._cap:
            self._grow(size)
        elif size < self._end:
            # zero the abandoned tail so a later shorter run can't expose
            # stale bytes between ``size`` and a prior high-water mark
            if self._view is not None:
                self._view[size:self._end] = 0
        self._end = size
        self._off = min(self._off, size)
        return size

    def flush(self) -> None:
        pass  # mapping writes are already visible to readers of the file

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._view = None
        for mm, _ in self._old:
            try:
                mm.close()
            except BufferError:
                pass  # a view escaped; the map lives until process exit
        self._old = []
        if self._mm is not None:
            try:
                self._mm.close()
            except BufferError:
                pass
            self._mm = None
        try:
            os.ftruncate(self._fd, self._end)
        finally:
            os.close(self._fd)  # never leak the fd (ftruncate can EINVAL
            #                     on the non-regular-file probe path)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
