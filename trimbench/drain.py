"""The output sink: a process of its own that drains the program's pipes.

The program writes each call's outputs (``pe``'s ``-o``, ``-p``, ``-s``, or
``se``'s ``-o``) into named pipes that the harness made, so a run writes no
output to disk.
This process reads them, one thread per output so the program never waits
on the order in which it opens them, and keeps what the comparison needs
and little else: the bytes of each distinct stream (as it came,
compressed), and per call and output which of them it was.  A program
that writes the same file twice writes the same stream, so a run keeps
one copy per sample and output.  A stream is matched to a kept one by
CRC-32 and size, then byte for byte, which costs the window far less
CPU than a cryptographic digest would.

After the window it inflates each stream it kept once, and reports per
call and output the digest of the decompressed bytes, their size and
record count, or the error that inflating met.  Only then, and only for
the digests the harness asks for (those that differ from the reference),
it sends the compressed bytes back.

Protocol, JSON lines on stdin and stdout:

* in: ``{"call": id, "paths": [out1, out2, singles]}`` before each call
  (one to three paths: ``se`` gives ``[out1]``), ``{"end": true}`` after
  the window, then ``{"want": [digest, ...]}``;
* out: one line ``{"calls": {id: [stream, ...]}, "window_cpu_s": s,
  "cpu_s": s}`` (a stream per path of the call; CPU seconds until the last
  pipe ended, and in all), each stream ``[sha256, size, records]`` or
  ``[null, 0, 0, error]``; then
  per wanted digest a line ``{"digest": d, "size": n}`` and ``n`` bytes.

Run as ``python -m trimbench.drain [cores]``, ``cores`` a comma-separated
list of the CPU cores it keeps to; it imports only the standard library.
"""

from __future__ import annotations

import fcntl
import hashlib
import json
import os
import queue
import sys
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor

PIPE_BYTES = 1 << 20
READ_BYTES = 1 << 20
FEED_BYTES = 1 << 17


def gunzip_chunks(data: bytes):
    """Decompressed pieces of a gzip stream of one or more members (BGZF
    is many).  Fed in bounded slices, so a member's end never copies the
    rest of a large stream.  Raises ``zlib.error`` on a corrupt or
    truncated stream; an empty stream is empty."""
    view = memoryview(data)
    d = None
    pos = 0
    while pos < len(view):
        piece = view[pos:pos + FEED_BYTES]
        pos += len(piece)
        while piece:
            if d is None:
                d = zlib.decompressobj(31)
            out = d.decompress(piece)
            if out:
                yield out
            if d.eof:
                piece, d = d.unused_data, None
            else:
                piece = b""
    if d is not None:
        raise zlib.error("the gzip stream ends inside a member")


def gunzip(data: bytes) -> bytes:
    return b"".join(gunzip_chunks(data))


def inflate_digest(data: bytes) -> list:
    """``[sha256, size, records]`` of the decompressed stream, or
    ``[None, 0, 0, error]``."""
    h = hashlib.sha256()
    size = lines = 0
    try:
        for out in gunzip_chunks(data):
            h.update(out)
            size += len(out)
            lines += out.count(b"\n")
    except zlib.error as e:
        return [None, 0, 0, str(e)]
    return [h.hexdigest(), size, lines // 4]


class Output:
    """One of the outputs: its pipes, one per call, in call order."""

    def __init__(self):
        self.jobs: queue.Queue = queue.Queue()
        self.calls: dict = {}     # call id -> index of its stream
        self.streams: list = []   # the distinct streams, as they came
        self.index: dict = {}     # (crc32, size) -> indices of streams
        self.errors: dict = {}    # call id -> what reading its pipe met
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self) -> None:
        while (job := self.jobs.get()) is not None:
            call, path = job
            try:
                self._drain(call, path)
            except OSError as e:
                self.errors[call] = f"{type(e).__name__}: {e}"

    def _drain(self, call, path: str) -> None:
        crc = 0
        parts = []
        with open(path, "rb", buffering=0) as f:
            try:
                fcntl.fcntl(f, fcntl.F_SETPIPE_SZ, PIPE_BYTES)
            except OSError:
                pass  # the pipe keeps its default size
            while piece := f.read(READ_BYTES):
                crc = zlib.crc32(piece, crc)
                parts.append(piece)
        os.unlink(path)
        size = sum(len(p) for p in parts)
        same = self.index.setdefault((crc, size), [])
        for i in same:
            if _equal(self.streams[i], parts):
                self.calls[call] = i
                return
        same.append(len(self.streams))
        self.calls[call] = len(self.streams)
        self.streams.append(b"".join(parts))


def _equal(stream: bytes, parts: list) -> bool:
    """``stream == b"".join(parts)``, a piece at a time."""
    pos = 0
    for part in parts:
        if stream[pos:pos + len(part)] != part:
            return False
        pos += len(part)
    return pos == len(stream)


def main() -> int:
    if len(sys.argv) > 1:  # before a thread starts, so each keeps to them
        os.sched_setaffinity(0, {int(c) for c in sys.argv[1].split(",")})
    outputs = [Output() for _ in range(3)]
    width = {}  # call id -> its number of paths
    lines = iter(sys.stdin.buffer.readline, b"")
    for line in lines:
        msg = json.loads(line)
        if msg.get("end"):
            break
        width[msg["call"]] = len(msg["paths"])
        for out, path in zip(outputs, msg["paths"]):
            out.jobs.put((msg["call"], path))
    for out in outputs:
        out.jobs.put(None)
    for out in outputs:
        out.thread.join()
    times = os.times()
    window_cpu_s = times.user + times.system

    kept = [stream for out in outputs for stream in out.streams]
    with ThreadPoolExecutor(3) as pool:
        inflated = list(pool.map(inflate_digest, kept))
    calls = {}
    first = 0
    for i, out in enumerate(outputs):
        for call, k in out.calls.items():
            calls.setdefault(call, [None] * width[call])[i] = inflated[first + k]
        for call, error in out.errors.items():
            calls.setdefault(call, [None] * width[call])[i] = [None, 0, 0,
                                                              error]
        first += len(out.streams)
    times = os.times()
    reply = {"calls": calls, "window_cpu_s": window_cpu_s,
             "cpu_s": times.user + times.system}
    sys.stdout.write(json.dumps(reply) + "\n")
    sys.stdout.flush()

    line = sys.stdin.buffer.readline()
    wanted = json.loads(line)["want"] if line else []
    by_plain = {}
    for entry, stream in zip(inflated, kept):
        by_plain.setdefault(entry[0], stream)
    sink = sys.stdout.buffer
    for digest in wanted:
        blob = by_plain.get(digest, b"")
        sink.write((json.dumps({"digest": digest, "size": len(blob)}) + "\n")
                   .encode())
        sink.write(blob)
    sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
