"""Logging / tracing.

The reference's observability is a compile-time debug macro ``msg()``
printing to stdout (on by default, the reference's src/sickle.h:99-108)
and ``error()`` to stderr (:113-120).  Here:

* ``msg()`` — debug prints, OFF by default (upstream-1.33-like quiet
  output), enabled by the CLI ``-d`` flag or ``set_debug(True)``;
* ``error()`` — stderr, same role as the reference's;
* structured ``logging`` logger for library users;
* device-side tracing is the CLI's ``--profile DIR`` (jax profiler).
"""

from __future__ import annotations

import logging
import sys

_DEBUG = False
_logger = logging.getLogger("sickle_tpu")


def get_logger() -> logging.Logger:
    return _logger


def set_debug(on: bool) -> None:
    global _DEBUG
    _DEBUG = on
    _logger.setLevel(logging.DEBUG if on else logging.WARNING)


def msg(text: str) -> None:
    """Debug print (reference msg(), src/sickle.h:102-108)."""
    if _DEBUG:
        print(text)
        _logger.debug(text)


def error(text: str) -> None:
    """Error print to stderr (reference error(), src/sickle.h:113-120)."""
    sys.stderr.write(text + "\n")
    _logger.error(text)
