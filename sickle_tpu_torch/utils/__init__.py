"""Cross-cutting utilities: logging/tracing parity + profiling hooks."""

from .logging import error, get_logger, msg, set_debug

__all__ = ["error", "get_logger", "msg", "set_debug"]
