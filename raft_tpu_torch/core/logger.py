"""Logging (counterpart of ``raft_tpu/core/logger.py``): one process-wide
named logger, ``raft_tpu_torch``, plus an optional callback sink that sees
the same ``[LEVEL] [name] msg`` lines as the stream handler.
:func:`set_level` sets the level by number or name."""

from __future__ import annotations

import logging
from typing import Callable, Optional, Union

_LOGGER_NAME = "raft_tpu_torch"

# one formatter for every sink: a callback sees the rendered line, not the
# bare message
_FORMATTER = logging.Formatter("[%(levelname)s] [%(name)s] %(message)s")


class _CallbackHandler(logging.Handler):
    def __init__(self, fn: Callable[[int, str], None]):
        super().__init__()
        self.setFormatter(_FORMATTER)
        self._fn = fn

    def emit(self, record: logging.LogRecord) -> None:
        try:
            self._fn(record.levelno, self.format(record))
        except Exception:  # pragma: no cover - sink errors must not propagate
            pass


def get_logger() -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(_FORMATTER)
        logger.addHandler(handler)
        logger.setLevel(logging.WARNING)
    return logger


def set_level(level: Union[int, str]) -> None:
    """Set the process-wide log level: a stdlib level int or a name like
    "debug"."""
    if isinstance(level, str):
        resolved = logging.getLevelName(level.upper())
        if not isinstance(resolved, int):
            raise ValueError(f"unknown log level {level!r}")
        level = resolved
    get_logger().setLevel(level)


def set_callback_sink(fn: Optional[Callable[[int, str], None]]) -> None:
    """Install (or with None, remove) a callback sink ``fn(level, line)``."""
    logger = get_logger()
    for h in list(logger.handlers):
        if isinstance(h, _CallbackHandler):
            logger.removeHandler(h)
    if fn is not None:
        logger.addHandler(_CallbackHandler(fn))
