"""Verbosity levels mirroring the reference's debug.h (QUIET..TRACE).

Counterpart of `esctp1raytracer_tpu/utils/debug.py`: the reference's int
levels QUIET=0, INFO=1, DEBUG=2, TRACE=3, chosen by the CLI's --debug and
--trace flags, mapped onto Python logging. The package's root logger is
named `esctp1raytracer_tpu_torch`.
"""

from __future__ import annotations

import logging
import sys

QUIET = 0
INFO = 1
DEBUG = 2
TRACE = 3

ROOT = "esctp1raytracer_tpu_torch"

_LEVEL_TO_LOGGING = {
    QUIET: logging.ERROR,
    INFO: logging.INFO,
    DEBUG: logging.DEBUG,
    TRACE: logging.DEBUG - 5,
}

_level = INFO

logging.addLevelName(logging.DEBUG - 5, "TRACE")


def get_logger(name: str = ROOT) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers and name == ROOT:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter("%(levelname)s %(name)s: %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(_LEVEL_TO_LOGGING[_level])
        logger.propagate = False
    return logger


def set_level(level: int) -> None:
    """Set global verbosity with a reference-style int level (0..3)."""
    global _level
    _level = max(QUIET, min(TRACE, int(level)))
    get_logger().setLevel(_LEVEL_TO_LOGGING[_level])


def current_level() -> int:
    return _level
