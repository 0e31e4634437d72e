"""Logging: stdout plus an optional file tee.

Port of ``quintnet_tpu/utils/logger.py`` (standard library only).
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional


def setup_logging(log_dir: Optional[str] = None, *, name: str = "quintnet",
                  level: int = logging.INFO) -> logging.Logger:
    """A logger writing to stdout and, with ``log_dir``, to
    ``<log_dir>/<name>.log``; earlier handlers of the same logger are
    dropped."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s",
                            "%H:%M:%S")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(log_dir, f"{name}.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def log_once(logger: logging.Logger, msg: str, *, _seen=set()):  # noqa: B006
    """Log ``msg`` at most once per logger per process (keyed by the
    logger's name and the message)."""
    key = (logger.name, msg)
    if key not in _seen:
        _seen.add(key)
        logger.info(msg)
