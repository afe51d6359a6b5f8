"""Logging helpers (ref: ``mxnet_tpu/log.py``; python/mxnet/log.py).

`get_logger(name)` returns a configured `logging.Logger` with the
reference's level constants re-exported.
"""
from __future__ import annotations

import logging
import sys

CRITICAL = logging.CRITICAL
ERROR = logging.ERROR
WARNING = logging.WARNING
INFO = logging.INFO
DEBUG = logging.DEBUG
NOTSET = logging.NOTSET


def get_logger(name=None, filename=None, filemode=None, level=WARNING):
    """Return a logger wired to stderr (or `filename`) at `level`."""
    logger = logging.getLogger(name)
    if getattr(logger, "_mxtpu_configured", False):
        if filename is None:
            logger.setLevel(level)
            return logger
        # re-route to a file: drop the handler we installed earlier
        for h in list(logger.handlers):
            logger.removeHandler(h)
    if filename:
        handler = logging.FileHandler(filename, filemode or "a")
    else:
        handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(
        "%(asctime)s [%(levelname)s] %(name)s: %(message)s"))
    logger.addHandler(handler)
    logger.setLevel(level)
    logger.propagate = False  # root may have its own handler (absl)
    logger._mxtpu_configured = True
    return logger
