"""Base utilities: the framework error and env-var config.

Port of ``mxnet_tpu/base.py``: knobs keep the names the JAX package
reads (``MXTPU_<NAME>``, falling back to ``MXNET_<NAME>``), so one
environment configures either package.
"""
from __future__ import annotations

import os

__version__ = "0.1.0"


class MXNetError(RuntimeError):
    """Error raised by the framework (ref: include/mxnet/base.h MXGetLastError)."""


def getenv(name: str, default=None, dtype=str):
    """Read config knob ``name`` from ``MXTPU_<name>`` or ``MXNET_<name>``
    (``MXTPU_`` wins); ``dtype=bool`` treats "0", "false" and "" as False."""
    for prefix in ("MXTPU_", "MXNET_"):
        v = os.environ.get(prefix + name)
        if v is not None:
            if dtype is bool:
                return v not in ("0", "false", "False", "")
            return dtype(v)
    return default


def setenv(name: str, value):
    """Write config knob ``name`` under its ``MXTPU_`` spelling (the one
    :func:`getenv` reads first); ``None`` clears both spellings (ref:
    ``mxnet_tpu/base.py:44``)."""
    if value is None:
        for prefix in ("MXTPU_", "MXNET_"):
            os.environ.pop(prefix + name, None)
        return None
    if value is True or value is False:
        value = int(value)
    os.environ["MXTPU_" + name] = str(value)
    return value
