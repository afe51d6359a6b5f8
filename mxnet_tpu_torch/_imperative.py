"""The NDArray boundary of an imperative call (ref: mxnet_tpu/_imperative.py
``invoke``).

Blocks and ops compute on ``torch.Tensor``s.  A call that arrives with
NDArray inputs (user code, ``ModelServer``) is unwrapped here, and its
tensor outputs are wrapped back, keeping the nesting of tuples and lists.
"""
from __future__ import annotations

import torch

from .ndarray.ndarray import NDArray


def _wrap(out):
    if isinstance(out, torch.Tensor):
        return NDArray(out)
    if isinstance(out, (list, tuple)):
        return type(out)(_wrap(o) for o in out)
    return out


def invoke(fn, *args):
    """Call ``fn`` on the tensors inside NDArray ``args``; return NDArray
    outputs when any input was an NDArray, else ``fn``'s own outputs."""
    boundary = any(isinstance(a, NDArray) for a in args)
    if not boundary:
        return fn(*args)
    out = fn(*(a.data if isinstance(a, NDArray) else a for a in args))
    return _wrap(out)
