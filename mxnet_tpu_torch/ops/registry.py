"""Operator registry (ref: the nnvm op registry behind ``mx.nd.*``).

One entry per op: a plain function of ``torch.Tensor`` positional inputs
and keyword attributes.  ``ndarray/__init__.py`` builds the ``F``
namespace that ``hybrid_forward`` receives from these entries, so the
eager namespace and the blocks call the same functions.
"""
from __future__ import annotations

from ..base import MXNetError

_ops = {}


def register(name, fn=None, aliases=()):
    """Register ``fn`` under ``name`` and ``aliases`` (decorator or direct)."""

    def _do(f):
        for key in (name,) + tuple(aliases):
            if key in _ops:
                raise MXNetError(f"op '{key}' already registered")
            _ops[key] = f
        return f

    return _do(fn) if fn is not None else _do


def get(name):
    if name not in _ops:
        raise MXNetError(f"unknown operator '{name}'")
    return _ops[name]


def list_ops():
    return sorted(_ops)
