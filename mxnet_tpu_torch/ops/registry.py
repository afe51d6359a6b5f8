"""Operator registry (ref: the nnvm op registry behind ``mx.nd.*``;
``mxnet_tpu/ops/registry.py`` of the JAX package).

One entry per op: a plain function of ``torch.Tensor`` positional inputs
and keyword attributes.  ``ndarray/__init__.py`` builds the ``F``
namespace that ``hybrid_forward`` receives from these entries, and
``symbol/symbol.py`` builds ``mx.sym.*`` and runs bound graphs from them,
so the eager namespace, the blocks and the graphs call the same
functions.

:class:`OpEntry` carries the metadata a graph reads (ref: ``OpEntry``,
``mxnet_tpu/ops/registry.py:78``): the names of the array inputs
(``arg_names``), the number of outputs (``num_outputs``; -1 when the
attributes decide it), whether the op reads the training flag
(``train_aware``: it does so from the autograd scope, and an op whose
function takes ``_train`` is also handed it), draws random numbers
(``needs_rng``: from the device's generator, ``random.generator``, so
no key is passed), has no gradient (``nondiff``), takes any number of
arrays (``variadic``), and which outputs are the new values of which
auxiliary inputs (``mutate_aux``: ``(input index, output index)``
pairs, BatchNorm's moving statistics).
"""
from __future__ import annotations

import inspect

from ..base import MXNetError

_ops = {}


class OpEntry:
    __slots__ = ("name", "fn", "arg_names", "aliases", "needs_rng",
                 "train_aware", "nondiff", "variadic", "num_outputs",
                 "mutate_aux", "takes_train")

    def __init__(self, name, fn, arg_names=("data",), aliases=(),
                 needs_rng=False, train_aware=False, nondiff=False,
                 variadic=False, num_outputs=1, mutate_aux=None):
        self.name = name
        self.fn = fn
        self.arg_names = tuple(arg_names)
        self.aliases = tuple(aliases)
        self.needs_rng = needs_rng
        self.train_aware = train_aware
        self.nondiff = nondiff
        self.variadic = variadic
        self.num_outputs = num_outputs
        self.mutate_aux = mutate_aux
        try:
            params = inspect.signature(fn).parameters
        except (TypeError, ValueError):
            params = {}
        self.takes_train = "_train" in params


def register(name, fn=None, aliases=(), **meta):
    """Register ``fn`` under ``name`` and ``aliases`` (decorator or
    direct); ``meta`` are :class:`OpEntry`'s metadata."""

    def _do(f):
        entry = OpEntry(name, f, aliases=aliases, **meta)
        for key in (name,) + tuple(aliases):
            if key in _ops:
                raise MXNetError(f"op '{key}' already registered")
            _ops[key] = entry
        return f

    return _do(fn) if fn is not None else _do


def entry(name):
    """The :class:`OpEntry` registered under ``name`` (or an alias)."""
    if name not in _ops:
        raise MXNetError(f"unknown operator '{name}'")
    return _ops[name]


def get(name):
    """The function registered under ``name``."""
    return entry(name).fn


def exists(name):
    return name in _ops


def list_ops():
    return sorted(_ops)


def canonical_items():
    """``(name, entry)`` pairs, one per op (aliases left out)."""
    seen = set()
    for v in _ops.values():
        if id(v) not in seen:
            seen.add(id(v))
            yield v.name, v
