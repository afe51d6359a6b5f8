"""Device contexts (ref: python/mxnet/context.py).

A :class:`Context` names a ``torch.device``.  ``gpu(i)`` is the i-th CUDA
device and ``xla(i)`` is kept as an alias of ``gpu(i)``, so scripts
written for the JAX package run unchanged.

The default context is ``gpu(0)``.  Where no CUDA device is present,
code that relies on the default raises instead of falling back to the
CPU: a caller who wants the CPU says so with ``cpu()`` (argument or
``with mx.cpu():``).

The *replica* context (:func:`replica_scope`, :func:`current_replica`) is
the context of the arrays a block call was given: a Parameter with copies
on several contexts hands out the copy on it (``Parameter.data()``), as
the JAX package's blocks pick ``p.data(x.context)``.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from .base import MXNetError

_default = threading.local()
_replica = threading.local()


class Context:
    """A device context: ``cpu(i)`` or ``gpu(i)`` (``xla`` is ``gpu``)."""

    _ALIASES = {"cpu": "cpu", "gpu": "gpu", "xla": "gpu"}

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            device_type, device_id = device_type.device_type, \
                device_type.device_id
        if device_type not in self._ALIASES:
            raise MXNetError(f"unknown device type {device_type!r}")
        self.device_type = self._ALIASES[device_type]
        self.device_id = int(device_id)

    @classmethod
    def from_device(cls, device):
        """The context of a ``torch.device``."""
        if device.type == "cpu":
            return cls("cpu", 0)
        return cls("gpu", device.index or 0)

    def torch_device(self):
        """The ``torch.device`` this context names; raises for a GPU
        context on a host without that CUDA device."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if self.device_id >= n:
            raise MXNetError(
                f"{self} requested but {n} CUDA device(s) are visible; "
                "pass mx.cpu() to run on the CPU")
        return torch.device("cuda", self.device_id)

    def __eq__(self, other):
        return (isinstance(other, Context)
                and (self.device_type, self.device_id)
                == (other.device_type, other.device_id))

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    __str__ = __repr__

    def __enter__(self):
        if not hasattr(_default, "stack"):
            _default.stack = []
        _default.stack.append(self)
        return self

    def __exit__(self, *exc):
        _default.stack.pop()


def cpu(device_id=0):
    """Return a CPU context (ref: mx.cpu())."""
    return Context("cpu", device_id)


def gpu(device_id=0):
    """Return the i-th CUDA device's context (ref: mx.gpu())."""
    return Context("gpu", device_id)


def xla(device_id=0):
    """Alias of :func:`gpu`, kept so scripts written for the JAX package
    run unchanged."""
    return Context("gpu", device_id)


def num_gpus():
    """Number of CUDA devices visible (ref: mx.context.num_gpus)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def current_context():
    """The innermost ``with ctx:`` context, else ``gpu(0)``.

    Raises :class:`MXNetError` when the default would be a GPU and no
    CUDA device is present: the port never moves to the CPU unasked."""
    stack = getattr(_default, "stack", None)
    if stack:
        return stack[-1]
    if not num_gpus():
        raise MXNetError(
            "no CUDA device is visible and no context was given; pass "
            "ctx=mx.cpu() (or use `with mx.cpu():`) to run on the CPU")
    return gpu(0)


def current_replica():
    """The context of the block call in progress (None outside one)."""
    return getattr(_replica, "ctx", None)


@contextlib.contextmanager
def replica_scope(ctx):
    """Make ``ctx`` the replica context of the calls inside."""
    prev = getattr(_replica, "ctx", None)
    _replica.ctx = ctx
    try:
        yield ctx
    finally:
        _replica.ctx = prev
