"""Gluon Block / HybridBlock (ref: python/mxnet/gluon/block.py).

Blocks are ``torch.nn.Module``s: child blocks are registered submodules
and each Gluon :class:`~.parameter.Parameter` held as an attribute puts
its value, a ``torch.nn.Parameter``, in ``_parameters`` under that
attribute's name.  ``hybrid_forward(F, x, ..., **params)`` receives
``F``, the namespace of plain tensor functions (``mx.nd``), tensors for
its inputs and each parameter's value by attribute name.

Calls with NDArray inputs are the public boundary: the tensors are
unwrapped and the outputs wrapped back.  Blocks call each other with
tensors.

``hybridize()`` runs eagerly in this port.  It keeps the CachedOp
counters of the JAX package (``gluon/block.py:356``): the first call
with a new ``(train, ctx, input shapes/dtypes)`` signature counts as a
"compile", a call with a seen one as a "reuse", so
``ModelServer.stats()["graph"]["post_warmup_compiles"]`` still counts
input signatures that warmup did not cover.  ``torch.compile`` and CUDA
graphs are later work.
"""
from __future__ import annotations

import threading

import torch

from .. import autograd
from .._imperative import invoke
from ..context import Context
from .parameter import (DeferredInitializationError, Parameter,
                        ParameterDict)


class _BlockScope:
    """Auto-naming: dense0_, conv1_, ... (ref: _BlockScope in block.py)."""

    _counters = {}
    _lock = threading.Lock()

    @classmethod
    def create_prefix(cls, hint):
        with cls._lock:
            i = cls._counters.get(hint, 0)
            cls._counters[hint] = i + 1
        return f"{hint}{i}_"


class Block(torch.nn.Module):
    """Base container for layers and parameters (ref: gluon.Block)."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        self._prefix = (prefix if prefix is not None
                        else _BlockScope.create_prefix(
                            type(self).__name__.lower()))
        self._params = ParameterDict(self._prefix, shared=params)
        self._reg_params = {}

    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            self._reg_params[name] = value
            object.__setattr__(self, name, value)
            value._attach(self, name)
            return
        super().__setattr__(name, value)

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix

    @property
    def params(self):
        return self._params

    @property
    def _children(self):
        return self._modules

    def _ordered_params(self):
        """``(name, Parameter)`` in a stable order: the order of
        :meth:`collect_params` (ref: ``Block._ordered_params``)."""
        return list(self.collect_params().items())

    def collect_params(self):
        ret = ParameterDict(self._params.prefix)
        ret.update(self._params)
        for child in self._children.values():
            ret.update(child.collect_params())
        return ret

    def register_child(self, block, name=None):
        """Register a child under an explicit structural name."""
        self.add_module(name if name is not None
                        else str(len(self._children)), block)
        return block

    def _collect_params_with_prefix(self, prefix=""):
        """Structural name -> Parameter (ref: Block._collect_params_with_
        prefix): the names ``convert.load_numpy_params`` matches on."""
        if prefix:
            prefix += "."
        ret = {prefix + k: v for k, v in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        self.collect_params().initialize(init=init, ctx=ctx,
                                         force_reinit=force_reinit)


class HybridBlock(Block):
    """Block whose forward is ``hybrid_forward(F, ...)`` (ref: gluon.HybridBlock)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._cached_op = None

    def hybridize(self, active=True, **kwargs):
        """Count input signatures from now on (see the module docstring);
        ``static_alloc``/``static_shape`` are accepted and unused."""
        self._active = active
        self._cached_op = None

    def infer_shape(self, *args):
        """Complete deferred parameter shapes from example inputs; the
        layers with deferred parameters override it."""
        raise DeferredInitializationError(
            f"{type(self).__name__} has deferred-init parameters and no "
            "infer_shape; initialize with explicit in_units/in_channels")

    def forward(self, x, *args):
        return invoke(self._call_tensors, x, *args)

    def _call_tensors(self, x, *args):
        with torch.set_grad_enabled(autograd.is_recording()):
            if self._active:
                if self._cached_op is None:
                    self._cached_op = CachedOp(self)
                return self._cached_op(x, *args)
            return self._eager_forward(x, *args)

    def _eager_forward(self, x, *args):
        from .. import ndarray as F

        try:
            params = {k: p.data() for k, p in self._reg_params.items()}
        except DeferredInitializationError:
            self.infer_shape(x, *args)
            for p in self.collect_params().values():
                p._finish_deferred_init()
            params = {k: p.data() for k, p in self._reg_params.items()}
        return self.hybrid_forward(F, x, *args, **params)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


def commit_aux(value, new_value):
    """Write ``new_value`` into the auxiliary state ``value`` (BatchNorm's
    moving statistics) in place, outside autograd; the ops return the new
    statistics and the layer that owns them commits them."""
    with torch.no_grad():
        value.copy_(new_value)


class CachedOp:
    """Input-signature counters of a hybridized block (ref: CachedOp,
    ``gluon/block.py:356`` of the JAX package).  The forward itself runs
    eagerly."""

    def __init__(self, block):
        self.block = block
        self._seen_sigs = set()
        self._lock = threading.Lock()
        self.stats = {"compiles": 0, "reuses": 0}

    def __call__(self, *inputs):
        ctx = next((Context.from_device(i.device) for i in inputs
                    if isinstance(i, torch.Tensor)), None)
        sig = (autograd.is_training(), str(ctx),
               tuple((tuple(i.shape), str(i.dtype))
                     if isinstance(i, torch.Tensor) else repr(i)
                     for i in inputs))
        with self._lock:
            if sig in self._seen_sigs:
                self.stats["reuses"] += 1
            else:
                self._seen_sigs.add(sig)
                self.stats["compiles"] += 1
        return self.block._eager_forward(*inputs)
