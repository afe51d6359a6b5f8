"""Gluon Parameter / ParameterDict (ref: python/mxnet/gluon/parameter.py).

A :class:`Parameter` keeps the Gluon metadata (name, shape with 0 for
unknown dims, init, grad_req) and its value, a ``torch.nn.Parameter``.
The value on the first context is registered in every block that holds
the Parameter as an attribute, under that attribute's name, so a block's
``named_parameters()`` and ``state_dict()`` keys are the structural names
of ``_collect_params_with_prefix`` (``encoder.layers.0.attn_in_weight``).

Contexts (ref: ``mxnet_tpu/gluon/parameter.py:87-226``):
``initialize(ctx=[c0, c1, ...])`` makes one copy per context, each its
own ``torch.nn.Parameter`` with its own gradient, all with the first
copy's initial values.  ``data(ctx)``/``grad(ctx)`` give one copy,
``list_data``/``list_grad``/``list_ctx`` all of them, in context order;
``data()`` gives the copy on the replica context of the block call in
progress (``context.replica_scope``) where there is one, else the first.
``set_data`` writes every copy; ``reset_ctx`` moves the value to other
contexts.  A Parameter on one context is exactly the single value it was
before multi-context parameters came.

Deferred init: a Parameter whose shape has unknown dims waits until its
layer infers them from the first input.

Gradients: a Parameter whose ``grad_req`` is ``'write'`` or ``'add'`` is
an autograd variable (``autograd.mark_variables``); its gradient is the
value's ``.grad``, allocated as zeros at first use, so a serving process
that never trains holds no gradient memory.

A :class:`Constant` (``ParameterDict.get_constant``) is a Parameter with
``grad_req='null'`` whose value is fixed at construction: trainers skip
it, checkpoints save and load it like any other parameter.
"""
from __future__ import annotations

import weakref

import numpy as np
import torch

from .. import autograd
from .. import initializer as init_mod
from ..base import MXNetError
from ..context import Context, current_context, current_replica
from ..ndarray.ndarray import NDArray, to_torch_dtype


class DeferredInitializationError(MXNetError):
    pass


class Parameter:
    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False):
        self.name = name
        self._data = None            # torch.nn.Parameter on the first context
        self._ctx_data = None        # {Context: torch.nn.Parameter}, ordered
        self.grad_req = grad_req
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        if isinstance(shape, int):
            shape = (shape,)
        self._shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._deferred_init = None   # (init, ctx, default_init)
        self._owners = []            # (weakref to block, attribute name)
        # the value blocks see in place of _data while a trainer that keeps
        # its own copies runs a forward (parallel.DataParallelTrainer)
        self._traced_value = None
        # hints for the initializer (``InitDesc.attrs``), set by layers
        self._init_attrs = None
        # trainers whose kvstore keeps (and updates) its own copy of the
        # value: set_data writes that copy too
        self._kv_trainers = weakref.WeakSet()

    # -- shape with merge-of-unknowns (MXNet uses 0 for unknown dims) ------

    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        new_shape = tuple(int(s) for s in new_shape)
        if self._shape is not None and (
                len(self._shape) != len(new_shape) or any(
                    s not in (0, n) for s, n in zip(self._shape, new_shape))):
            raise MXNetError(f"cannot update shape {self._shape} -> "
                             f"{new_shape} for {self.name}")
        self._shape = new_shape

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        """``'write'``, ``'add'`` or ``'null'``; ``'null'`` drops the
        gradient and stops tracking the value."""
        if req not in ("write", "add", "null"):
            raise MXNetError(f"Parameter {self.name}: grad_req must be "
                             f"'write', 'add' or 'null', not {req!r}")
        self._grad_req = req
        for v in self._values():
            autograd.mark_variables([v], [v.grad], req)

    def _shape_known(self):
        return self._shape is not None and all(s > 0 for s in self._shape)

    # -- ownership ----------------------------------------------------------

    def _attach(self, block, attr):
        """Register this Parameter's value in ``block._parameters[attr]``,
        now if it exists and again whenever it is (re)created."""
        self._owners.append((weakref.ref(block), attr))
        block._parameters[attr] = self._data

    def _publish(self):
        live = []
        for ref, attr in self._owners:
            block = ref()
            if block is not None:
                block._parameters[attr] = self._data
                live.append((ref, attr))
        self._owners = live

    # -- init ---------------------------------------------------------------

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Make the value on ``ctx`` (a Context or a list of them; default
        :func:`current_context`), one copy per context, now or, with
        unknown dims, at the first forward."""
        default_init = default_init or init_mod.Uniform()
        if self._data is not None and not force_reinit:
            return
        if ctx is None:
            ctx = current_context()
        ctx = _ctx_list(ctx)
        if len(ctx) == 1:
            ctx = ctx[0]
        if not self._shape_known():
            if self.allow_deferred_init:
                self._deferred_init = (init, ctx, default_init)
                return
            raise MXNetError(
                f"cannot initialize Parameter {self.name}: unknown shape "
                f"{self._shape} and allow_deferred_init=False")
        self._finish_init(init, ctx, default_init)

    def _initial_value(self, init, ctx, default_init):
        """The value to start from, on ``ctx``."""
        initializer = init or self.init or default_init
        if isinstance(initializer, str):
            initializer = init_mod.create(initializer)
        data = torch.empty(self._shape, dtype=to_torch_dtype(self.dtype),
                           device=ctx.torch_device())
        initializer(init_mod.InitDesc(self.name, self._init_attrs), data)
        return data

    def _finish_init(self, init, ctx, default_init):
        ctxs = _ctx_list(ctx)
        self._place(ctxs, self._initial_value(init, ctxs[0], default_init))
        self._deferred_init = None

    def _place(self, ctxs, data):
        """Make the copies on ``ctxs`` from ``data`` (the first copy is
        ``data`` itself when it lies on the first context)."""
        values = {}
        for c in ctxs:
            t = data if not values and data.device == c.torch_device() \
                else data.detach().to(c.torch_device(), copy=True)
            v = torch.nn.Parameter(t, requires_grad=False)
            autograd.mark_variables([v], [None], self._grad_req)
            values[c] = v
        self._ctx_data = values
        self._data = values[ctxs[0]]
        self._publish()

    def _finish_deferred_init(self):
        if self._deferred_init is None:
            return
        if not self._shape_known():
            raise DeferredInitializationError(
                f"Parameter {self.name} has unknown shape {self._shape}")
        self._finish_init(*self._deferred_init)

    # -- access -------------------------------------------------------------

    def _values(self):
        return list(self._ctx_data.values()) if self._ctx_data else []

    def _check_initialized(self):
        if self._data is None:
            if self._deferred_init is not None:
                raise DeferredInitializationError(
                    f"Parameter {self.name} has not been initialized yet "
                    "(deferred); run a forward pass first")
            raise MXNetError(f"Parameter {self.name} has not been "
                             "initialized. Call .initialize() first")

    def _replica(self, ctx=None):
        """The copy on ``ctx``; with None, on the replica context of the
        block call in progress where the value has one, else the first."""
        self._check_initialized()
        if ctx is None:
            if len(self._ctx_data) > 1:
                cur = current_replica()
                if cur is not None and cur in self._ctx_data:
                    return self._ctx_data[cur]
            return self._data
        got = self._ctx_data.get(Context(ctx))
        if got is None:
            raise MXNetError(f"Parameter {self.name} is not initialized on "
                             f"{ctx}; it lives on {list(self._ctx_data)}")
        return got

    def data(self, ctx=None):
        """The value on ``ctx`` (see the module docstring for None), a
        ``torch.nn.Parameter``; inside a forward that
        :class:`~mxnet_tpu_torch.parallel.DataParallelTrainer` runs, the
        trainer's tensor for it."""
        if self._traced_value is not None:
            return self._traced_value
        return self._replica(ctx)

    def list_data(self):
        """The value on each context, in context order."""
        self._check_initialized()
        return self._values()

    def list_ctx(self):
        """The contexts the value lives on, in order."""
        self._check_initialized()
        return list(self._ctx_data)

    def grad(self, ctx=None):
        """The gradient buffer of the value on ``ctx``, its ``.grad``
        (zeros until a backward writes it)."""
        data = self.data(ctx)
        if self._grad_req == "null":
            raise MXNetError(f"Parameter {self.name} has no gradient "
                             "(grad_req='null')")
        if data.grad is None:
            data.grad = torch.zeros_like(data)
        return data.grad

    def list_grad(self):
        """The gradient buffer on each context, in context order."""
        return [self.grad(c) for c in self.list_ctx()]

    def zero_grad(self):
        """Set every gradient buffer to zeros, in place."""
        for v in self._values():
            if v.grad is not None:
                v.grad.zero_()

    @property
    def context(self):
        """The first Context of the value (None before initialization)."""
        if self._data is None:
            return None
        return next(iter(self._ctx_data))

    def set_data(self, data):
        """Copy ``data`` (numpy, NDArray or tensor) into the value on every
        context in place, finishing a deferred init first, and into the
        copy a Trainer's kvstore updates (``update_on_kvstore``), as MXNet
        1.x resets that kvstore."""
        if isinstance(data, NDArray):
            data = data.data
        src = data if isinstance(data, torch.Tensor) \
            else torch.from_numpy(np.array(data))
        self.shape = src.shape
        if self._data is None:
            if self._deferred_init is None:
                raise MXNetError(
                    f"Parameter {self.name}: set_data before initialize()")
            self._finish_init(*self._deferred_init)
        with torch.no_grad():
            for v in self._values():
                v.copy_(src.to(v.dtype))
        for trainer in list(self._kv_trainers):
            trainer._refresh_kv_value(self)

    def reset_ctx(self, ctx):
        """Move the value to ``ctx`` (a Context or a list): one copy per
        context of the first copy's values, with fresh gradients (ref:
        Parameter.reset_ctx)."""
        ctx = _ctx_list(ctx)
        if self._data is None:
            if self._deferred_init is None:
                raise MXNetError(f"Parameter {self.name}: reset_ctx before "
                                 "initialize()")
            init, _, default_init = self._deferred_init
            self._deferred_init = (init, ctx[0] if len(ctx) == 1 else ctx,
                                   default_init)
            return
        for v in self._values():
            autograd.mark_variables([v], [None], "null")
        self._place(ctx, self._data.detach())

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self._shape}, "
                f"dtype={self.dtype})")


def _ctx_list(ctx):
    """``ctx`` (a Context or a list of them) as a list of distinct
    Contexts, in order."""
    ctxs = list(ctx) if isinstance(ctx, (list, tuple)) else [ctx]
    if not ctxs:
        raise MXNetError("an empty list of contexts")
    return list(dict.fromkeys(Context(c) for c in ctxs))


class Constant(Parameter):
    """A non-differentiable parameter holding a fixed value (ref:
    ``gluon.Constant``, ``mxnet_tpu/gluon/parameter.py:245``): its
    ``grad_req`` is ``'null'``, so no trainer updates it, and
    ``save_parameters``/``load_parameters`` carry it like any parameter.

    Unlike the JAX package, whose ``initialize(init)`` lets the global
    initializer overwrite the value (ROADMAP.md, reference caveat (g)),
    the value survives every ``initialize`` call, ``force_reinit``
    included, as in MXNet 1.x, where the global initializer is only the
    default of a parameter without its own."""

    def __init__(self, name, value):
        if isinstance(value, NDArray):
            value = value.data
        value = value.detach().cpu() if isinstance(value, torch.Tensor) \
            else torch.from_numpy(np.array(value))
        if value.dtype == torch.float64:
            value = value.to(torch.float32)
        self.value = value
        super().__init__(name, grad_req="null", shape=tuple(value.shape),
                         dtype=str(value.dtype).replace("torch.", ""))

    def _initial_value(self, init, ctx, default_init):
        """The value itself, whatever initializer was asked for."""
        return self.value.to(ctx.torch_device(), copy=True)


class ParameterDict:
    """Ordered name -> Parameter mapping with a prefix (ref: gluon.ParameterDict)."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = {}
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def get(self, name, **kwargs):
        full = self._prefix + name
        if full in self._params:
            return self._params[full]
        if self._shared is not None and full in self._shared._params:
            self._params[full] = self._shared._params[full]
            return self._params[full]
        param = Parameter(full, **kwargs)
        self._params[full] = param
        return param

    def get_constant(self, name, value=None):
        """The :class:`Constant` ``prefix + name``, made from ``value`` on
        first use (ref: ``ParameterDict.get_constant``)."""
        full = self._prefix + name
        if full not in self._params:
            if value is None:
                raise MXNetError(f"no constant {full} yet, and no value "
                                 "to make it from")
            self._params[full] = Constant(full, value)
        return self._params[full]

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise MXNetError(f"duplicate parameter name {k}")
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        for p in self.values():
            p.initialize(init=init, ctx=ctx, force_reinit=force_reinit)

    def zero_grad(self):
        for p in self.values():
            p.zero_grad()

    def reset_ctx(self, ctx):
        """Move every Parameter to ``ctx`` (ref: ParameterDict.reset_ctx)."""
        for p in self.values():
            p.reset_ctx(ctx)

    def setattr(self, name, value):
        """Set attribute ``name`` of every Parameter, e.g.
        ``setattr('grad_req', 'null')`` or ``setattr('lr_mult', 0.1)``."""
        for p in self.values():
            setattr(p, name, value)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def __getitem__(self, k):
        return self._params[k]

    def __contains__(self, k):
        return k in self._params

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __repr__(self):
        lines = "\n".join(f"  {p}" for p in self.values())
        return f"ParameterDict '{self._prefix}' (\n{lines}\n)"
