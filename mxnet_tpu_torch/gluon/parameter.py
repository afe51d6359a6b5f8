"""Gluon Parameter / ParameterDict (ref: python/mxnet/gluon/parameter.py).

A :class:`Parameter` keeps the Gluon metadata (name, shape with 0 for
unknown dims, init, grad_req) and its value, a ``torch.nn.Parameter`` on
one device.  The value is registered in every block that holds the
Parameter as an attribute, under that attribute's name, so a block's
``named_parameters()`` and ``state_dict()`` keys are the structural names
of ``_collect_params_with_prefix`` (``encoder.layers.0.attn_in_weight``).

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
from ..context import Context, current_context
from ..ndarray.ndarray import NDArray, to_torch_dtype


class DeferredInitializationError(MXNetError):
    pass


class Parameter:
    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False):
        self.name = name
        self._data = None            # torch.nn.Parameter
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
        if self._data is not None:
            autograd.mark_variables([self._data], [self._data.grad], req)

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
        default_init = default_init or init_mod.Uniform()
        if self._data is not None and not force_reinit:
            return
        if isinstance(ctx, (list, tuple)):
            if len(ctx) != 1:
                raise MXNetError(
                    f"Parameter {self.name}: the port keeps one device per "
                    f"parameter, got {ctx}")
            ctx = ctx[0]
        if ctx is None:
            ctx = current_context()
        if not self._shape_known():
            if self.allow_deferred_init:
                self._deferred_init = (init, ctx, default_init)
                return
            raise MXNetError(
                f"cannot initialize Parameter {self.name}: unknown shape "
                f"{self._shape} and allow_deferred_init=False")
        self._finish_init(init, ctx, default_init)

    def _finish_init(self, init, ctx, default_init):
        initializer = init or self.init or default_init
        if isinstance(initializer, str):
            initializer = init_mod.create(initializer)
        data = torch.empty(self._shape, dtype=to_torch_dtype(self.dtype),
                           device=ctx.torch_device())
        initializer(init_mod.InitDesc(self.name, self._init_attrs), data)
        self._data = torch.nn.Parameter(data, requires_grad=False)
        autograd.mark_variables([self._data], [None], self._grad_req)
        self._deferred_init = None
        self._publish()

    def _finish_deferred_init(self):
        if self._deferred_init is None:
            return
        if not self._shape_known():
            raise DeferredInitializationError(
                f"Parameter {self.name} has unknown shape {self._shape}")
        self._finish_init(*self._deferred_init)

    # -- access -------------------------------------------------------------

    def data(self, ctx=None):
        """The value, a ``torch.nn.Parameter`` (or, inside a forward that
        :class:`~mxnet_tpu_torch.parallel.DataParallelTrainer` runs, the
        trainer's tensor for it)."""
        if self._traced_value is not None:
            return self._traced_value
        if self._data is None:
            if self._deferred_init is not None:
                raise DeferredInitializationError(
                    f"Parameter {self.name} has not been initialized yet "
                    "(deferred); run a forward pass first")
            raise MXNetError(f"Parameter {self.name} has not been "
                             "initialized. Call .initialize() first")
        if ctx is not None and Context(ctx) != self.context:
            raise MXNetError(f"Parameter {self.name} lives on "
                             f"{self.context}, not {ctx}")
        return self._data

    def list_data(self):
        """The value on each device: one, in this port."""
        return [self.data()]

    def list_ctx(self):
        """The devices the value lives on: one, in this port."""
        self.data()
        return [self.context]

    def grad(self, ctx=None):
        """The gradient buffer, the value's ``.grad`` (zeros until a
        backward writes it)."""
        data = self.data(ctx)
        if self._grad_req == "null":
            raise MXNetError(f"Parameter {self.name} has no gradient "
                             "(grad_req='null')")
        if data.grad is None:
            data.grad = torch.zeros_like(data)
        return data.grad

    def list_grad(self):
        return [self.grad()]

    def zero_grad(self):
        """Set the gradient buffer to zeros, in place."""
        if self._data is not None and self._data.grad is not None:
            self._data.grad.zero_()

    @property
    def context(self):
        """The Context of the value (None before initialization)."""
        if self._data is None:
            return None
        return Context.from_device(self._data.device)

    def set_data(self, data):
        """Copy ``data`` (numpy, NDArray or tensor) into the value in place,
        finishing a deferred init first."""
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
            self._data.copy_(src.to(self._data.dtype))

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self._shape}, "
                f"dtype={self.dtype})")


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

    def _finish_init(self, init, ctx, default_init):
        """The value itself, whatever initializer was asked for."""
        self._data = torch.nn.Parameter(
            self.value.to(ctx.torch_device(), copy=True),
            requires_grad=False)
        autograd.mark_variables([self._data], [None], self._grad_req)
        self._deferred_init = None
        self._publish()


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
