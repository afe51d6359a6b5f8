"""Weight initializers (ref: python/mxnet/initializer.py): the ones BERT's
and ResNet's blocks use.  Random draws come from the explicit generator of
the device being filled (``random.generator``)."""
from __future__ import annotations

import math

import torch

from . import random as _random
from .base import MXNetError

_registry = {}


def register(cls):
    _registry[cls.__name__.lower()] = cls
    return cls


class InitDesc(str):
    """Parameter name handed to initializers, with attribute hints (ref:
    mxnet.init.InitDesc).  Channel-last convolutions attach
    ``__init_fan__``, so fan-based initializers read the fans of an OHWI
    weight right (its shape alone is ambiguous)."""

    def __new__(cls, name, attrs=None):
        s = super().__new__(cls, name)
        s.attrs = dict(attrs or {})
        return s


class Initializer:
    """Base initializer: dispatches on the parameter name's suffix as
    MXNet does (bias, beta and moving means zero, gamma and moving
    variances one, the rest ``_init_weight``)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, name, arr):
        with torch.no_grad(), _random.capture_lock:
            self.init_array(name, arr)

    def init_array(self, name, arr):
        if name.endswith(("bias", "beta", "running_mean", "moving_mean")):
            arr.zero_()
        elif name.endswith(("gamma", "running_var", "moving_var")):
            arr.fill_(1.0)
        else:
            self._init_weight(name, arr)

    def _init_weight(self, name, arr):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}({self._kwargs})"


@register
class Zero(Initializer):
    def _init_weight(self, name, arr):
        arr.zero_()


@register
class One(Initializer):
    def _init_weight(self, name, arr):
        arr.fill_(1.0)


@register
class Uniform(Initializer):
    """U(-scale, scale); the default of ``Parameter.initialize``."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, arr):
        arr.uniform_(-self.scale, self.scale,
                     generator=_random.generator(arr.device))


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, arr):
        arr.normal_(0.0, self.sigma, generator=_random.generator(arr.device))


@register
class Xavier(Initializer):
    """Ref: mx.init.Xavier: U(-a, a) (``rnd_type='uniform'``) or N(0, a)
    (``'gaussian'``) with ``a = sqrt(magnitude / factor)``, the factor the
    average, in- or out-fan (``factor_type`` avg, in, out)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        hints = getattr(name, "attrs", {})
        if "__init_fan__" in hints:
            fan_in, fan_out = hints["__init_fan__"]
        else:
            if len(shape) < 2:
                raise MXNetError(f"Xavier initializer needs a weight of 2 or "
                                 f"more dims, got {tuple(shape)} for {name}")
            hw_scale = math.prod(shape[2:])
            fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        scale = math.sqrt(self.magnitude / factor)
        gen = _random.generator(arr.device)
        if self.rnd_type == "uniform":
            arr.uniform_(-scale, scale, generator=gen)
        else:
            arr.normal_(0.0, scale, generator=gen)


_registry["zeros"] = Zero
_registry["ones"] = One


def create(name, **kwargs):
    """An initializer from an instance or a registered name."""
    if isinstance(name, Initializer):
        return name
    key = str(name).lower()
    if key not in _registry:
        raise MXNetError(f"unknown initializer {name!r}; known: "
                         f"{sorted(_registry)}")
    return _registry[key](**kwargs)

