"""Weight initializers (ref: python/mxnet/initializer.py): the ones BERT's
blocks use.  Random draws come from the explicit generator of the
device being filled (``random.generator``)."""
from __future__ import annotations

import torch

from . import random as _random
from .base import MXNetError

_registry = {}


def register(cls):
    _registry[cls.__name__.lower()] = cls
    return cls


class InitDesc(str):
    """Parameter name handed to initializers (ref: mxnet.init.InitDesc)."""


class Initializer:
    """Base initializer: dispatches on the parameter name's suffix as
    MXNet does (bias and beta zero, gamma one, the rest ``_init_weight``)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, name, arr):
        with torch.no_grad():
            self.init_array(str(name), arr)

    def init_array(self, name, arr):
        if name.endswith("bias") or name.endswith("beta"):
            arr.zero_()
        elif name.endswith("gamma"):
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

