"""Weight initializers (ref: python/mxnet/initializer.py;
``mxnet_tpu/initializer.py``).  ``Uniform``, ``Normal`` and ``Xavier``
draw from the explicit generator of the device being filled
(``random.generator``); ``TruncNorm``, ``Orthogonal`` and ``MSRAPrelu``
draw from the framework's numpy stream (``random.np_rng()``), as the JAX
package's initializers do, so after one ``mx.random.seed`` they fill the
same bits in both packages."""
from __future__ import annotations

import math
import re

import numpy as np
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


def _fill(arr, values):
    """Write the numpy ``values`` into ``arr`` in its dtype and place."""
    arr.copy_(torch.from_numpy(np.asarray(values)).to(arr.dtype))


@register
class Constant(Initializer):
    """Every weight ``value`` (a number, or an array that broadcasts)."""

    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, name, arr):
        arr[...] = torch.as_tensor(self.value, dtype=arr.dtype,
                                   device=arr.device)


@register
class TruncNorm(Initializer):
    """N(mean, stdev) truncated to two deviations: the draws outside
    redrawn, not clipped (ref: initializer.py TruncNorm; BERT's init)."""

    def __init__(self, mean=0.0, stdev=0.01):
        super().__init__(mean=mean, stdev=stdev)
        self.mean = mean
        self.stdev = stdev

    def _init_weight(self, name, arr):
        rng = _random.np_rng()
        vals = rng.normal(0, 1, tuple(arr.shape))
        bad = (vals < -2.0) | (vals > 2.0)
        while bad.any():
            vals[bad] = rng.normal(0, 1, int(bad.sum()))
            bad = (vals < -2.0) | (vals > 2.0)
        _fill(arr, self.mean + self.stdev * vals)


@register
class Orthogonal(Initializer):
    """``scale`` times an orthonormal basis from the SVD of a uniform
    (``rand_type='uniform'``) or normal draw, the weight seen as
    ``(shape[0], rest)``."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, arr):
        nout = arr.shape[0]
        nin = math.prod(arr.shape[1:]) if arr.dim() > 1 else 1
        rng = _random.np_rng()
        if self.rand_type == "uniform":
            tmp = rng.uniform(-1, 1, (nout, nin))
        else:
            tmp = rng.normal(0, 1, (nout, nin))
        u, _, v = np.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == tmp.shape else v
        _fill(arr, self.scale * q.reshape(tuple(arr.shape)))


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
        self._draw(arr, math.sqrt(self.magnitude / factor))

    def _draw(self, arr, scale):
        gen = _random.generator(arr.device)
        if self.rnd_type == "uniform":
            arr.uniform_(-scale, scale, generator=gen)
        else:
            arr.normal_(0.0, scale, generator=gen)


@register
class MSRAPrelu(Xavier):
    """He's initialization for PReLU nets: Xavier's gaussian with
    ``magnitude = 2 / (1 + slope^2)``, drawn from the numpy stream."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}

    def _draw(self, arr, scale):
        _fill(arr, _random.np_rng().normal(0, scale, tuple(arr.shape)))


@register
class Bilinear(Initializer):
    """The bilinear upsampling filter, for a ``Deconvolution`` weight of
    shape ``(C, 1, k, k)`` (ref: initializer.py Bilinear)."""

    def _init_weight(self, name, arr):
        shape = tuple(arr.shape)
        weight = np.zeros(math.prod(shape), dtype="float32")
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(math.prod(shape)):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        _fill(arr, weight.reshape(shape))


@register
class LSTMBias(Initializer):
    """Zeros with the forget gate's quarter at ``forget_bias`` (gate order
    i, f, g, o).  It fills the weights that reach ``_init_weight``: a name
    ending in ``bias`` takes the base class's zeros, as in the JAX
    package."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        arr.zero_()
        n = arr.shape[0] // 4
        arr[n:2 * n] = self.forget_bias


@register
class Mixed(Initializer):
    """Each parameter initialized by the first initializer whose regular
    expression matches its full name (``re.match``); a name that none
    matches raises, so put ``'.*'`` last as the catch-all."""

    def __init__(self, patterns, initializers):
        super().__init__(patterns=patterns)
        if len(patterns) != len(initializers):
            raise ValueError(
                "patterns and initializers must pair up, got "
                f"{len(patterns)} vs {len(initializers)}")
        self._map = [(re.compile(p), init)
                     for p, init in zip(patterns, initializers)]

    def init_array(self, name, arr):
        for pat, init in self._map:
            if pat.match(name):
                init.init_array(name, arr)
                return
        raise ValueError(
            f"parameter {name!r} matched none of the Mixed patterns; "
            "add a '.*' catch-all as the last pattern")


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


# aliases matching mx.init
zero = Zero
one = One
