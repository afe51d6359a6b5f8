"""Random sampling ops (ref: ``mxnet_tpu/ops/random_ops.py``).

Two families, as in the JAX module:

- ``_random_*``: scalar parameters and a ``shape``, drawn on ``ctx`` (a
  Context or ``torch.device``; default :func:`current_context`); the ops
  behind ``F.random.*`` and ``mx.sym.random.*``;
- ``sample_*``: per-element parameter arrays; the output's shape is the
  parameters' shape followed by ``shape``.

Every draw comes from the explicit generator of the device it lands on
(``random.generator``), which ``mx.random.seed`` reseeds, so the values
are reproducible from the seed but differ from the JAX package's
threefry streams.
"""
from __future__ import annotations

import torch

from .. import random as _random
from ..ndarray.ndarray import to_torch_dtype
from .registry import register
from .tensor import _device


def _shp(shape):
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)


def _dt(dtype, default=torch.float32):
    return default if dtype in (None, "None") else to_torch_dtype(dtype)


def _empty(shape, dtype, ctx):
    device = _device(ctx)
    return torch.empty(_shp(shape), dtype=_dt(dtype), device=device), \
        _random.generator(device)


def _k_random_uniform(low=0.0, high=1.0, shape=(1,), dtype=None, ctx=None):
    """Draws from U[low, high)."""
    out, gen = _empty(shape, dtype, ctx)
    return out.uniform_(float(low), float(high), generator=gen)


def _k_random_normal(loc=0.0, scale=1.0, shape=(1,), dtype=None, ctx=None):
    out, gen = _empty(shape, dtype, ctx)
    return out.normal_(float(loc), float(scale), generator=gen)


def _k_random_gamma(alpha=1.0, beta=1.0, shape=(1,), dtype=None, ctx=None):
    """Gamma with shape ``alpha`` and scale ``beta``."""
    out, gen = _empty(shape, dtype, ctx)
    conc = torch.full_like(out, float(alpha), dtype=torch.float32)
    return (torch._standard_gamma(conc, generator=gen) * beta).to(out.dtype)


def _k_random_exponential(lam=None, scale=None, shape=(1,), dtype=None,
                          ctx=None):
    """Rate ``lam``, or the Python API's mean ``scale`` (= 1/lam)."""
    if lam is None:
        lam = 1.0 / scale if scale is not None else 1.0
    out, gen = _empty(shape, dtype, ctx)
    return out.exponential_(float(lam), generator=gen)


def _k_random_bernoulli(p=0.5, shape=(1,), dtype=None, ctx=None):
    out, gen = _empty(shape, dtype, ctx)
    return out.bernoulli_(float(p), generator=gen)


def _k_random_poisson(lam=1.0, shape=(1,), dtype=None, ctx=None):
    out, gen = _empty(shape, dtype, ctx)
    rate = torch.full(out.shape, float(lam), dtype=torch.float32,
                      device=out.device)
    return torch.poisson(rate, generator=gen).to(out.dtype)


def _k_random_randint(low=0, high=None, shape=(1,), dtype="int32", ctx=None):
    """Integers in [low, high)."""
    if high is None:
        raise ValueError("_random_randint requires both low and high")
    device = _device(ctx)
    return torch.randint(int(low), int(high), _shp(shape),
                         dtype=_dt(dtype, torch.int32), device=device,
                         generator=_random.generator(device))


_META = dict(arg_names=(), needs_rng=True, nondiff=True)
register("_random_uniform", _k_random_uniform, aliases=("random_uniform",),
         **_META)
register("_random_normal", _k_random_normal, aliases=("random_normal",),
         **_META)
register("_random_gamma", _k_random_gamma, aliases=("random_gamma",),
         **_META)
register("_random_exponential", _k_random_exponential,
         aliases=("random_exponential",), **_META)
register("_random_poisson", _k_random_poisson, aliases=("random_poisson",),
         **_META)
register("_random_randint", _k_random_randint, **_META)
register("_random_bernoulli", _k_random_bernoulli, **_META)


# ---------------------------------------------------------------------------
# per-element parameters: the output is param.shape + shape

def _expand(p, shp):
    return p.reshape(tuple(p.shape) + (1,) * len(shp))


def _full(p, shp):
    """``p`` broadcast to ``p.shape + shp``, as float32 (the samplers'
    parameter type), a new tensor."""
    return _expand(p, shp).to(torch.float32).expand(
        tuple(p.shape) + shp).contiguous()


def _k_sample_uniform(low, high, shape=(), dtype=None):
    shp = _shp(shape)
    u = torch.empty(tuple(low.shape) + shp, dtype=_dt(dtype, low.dtype),
                    device=low.device)
    u.uniform_(0.0, 1.0, generator=_random.generator(low.device))
    return _expand(low, shp) + u * (_expand(high, shp) - _expand(low, shp))


def _k_sample_normal(mu, sigma, shape=(), dtype=None):
    shp = _shp(shape)
    z = torch.empty(tuple(mu.shape) + shp, dtype=_dt(dtype, mu.dtype),
                    device=mu.device)
    z.normal_(generator=_random.generator(mu.device))
    return _expand(mu, shp) + _expand(sigma, shp) * z


def _k_sample_gamma(alpha, beta, shape=(), dtype=None):
    shp = _shp(shape)
    g = torch._standard_gamma(_full(alpha, shp),
                              generator=_random.generator(alpha.device))
    return (g * _expand(beta, shp)).to(_dt(dtype, alpha.dtype))


def _k_sample_exponential(lam, shape=(), dtype=None):
    shp = _shp(shape)
    e = torch.empty(tuple(lam.shape) + shp, dtype=_dt(dtype, lam.dtype),
                    device=lam.device)
    e.exponential_(1.0, generator=_random.generator(lam.device))
    return e / _expand(lam, shp)


def _k_sample_poisson(lam, shape=(), dtype=None):
    shp = _shp(shape)
    out = torch.poisson(_full(lam, shp),
                        generator=_random.generator(lam.device))
    return out.to(_dt(dtype))


def _gamma_poisson(shape_param, rate_scale, gen):
    """Poisson draws whose rates are Gamma(``shape_param``) times
    ``rate_scale``: the negative binomials' mixture."""
    g = torch._standard_gamma(shape_param, generator=gen)
    return torch.poisson(g * rate_scale, generator=gen)


def _k_sample_negative_binomial(k, p, shape=(), dtype=None):
    """NB(k successes, success probability p), as a gamma-Poisson
    mixture."""
    shp = _shp(shape)
    pe = _expand(p, shp).to(torch.float32)
    out = _gamma_poisson(_full(k, shp), (1.0 - pe) / torch.clamp_min(
        pe, 1e-12), _random.generator(k.device))
    return out.to(_dt(dtype))


def _k_sample_generalized_negative_binomial(mu, alpha, shape=(), dtype=None):
    """GNB(mu, alpha): r = 1/alpha, p = r/(r+mu)."""
    shp = _shp(shape)
    a = torch.clamp_min(_full(alpha, shp), 1e-12)
    out = _gamma_poisson(1.0 / a, _expand(mu, shp).to(torch.float32) * a,
                         _random.generator(mu.device))
    return out.to(_dt(dtype))


_SMETA = dict(needs_rng=True, nondiff=True)
register("sample_uniform", _k_sample_uniform, arg_names=("low", "high"),
         **_SMETA)
register("sample_normal", _k_sample_normal, arg_names=("mu", "sigma"),
         **_SMETA)
register("sample_gamma", _k_sample_gamma, arg_names=("alpha", "beta"),
         **_SMETA)
register("sample_exponential", _k_sample_exponential, arg_names=("lam",),
         **_SMETA)
register("sample_poisson", _k_sample_poisson, arg_names=("lam",), **_SMETA)
register("sample_negative_binomial", _k_sample_negative_binomial,
         arg_names=("k", "p"), **_SMETA)
register("sample_generalized_negative_binomial",
         _k_sample_generalized_negative_binomial, arg_names=("mu", "alpha"),
         **_SMETA)
