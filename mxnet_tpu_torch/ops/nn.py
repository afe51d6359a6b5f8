"""Neural-network ops: the subset of ``mxnet_tpu/ops/nn.py`` that BERT
serving and training and the ported losses run."""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from .. import autograd
from .. import random as _random
from ..base import MXNetError
from .registry import register


def _k_fully_connected(data, weight, bias=None, num_hidden=None,
                       no_bias=False, flatten=True):
    """``x @ weight.T + bias`` (ref: ops/nn.py:40); ``flatten`` folds
    every axis after the first into one."""
    x = data.reshape(data.shape[0], -1) if flatten and data.dim() > 2 \
        else data
    return tF.linear(x, weight, None if no_bias else bias)


register("FullyConnected", _k_fully_connected, aliases=("fully_connected",))


def _k_layer_norm(data, gamma, beta, axis=-1, eps=1e-5):
    """Layer normalization with the biased variance (ref: ops/nn.py:420)."""
    if axis in (-1, data.dim() - 1):
        return tF.layer_norm(data, data.shape[-1:], gamma, beta, eps)
    mean = data.mean(dim=axis, keepdim=True)
    var = data.var(dim=axis, keepdim=True, unbiased=False)
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    return (data - mean) * torch.rsqrt(var + eps) * gamma.reshape(shape) \
        + beta.reshape(shape)


register("LayerNorm", _k_layer_norm, aliases=("layer_norm",))


def _k_activation(data, act_type):
    """Ref: ops/nn.py:489.  ``gelu`` here is the exact erf form."""
    if act_type == "relu":
        return torch.relu(data)
    if act_type == "sigmoid":
        return torch.sigmoid(data)
    if act_type == "tanh":
        return torch.tanh(data)
    if act_type == "softrelu":
        return tF.softplus(data)
    if act_type == "gelu":
        return tF.gelu(data, approximate="none")
    raise MXNetError(f"Activation: unknown act_type {act_type!r}")


register("Activation", _k_activation, aliases=("activation",))


def _k_leaky_relu(data, act_type="leaky", slope=0.25):
    """Ref: ops/nn.py:507.  ``gelu`` here is the tanh approximation,
    unlike ``Activation(gelu)`` (ops/nn.py:500 vs :520)."""
    if act_type == "leaky":
        return torch.where(data > 0, data, slope * data)
    if act_type == "gelu":
        return tF.gelu(data, approximate="tanh")
    raise MXNetError(f"LeakyReLU: act_type {act_type!r} is not ported")


register("LeakyReLU", _k_leaky_relu)


def _k_dropout(data, p=0.5, mode="training", axes=()):
    """Inverted dropout (ref: ops/nn.py:700): the identity outside
    training unless ``mode='always'``; the keep mask is drawn from the
    device's explicit generator."""
    if not (autograd.is_training() or mode == "always") or p <= 0:
        return data
    shape = list(data.shape)
    for ax in axes:
        shape[ax] = 1
    keep = 1.0 - p
    mask = torch.empty(shape, dtype=data.dtype, device=data.device)
    mask.bernoulli_(keep, generator=_random.generator(data.device))
    return data * mask / keep


register("Dropout", _k_dropout, aliases=("dropout",))


def _k_softmax(data, axis=-1, temperature=None):
    """Ref: ops/nn.py:541."""
    x = data / temperature if temperature else data
    return torch.softmax(x, dim=axis)


register("softmax", _k_softmax, aliases=("SoftmaxActivation",))


def _k_log_softmax(data, axis=-1, temperature=None):
    """Ref: ops/nn.py:548."""
    x = data / temperature if temperature else data
    return torch.log_softmax(x, dim=axis)


register("log_softmax", _k_log_softmax)
