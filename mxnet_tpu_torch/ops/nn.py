"""Neural-network ops: the subset of ``mxnet_tpu/ops/nn.py`` that BERT
serving and training, the ported losses and ResNet run."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as tF

from .. import autograd
from .. import random as _random
from ..base import MXNetError, getenv
from .registry import register


def _k_fully_connected(data, weight, bias=None, num_hidden=None,
                       no_bias=False, flatten=True):
    """``x @ weight.T + bias`` (ref: ops/nn.py:40); ``flatten`` folds
    every axis after the first into one."""
    x = data.reshape(data.shape[0], -1) if flatten and data.dim() > 2 \
        else data
    return tF.linear(x, weight, None if no_bias else bias)


register("FullyConnected", _k_fully_connected, aliases=("fully_connected",))


def _amp_in(data, weight):
    """A bf16/fp16 weight pulls the activation down to its dtype (ref:
    ``_amp_in``, ops/nn.py:32)."""
    if weight.dtype in (torch.bfloat16, torch.float16) \
            and data.dtype != weight.dtype:
        return data.to(weight.dtype)
    return data


def _conv_layouts(layout, nd):
    """(data_layout, weight_layout) for a layout string (ref: ops/nn.py:61):
    channel-last data (NHWC, ...) takes OHWI-style weights, channel-first
    data OIHW-style ones."""
    if not layout:
        layout = ("NCW", "NCHW", "NCDHW")[nd - 1]
    spatial = layout.replace("N", "").replace("C", "")
    if layout.endswith("C"):
        return layout, "O" + spatial + "I"
    return layout, "OI" + spatial


_CONV_FNS = {1: tF.conv1d, 2: tF.conv2d, 3: tF.conv3d}


def _k_convolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                   pad=(), num_filter=0, num_group=1, no_bias=False,
                   layout=None, cudnn_tune=None, cudnn_off=False,
                   workspace=1024):
    """Convolution (ref: ops/nn.py:78).  Channel-last data and its
    O...I weight go to cuDNN as channel-first views of the same memory
    (PyTorch's channels-last format), so no NCHW copy is made, and the
    output comes back as a channel-last view."""
    nd = len(kernel)
    stride = tuple(stride) or (1,) * nd
    dilate = tuple(dilate) or (1,) * nd
    pad = tuple(pad) or (0,) * nd
    data = _amp_in(data, weight)
    dl, _ = _conv_layouts(layout, nd)
    channel_last = dl.endswith("C")
    if channel_last:
        data = data.movedim(-1, 1)
        weight = weight.movedim(-1, 1)
    out = _CONV_FNS[nd](data, weight, None, stride, pad, dilate, num_group)
    if not no_bias and bias is not None:
        out = out + bias.to(out.dtype).reshape((1, -1) + (1,) * nd)
    return out.movedim(1, -1) if channel_last else out


register("Convolution", _k_convolution, aliases=("convolution",))


def _pool_out_pad(in_size, k, s, p, convention):
    """(low, high) padding of one spatial dim (ref: ops/nn.py:155): the
    ``full`` convention pads the high side up to the ceil-mode output."""
    if convention == "full":
        out = int(math.ceil((in_size + 2 * p - k) / s)) + 1
        needed = (out - 1) * s + k - in_size - p
        return p, max(needed, p)
    return p, p


_AVG_POOL = {1: tF.avg_pool1d, 2: tF.avg_pool2d, 3: tF.avg_pool3d}
_MAX_POOL = {1: tF.max_pool1d, 2: tF.max_pool2d, 3: tF.max_pool3d}


def _k_pooling(data, kernel=(), pool_type="max", stride=(), pad=(),
               global_pool=False, pooling_convention="valid",
               count_include_pad=True, cudnn_off=False, p_value=2,
               layout=None):
    """Pooling (ref: ops/nn.py:165): ``max``, ``avg`` and ``sum``, global
    or windowed, conventions ``valid`` and ``full``, ``count_include_pad``
    (whose divisor, as the reference's, is the window size even over the
    ``full`` convention's extra padding), channel-first or channel-last
    (``layout`` ending in C)."""
    if pool_type not in ("max", "avg", "sum"):
        raise MXNetError(f"Pooling: pool_type {pool_type!r} is not ported")
    nd = data.dim() - 2
    channel_last = bool(layout) and layout.endswith("C")
    x = data.movedim(-1, 1) if channel_last else data
    if global_pool:
        axes = tuple(range(2, 2 + nd))
        if pool_type == "max":
            out = x.amax(dim=axes, keepdim=True)
        elif pool_type == "sum":
            out = x.sum(dim=axes, keepdim=True)
        else:
            out = x.mean(dim=axes, keepdim=True)
        return out.movedim(1, -1) if channel_last else out
    kernel = tuple(kernel)
    stride = tuple(stride) or (1,) * nd
    pad = tuple(pad) or (0,) * nd
    pads = [_pool_out_pad(x.shape[2 + i], kernel[i], stride[i], pad[i],
                          pooling_convention) for i in range(nd)]
    # PyTorch pads both sides alike, by at most half the window; any other
    # padding is written out first
    inline = all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pads, kernel))
    torch_pad = tuple(lo for lo, _ in pads) if inline else 0
    if not inline:
        flat = [v for lo, hi in reversed(pads) for v in (lo, hi)]
        fill = float("-inf") if pool_type == "max" else 0.0
        x = tF.pad(x, flat, value=fill)
    if pool_type == "max":
        out = _MAX_POOL[nd](x, kernel, stride, torch_pad)
    else:
        window = math.prod(kernel)
        avg = _AVG_POOL[nd](x, kernel, stride, torch_pad,
                            count_include_pad=True)
        if pool_type == "sum":
            out = avg * window
        elif count_include_pad:
            out = avg
        else:
            ones = torch.ones_like(data if not channel_last
                                   else data.movedim(-1, 1))
            if not inline:
                ones = tF.pad(ones, flat, value=0.0)
            out = avg / _AVG_POOL[nd](ones, kernel, stride, torch_pad,
                                      count_include_pad=True)
    return out.movedim(1, -1) if channel_last else out


register("Pooling", _k_pooling, aliases=("pooling",))


# -- BatchNorm (ref: ops/nn.py:227-417) ---------------------------------------


def _bn_stats_use_pallas():
    """``MXTPU_BN_STATS=pallas``: training BatchNorm takes its statistics
    through autograd, from the one-pass statistics kernel (row 7 of the
    kernel table) on channel-last input, instead of the default
    closed-form Function (ops/nn.py:227-258).  A shape the kernel's gate
    refuses takes ``bn_stats``' plain sums, which square in fp32 where the
    JAX op squares in the data's dtype: they differ for bf16 input only."""
    return getenv("BN_STATS", "jnp").lower() == "pallas"


def _bn_shape(x, red):
    return [1 if i in red else d for i, d in enumerate(x.shape)]


def _bn_train_impl(x, g32, b32, eps, red):
    """(out, mean, var, inv): both moments from one fp32 view of x, the
    normalize as a per-channel scale and shift in x's dtype."""
    n = math.prod(x.shape[i] for i in red)
    xf = x.float()
    mean = xf.sum(dim=red) / n
    sq = (xf * xf).sum(dim=red) / n
    var = torch.clamp_min(sq - torch.square(mean), 0.0)
    inv = torch.rsqrt(var + eps)
    scale = g32 * inv
    shift = b32 - mean * scale
    shape = _bn_shape(x, red)
    out = x * scale.to(x.dtype).reshape(shape) \
        + shift.to(x.dtype).reshape(shape)
    return out, mean, var, inv


class _BnTrainFused(torch.autograd.Function):
    """Train BatchNorm with the closed-form backward of ``_bn_train_fused``
    (ops/nn.py:261-332): two sums over the activation (``sum dy`` and
    ``sum dy*(x-mean)``) and one elementwise pass for dx.  mean and var
    carry no gradient: they feed the moving averages only."""

    @staticmethod
    def forward(ctx, x, g32, b32, eps, red):
        out, mean, var, inv = _bn_train_impl(x, g32, b32, eps, red)
        ctx.save_for_backward(x, g32, mean, inv)
        ctx.red = red
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, g32, mean, inv = ctx.saved_tensors
        red = ctx.red
        n = math.prod(x.shape[i] for i in red)
        shape = _bn_shape(x, red)
        dyf = dy.float()
        xm = x.float() - mean.reshape(shape)
        sum_dy = dyf.sum(dim=red)
        sum_dy_xm = (dyf * xm).sum(dim=red)
        dgamma = inv * sum_dy_xm
        k1 = (g32 * inv).reshape(shape)
        k2 = (sum_dy / n).reshape(shape)
        k3 = (inv * inv * sum_dy_xm / n).reshape(shape)
        dx = (k1 * (dyf - k2 - xm * k3)).to(x.dtype)
        return dx, dgamma, sum_dy, None, None


def _k_batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                  momentum=0.9, fix_gamma=True, use_global_stats=False,
                  output_mean_var=False, axis=1, cudnn_off=False,
                  axis_name=None, _train=False):
    """BatchNorm (ref: ops/nn.py:335): ``(out, new_moving_mean,
    new_moving_var)``; the caller commits the moving statistics.

    Training without ``use_global_stats`` normalizes with the batch's
    biased variance ``E[x^2] - E[x]^2`` clamped at 0, computed in fp32,
    and moves the averages as ``mm*momentum + mean*(1-momentum)``.  (Not
    ``torch.nn.functional.batch_norm``: it moves the variance by the
    unbiased estimate and takes momentum the other way round.)"""
    if axis_name is not None:
        raise MXNetError("BatchNorm: cross-replica statistics (axis_name) "
                         "come with part 2 of the distributed slice "
                         "(ROADMAP queue 1, slice 7, part 2)")
    g = torch.ones_like(gamma) if fix_gamma else gamma
    axis = axis % data.dim()
    red = tuple(i for i in range(data.dim()) if i != axis)
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    train = _train and not use_global_stats
    if train and not _bn_stats_use_pallas():
        out, mean, var = _BnTrainFused.apply(data, g.float(), beta.float(),
                                             float(eps), red)
        with torch.no_grad():
            new_mm = moving_mean * momentum \
                + mean.to(moving_mean.dtype) * (1 - momentum)
            new_mv = moving_var * momentum \
                + var.to(moving_var.dtype) * (1 - momentum)
        return out, new_mm, new_mv
    if train:
        n = math.prod(data.shape[i] for i in red)
        if axis == data.dim() - 1:
            from .kernels import batch_norm as _kbn

            s, q = _kbn.bn_stats(data.reshape(n, data.shape[-1]))
            mean, sumsq_mean = s / n, q / n
        else:
            mean = data.float().mean(dim=red)
            sumsq_mean = torch.square(data).float().mean(dim=red)
        var = torch.clamp_min(sumsq_mean - torch.square(mean), 0.0)
        with torch.no_grad():
            new_mm = moving_mean * momentum \
                + mean.to(moving_mean.dtype) * (1 - momentum)
            new_mv = moving_var * momentum \
                + var.to(moving_var.dtype) * (1 - momentum)
    else:
        mean, var = moving_mean.float(), moving_var.float()
        new_mm, new_mv = moving_mean, moving_var
    scale = g.float() * torch.rsqrt(var + eps)
    shift = beta.float() - mean * scale
    out = data * scale.to(data.dtype).reshape(shape) \
        + shift.to(data.dtype).reshape(shape)
    return out, new_mm, new_mv


register("BatchNorm", _k_batch_norm, aliases=("batch_norm",))


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
