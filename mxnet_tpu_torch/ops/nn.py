"""Neural-network ops (ref: ``mxnet_tpu/ops/nn.py``): the products,
convolutions and transposed convolutions, pooling, the normalizations,
activations, softmax family, dropout, resizing and the loss heads of
symbolic graphs (``SoftmaxOutput``, the regression outputs and
``SVMOutput``)."""
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
    every axis after the first into one.  Inside the mesh step a weight
    split over ``mp`` is computed on its shard
    (``parallel.spmd.products.linear``).  Dtypes follow the reference: a
    bfloat16 or float16 weight casts the data to its dtype (``_amp_in``),
    a float16 input to float32 weights computes in float32, and the bias
    takes the product's dtype."""
    from ..parallel.spmd.products import linear

    data = _amp_in(data, weight)
    x = data.reshape(data.shape[0], -1) if flatten and data.dim() > 2 \
        else data
    if x.dtype != weight.dtype:   # a float16 input to float32 weights
        dt = torch.promote_types(x.dtype, weight.dtype)
        x, weight = x.to(dt), weight.to(dt)
    if bias is not None and bias.dtype != weight.dtype:
        bias = bias.to(weight.dtype)   # ref: bias.astype(out.dtype)
    return linear(x, weight, None if no_bias else bias)


register("FullyConnected", _k_fully_connected, aliases=("fully_connected",),
         arg_names=("data", "weight", "bias"))


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


register("Convolution", _k_convolution, aliases=("convolution",),
         arg_names=("data", "weight", "bias"))


_DECONV_FNS = {1: tF.conv_transpose1d, 2: tF.conv_transpose2d,
               3: tF.conv_transpose3d}


def _k_deconvolution(data, weight, bias=None, kernel=(), stride=(),
                     dilate=(), pad=(), adj=(), num_filter=0, num_group=1,
                     no_bias=True, target_shape=(), layout=None,
                     cudnn_tune=None, cudnn_off=False, workspace=1024):
    """Transposed convolution (ref: ops/nn.py:105), channel-first only.
    The weight is MXNet's ``(in, out/groups, *k)``, which is also
    ``conv_transpose*d``'s; a group takes its slice of the data's channels
    and of the weight's first axis, as the JAX op splits them.  Each output
    dim is ``(in - 1)*stride - 2*pad + dilate*(k - 1) + adj + 1``: the
    transposed convolution without padding, cut from ``pad`` on, with the
    ``adj`` positions past its end zeros where it has none (so any ``adj``
    is taken, as ``lax.conv_general_dilated`` takes it, where
    ``output_padding`` must stay below the stride or the dilation).
    ``target_shape``, which the JAX op accepts and ignores, raises for any
    value but the default."""
    nd = len(kernel)
    if layout and layout.endswith("C"):
        raise MXNetError(
            "Deconvolution supports channel-first layouts only; "
            f"got layout={layout!r} (channel-last deconv weights/"
            "grouping are not implemented)")
    if tuple(target_shape or ()):
        raise MXNetError(f"Deconvolution: target_shape={target_shape!r} is "
                         "not implemented (only the default ())")
    stride = tuple(stride) or (1,) * nd
    dilate = tuple(dilate) or (1,) * nd
    pad = tuple(pad) or (0,) * nd
    adj = tuple(adj) or (0,) * nd
    full = _DECONV_FNS[nd](data, weight, None, stride, 0, 0, num_group,
                           dilate)
    out = full
    for i, (p, a) in enumerate(zip(pad, adj)):
        ax, n = 2 + i, full.shape[2 + i]
        want = n - 2 * p + a
        out = out.narrow(ax, p, min(want, n - p))
        if want > n - p:
            extra = [0, 0] * (nd - 1 - i) + [0, want - (n - p)]
            out = tF.pad(out, extra)
    if not no_bias and bias is not None:
        out = out + bias.to(out.dtype).reshape((1, -1) + (1,) * nd)
    return out


register("Deconvolution", _k_deconvolution, aliases=("deconvolution",),
         arg_names=("data", "weight", "bias"))


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
    (``layout`` ending in C); and ``lp``, ``(sum |x|^p_value)^(1/p_value)``
    over the window, the padding adding zeros."""
    if pool_type not in ("max", "avg", "sum", "lp"):
        raise MXNetError(f"Pooling: unknown pool_type {pool_type!r}")
    nd = data.dim() - 2
    channel_last = bool(layout) and layout.endswith("C")
    x = data.movedim(-1, 1) if channel_last else data
    if pool_type == "lp":
        x = torch.abs(x) ** p_value
    if global_pool:
        axes = tuple(range(2, 2 + nd))
        if pool_type == "max":
            out = x.amax(dim=axes, keepdim=True)
        elif pool_type in ("sum", "lp"):
            out = x.sum(dim=axes, keepdim=True)
        else:
            out = x.mean(dim=axes, keepdim=True)
        if pool_type == "lp":
            out = out ** (1.0 / p_value)
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
        if pool_type in ("sum", "lp"):
            out = avg * window
            if pool_type == "lp":
                out = out ** (1.0 / p_value)
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


def moving_average(avg, value, momentum):
    """``avg * momentum + value * (1 - momentum)`` in avg's dtype, value
    cast to it first (ref: ops/nn.py:364-367, conv_fused_ops.py:47-50).
    A float16 ``avg`` takes the reference's arithmetic as XLA compiles it
    on the CPU: the momenta rounded to float16 (Python scalars take the
    array's dtype there), ``value * (1 - momentum)`` rounded to float16,
    then ``avg * momentum`` and the sum in fp32, rounded once (ROADMAP
    queue 3, item 19)."""
    value = value.to(avg.dtype)
    if avg.dtype == torch.float16:
        m, rest = (float(torch.tensor(v, dtype=torch.float16))
                   for v in (momentum, 1 - momentum))
        return (avg.float() * m + (value * rest).float()).to(avg.dtype)
    return avg * momentum + value * (1 - momentum)


def _scale_shift(x, scale, shift, shape):
    """``x * scale + shift`` per channel, with scale and shift rounded to
    x's dtype first (ref: ops/nn.py:282-283, 408-409).  The reference's op
    is one XLA computation, which widens float16 to fp32 for the multiply
    and the add and rounds their result once, where torch rounds each step:
    so a float16 x is computed in fp32 and rounded once (one ulp apart
    otherwise on ~28% of the elements, ROADMAP queue 3, item 19); bfloat16
    and fp32 round each step, as there."""
    sc = scale.to(x.dtype).reshape(shape)
    sh = shift.to(x.dtype).reshape(shape)
    if x.dtype == torch.float16:
        return (x.float() * sc.float() + sh.float()).to(x.dtype)
    return x * sc + sh


def _group_sum(group, a, b):
    """``(a, b)`` summed over ``group`` in one all-reduce (no autograd:
    the closed-form Function below calls it in its forward and its
    backward, which is ``parallel.mesh.SumOverGroup`` inlined)."""
    buf = group.all_reduce_(torch.cat([a, b]), "stats")
    return buf[:a.numel()], buf[a.numel():]


def _bn_train_impl(x, g32, b32, eps, red, group=None):
    """(out, mean, var, inv): both moments from one fp32 view of x, the
    normalize as a per-channel scale and shift in x's dtype.  With a
    ``group`` the sums are those over its ranks' batches."""
    n = math.prod(x.shape[i] for i in red)
    xf = x.float()
    s, q = xf.sum(dim=red), (xf * xf).sum(dim=red)
    if group is not None:
        s, q = _group_sum(group, s, q)
        n *= group.size
    mean = s / n
    sq = q / n
    var = torch.clamp_min(sq - torch.square(mean), 0.0)
    inv = torch.rsqrt(var + eps)
    scale = g32 * inv
    shift = b32 - mean * scale
    out = _scale_shift(x, scale, shift, _bn_shape(x, red))
    return out, mean, var, inv


class _BnTrainFused(torch.autograd.Function):
    """Train BatchNorm with the closed-form backward of ``_bn_train_fused``
    (ops/nn.py:261-332): two sums over the activation (``sum dy`` and
    ``sum dy*(x-mean)``) and one elementwise pass for dx.  mean and var
    carry no gradient: they feed the moving averages only.

    With a ``group`` (statistics over several ranks' batches) the forward
    sums and the backward's two sums are summed over the group, as the
    JAX op pmeans them (ops/nn.py:275-276, 302-303); dgamma and dbeta stay
    this rank's, as the gradient of its own loss, which the trainer then
    sums over the ranks."""

    @staticmethod
    def forward(ctx, x, g32, b32, eps, red, group):
        out, mean, var, inv = _bn_train_impl(x, g32, b32, eps, red, group)
        ctx.save_for_backward(x, g32, mean, inv)
        ctx.red, ctx.group = red, group
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, g32, mean, inv = ctx.saved_tensors
        red, group = ctx.red, ctx.group
        n = math.prod(x.shape[i] for i in red)
        shape = _bn_shape(x, red)
        dyf = dy.float()
        xm = x.float() - mean.reshape(shape)
        sum_dy = dyf.sum(dim=red)
        sum_dy_xm = (dyf * xm).sum(dim=red)
        dgamma = inv * sum_dy_xm
        dbeta = sum_dy
        if group is not None:
            sum_dy, sum_dy_xm = _group_sum(group, sum_dy, sum_dy_xm)
            n *= group.size
        k1 = (g32 * inv).reshape(shape)
        k2 = (sum_dy / n).reshape(shape)
        k3 = (inv * inv * sum_dy_xm / n).reshape(shape)
        dx = (k1 * (dyf - k2 - xm * k3)).to(x.dtype)
        return dx, dgamma, dbeta, None, None, None


_BN_ARGS = ("data", "gamma", "beta", "moving_mean", "moving_var")


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
    unbiased estimate and takes momentum the other way round.)

    Cross-replica statistics: in training, the sums behind the mean and
    ``E[x^2]`` are summed over ``parallel.mesh.stats_group(axis_name)``
    before the moments are taken: the group of mesh axis ``axis_name``,
    or, inside a ``DataParallelTrainer`` step on a mesh of more than one
    rank, the data axes' group (the JAX trainer's sharded batch reduces
    globally).  Elsewhere nothing changes."""
    from ..parallel import mesh as _mesh

    g = torch.ones_like(gamma) if fix_gamma else gamma
    axis = axis % data.dim()
    red = tuple(i for i in range(data.dim()) if i != axis)
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    train = _train and not use_global_stats
    group = _mesh.stats_group(axis_name) if train else None
    if train and not _bn_stats_use_pallas():
        out, mean, var = _BnTrainFused.apply(data, g.float(), beta.float(),
                                             float(eps), red, group)
        with torch.no_grad():
            new_mm = moving_average(moving_mean, mean, momentum)
            new_mv = moving_average(moving_var, var, momentum)
        return out, new_mm, new_mv
    if train:
        n = math.prod(data.shape[i] for i in red)
        if axis == data.dim() - 1:
            from .kernels import batch_norm as _kbn

            s, q = _kbn.bn_stats(data.reshape(n, data.shape[-1]))
            if group is not None:
                (s, q), k = _mesh.sum_stats([s, q], axis_name)
                n *= k
            mean, sumsq_mean = s / n, q / n
        elif group is not None:
            (s, q), k = _mesh.sum_stats(
                [data.float().sum(dim=red),
                 torch.square(data).float().sum(dim=red)], axis_name)
            mean, sumsq_mean = s / (n * k), q / (n * k)
        else:
            mean = data.float().mean(dim=red)
            sumsq_mean = torch.square(data).float().mean(dim=red)
        var = torch.clamp_min(sumsq_mean - torch.square(mean), 0.0)
        with torch.no_grad():
            new_mm = moving_average(moving_mean, mean, momentum)
            new_mv = moving_average(moving_var, var, momentum)
    else:
        mean, var = moving_mean.float(), moving_var.float()
        new_mm, new_mv = moving_mean, moving_var
    scale = g.float() * torch.rsqrt(var + eps)
    shift = beta.float() - mean * scale
    return _scale_shift(data, scale, shift, shape), new_mm, new_mv


register("BatchNorm", _k_batch_norm, aliases=("batch_norm",),
         arg_names=_BN_ARGS, train_aware=True, num_outputs=3,
         mutate_aux=((3, 1), (4, 2)))


def _k_sync_batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                       momentum=0.9, fix_gamma=True, use_global_stats=False,
                       output_mean_var=False, ndev=1, key=None,
                       axis_name=None, _train=False):
    """Cross-replica BatchNorm (ref: ``_contrib_SyncBatchNorm``,
    contrib_ops.py:898): ``_k_batch_norm`` on channel axis 1.  Inside a
    ``DataParallelTrainer`` step on a mesh the statistics are the data
    axes' ranks' (as every BatchNorm's there); ``axis_name`` names one
    mesh axis to sum them over instead.  ``ndev`` and ``key`` are taken
    for the API and change nothing."""
    return _k_batch_norm(data, gamma, beta, moving_mean, moving_var,
                         eps=eps, momentum=momentum, fix_gamma=fix_gamma,
                         use_global_stats=use_global_stats, axis=1,
                         axis_name=axis_name, _train=_train)


register("_contrib_SyncBatchNorm", _k_sync_batch_norm,
         aliases=("SyncBatchNorm",), arg_names=_BN_ARGS, train_aware=True,
         num_outputs=3, mutate_aux=((3, 1), (4, 2)))


def _k_layer_norm(data, gamma, beta, axis=-1, eps=1e-5):
    """Layer normalization with the biased variance (ref: ops/nn.py:420).

    The reference's dtype rule: the data is normalized in its own dtype,
    then scaled and shifted, so gamma's and beta's dtype promote the
    result.  Under AMP (float16 or bfloat16 data, the float32 norm
    parameters ``amp.convert_model`` leaves) the output is float32, and
    the normalized values are rounded to the data's dtype first, as the
    reference rounds them (its mean and variance are reduced in float32,
    as ``jnp.mean``/``jnp.var`` reduce half-precision data)."""
    axis = axis % data.dim()
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    if gamma.dtype == data.dtype and beta.dtype == data.dtype:
        if axis == data.dim() - 1:
            return tF.layer_norm(data, data.shape[-1:], gamma, beta, eps)
        mean = data.mean(dim=axis, keepdim=True)
        var = data.var(dim=axis, keepdim=True, unbiased=False)
        return (data - mean) * torch.rsqrt(var + eps) \
            * gamma.reshape(shape) + beta.reshape(shape)
    xf = data.float()
    var, mean = torch.var_mean(xf, dim=axis, keepdim=True, correction=0)
    mean, var = mean.to(data.dtype), var.to(data.dtype)
    # eps rounded to the data's dtype first, as the reference's weak-typed
    # scalar is (a host value: a CUDA graph may capture this)
    eps = float(torch.tensor(eps, dtype=data.dtype))
    xhat = (data - mean) * torch.rsqrt(var + eps)
    return xhat * gamma.reshape(shape) + beta.reshape(shape)


register("LayerNorm", _k_layer_norm, aliases=("layer_norm",),
         arg_names=("data", "gamma", "beta"))


def _normalize(x, red, eps):
    """``(x - mean) / sqrt(var + eps)`` over ``red``, with the biased
    variance (``jnp.var``'s; torch's default divides by n-1)."""
    var, mean = torch.var_mean(x, dim=red, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps)


def _k_instance_norm(data, gamma, beta, eps=1e-3):
    """Each sample's channel normalized over its spatial axes, then a
    per-channel scale and shift (ref: ops/nn.py:433).  The op's default
    ``eps`` is 1e-3; ``nn.InstanceNorm`` passes its own, 1e-5."""
    shape = (1, -1) + (1,) * (data.dim() - 2)
    return _normalize(data, tuple(range(2, data.dim())), eps) \
        * gamma.reshape(shape) + beta.reshape(shape)


register("InstanceNorm", _k_instance_norm, aliases=("instance_norm",),
         arg_names=("data", "gamma", "beta"))


def _k_group_norm(data, gamma, beta, num_groups=1, eps=1e-5):
    """The channels in ``num_groups`` groups, each normalized over its
    channels and the spatial axes; ``gamma``/``beta`` are per group, shape
    ``(num_groups,)`` (ref: ops/nn.py:445, the reference's group_norm.cc),
    not per channel as ``torch.nn.GroupNorm``'s."""
    n, c = data.shape[:2]
    x = data.reshape((n, num_groups, c // num_groups) + data.shape[2:])
    x = _normalize(x, tuple(range(2, x.dim())), eps)
    gshape = (1, num_groups) + (1,) * (x.dim() - 2)
    x = x * gamma.reshape(gshape) + beta.reshape(gshape)
    return x.reshape(data.shape)


register("GroupNorm", _k_group_norm, arg_names=("data", "gamma", "beta"))


def _k_l2_normalization(data, eps=1e-10, mode="instance"):
    """``data / sqrt(sum(data^2) + eps)`` over every axis but the first
    (``instance``), the channel axis (``channel``) or the spatial axes
    (``spatial``) (ref: ops/nn.py:461)."""
    if mode == "instance":
        red = tuple(range(1, data.dim()))
    elif mode == "channel":
        red = (1,)
    elif mode == "spatial":
        red = tuple(range(2, data.dim()))
    else:
        raise MXNetError(f"L2Normalization: unknown mode {mode!r}")
    return data / torch.sqrt(torch.square(data).sum(dim=red, keepdim=True)
                             + eps)


register("L2Normalization", _k_l2_normalization)


def _k_lrn(data, nsize, alpha=1e-4, beta=0.75, knorm=2.0):
    """Local response normalization across the channels of NCHW data:
    ``data / (knorm + alpha/nsize * sum of the squares of nsize
    neighbouring channels)^beta`` (ref: ops/nn.py:476)."""
    half = nsize // 2
    padded = tF.pad(torch.square(data), (0, 0, 0, 0, half, half))
    c = data.shape[1]
    acc = padded[:, 0:c]
    for i in range(1, nsize):
        acc = acc + padded[:, i:i + c]
    return data / torch.pow(knorm + alpha * acc / nsize, beta)


register("LRN", _k_lrn)


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


_SELU_ALPHA, _SELU_SCALE = 1.6732632423543772, 1.0507009873554805


def _k_leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
                  lower_bound=0.125, upper_bound=0.334):
    """Ref: ops/nn.py:507.  ``leaky``: ``slope*x`` below 0; ``elu``:
    ``slope*(e^x - 1)``; ``selu``: scaled ELU with SELU's constants;
    ``prelu``: ``gamma*x``, ``gamma`` per channel (axis 1) when it is 1-D
    and the data has more than 2 dims; ``gelu``: the tanh approximation,
    unlike ``Activation(gelu)`` (ops/nn.py:500 vs :520); ``rrelu``: the
    mid slope ``(lower_bound + upper_bound)/2``, with no random draw, in
    training too, as the reference's port does."""
    if act_type == "leaky":
        return torch.where(data > 0, data, slope * data)
    if act_type == "elu":
        return torch.where(data > 0, data, slope * torch.expm1(data))
    if act_type == "selu":
        return _SELU_SCALE * torch.where(data > 0, data,
                                         _SELU_ALPHA * torch.expm1(data))
    if act_type == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (data.dim() - 2)) \
            if gamma.dim() == 1 and data.dim() > 2 else gamma
        return torch.where(data > 0, data, g * data)
    if act_type == "gelu":
        return tF.gelu(data, approximate="tanh")
    if act_type == "rrelu":
        mid = (lower_bound + upper_bound) / 2
        return torch.where(data > 0, data, mid * data)
    raise MXNetError(f"LeakyReLU: unknown act_type {act_type!r}")


register("LeakyReLU", _k_leaky_relu, arg_names=("data", "gamma"),
         train_aware=True)


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


register("Dropout", _k_dropout, aliases=("dropout",), needs_rng=True,
         train_aware=True)


def _resize_bilinear(data, th, tw):
    """NCHW ``data`` resized to ``(th, tw)`` as ``jax.image.resize(...,
    "bilinear")`` does: half-pixel centres, the triangle kernel widened by
    the factor where a side shrinks (antialiasing), the weights that fall
    outside the image dropped and the rest renormalised, which
    ``interpolate``'s antialiased bilinear mode also does."""
    return tF.interpolate(data, size=(int(th), int(tw)), mode="bilinear",
                          align_corners=False, antialias=True)


def _k_upsampling(data, scale, sample_type="nearest", num_args=1,
                  workspace=512):
    """NCHW ``data`` grown by the integer ``scale`` on both spatial axes:
    each pixel repeated (``nearest``) or ``bilinear`` (ref: ops/nn.py:722)."""
    n, c, h, w = data.shape
    if sample_type == "nearest":
        return data.repeat_interleave(scale, dim=2).repeat_interleave(
            scale, dim=3)
    if sample_type != "bilinear":
        raise MXNetError(f"UpSampling: unknown sample_type {sample_type!r}")
    return _resize_bilinear(data, h * scale, w * scale)


register("UpSampling", _k_upsampling, variadic=True)


def _k_bilinear_resize(data, height=0, width=0, scale_height=None,
                       scale_width=None, mode="size"):
    """NCHW ``data`` resized to ``height`` x ``width``, or by the scales
    where a size is 0 (ref: ops/nn.py:732; ``mode`` is taken and, as
    there, changes nothing)."""
    n, c, h, w = data.shape
    th = height or int(h * scale_height)
    tw = width or int(w * scale_width)
    return _resize_bilinear(data, th, tw)


register("_contrib_BilinearResize2D", _k_bilinear_resize,
         aliases=("bilinear_resize_2d",))


def _half_sum(x, dim):
    """``jnp.sum`` of float16 data: reduced in float32, the result rounded
    to float16."""
    return x.sum(dim, keepdim=True, dtype=torch.float32).to(x.dtype)


class _HalfSoftmax(torch.autograd.Function):
    """``jax.nn.softmax`` on float16 data: each step rounded to float16 as
    the reference rounds it (``exp(x - max)``, then over its sum), where
    torch's kernel rounds once (two ulps apart: ROADMAP queue 3, item 17);
    the backward is the reference's ``y * (g - sum(g * y))``.  bfloat16
    keeps torch's kernel, on which the bfloat16 paths' gates were set."""

    @staticmethod
    def forward(ctx, x, dim):
        u = torch.exp(x - x.amax(dim, keepdim=True))
        y = u / _half_sum(u, dim)
        ctx.save_for_backward(y)
        ctx.dim = dim
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return y * (g - _half_sum(g * y, ctx.dim)), None


def _softmax(x, dim):
    """Softmax over ``dim``; float16 data in the reference's roundings
    (:class:`_HalfSoftmax`)."""
    if x.dtype == torch.float16:
        return _HalfSoftmax.apply(x, dim % x.dim())
    return torch.softmax(x, dim=dim)


def _k_softmax(data, axis=-1, temperature=None):
    """Ref: ops/nn.py:541."""
    x = data / temperature if temperature else data
    return _softmax(x, axis)


register("softmax", _k_softmax, aliases=("SoftmaxActivation",))


def _k_log_softmax(data, axis=-1, temperature=None):
    """Ref: ops/nn.py:548; float16 data as ``jax.nn.log_softmax``
    computes it, each step rounded to float16: ``x - max - log(sum(exp(x
    - max)))``, the max without a gradient."""
    x = data / temperature if temperature else data
    if x.dtype == torch.float16:
        shifted = x - x.amax(axis, keepdim=True).detach()
        return shifted - torch.log(_half_sum(torch.exp(shifted), axis))
    return torch.log_softmax(x, dim=axis)


register("log_softmax", _k_log_softmax)


def _k_softmin(data, axis=-1):
    """``softmax(-data)`` (ref: ops/nn.py:548)."""
    return _softmax(-data, axis)


register("softmin", _k_softmin)


# -- the loss heads (ref: ops/nn.py:553-780) -----------------------------------
# Each forward is the head's output (the softmax, the sigmoid or the data
# itself); each backward is MXNet's loss gradient, a torch.autograd.Function
# as the JAX ops are custom VJPs.  All but SVMOutput ignore the incoming
# gradient: the executor feeds ones.


def _class_one_hot(lab_ids, classes, axis, like):
    """One-hot of integer ``lab_ids`` along ``axis`` of ``like``; an id
    outside ``[0, classes)`` (an ignored label) gives a row of zeros, as
    ``jax.nn.one_hot`` does."""
    shape = [1] * like.dim()
    shape[axis] = classes
    ids = torch.arange(classes, device=like.device).reshape(shape)
    return (lab_ids.unsqueeze(axis) == ids).to(like.dtype)


class _SoftmaxOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, opts):
        p = _softmax(data, opts[5])
        ctx.save_for_backward(p, label)
        ctx.opts = opts
        return p

    @staticmethod
    def backward(ctx, g):
        """``p - onehot(label)`` under ``grad_scale``, ``ignore_label``,
        ``normalization`` and label smoothing (ref: ``_smo_bwd``,
        ops/nn.py:564)."""
        grad_scale, ignore_label, use_ignore, normalization, smooth_alpha, \
            axis = ctx.opts
        p, label = ctx.saved_tensors
        classes = p.shape[axis]
        lab_ids = None
        if label.dim() == p.dim() - 1:
            lab_ids = label.to(torch.int64)
            oh = _class_one_hot(lab_ids, classes, axis, p)
        else:
            oh = label.to(p.dtype)
        if smooth_alpha > 0:
            oh = oh * (1.0 - smooth_alpha) + (1.0 - oh) * (
                smooth_alpha / max(classes - 1, 1))
        grad = p - oh
        valid = None
        if use_ignore and lab_ids is not None:
            valid = (lab_ids != int(ignore_label)).to(p.dtype)
            grad = grad * valid.unsqueeze(axis)
        if normalization == "batch":
            grad = grad / p.shape[0]
        elif normalization == "valid":
            n = valid.sum() if valid is not None else torch.tensor(
                float(lab_ids.numel() if lab_ids is not None
                      else p.shape[0]), device=p.device)
            grad = grad / torch.clamp(n, min=1.0)
        return (grad * grad_scale,
                torch.zeros_like(label) if ctx.needs_input_grad[1] else None,
                None)


def _k_softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                      multi_output=False, use_ignore=False,
                      preserve_shape=False, normalization="null",
                      out_grad=False, smooth_alpha=0.0):
    """The softmax over the class axis (1, or the last with
    ``preserve_shape``), with the cross-entropy gradient (ref: ops/nn.py:
    601); ``normalization='null'`` leaves the 1/batch to the optimizer's
    ``rescale_grad`` (``Module`` sets it)."""
    if normalization not in ("null", "batch", "valid"):
        raise ValueError(f"SoftmaxOutput normalization must be one of "
                         f"null/batch/valid, got {normalization!r}")
    axis = -1 if preserve_shape else (1 if data.dim() > 1 else -1)
    axis = axis % data.dim()
    opts = (float(grad_scale), float(ignore_label), bool(use_ignore),
            str(normalization), float(smooth_alpha), axis)
    return _SoftmaxOutput.apply(data, label, opts)


register("SoftmaxOutput", _k_softmax_output, arg_names=("data", "label"),
         aliases=("softmax_output", "Softmax"))


class _RegressionOutput(torch.autograd.Function):
    """``kind``: ``linear`` (identity, ``data - label``), ``logistic``
    (sigmoid, ``p - label``) or ``mae`` (identity, ``sign(data -
    label)``), each gradient times ``grad_scale`` (ref: ops/nn.py:
    622-693; regression_output-inl.h)."""

    @staticmethod
    def forward(ctx, data, label, kind, grad_scale):
        out = torch.sigmoid(data) if kind == "logistic" else data.clone()
        ctx.save_for_backward(out, label)
        ctx.kind, ctx.grad_scale = kind, grad_scale
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        diff = out - label.reshape(out.shape)
        grad = torch.sign(diff) if ctx.kind == "mae" else diff
        return (grad * ctx.grad_scale,
                torch.zeros_like(label) if ctx.needs_input_grad[1] else None,
                None, None)


def _regression_op(kind):
    def _k(data, label, grad_scale=1.0):
        return _RegressionOutput.apply(data, label, kind, float(grad_scale))

    _k.__name__ = f"_k_{kind}_regression_output"
    return _k


register("LinearRegressionOutput", _regression_op("linear"),
         arg_names=("data", "label"))
register("LogisticRegressionOutput", _regression_op("logistic"),
         arg_names=("data", "label"))
register("MAERegressionOutput", _regression_op("mae"),
         arg_names=("data", "label"))


class _SVMOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, margin, reg, linear):
        ctx.save_for_backward(data, label)
        ctx.opts = (margin, reg, linear)
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        """The hinge (``use_linear``) or squared-hinge gradient of the
        scores, times the incoming gradient (ref: ``_svm_bwd``, ops/nn.py:
        760)."""
        margin, reg, linear = ctx.opts
        data, label = ctx.saved_tensors
        k = data.shape[1]
        lab = label.to(torch.int64).reshape(-1)
        onehot = _class_one_hot(lab, k, 1, data)
        score_y = torch.gather(data, 1, lab.unsqueeze(1))
        gap = margin - (score_y - data)
        viol = (gap > 0) & (onehot == 0)
        zero = torch.zeros((), dtype=data.dtype, device=data.device)
        if linear:
            gj = torch.where(viol, torch.full_like(data, reg), zero)
        else:
            gj = torch.where(viol, 2.0 * reg * gap, zero)
        gy = -gj.sum(dim=1, keepdim=True)
        grad = gj + onehot * gy
        return (grad * g,
                torch.zeros_like(label) if ctx.needs_input_grad[1] else None,
                None, None, None)


def _k_svm_output(data, label, margin=1.0, regularization_coefficient=1.0,
                  use_linear=False):
    """Identity forward, hinge gradient of the scores (ref: ops/nn.py:745,
    src/operator/svm_output.cc)."""
    return _SVMOutput.apply(data, label, float(margin),
                            float(regularization_coefficient),
                            bool(use_linear))


register("SVMOutput", _k_svm_output, arg_names=("data", "label"),
         aliases=("svm_output",))
