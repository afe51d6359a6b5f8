"""Fused 1x1-convolution + BatchNorm ops (ref: ``mxnet_tpu/ops/
conv_fused_ops.py``), chained by ResNet's ``BottleneckV1`` under
``MXTPU_CONV_EPILOGUE=pallas`` (NHWC only):

- ``_contrib_conv1x1_bn_act``: a 1x1 convolution, optionally reading the
  previous BatchNorm's normalize (+ReLU) into its input, whose epilogue
  computes this layer's BatchNorm statistics.  It returns the raw
  convolution output with the folded ``(scale, shift)`` for its consumer
  and the new moving statistics;
- ``_contrib_bn_fold``: BatchNorm statistics and the fold, without
  writing a normalized copy of the activation.

``F.contrib.conv1x1_bn_act`` and ``F.contrib.bn_fold`` name them.  As the
port's ``BatchNorm`` op does, they return the new moving statistics as
outputs and the caller commits them (the JAX package's nd wrapper commits
them itself and returns the other outputs).  The matrix products and the
statistics go to the kernels of ``ops/kernels/conv_fused.py`` and
``ops/kernels/batch_norm.py``.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .kernels import batch_norm as _kbn
from .kernels import conv_fused as _kcf
from .registry import register


def _fold_stats(s, q, n, gamma, beta, moving_mean, moving_var, *, eps,
                momentum, fix_gamma, train):
    """``(scale, shift, new_mm, new_mv)`` from the epilogue's sums (train)
    or the moving statistics (eval), with ``_k_batch_norm``'s arithmetic
    (ref: ``_fold_stats``, conv_fused_ops.py:39)."""
    g = torch.ones_like(gamma) if fix_gamma else gamma
    if train:
        mean = (s / n).reshape(-1)
        var = torch.clamp_min((q / n).reshape(-1) - torch.square(mean), 0.0)
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
    return scale, shift, new_mm, new_mv


def _k_conv1x1_bn_act(data, weight, gamma, beta, moving_mean, moving_var,
                      in_scale=None, in_shift=None, stride=1, eps=1e-5,
                      momentum=0.9, fix_gamma=False, in_act=True,
                      _train=False):
    """data NHWC ``(N, H, W, Cin)``; weight OHWI ``(Cout, 1, 1, Cin)``.

    Returns ``(y_raw NHWC, scale (Cout,), shift (Cout,), new_moving_mean,
    new_moving_var)``: y_raw is the un-normalized convolution output, to
    which the caller (or the next fused op) applies ``y*scale + shift``.
    With ``in_scale``/``in_shift`` the previous BatchNorm's normalize
    (+ReLU when ``in_act``) is applied as the product reads its input.  A
    stride takes every s-th row and column first, as a contiguous copy."""
    s = int(stride)
    n_img, _, _, cin = data.shape
    cout = weight.shape[0]
    if weight.shape[1] != 1 or weight.shape[2] != 1:
        raise MXNetError(f"conv1x1_bn_act needs a 1x1 OHWI weight, got "
                         f"{tuple(weight.shape)}")
    if s > 1:
        data = data[:, ::s, ::s, :].contiguous()
    h, w = data.shape[1], data.shape[2]
    x2d = data.reshape(n_img * h * w, cin)
    w2d = weight.reshape(cout, cin).t()
    n = x2d.shape[0]
    if _train:
        if in_scale is not None:
            y2d, ss, qq = _kcf.bn_act_matmul_stats(
                x2d, in_scale.reshape(1, -1), in_shift.reshape(1, -1), w2d,
                bool(in_act))
        else:
            y2d, ss, qq = _kcf.matmul_bn_stats(x2d, w2d)
    else:
        ss = qq = None
        if in_scale is not None:
            y2d = _kcf.bn_act_matmul(x2d, in_scale.reshape(1, -1),
                                     in_shift.reshape(1, -1), w2d,
                                     bool(in_act))
        else:
            y2d = torch.matmul(x2d, w2d)
    scale, shift, new_mm, new_mv = _fold_stats(
        ss, qq, n, gamma, beta, moving_mean, moving_var, eps=eps,
        momentum=momentum, fix_gamma=fix_gamma, train=bool(_train))
    return y2d.reshape(n_img, h, w, cout), scale, shift, new_mm, new_mv


register("_contrib_conv1x1_bn_act", _k_conv1x1_bn_act,
         aliases=("conv1x1_bn_act",))


def _k_bn_fold(data, gamma, beta, moving_mean, moving_var, eps=1e-5,
               momentum=0.9, fix_gamma=False, _train=False):
    """``(scale, shift, new_moving_mean, new_moving_var)`` of a
    channel-last activation without writing a normalized copy of it; the
    consumer applies ``data*scale + shift``, typically inside
    ``conv1x1_bn_act``'s input read.  Training takes the batch's statistics
    in one pass through ``bn_stats``: its kernel where the JAX package's
    gate (``stats_supported``) takes the shape, else the plain sums."""
    C = data.shape[-1]
    n = data.numel() // C
    ss = qq = None
    if _train:
        ss, qq = _kbn.bn_stats(data.reshape(n, C))
    return _fold_stats(ss, qq, n, gamma, beta, moving_mean, moving_var,
                       eps=eps, momentum=momentum, fix_gamma=fix_gamma,
                       train=bool(_train))


register("_contrib_bn_fold", _k_bn_fold, aliases=("bn_fold",))
