"""The INT8 quantization ops (ref: mxnet_tpu/ops/quantization.py).

A quantized tensor travels as ``(q, min_range, max_range)``:

  int8  (signed, symmetric):  real = q * max(|min|,|max|) / 127
  uint8 (affine):             real = min + q * (max-min) / 255
  int32 (accumulator):        real = q * max(|min|,|max|) / (2^31 - 1)

and the int32 range of an s8 x s8 product is
``INT32_MAX/(127*127) * r_data * r_weight``.  All ops are inference-only.

The s8 x s8 -> s32 products are ``torch._int_mm`` (the JAX package
computes them with ``lax.dot_general``/``lax.conv_general_dilated`` and
``preferred_element_type=int32``, outside any Pallas kernel).  A
convolution is an unfold (im2col) and then the same product: a
convolution computed in float32 stops being exact once 127*127*K passes
2^24.  On the card cuBLAS refuses ``_int_mm`` for 16 rows or fewer and
for inner or outer sizes that are not multiples of 8, so
:func:`int8_matmul` pads with zeros to a legal shape by a rule fixed from
the shapes alone (:func:`int_mm_shape`) and slices the padding off; it
never falls back to another product.  On the CPU the product is a float64
one, exact on any host while ``127 * 127 * K`` stays below 2^53 (the
CPU's ``torch._int_mm`` goes through oneDNN, which documents that its
int8 products may saturate on a host without VNNI).
"""
from __future__ import annotations

import math
import threading

import torch
import torch.nn.functional as tF

from ..base import MXNetError
from .registry import register

_INT32_MAX = float(2**31 - 1)

# the registry metadata of the int8 ops: inference only, three outputs
# (the values and their range)
_Q3 = dict(nondiff=True, num_outputs=3)
_Q_ARGS = ("data", "weight", "bias", "min_data", "max_data", "min_weight",
           "max_weight", "min_bias", "max_bias")
_PC_ARGS = ("data", "weight", "wrange", "bias", "min_data", "max_data")


# -- the s8 x s8 -> s32 product -----------------------------------------------

#: counters of :func:`int8_matmul` on CUDA tensors: products, and those that
#: needed padding to reach a shape cuBLAS takes
int_mm_counts = {"calls": 0, "padded": 0}
_counts_lock = threading.Lock()

#: rows a padded product is given when it has too few (cuBLAS takes > 16)
INT_MM_MIN_ROWS = 32


def _ceil8(n):
    return -(-n // 8) * 8


def int_mm_shape(m, k, n):
    """The ``(m, k, n)`` a product of ``(m, k) x (k, n)`` is padded to on
    the card: ``m`` to :data:`INT_MM_MIN_ROWS` when 16 or fewer, ``k``
    and ``n`` up to multiples of 8."""
    return (m if m > 16 else INT_MM_MIN_ROWS), _ceil8(k), _ceil8(n)


def int8_matmul(x, w):
    """``x @ w.T`` of int8 ``x`` (M, K) and int8 ``w`` (N, K), exact, as
    int32 (M, N)."""
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise MXNetError(f"int8_matmul takes int8 operands, not {x.dtype} "
                         f"and {w.dtype}")
    m, k = x.shape
    n = w.shape[0]
    if not x.is_cuda:
        return (x.to(torch.float64) @ w.to(torch.float64).t()) \
            .to(torch.int32)
    mp, kp, np_ = int_mm_shape(m, k, n)
    padded = (mp, kp, np_) != (m, k, n)
    with _counts_lock:
        int_mm_counts["calls"] += 1
        int_mm_counts["padded"] += int(padded)
    if padded:
        x = tF.pad(x, (0, kp - k, 0, mp - m))
        w = tF.pad(w, (0, kp - k, 0, np_ - n))
    out = torch._int_mm(x.contiguous(), w.contiguous().t())
    return out[:m, :n] if padded else out


def reset_int_mm_counts():
    with _counts_lock:
        for key in int_mm_counts:
            int_mm_counts[key] = 0


# -- range helpers ------------------------------------------------------------


def _f32(v, like):
    """``v`` (a tensor or a number) as a float32 tensor on ``like``'s
    device."""
    if isinstance(v, torch.Tensor):
        return v.to(device=like.device, dtype=torch.float32)
    return torch.tensor(float(v), dtype=torch.float32, device=like.device)


def _abs_range(mn, mx):
    return torch.maximum(mn.abs(), mx.abs())


def _q8(x, real_range):
    scale = 127.0 / torch.clamp(real_range, min=1e-30)
    return torch.clamp(torch.round(x * scale), -127, 127).to(torch.int8)


# -- quantize / quantize_v2 (ref: quantize-inl.h, quantize_v2-inl.h) ----------


def _k_quantize(data, min_range, max_range, out_type="int8"):
    mn = _f32(min_range, data).reshape(())
    mx = _f32(max_range, data).reshape(())
    if out_type == "uint8":
        scale = 255.0 / torch.clamp(mx - mn, min=1e-30)
        q = torch.clamp(torch.round((data - mn) * scale), 0, 255) \
            .to(torch.uint8)
        return q, mn, mx
    r = _abs_range(mn, mx)
    return _q8(data, r), -r, r


register("_contrib_quantize", _k_quantize, aliases=("quantize",),
         arg_names=("data", "min_range", "max_range"), **_Q3)


def _k_quantize_v2(data, out_type="int8", min_calib_range=None,
                   max_calib_range=None):
    if min_calib_range is None or max_calib_range is None:
        mn = data.min().to(torch.float32)
        mx = data.max().to(torch.float32)
    else:
        mn = _f32(min_calib_range, data)
        mx = _f32(max_calib_range, data)
    return _k_quantize(data, mn, mx, out_type=out_type)


register("_contrib_quantize_v2", _k_quantize_v2, aliases=("quantize_v2",),
         **_Q3)


# -- dequantize (ref: dequantize-inl.h) ---------------------------------------


def _k_dequantize(data, min_range, max_range, out_type="float32"):
    """The ranges broadcast against ``data``, so per-channel range vectors
    ride the same triple protocol as scalars."""
    mn = _f32(min_range, data)
    mx = _f32(max_range, data)
    if data.dtype == torch.uint8:
        return mn + data.to(torch.float32) * (mx - mn) / 255.0
    if data.dtype == torch.int32:
        return data.to(torch.float32) * _abs_range(mn, mx) / _INT32_MAX
    return data.to(torch.float32) * _abs_range(mn, mx) / 127.0


register("_contrib_dequantize", _k_dequantize, aliases=("dequantize",),
         arg_names=("data", "min_range", "max_range"), nondiff=True)


# -- requantize: int32 accumulator -> calibrated int8 (requantize-inl.h) -----


def _k_requantize(data, min_range, max_range, min_calib_range=None,
                  max_calib_range=None):
    real = _k_dequantize(data, min_range, max_range)
    if min_calib_range is not None and max_calib_range is not None:
        r = _abs_range(_f32(min_calib_range, data),
                       _f32(max_calib_range, data))
    else:
        r = real.abs().max()
    return _q8(real, r), -r, r


register("_contrib_requantize", _k_requantize, aliases=("requantize",),
         arg_names=("data", "min_range", "max_range"), **_Q3)


def _k_requantize_v2(data, min_range, max_range, min_calib, max_calib,
                     act=None):
    """The fold op: :func:`_k_requantize` with the calibrated range as
    tensors (parameters of a captured graph), and relu applied in int8
    (symmetric scaling commutes with it)."""
    real = _k_dequantize(data, min_range, max_range)
    r = _abs_range(_f32(min_calib, data).reshape(()),
                   _f32(max_calib, data).reshape(()))
    q = _q8(real, r)
    if act == "relu":
        q = torch.clamp(q, min=0)
    return q, -r, r


register("_contrib_requantize_v2", _k_requantize_v2,
         aliases=("requantize_v2",),
         arg_names=("data", "min_range", "max_range", "min_calib",
                    "max_calib"), **_Q3)


# -- quantized FullyConnected / Convolution (per tensor) ----------------------


def _s8s8_out_range(min_d, max_d, min_w, max_w):
    r = (_abs_range(min_d, max_d) * _abs_range(min_w, max_w)
         * (_INT32_MAX / (127.0 * 127.0)))
    return -r, r


def _bias_to_i32(bias, min_b, max_b, min_d, max_d, min_w, max_w):
    real_b = _k_dequantize(bias, min_b, max_b)
    s_d = 127.0 / torch.clamp(_abs_range(min_d, max_d), min=1e-30)
    s_w = 127.0 / torch.clamp(_abs_range(min_w, max_w), min=1e-30)
    return torch.round(real_b * s_d * s_w).to(torch.int32)


def _parse_q_inputs(no_bias, rest):
    """The int8 FC/conv inputs after (data, weight): with a bias (bias,
    min_data, max_data, min_weight, max_weight[, min_bias, max_bias]);
    without one the bias slot may be absent or an explicit None (ref:
    ``_parse_q_inputs``)."""
    if no_bias:
        if len(rest) in (5, 7):
            rest = rest[1:]
        min_data, max_data, min_weight, max_weight = rest[:4]
        return None, min_data, max_data, min_weight, max_weight, None, None
    bias, min_data, max_data, min_weight, max_weight = rest[:5]
    min_bias, max_bias = rest[5:7] if len(rest) >= 7 else (None, None)
    return (bias, min_data, max_data, min_weight, max_weight, min_bias,
            max_bias)


def _linear_i32(x, weight):
    """int8 ``x`` (..., K) times int8 ``weight`` (N, K) -> int32 (..., N)."""
    lead = x.shape[:-1]
    out = int8_matmul(x.reshape(-1, x.shape[-1]), weight)
    return out.reshape(lead + (weight.shape[0],))


def _k_quantized_fully_connected(data, weight, *rest, num_hidden=None,
                                 no_bias=False, flatten=True):
    (bias, min_data, max_data, min_weight, max_weight, min_bias,
     max_bias) = _parse_q_inputs(no_bias, rest)
    min_data, max_data = _f32(min_data, data), _f32(max_data, data)
    min_weight, max_weight = _f32(min_weight, data), _f32(max_weight, data)
    x = data.reshape(data.shape[0], -1) if flatten and data.dim() > 2 \
        else data
    out = _linear_i32(x, weight)
    if not no_bias and bias is not None:
        out = out + _bias_to_i32(bias, _f32(min_bias, data),
                                 _f32(max_bias, data), min_data, max_data,
                                 min_weight, max_weight)
    mn, mx = _s8s8_out_range(min_data, max_data, min_weight, max_weight)
    return out, mn, mx


register("_contrib_quantized_fully_connected", _k_quantized_fully_connected,
         aliases=("quantized_fully_connected",), arg_names=_Q_ARGS, **_Q3)


def _out_size(size, k, s, d, p):
    return (size + 2 * p - d * (k - 1) - 1) // s + 1


def _im2col_3d(data, kernel, stride, dilate, pad):
    """The columns of a 3-D convolution: ``(n, c * kd*kh*kw, L)`` int8, in
    the order of an ``(O, C, kd, kh, kw)`` weight reshaped to ``(O, -1)``,
    and the output's ``(od, oh, ow)``: one strided slice of the padded
    input per kernel offset (torch's unfold is 2-D only)."""
    n, c = data.shape[:2]
    xp = tF.pad(data, [v for p in reversed(pad) for v in (p, p)])
    outs = [_out_size(data.shape[2 + i], kernel[i], stride[i], dilate[i],
                      pad[i]) for i in range(3)]
    taps = []
    for a in range(kernel[0]):
        for b in range(kernel[1]):
            for e in range(kernel[2]):
                starts = (a * dilate[0], b * dilate[1], e * dilate[2])
                taps.append(xp[:, :,
                               starts[0]:starts[0] + stride[0]
                               * (outs[0] - 1) + 1:stride[0],
                               starts[1]:starts[1] + stride[1]
                               * (outs[1] - 1) + 1:stride[1],
                               starts[2]:starts[2] + stride[2]
                               * (outs[2] - 1) + 1:stride[2]])
    cols = torch.stack(taps, dim=2)              # (n, c, K, od, oh, ow)
    return cols.reshape(n, c * len(taps), -1), tuple(outs)


def _conv_i32(data, weight, kernel, stride, dilate, pad, num_group):
    """The int8 convolution (NC* data, OI* weight) as im2col and
    :func:`int8_matmul`, group by group; 1-D convolutions run as 2-D ones
    of height 1, 2-D ones unfold, 3-D ones take :func:`_im2col_3d`."""
    nd = len(kernel)
    if nd not in (1, 2, 3):
        raise MXNetError(f"quantized convolution: {nd}-D kernels are not "
                         "ported (1-D, 2-D and 3-D are)")
    stride = tuple(stride) or (1,) * nd
    dilate = tuple(dilate) or (1,) * nd
    pad = tuple(pad) or (0,) * nd
    n, c = data.shape[:2]
    o = weight.shape[0]
    if nd == 3:
        cols, spatial = _im2col_3d(data, tuple(kernel), stride, dilate, pad)
    else:
        if nd == 1:
            data, weight = data.unsqueeze(2), weight.unsqueeze(2)
            kernel, stride = (1,) + tuple(kernel), (1,) + stride
            dilate, pad = (1,) + dilate, (0,) + pad
        h, w = data.shape[2:]
        spatial = (_out_size(h, kernel[0], stride[0], dilate[0], pad[0]),
                   _out_size(w, kernel[1], stride[1], dilate[1], pad[1]))
        # im2col moves the values only: int8 in float32 is exact
        cols = tF.unfold(data.to(torch.float32), tuple(kernel), dilate, pad,
                         stride).to(torch.int8)       # (n, c*kh*kw, L)
    cg, og = c // num_group, o // num_group
    per = cols.shape[1] // num_group
    L = cols.shape[2]
    outs = []
    for g in range(num_group):
        xg = cols[:, g * per:(g + 1) * per].transpose(1, 2) \
            .reshape(-1, per)                         # (n*L, per)
        wg = weight[g * og:(g + 1) * og].reshape(og, per)
        outs.append(int8_matmul(xg, wg).reshape(n, L, og))
    out = torch.cat(outs, dim=2) if num_group > 1 else outs[0]
    out = out.transpose(1, 2).reshape((n, o) + spatial)
    return out.squeeze(2) if nd == 1 else out


def _k_quantized_conv(data, weight, *rest, kernel, stride=(), dilate=(),
                      pad=(), num_filter=0, num_group=1, no_bias=False,
                      layout=None):
    (bias, min_data, max_data, min_weight, max_weight, min_bias,
     max_bias) = _parse_q_inputs(no_bias, rest)
    min_data, max_data = _f32(min_data, data), _f32(max_data, data)
    min_weight, max_weight = _f32(min_weight, data), _f32(max_weight, data)
    out = _conv_i32(data, weight, kernel, stride, dilate, pad, num_group)
    if not no_bias and bias is not None:
        b = _bias_to_i32(bias, _f32(min_bias, data), _f32(max_bias, data),
                         min_data, max_data, min_weight, max_weight)
        out = out + b.reshape((1, -1) + (1,) * len(kernel))
    mn, mx = _s8s8_out_range(min_data, max_data, min_weight, max_weight)
    return out, mn, mx


register("_contrib_quantized_conv", _k_quantized_conv,
         aliases=("quantized_conv",), arg_names=_Q_ARGS, **_Q3)


# -- per-channel FC / conv: the quantize_net path -----------------------------
# Weight ranges arrive as a per-output-channel vector (or a length-1 one for
# per-tensor scaling); the float32 bias is quantized to the per-channel
# accumulator scale inside the op.


def _ranges_i32_pc(min_data, max_data, wrange, bcast_shape, like):
    r_d = _abs_range(_f32(min_data, like).reshape(()),
                     _f32(max_data, like).reshape(()))
    r_w = torch.clamp(_f32(wrange, like).reshape(-1), min=1e-30)
    r_o = (r_d * r_w * (_INT32_MAX / (127.0 * 127.0))).reshape(bcast_shape)
    return r_d, r_w, r_o


def _bias_to_i32_pc(bias, r_d, r_w):
    s = (127.0 / torch.clamp(r_d, min=1e-30)) * (127.0 / r_w)
    return torch.round(bias.to(torch.float32) * s).to(torch.int32)


def _k_quantized_dense_pc(data, weight, wrange, *rest, num_hidden=None,
                          no_bias=False, flatten=True):
    if no_bias:
        bias = None
        min_data, max_data = rest[:2]
    else:
        bias, min_data, max_data = rest[:3]
    x = data.reshape(data.shape[0], -1) if flatten and data.dim() > 2 \
        else data
    out = _linear_i32(x, weight)
    r_d, r_w, r_o = _ranges_i32_pc(min_data, max_data, wrange, (-1,), data)
    if not no_bias and bias is not None:
        out = out + _bias_to_i32_pc(bias, r_d, r_w)
    return out, -r_o, r_o


register("_contrib_quantized_dense_pc", _k_quantized_dense_pc,
         aliases=("quantized_dense_pc",), arg_names=_PC_ARGS, **_Q3)


def _k_quantized_conv_pc(data, weight, wrange, *rest, kernel, stride=(),
                         dilate=(), pad=(), num_filter=0, num_group=1,
                         no_bias=False):
    if no_bias:
        bias = None
        min_data, max_data = rest[:2]
    else:
        bias, min_data, max_data = rest[:3]
    nd = len(kernel)
    out = _conv_i32(data, weight, kernel, stride, dilate, pad, num_group)
    r_d, r_w, r_o = _ranges_i32_pc(min_data, max_data, wrange,
                                   (-1,) + (1,) * nd, data)
    if not no_bias and bias is not None:
        b = _bias_to_i32_pc(bias, r_d, r_w)
        out = out + b.reshape((1, -1) + (1,) * nd)
    return out, -r_o, r_o


register("_contrib_quantized_conv_pc", _k_quantized_conv_pc,
         aliases=("quantized_conv_pc",), arg_names=_PC_ARGS, **_Q3)


# -- quantized pooling / flatten ----------------------------------------------


def _k_quantized_pooling(data, min_data, max_data, kernel=(),
                         pool_type="max", stride=(), pad=(),
                         global_pool=False):
    """Max pooling keeps the int8 values; average pooling sums in int32
    (exact in float32 below 2^24), divides by the window and rounds half
    to even back to the input's dtype.  Padding counts as the dtype's
    least value for max and as 0 for the average."""
    nd = data.dim() - 2
    if nd not in (1, 2, 3):
        raise MXNetError(f"quantized pooling of a {data.dim()}-D input")
    if global_pool:
        kernel = tuple(data.shape[2:])
        stride = (1,) * nd
        pad = (0,) * nd
    kernel = tuple(kernel)
    stride = tuple(stride) or (1,) * nd
    pad = tuple(pad) or (0,) * nd
    x = data.to(torch.float32)
    flat = [v for p in reversed(pad) for v in (p, p)]
    if pool_type == "max":
        low = float(torch.iinfo(data.dtype).min) \
            if data.dtype == torch.int8 else 0.0
        x = tF.pad(x, flat, value=low)
        pool = (tF.max_pool1d, tF.max_pool2d, tF.max_pool3d)[nd - 1]
        out = pool(x, kernel, stride).to(data.dtype)
    else:
        x = tF.pad(x, flat, value=0.0)
        if nd == 1:   # avg_pool1d has no divisor_override: run it as 2-D
            s = tF.avg_pool2d(x.unsqueeze(2), (1,) + kernel, (1,) + stride,
                              divisor_override=1).squeeze(2)
        else:
            pool = (None, tF.avg_pool2d, tF.avg_pool3d)[nd - 1]
            s = pool(x, kernel, stride, divisor_override=1)
        out = torch.round(s / math.prod(kernel)).to(data.dtype)
    return (out, _f32(min_data, data).reshape(()),
            _f32(max_data, data).reshape(()))


register("_contrib_quantized_pooling", _k_quantized_pooling,
         aliases=("quantized_pooling",),
         arg_names=("data", "min_data", "max_data"), **_Q3)


def _k_quantized_flatten(data, min_data, max_data):
    return (data.reshape(data.shape[0], -1),
            _f32(min_data, data).reshape(()),
            _f32(max_data, data).reshape(()))


register("_contrib_quantized_flatten", _k_quantized_flatten,
         aliases=("quantized_flatten",),
         arg_names=("data", "min_data", "max_data"), **_Q3)
