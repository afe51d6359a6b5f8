"""Tensor ops: the subset of ``mxnet_tpu/ops/tensor.py`` that BERT
serving and training and the ported losses run (reshape, slice_axis,
take, pick, Embedding, arange, broadcast_lesser, broadcast_mul, the sum
and mean reductions, and the elementwise square, abs, relu and log)."""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..context import Context, current_context
from ..ndarray.ndarray import to_torch_dtype
from .registry import register


def _k_reshape(data, shape):
    """MXNet reshape; of the magic codes, 0 (copy the input dim) and -1
    (infer one dim) are supported."""
    shape = tuple(int(s) for s in shape)
    if any(s < -1 for s in shape):
        raise MXNetError(f"reshape: codes below -1 are not ported: {shape}")
    shape = tuple(data.shape[i] if s == 0 else s for i, s in enumerate(shape))
    return data.reshape(shape)


register("reshape", _k_reshape, aliases=("Reshape",))


def _k_slice_axis(data, axis, begin, end):
    n = data.shape[axis]
    end = n if end is None else (end + n if end < 0 else end)
    begin = begin + n if begin < 0 else begin
    return data.narrow(axis, begin, end - begin)


register("slice_axis", _k_slice_axis)


def _k_take(a, indices, axis=0, mode="clip"):
    """``a`` gathered along ``axis`` (ref: ops/tensor.py:495).  Float
    indices truncate; ``clip`` clamps out-of-range indices into range,
    ``wrap`` takes them modulo the axis size."""
    n = a.shape[axis]
    idx = indices.to(torch.int64)
    if mode == "wrap":
        idx = idx.remainder(n)
    elif mode in ("clip", "raise"):
        idx = idx.clamp(0, n - 1)
    else:
        raise MXNetError(f"take: unknown mode {mode!r}")
    axis = axis % a.dim()
    out = a.index_select(axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


register("take", _k_take)


def _k_embedding(data, weight, input_dim=None, output_dim=None,
                 dtype="float32", sparse_grad=False):
    """Rows of ``weight`` for the ids in ``data`` (ref: ops/tensor.py:690).

    Ids are cast to int64 for torch indexing and clamped into
    ``[0, vocab)``: an out-of-range id on a CUDA device would otherwise
    abort the device context that every later request shares."""
    idx = data.to(torch.int64).clamp(0, weight.shape[0] - 1)
    return weight[idx]


register("Embedding", _k_embedding, aliases=("embedding",))


def _k_arange(start, stop=None, step=1.0, dtype=None, ctx=None):
    """``torch.arange`` on ``ctx`` (a Context or ``torch.device``;
    default :func:`current_context`)."""
    if stop is None:
        start, stop = 0, start
    if ctx is None:
        ctx = current_context()
    device = ctx.torch_device() if isinstance(ctx, Context) else ctx
    return torch.arange(start, stop, step, dtype=to_torch_dtype(dtype),
                        device=device)


register("arange", _k_arange)


def _k_broadcast_lesser(lhs, rhs):
    """``lhs < rhs`` broadcast, as ``lhs``'s dtype (ref: ops/tensor.py:54)."""
    return (lhs < rhs).to(lhs.dtype)


register("broadcast_lesser", _k_broadcast_lesser)


def _k_broadcast_mul(lhs, rhs):
    return lhs * rhs


register("broadcast_mul", _k_broadcast_mul)

register("square", torch.square)
register("abs", torch.abs)
register("relu", torch.relu)
register("log", torch.log)


def _reduce_axes(data, axis, exclude):
    """The axes to reduce (ref: ``_excl``, ops/tensor.py:162): None for
    every axis; with ``exclude``, every axis not named."""
    if isinstance(axis, list):
        axis = tuple(axis)
    if not exclude:
        return axis
    if axis is None:
        return ()
    axis = (axis,) if isinstance(axis, int) else tuple(axis)
    axis = tuple(a % data.dim() for a in axis)
    return tuple(i for i in range(data.dim()) if i not in axis)


def _reduce(fn, data, axis, keepdims, exclude):
    axes = _reduce_axes(data, axis, exclude)
    if axes is None:
        out = fn(data)
        return out.reshape((1,) * data.dim()) if keepdims else out
    if axes == ():  # torch reads an empty dim list as "every axis"
        return data
    return fn(data, dim=axes, keepdim=keepdims)


def _k_sum(data, axis=None, keepdims=False, exclude=False):
    """Ref: ops/tensor.py:144."""
    return _reduce(torch.sum, data, axis, keepdims, exclude)


def _k_mean(data, axis=None, keepdims=False, exclude=False):
    """Ref: ops/tensor.py:146."""
    return _reduce(torch.mean, data, axis, keepdims, exclude)


register("sum", _k_sum, aliases=("sum_axis",))
register("mean", _k_mean)


def _k_pick(data, index, axis=-1, keepdims=False, mode="clip"):
    """``data``'s element at ``index`` along ``axis`` (ref: ops/tensor.py:
    525); float indices truncate; ``clip`` clamps them into range,
    ``wrap`` takes them modulo the axis size."""
    if mode not in ("clip", "wrap"):
        raise MXNetError(f"pick: mode must be 'clip' or 'wrap', got {mode!r}")
    axis = axis % data.dim()
    n = data.shape[axis]
    idx = index.to(torch.int64)
    idx = idx.remainder(n) if mode == "wrap" else idx.clamp(0, n - 1)
    out = torch.gather(data, axis, idx.unsqueeze(axis))
    return out if keepdims else out.squeeze(axis)


register("pick", _k_pick)
