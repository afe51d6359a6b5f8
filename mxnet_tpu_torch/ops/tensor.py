"""Tensor ops: the subset of ``mxnet_tpu/ops/tensor.py`` that BERT
serving and training, the ported losses, ResNet, DeepAR, the Transformer
and the recurrent cells run (reshape, flatten, slice_axis, take, pick,
Embedding, arange, broadcast_lesser, broadcast_mul, expand_dims, squeeze,
stack, concat, split, swapaxes, pad, flip, where, SequenceMask,
SequenceReverse, the sum and mean reductions, the elementwise square,
abs, relu, sigmoid, tanh, log and gammaln, and the uniform draw behind
``F.random.uniform``)."""
from __future__ import annotations

import torch

from .. import random as _random
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


def _k_flatten(data):
    """Every axis after the first folded into one (ref: ops/tensor.py:333)."""
    return data.reshape(data.shape[0], -1)


register("flatten", _k_flatten, aliases=("Flatten",))


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


def _device(ctx):
    """The ``torch.device`` of ``ctx``: a Context, a ``torch.device``, or
    None for :func:`current_context`."""
    if ctx is None:
        ctx = current_context()
    return ctx.torch_device() if isinstance(ctx, Context) else ctx


def _k_arange(start, stop=None, step=1.0, dtype=None, ctx=None):
    """``torch.arange`` on ``ctx`` (a Context or ``torch.device``;
    default :func:`current_context`)."""
    if stop is None:
        start, stop = 0, start
    return torch.arange(start, stop, step, dtype=to_torch_dtype(dtype),
                        device=_device(ctx))


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
register("sigmoid", torch.sigmoid)
register("tanh", torch.tanh)
register("log", torch.log)
register("gammaln", torch.lgamma)


def _k_expand_dims(data, axis):
    """Ref: ops/tensor.py:345."""
    return data.unsqueeze(axis)


register("expand_dims", _k_expand_dims)


def _k_squeeze(data, axis=None):
    """Every size-1 axis, or the ones named (ref: ops/tensor.py:351)."""
    if axis is None:
        return data.squeeze()
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    for ax in axes:
        if data.shape[ax] != 1:
            raise MXNetError(f"squeeze: axis {ax} of shape "
                             f"{tuple(data.shape)} is not 1")
    return data.squeeze(axes)


register("squeeze", _k_squeeze)


def _k_stack(*args, axis=0):
    """Ref: ops/tensor.py:357."""
    return torch.stack(args, dim=axis)


register("stack", _k_stack)


def _k_concat(*args, dim=1):
    """Ref: ops/tensor.py:363."""
    return torch.cat(args, dim=dim)


register("concat", _k_concat, aliases=("Concat",))


def _k_split(data, num_outputs, axis=1, squeeze_axis=False):
    """``num_outputs`` equal parts along ``axis``, a tuple (ref:
    ops/tensor.py:369)."""
    n = data.shape[axis]
    if n % num_outputs:
        raise MXNetError(f"split: axis {axis} of size {n} does not divide "
                         f"into {num_outputs} equal parts")
    parts = torch.split(data, n // num_outputs, dim=axis)
    if squeeze_axis:
        parts = tuple(p.squeeze(axis) for p in parts)
    return tuple(parts)


register("split", _k_split, aliases=("SliceChannel", "split_v2"))


def _k_flip(data, axis):
    """Ref: ops/tensor.py:424."""
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    return torch.flip(data, axes)


register("flip", _k_flip, aliases=("reverse",))


def _k_where(condition, x, y):
    """``x`` where ``condition`` is non-zero, else ``y`` (ref:
    ops/tensor.py:569)."""
    return torch.where(condition != 0, x, y)


register("where", _k_where)


def _time_lengths(data, sequence_length):
    """``(steps, lengths)`` broadcastable over ``data``'s first two axes
    (time, batch)."""
    steps = torch.arange(data.shape[0], device=data.device)[:, None]
    return steps, sequence_length.to(torch.int64).to(data.device)[None, :]


def _k_sequence_mask(data, sequence_length=None, use_sequence_length=False,
                     value=0.0, axis=0):
    """Steps at or past each batch column's length set to ``value``; time
    on ``axis`` (0 or 1), batch on the other (ref: ops/tensor.py:711)."""
    if not use_sequence_length or sequence_length is None:
        return data
    if axis == 1:
        data = data.transpose(0, 1)
    steps, lengths = _time_lengths(data, sequence_length)
    keep = (steps < lengths).reshape(
        steps.shape[0], lengths.shape[1], *(1,) * (data.dim() - 2))
    out = torch.where(keep, data, torch.full((), value, dtype=data.dtype,
                                             device=data.device))
    return out.transpose(0, 1) if axis == 1 else out


register("SequenceMask", _k_sequence_mask, aliases=("sequence_mask",))


def _k_sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                        axis=0):
    """Each batch column's first ``length`` steps reversed in place, the
    padding after them kept (ref: ops/tensor.py:744).  Time is axis 0, as
    in MXNet; the reference ignores ``axis``, the port raises for another
    value."""
    if axis != 0:
        raise MXNetError(f"SequenceReverse: time must be axis 0, got {axis}")
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, (0,))
    steps, lengths = _time_lengths(data, sequence_length)
    idx = torch.where(steps < lengths, lengths - 1 - steps, steps)
    idx = idx.reshape(idx.shape + (1,) * (data.dim() - 2)).expand(data.shape)
    return torch.gather(data, 0, idx)


register("SequenceReverse", _k_sequence_reverse,
         aliases=("sequence_reverse",))


def _k_random_uniform(low=0.0, high=1.0, shape=(1,), dtype=None, ctx=None):
    """Draws from U[low, high) on ``ctx`` (a Context or ``torch.device``;
    default :func:`current_context`), from that device's explicit
    generator (ref: ``mxnet_tpu/random.py:133``); ``F.random.uniform``."""
    device = _device(ctx)
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    out = torch.empty(shape, dtype=to_torch_dtype(dtype), device=device)
    return out.uniform_(float(low), float(high),
                        generator=_random.generator(device))


register("_random_uniform", _k_random_uniform)


def _k_swapaxes(data, dim1=0, dim2=1):
    """Ref: ops/tensor.py:441."""
    return data.transpose(dim1, dim2)


register("swapaxes", _k_swapaxes, aliases=("SwapAxis",))


def _k_pad(data, mode="constant", pad_width=(), constant_value=0.0):
    """MXNet's flat ``pad_width`` (before, after) per axis, first axis
    first (ref: ops/tensor.py:431); of the modes, ``constant``."""
    if mode != "constant":
        raise MXNetError(f"pad: mode {mode!r} is not ported")
    if len(pad_width) != 2 * data.dim():
        raise MXNetError(f"pad: pad_width needs 2 values per axis of a "
                         f"{data.dim()}-d input, got {tuple(pad_width)}")
    flat = []
    for ax in reversed(range(data.dim())):  # torch lists the last axis first
        flat += [int(pad_width[2 * ax]), int(pad_width[2 * ax + 1])]
    return torch.nn.functional.pad(data, flat, mode="constant",
                                   value=constant_value)


register("pad", _k_pad, aliases=("Pad",))


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
