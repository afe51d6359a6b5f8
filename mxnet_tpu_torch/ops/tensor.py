"""Tensor ops (ref: ``mxnet_tpu/ops/tensor.py``): every name the JAX
module registers, as plain functions on ``torch.Tensor``s.

The elementwise binary and unary math, the comparisons and logical ops
(0/1 in the left operand's dtype), the reductions, ``dot``/``batch_dot``,
the shape ops (``reshape`` with MXNet's codes 0, -1, -2, -3, -4 and
``reverse``), slicing and indexing, the ordering ops, casts and the
sequence ops.  Output dtypes follow the JAX package's (its 32-bit mode):
integer sums and products stay in the input's dtype, ``argmax``/
``argmin`` give float32.  Ops that give views in torch (``reshape``,
``transpose``, ``diag``, ...) return views; the broadcasts return new
tensors, so that a write into one cannot reach its source.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from ..context import Context, current_context
from ..ndarray.ndarray import to_torch_dtype
from .registry import register


def mx_reshape_target(in_shape, spec, reverse=False):
    """MXNet's reshape codes resolved to a concrete shape (ref:
    ``mx_reshape_target``, ops/tensor.py:244): 0 copies an input dim, -1
    infers one, -2 copies the rest, -3 merges the next two, -4 splits one
    into the two entries after it; ``reverse`` reads the spec from the
    right."""
    ins = list(in_shape)
    spec = [int(s) for s in spec]
    if reverse:
        if -4 in spec:
            raise MXNetError("reshape: reverse=True with -4 split is not "
                             "supported")
        ins, spec = ins[::-1], spec[::-1]
    out, i, j = [], 0, 0
    while j < len(spec):
        s = spec[j]
        if s > 0:
            out.append(s)
            i += 1
        elif s == 0:
            if i >= len(ins):
                raise MXNetError(f"reshape 0 at output pos {j} has no "
                                 f"matching input dim for {tuple(in_shape)}")
            out.append(ins[i])
            i += 1
        elif s == -1:
            out.append(-1)
            i += 1
        elif s == -2:
            out.extend(ins[i:])
            i = len(ins)
        elif s == -3:
            if i + 1 >= len(ins):
                raise MXNetError("reshape -3 needs two input dims")
            out.append(ins[i] * ins[i + 1])
            i += 2
        elif s == -4:
            if j + 2 >= len(spec):
                raise MXNetError("reshape -4 needs two following entries")
            d1, d2 = spec[j + 1], spec[j + 2]
            cur = ins[i]
            if d1 == -1 and d2 == -1:
                raise MXNetError("reshape -4 cannot infer both factors")
            if d1 == 0 or d2 == 0 or d1 < -1 or d2 < -1:
                raise MXNetError(f"reshape -4 factors must be positive or "
                                 f"-1, got ({d1}, {d2})")
            if d1 == -1:
                d1 = cur // d2
            if d2 == -1:
                d2 = cur // d1
            if d1 * d2 != cur:
                raise MXNetError(f"reshape -4 split ({spec[j + 1]}, "
                                 f"{spec[j + 2]}) does not factor input dim "
                                 f"{cur}")
            out.extend([d1, d2])
            i += 1
            j += 2
        else:
            raise MXNetError(f"invalid reshape code {s}")
        j += 1
    if reverse:
        out = out[::-1]
    if out.count(-1) > 1:
        raise MXNetError(f"reshape can infer at most one dim, got {spec}")
    total = math.prod(in_shape)
    if -1 in out:
        known = math.prod(d for d in out if d != -1)
        if known <= 0 or total % known:
            raise MXNetError(f"reshape cannot infer -1: input size {total} "
                             f"is not divisible by the known dims of "
                             f"{tuple(spec)}")
        out[out.index(-1)] = total // known
    return tuple(out)


def _k_reshape(data, shape, reverse=False):
    """MXNet reshape with its codes (:func:`mx_reshape_target`)."""
    shape = (shape,) if isinstance(shape, int) else tuple(int(s) for s in shape)
    if reverse or any(s <= 0 for s in shape):
        shape = mx_reshape_target(data.shape, shape, reverse)
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


register("take", _k_take, arg_names=("a", "indices"))


def _k_embedding(data, weight, input_dim=None, output_dim=None,
                 dtype="float32", sparse_grad=False):
    """Rows of ``weight`` for the ids in ``data`` (ref: ops/tensor.py:690).

    Ids are cast to int64 for torch indexing and clamped into
    ``[0, vocab)``: an out-of-range id on a CUDA device would otherwise
    abort the device context that every later request shares."""
    idx = data.to(torch.int64).clamp(0, weight.shape[0] - 1)
    return weight[idx]


register("Embedding", _k_embedding, aliases=("embedding",),
         arg_names=("data", "weight"))


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


register("arange", _k_arange, arg_names=(), nondiff=True)


def _k_broadcast_lesser(lhs, rhs):
    """``lhs < rhs`` broadcast, as ``lhs``'s dtype (ref: ops/tensor.py:54)."""
    return (lhs < rhs).to(lhs.dtype)


register("broadcast_lesser", _k_broadcast_lesser, arg_names=("lhs", "rhs"),
         nondiff=True)


# elementwise binary ops, broadcast (ref: ops/tensor.py:25-44); the
# operators of ``mx.sym.Symbol`` emit these names
def _k_broadcast_add(lhs, rhs):
    return lhs + rhs


def _k_broadcast_sub(lhs, rhs):
    return lhs - rhs


def _k_broadcast_mul(lhs, rhs):
    return lhs * rhs


def _k_broadcast_div(lhs, rhs):
    return lhs / rhs


def _k_broadcast_power(lhs, rhs):
    return lhs ** rhs


register("broadcast_add", _k_broadcast_add, arg_names=("lhs", "rhs"),
         aliases=("broadcast_plus", "elemwise_add", "_add"))
register("broadcast_sub", _k_broadcast_sub, arg_names=("lhs", "rhs"),
         aliases=("broadcast_minus", "elemwise_sub", "_sub"))
register("broadcast_mul", _k_broadcast_mul, arg_names=("lhs", "rhs"),
         aliases=("elemwise_mul", "_mul"))
register("broadcast_div", _k_broadcast_div, arg_names=("lhs", "rhs"),
         aliases=("elemwise_div", "_div"))
register("broadcast_power", _k_broadcast_power, arg_names=("lhs", "rhs"))
register("negative", torch.neg)


def _k_stop_gradient(data):
    """The values, with no gradient flowing back (ref: ops/tensor.py:670)."""
    return data.detach()


register("stop_gradient", _k_stop_gradient, aliases=("BlockGrad",))


def _k_make_loss(data):
    """Marks a graph's head as a loss: the identity (ref: ops/tensor.py:
    676); its gradient is the head gradient the executor feeds, ones by
    default."""
    return data


register("make_loss", _k_make_loss, aliases=("MakeLoss",))

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


register("stack", _k_stack, variadic=True)


def _k_concat(*args, dim=1):
    """Ref: ops/tensor.py:363."""
    return torch.cat(args, dim=dim)


register("concat", _k_concat, aliases=("Concat",), variadic=True)


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


register("split", _k_split, aliases=("SliceChannel", "split_v2"),
         num_outputs=-1)


def _k_flip(data, axis):
    """Ref: ops/tensor.py:424."""
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    return torch.flip(data, axes)


register("flip", _k_flip, aliases=("reverse",))


def _k_where(condition, x, y):
    """``x`` where ``condition`` is non-zero, else ``y`` (ref:
    ops/tensor.py:569)."""
    return torch.where(condition != 0, x, y)


register("where", _k_where, arg_names=("condition", "x", "y"))


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


register("SequenceMask", _k_sequence_mask, aliases=("sequence_mask",),
         arg_names=("data", "sequence_length"))


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
         aliases=("sequence_reverse",), arg_names=("data", "sequence_length"))


def _k_swapaxes(data, dim1=0, dim2=1):
    """Ref: ops/tensor.py:441."""
    return data.transpose(dim1, dim2)


register("swapaxes", _k_swapaxes, aliases=("SwapAxis",))


def _pad_index(n, before, after, mode, device):
    """The source index of each position of one axis padded ``before`` and
    ``after``: ``edge`` repeats the end values, ``reflect`` mirrors about
    them without repeating them, folding again where the pad is longer
    than the axis (``numpy.pad``'s rules)."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge" or n == 1:
        return i.clamp(0, n - 1)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


def _k_pad(data, mode="constant", pad_width=(), constant_value=0.0):
    """MXNet's flat ``pad_width`` (before, after) per axis, first axis
    first (ref: ops/tensor.py:431), in the modes ``constant``, ``edge``
    and ``reflect``.  Every axis the widths name is padded, as
    ``jnp.pad`` pads it (``torch.nn.functional.pad``'s edge and reflect
    modes pad only the trailing axes): each padded axis is one gather."""
    if mode not in ("constant", "edge", "reflect"):
        raise MXNetError(f"pad: unknown mode {mode!r}")
    if len(pad_width) != 2 * data.dim():
        raise MXNetError(f"pad: pad_width needs 2 values per axis of a "
                         f"{data.dim()}-d input, got {tuple(pad_width)}")
    if mode != "constant":
        out = data
        for ax in range(data.dim()):
            before, after = int(pad_width[2 * ax]), int(pad_width[2 * ax + 1])
            if before or after:
                idx = _pad_index(data.shape[ax], before, after, mode,
                                 data.device)
                out = out.index_select(ax, idx)
        return out
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


def _int_sum_dtype(data):
    """The JAX package's dtype of an integer sum or product (its 32-bit
    mode): the input's, bool as int32; None for floats."""
    if data.is_floating_point() or data.is_complex():
        return None
    return torch.int32 if data.dtype == torch.bool else data.dtype


def _k_sum(data, axis=None, keepdims=False, exclude=False):
    """Ref: ops/tensor.py:144."""
    dt = _int_sum_dtype(data)
    out = _reduce(torch.sum, data, axis, keepdims, exclude)
    return out if dt is None else out.to(dt)


def _k_mean(data, axis=None, keepdims=False, exclude=False):
    """Ref: ops/tensor.py:146; an integer input's mean is float32."""
    if not data.is_floating_point():
        data = data.float()
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


register("pick", _k_pick, arg_names=("data", "index"),
         aliases=("choose_element_0d",))


# ---------------------------------------------------------------------------
# the rest of the JAX module's names (ref: ops/tensor.py:25-908)

def _k_mod(lhs, rhs):
    return torch.remainder(lhs, rhs)


def _k_maximum(lhs, rhs):
    return torch.maximum(lhs, rhs)


def _k_minimum(lhs, rhs):
    return torch.minimum(lhs, rhs)


def _k_hypot(lhs, rhs):
    return torch.hypot(lhs, rhs)


register("broadcast_mod", _k_mod, arg_names=("lhs", "rhs"))
register("broadcast_maximum", _k_maximum, arg_names=("lhs", "rhs"))
register("broadcast_minimum", _k_minimum, arg_names=("lhs", "rhs"))
register("broadcast_hypot", _k_hypot, arg_names=("lhs", "rhs"))
register("_maximum", _k_maximum, arg_names=("lhs", "rhs"))
register("_minimum", _k_minimum, arg_names=("lhs", "rhs"))


def _comparison(test):
    def _k(lhs, rhs):
        return test(lhs, rhs).to(lhs.dtype)
    return _k


def _logical(test):
    def _k(lhs, rhs):
        return test(lhs != 0, rhs != 0).to(lhs.dtype)
    return _k


# 0/1 in the left operand's dtype (ref: ops/tensor.py:50-69)
for _name, _k in (("equal", _comparison(torch.eq)),
                  ("not_equal", _comparison(torch.ne)),
                  ("greater", _comparison(torch.gt)),
                  ("greater_equal", _comparison(torch.ge)),
                  ("lesser_equal", _comparison(torch.le)),
                  ("logical_and", _logical(torch.logical_and)),
                  ("logical_or", _logical(torch.logical_or)),
                  ("logical_xor", _logical(torch.logical_xor))):
    _k.__name__ = f"_k_broadcast_{_name}"
    register(f"broadcast_{_name}", _k, arg_names=("lhs", "rhs"), nondiff=True)


def _gamma(x):
    # the JAX package's exp(gammaln(x)): |Gamma(x)| for negative x
    return torch.exp(torch.lgamma(x))


_UNARY = {
    "exp": torch.exp, "log2": torch.log2, "log10": torch.log10,
    "log1p": torch.log1p, "expm1": torch.expm1, "sqrt": torch.sqrt,
    "cbrt": lambda x: torch.sign(x) * torch.abs(x) ** (1.0 / 3.0),
    "sign": torch.sign, "floor": torch.floor, "ceil": torch.ceil,
    "round": torch.round, "rint": torch.round, "trunc": torch.trunc,
    "fix": torch.trunc, "reciprocal": lambda x: 1.0 / x,
    "rsqrt": torch.rsqrt,
    "rcbrt": lambda x: 1.0 / (torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)),
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "arcsin": torch.arcsin, "arccos": torch.arccos, "arctan": torch.arctan,
    "sinh": torch.sinh, "cosh": torch.cosh, "arcsinh": torch.arcsinh,
    "arccosh": torch.arccosh, "arctanh": torch.arctanh,
    "degrees": torch.rad2deg, "radians": torch.deg2rad,
    "erf": torch.erf, "erfinv": torch.erfinv, "gamma": _gamma,
    "digamma": torch.digamma,
    "logical_not": lambda x: (x == 0).to(x.dtype),
    "isnan": lambda x: torch.isnan(x).to(torch.float32),
    "isinf": lambda x: torch.isinf(x).to(torch.float32),
    "softsign": torch.nn.functional.softsign,
    "softrelu": torch.nn.functional.softplus,
}
_NONDIFF = ("sign", "floor", "ceil", "round", "rint", "trunc",
            "logical_not", "isnan", "isinf")


def _unary(fn):
    def _k(data):
        return fn(data)
    return _k


for _name, _fn in _UNARY.items():
    _k = _unary(_fn)
    _k.__name__ = f"_k_{_name}"
    register(_name, _k, nondiff=_name in _NONDIFF,
             aliases=("softplus",) if _name == "softrelu" else ())


def _k_hard_sigmoid(data, alpha=0.2, beta=0.5):
    return torch.clamp(alpha * data + beta, 0.0, 1.0)


def _k_clip(data, a_min=None, a_max=None):
    return torch.clamp(data, a_min, a_max)


def _k_smooth_l1(data, scalar=1.0):
    s2 = scalar * scalar
    a = torch.abs(data)
    return torch.where(a < 1.0 / s2, 0.5 * s2 * data * data, a - 0.5 / s2)


register("hard_sigmoid", _k_hard_sigmoid)
register("clip", _k_clip)
register("smooth_l1", _k_smooth_l1)


# -- reductions (ref: ops/tensor.py:144-209) --------------------------------

def _prod_dims(data, dim=None, keepdim=False):
    if dim is None:
        return torch.prod(data)
    dims = (dim,) if isinstance(dim, int) else dim
    out = data
    for d in sorted((d % data.dim() for d in dims), reverse=True):
        out = torch.prod(out, dim=d, keepdim=keepdim)
    return out


def _k_prod(data, axis=None, keepdims=False, exclude=False):
    dt = _int_sum_dtype(data)
    out = _reduce(_prod_dims, data, axis, keepdims, exclude)
    return out if dt is None else out.to(dt)


def _k_max(data, axis=None, keepdims=False, exclude=False):
    return _reduce(torch.amax, data, axis, keepdims, exclude)


def _k_min(data, axis=None, keepdims=False, exclude=False):
    return _reduce(torch.amin, data, axis, keepdims, exclude)


def _k_nansum(data, axis=None, keepdims=False, exclude=False):
    return _reduce(torch.nansum, data, axis, keepdims, exclude)


def _k_nanprod(data, axis=None, keepdims=False, exclude=False):
    data = torch.where(torch.isnan(data), torch.ones_like(data), data)
    return _reduce(_prod_dims, data, axis, keepdims, exclude)


register("prod", _k_prod)
register("max", _k_max, aliases=("max_axis",))
register("min", _k_min, aliases=("min_axis",))
register("nansum", _k_nansum)
register("nanprod", _k_nanprod)


def _k_norm(data, ord=2, axis=None, keepdims=False):
    """L1 for ``ord=1``, else L2 (ref: ops/tensor.py:179)."""
    if ord == 1:
        return _reduce(torch.sum, torch.abs(data), axis, keepdims, False)
    return torch.sqrt(_reduce(torch.sum, torch.square(data), axis, keepdims,
                              False))


register("norm", _k_norm)


def _arg_reduce(fn, data, axis, keepdims):
    if axis is None:
        out = fn(data.reshape(-1))
    else:
        out = fn(data, dim=axis, keepdim=bool(keepdims))
    return out.to(torch.float32)


def _k_argmax(data, axis=None, keepdims=False):
    """Float32 indices, as MXNet (ref: ops/tensor.py:188)."""
    return _arg_reduce(torch.argmax, data, axis, keepdims)


def _k_argmin(data, axis=None, keepdims=False):
    return _arg_reduce(torch.argmin, data, axis, keepdims)


def _k_argmax_channel(data):
    return torch.argmax(data, dim=1).to(torch.float32)


register("argmax", _k_argmax, nondiff=True)
register("argmin", _k_argmin, nondiff=True)
register("argmax_channel", _k_argmax_channel, nondiff=True)


# -- products (ref: ops/tensor.py:215-239) ----------------------------------

def _all_axes_reversed(x):
    return x.permute(*reversed(range(x.dim())))


def _k_dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """MXNet's dot: ``lhs``'s last axis contracted with ``rhs``'s first
    (``transpose_*`` reverse an operand's axes first)."""
    a = _all_axes_reversed(lhs) if transpose_a else lhs
    b = _all_axes_reversed(rhs) if transpose_b else rhs
    if a.dim() <= 2 and b.dim() <= 2:
        return torch.matmul(a, b)
    return torch.tensordot(a, b, dims=([a.dim() - 1], [0]))


def _k_batch_dot(lhs, rhs, transpose_a=False, transpose_b=False):
    a = lhs.transpose(-1, -2) if transpose_a else lhs
    b = rhs.transpose(-1, -2) if transpose_b else rhs
    return torch.matmul(a, b)


def _k_khatri_rao(*args):
    """Column-wise Kronecker product of matrices with equal columns."""
    out = args[0]
    for m in args[1:]:
        out = torch.einsum("i...,j...->ij...", out, m).reshape(
            out.shape[0] * m.shape[0], *out.shape[1:])
    return out


register("dot", _k_dot, arg_names=("lhs", "rhs"))
register("batch_dot", _k_batch_dot, arg_names=("lhs", "rhs"),
         aliases=("linalg_gemm2",))
register("khatri_rao", _k_khatri_rao, variadic=True)


# -- shape (ref: ops/tensor.py:339-464) -------------------------------------

def _k_transpose(data, axes=()):
    axes = tuple(axes) if axes else tuple(reversed(range(data.dim())))
    return data.permute(*axes)


def _k_add_n(*args):
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


def _k_broadcast_axis(data, axis=(), size=()):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    sizes = (size,) if isinstance(size, int) else tuple(size)
    shape = list(data.shape)
    for ax, s in zip(axes, sizes):
        shape[ax] = s
    return data.expand(shape).contiguous()


def _k_broadcast_to(data, shape):
    tgt = [d if s == 0 else s for s, d in zip(shape, data.shape)]
    return data.expand(tgt).contiguous()


def _k_broadcast_like(lhs, rhs):
    return lhs.expand(rhs.shape).contiguous()


def _k_tile(data, reps):
    return torch.tile(data, (reps,) if isinstance(reps, int) else tuple(reps))


def _k_repeat(data, repeats, axis=None):
    return torch.repeat_interleave(data, int(repeats), dim=axis)


def _k_depth_to_space(data, block_size):
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


def _k_space_to_depth(data, block_size):
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


register("transpose", _k_transpose)
register("add_n", _k_add_n, variadic=True,
         aliases=("ElementWiseSum", "elemwise_sum"))
register("broadcast_axis", _k_broadcast_axis, aliases=("broadcast_axes",))
register("broadcast_to", _k_broadcast_to)
register("broadcast_like", _k_broadcast_like, arg_names=("lhs", "rhs"))
register("tile", _k_tile)
register("repeat", _k_repeat)
register("depth_to_space", _k_depth_to_space)
register("space_to_depth", _k_space_to_depth)


# -- slicing and indexing (ref: ops/tensor.py:469-583) ----------------------

def _slice_dim(x, axis, begin, end, step):
    """Python's ``x[begin:end:step]`` along ``axis``, negative steps too."""
    step = 1 if step is None else int(step)
    if step > 0:
        idx = [slice(None)] * x.dim()
        idx[axis] = slice(begin, end, step)
        return x[tuple(idx)]
    picks = list(range(x.shape[axis]))[slice(begin, end, step)]
    return x.index_select(axis, torch.tensor(picks, dtype=torch.int64,
                                             device=x.device))


def _k_slice(data, begin, end, step=()):
    step = tuple(step) or (1,) * len(begin)
    out = data
    for ax, (b, e, s) in enumerate(zip(begin, end, step)):
        out = _slice_dim(out, ax, b, e, s)
    return out


def _k_slice_like(data, shape_like, axes=()):
    sel = tuple(axes) if axes else range(min(data.dim(), shape_like.dim()))
    out = data
    for ax in sel:
        out = out.narrow(ax, 0, min(shape_like.shape[ax], out.shape[ax]))
    return out


def _k_gather_nd(data, indices):
    """``data[indices[0], indices[1], ...]`` (ref: ops/tensor.py:547)."""
    return data[tuple(indices.to(torch.int64))]


def _k_scatter_nd(data, indices, shape):
    """Zeros of ``shape`` with ``data`` added at ``indices`` (ref:
    ops/tensor.py:554).  Repeated indices are summed; on CUDA their sum is
    taken in no fixed order, so repeated float indices need not give the
    same bits from run to run."""
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(tuple(indices.to(torch.int64)), data,
                         accumulate=True)


def _k_one_hot(indices, depth, on_value=1.0, off_value=0.0, dtype="float32"):
    """Out-of-range indices give rows of ``off_value`` (as jax.nn.one_hot)."""
    hot = indices.to(torch.int64).unsqueeze(-1) == torch.arange(
        int(depth), device=indices.device)
    out = hot.to(to_torch_dtype(dtype))
    return out * (on_value - off_value) + off_value


def _k_boolean_mask(data, index, axis=0):
    """The slices of ``data`` along ``axis`` where ``index`` is non-zero;
    the output's size depends on the data, so the host reads the mask."""
    keep = torch.nonzero(index != 0).reshape(-1)
    return data.index_select(axis, keep.to(data.device))


register("slice", _k_slice)
register("slice_like", _k_slice_like, arg_names=("data", "shape_like"))
register("gather_nd", _k_gather_nd, arg_names=("data", "indices"))
register("scatter_nd", _k_scatter_nd, arg_names=("data", "indices"))
register("one_hot", _k_one_hot, arg_names=("indices",), nondiff=True)
register("boolean_mask", _k_boolean_mask, arg_names=("data", "index"),
         nondiff=True)


# -- ordering (ref: ops/tensor.py:588-634); stable sorts, as jnp's ----------

def _k_sort(data, axis=-1, is_ascend=True):
    out = torch.sort(data, dim=axis, stable=True).values
    return out if is_ascend else torch.flip(out, (axis,))


def _k_argsort(data, axis=-1, is_ascend=True, dtype="float32"):
    out = torch.argsort(data, dim=axis, stable=True)
    if not is_ascend:
        out = torch.flip(out, (axis,))
    return out.to(to_torch_dtype(dtype))


def _k_topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
            dtype="float32"):
    """The ``k`` largest (smallest with ``is_ascend``) along ``axis``; ties
    go to the lower index, as ``lax.top_k``."""
    axis = axis % data.dim()
    src = data.movedim(axis, -1)
    order = torch.argsort(src if is_ascend else -src, dim=-1, stable=True)
    idx = order[..., :int(k)]
    if ret_typ == "mask":
        mask = torch.zeros_like(src).scatter(-1, idx, 1)
        return mask.movedim(-1, axis)
    vals = torch.gather(src, -1, idx).movedim(-1, axis)
    idx = idx.movedim(-1, axis).to(to_torch_dtype(dtype))
    if ret_typ == "indices":
        return idx
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return vals, idx
    raise MXNetError(f"topk: unknown ret_typ {ret_typ!r}")


register("sort", _k_sort)
register("argsort", _k_argsort, nondiff=True)
register("topk", _k_topk, nondiff=True, num_outputs=-1)


# -- init-like, casts and the rest (ref: ops/tensor.py:639-908) -------------

def _k_zeros_like(data):
    return torch.zeros_like(data)


def _k_ones_like(data):
    return torch.ones_like(data)


def _k_cast(data, dtype):
    return data.to(to_torch_dtype(dtype))


def _k_shape_array(data):
    # int32: the JAX package's int64 request in its 32-bit mode
    return torch.tensor(tuple(data.shape), dtype=torch.int32,
                        device=data.device)


def _k_size_array(data):
    return torch.tensor([data.numel()], dtype=torch.int32, device=data.device)


def _k_identity(data):
    """A copy (``_copy``): writing into it leaves ``data`` as it is."""
    return data.clone()


def _k_diag(data, k=0):
    if data.dim() == 1:
        return torch.diag(data, k)
    return torch.diagonal(data, offset=k, dim1=-2, dim2=-1)


register("zeros_like", _k_zeros_like, nondiff=True)
register("ones_like", _k_ones_like, nondiff=True)
register("cast", _k_cast, aliases=("Cast",))
register("shape_array", _k_shape_array, nondiff=True)
register("size_array", _k_size_array, nondiff=True)
register("identity", _k_identity, aliases=("_copy",))
register("diag", _k_diag)


def _k_sequence_last(data, sequence_length=None, use_sequence_length=False,
                     axis=0):
    """Each batch column's last valid step (ref: ops/tensor.py:727)."""
    if not use_sequence_length or sequence_length is None:
        return data.select(axis, -1)
    if axis == 1:
        data = data.transpose(0, 1)
    last = sequence_length.to(torch.int64).to(data.device) - 1
    idx = last.reshape((1, -1) + (1,) * (data.dim() - 2)).expand(
        (1,) + tuple(data.shape[1:]))
    return torch.gather(data, 0, idx)[0]


register("SequenceLast", _k_sequence_last, aliases=("sequence_last",),
         arg_names=("data", "sequence_length"))


def _k_div_sqrt_dim(data):
    return data / math.sqrt(data.shape[-1])


register("_contrib_div_sqrt_dim", _k_div_sqrt_dim)


def _k_cumsum(a, axis=None, dtype=None):
    """Ref: ops/tensor.py:769; the input's dtype unless ``dtype``."""
    x = a if dtype is None else a.to(to_torch_dtype(dtype))
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.cumsum(x, dim=axis, dtype=x.dtype)


def _k_batch_take(a, indices):
    """``a[i, indices[i]]`` for each row ``i``."""
    idx = indices.to(torch.int64).reshape(-1)
    return a[torch.arange(a.shape[0], device=a.device), idx]


register("cumsum", _k_cumsum, arg_names=("a",))
register("batch_take", _k_batch_take, arg_names=("a", "indices"))


def _strides(shape, device):
    dims = torch.tensor(tuple(shape), dtype=torch.int64, device=device)
    rev = torch.cumprod(dims.flip(0), 0).flip(0)
    return dims, torch.cat([rev[1:], torch.ones(1, dtype=torch.int64,
                                                 device=device)])


def _index_dtype(data):
    return torch.int32 if data.is_floating_point() else data.dtype


def _k_ravel_multi_index(data, shape):
    """(ndim, n) coordinates -> flat indices, integer (ref: ops/tensor.py:
    805)."""
    _, strides = _strides(shape, data.device)
    flat = (data.to(torch.int64) * strides[:, None]).sum(dim=0)
    return flat.to(_index_dtype(data))


def _k_unravel_index(data, shape):
    """Flat indices -> (ndim,) + data.shape coordinates."""
    dims, strides = _strides(shape, data.device)
    flat = data.to(torch.int64).reshape(-1)
    coords = torch.div(flat[None, :], strides[:, None],
                       rounding_mode="floor") % dims[:, None]
    return coords.reshape((len(shape),) + tuple(data.shape)).to(
        _index_dtype(data))


register("_ravel_multi_index", _k_ravel_multi_index,
         aliases=("ravel_multi_index",), nondiff=True)
register("_unravel_index", _k_unravel_index, aliases=("unravel_index",),
         nondiff=True)


def _k_crop(data, offset=(0, 0), h_w=(0, 0), center_crop=False):
    """The legacy Crop op on NCHW (ref: ops/tensor.py:834)."""
    H, W = data.shape[2], data.shape[3]
    ch, cw = int(h_w[0]) or H, int(h_w[1]) or W
    if center_crop:
        y0, x0 = (H - ch) // 2, (W - cw) // 2
    else:
        y0, x0 = int(offset[0]), int(offset[1])
    if y0 < 0 or x0 < 0 or y0 + ch > H or x0 + cw > W:
        raise MXNetError(f"Crop out of bounds: offset=({y0},{x0}) "
                         f"h_w=({ch},{cw}) on input {H}x{W}")
    return data[:, :, y0:y0 + ch, x0:x0 + cw]


register("Crop", _k_crop, aliases=("crop_legacy",))


def _k_reshape_like(lhs, rhs, lhs_begin=None, lhs_end=None, rhs_begin=None,
                    rhs_end=None):
    """``lhs`` in ``rhs``'s shape, or its axes ``[lhs_begin, lhs_end)`` in
    the shape of ``rhs``'s ``[rhs_begin, rhs_end)`` (ref: ops/tensor.py:
    853)."""
    if lhs_begin is None and lhs_end is None and rhs_begin is None \
            and rhs_end is None:
        return lhs.reshape(rhs.shape)
    lb = 0 if lhs_begin is None else int(lhs_begin) % (lhs.dim() + 1)
    le = lhs.dim() if lhs_end is None else int(lhs_end) % (lhs.dim() + 1)
    rb = 0 if rhs_begin is None else int(rhs_begin) % (rhs.dim() + 1)
    re_ = rhs.dim() if rhs_end is None else int(rhs_end) % (rhs.dim() + 1)
    return lhs.reshape(tuple(lhs.shape[:lb]) + tuple(rhs.shape[rb:re_])
                       + tuple(lhs.shape[le:]))


register("reshape_like", _k_reshape_like, arg_names=("lhs", "rhs"))


class _KLSparseReg(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, target, penalty):
        ctx.save_for_backward(data)
        ctx.target, ctx.penalty = target, penalty
        return data.view_as(data)

    @staticmethod
    def backward(ctx, g):
        (data,) = ctx.saved_tensors
        rho = torch.clamp(data.mean(dim=0), 1e-6, 1 - 1e-6)
        dkl = (-ctx.target / rho + (1 - ctx.target) / (1 - rho)) * ctx.penalty
        return g + dkl.expand(data.shape).to(g.dtype), None, None


def _k_identity_attach_kl_sparse_reg(data, sparseness_target=0.1,
                                     penalty=0.001, momentum=0.9):
    """The identity forward; the backward adds the KL-sparseness penalty's
    gradient, pushing the batch mean of the (sigmoid) input toward
    ``sparseness_target`` (ref: ops/tensor.py:895; rho is the current
    batch mean, as there)."""
    return _KLSparseReg.apply(data, float(sparseness_target), float(penalty))


register("IdentityAttachKLSparseReg", _k_identity_attach_kl_sparse_reg)
