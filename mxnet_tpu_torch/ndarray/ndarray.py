"""NDArray: the imperative n-dimensional array over a ``torch.Tensor``.

Ref: include/mxnet/ndarray.h; ``mxnet_tpu/ndarray/ndarray.py`` of the JAX
package.  An NDArray wraps ``data``, a tensor, and the
:class:`~mxnet_tpu_torch.context.Context` it was made on.  It carries the
MXNet 1.x imperative API: arithmetic with its reflected and in-place
forms, elementwise comparisons (0/1 in the array's dtype), indexing and
assignment, ``reshape`` with MXNet's codes, the reductions and the math
methods.  Every method computes through one helper, :func:`_call`, over
``_imperative.invoke``: it unwraps the NDArrays, runs the registered
tensor function (``ops/``) with autograd on exactly while
``autograd.record()`` is, and wraps the results on the first input's
context.  Blocks and ops themselves compute on plain tensors (``mx.nd``
is also the ``F`` of ``hybrid_forward``; see ``ndarray/ops.py`` for the
dispatch rule).

In-place writes (``x[...] = v``, ``+=``, ``-=``, ``*=``, ``/=``,
``copyto`` into an NDArray, ``out=``) write into the same tensor, never
rebind ``data``: a variable (``attach_grad``) is its tensor to autograd,
and captured graphs hold tensors.  Under ``autograd.record()`` such a
write into a variable raises :class:`MXNetError`, as torch refuses it.
Results may share memory with their source where torch gives a view
(``reshape``, basic indexing, ``T``): a write into one then shows in the
other, as with MXNet's own ``reshape`` and basic slicing; the JAX
package's arrays never share.  ``copy()`` gives an independent array.

An NDArray keeps the context it was made on (``array(..., ctx=)``,
``zeros``, ``as_in_context``, ``copyto``, ``gluon.utils.split_and_load``,
and a block's or op's outputs take their first NDArray input's): the
port's ``cpu(i)`` are one torch device, so ``cpu(1)`` cannot be read back
from the tensor.  An NDArray made from a bare tensor reads its context
from the tensor's device (``gpu(i)`` for ``cuda:i``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from ..context import Context, current_context

__all__ = ["NDArray", "array", "zeros", "ones", "full", "arange", "empty",
           "zeros_like", "ones_like", "eye", "linspace", "histogram",
           "concatenate", "moveaxis", "waitall", "to_torch_dtype",
           "as_tensor"]

_DTYPES = {
    "float32": torch.float32, "float": torch.float32,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float64": torch.float64, "int32": torch.int32, "int": torch.int32,
    "int64": torch.int64, "int8": torch.int8, "uint8": torch.uint8,
    "bool": torch.bool,
}


def to_torch_dtype(dtype):
    """``torch.dtype`` of a dtype given as a string, numpy dtype, Python
    type or ``torch.dtype``; None means float32 (the MXNet default)."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype is float:
        return torch.float32
    if dtype is int:
        return torch.int32
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    if name not in _DTYPES:
        raise MXNetError(f"unsupported dtype {dtype!r}")
    return _DTYPES[name]


def as_tensor(x):
    """The tensor of an NDArray, or ``x`` itself."""
    return x.data if isinstance(x, NDArray) else x


def _ctx_of(ctx):
    return Context(ctx) if ctx is not None else current_context()


def _call(fn, *args, **attrs):
    """``fn`` on the tensors of the NDArrays among ``args``, its outputs
    wrapped on the first one's context (``_imperative.invoke``); autograd
    records it exactly while ``autograd.record()`` is on."""
    from .. import _imperative, autograd

    with torch.set_grad_enabled(autograd.is_recording()):
        return _imperative.invoke(fn, *args, **attrs)


def _op(name, *args, **attrs):
    """The registered op ``name`` through :func:`_call`."""
    from ..ops import registry

    return _call(registry.get(name), *args, **attrs)


def _describe(x):
    return f"NDArray {x.shape} {x.dtype} @{x.context}"


def _scalar(v):
    return v.item() if isinstance(v, np.generic) else v


# the operators' tensor functions (module-level: the profiler names an op
# by its function)
def _k_add(x, y): return x + y
def _k_sub(x, y): return x - y
def _k_rsub(x, y): return y - x
def _k_mul(x, y): return x * y
def _k_div(x, y): return x / y
def _k_rdiv(x, y): return y / x
def _k_mod(x, y): return torch.remainder(x, y)
def _k_rmod(x, y): return y % x
def _k_pow(x, y): return x ** y
def _k_rpow(x, y): return y ** x
def _k_eq(x, y): return (x == y).to(x.dtype)
def _k_ne(x, y): return (x != y).to(x.dtype)
def _k_gt(x, y): return (x > y).to(x.dtype)
def _k_ge(x, y): return (x >= y).to(x.dtype)
def _k_lt(x, y): return (x < y).to(x.dtype)
def _k_le(x, y): return (x <= y).to(x.dtype)


def _k_getitem(x, *arrays, index):
    idx, flips = _positive_steps(x, _fill_index(index, iter(arrays)))
    out = x[idx]
    return out.flip(flips) if flips else out


def _k_astype(x, dtype, copy):
    out = x.to(dtype)
    return out.clone() if copy and out is x else out


def _k_expand(x, shape):
    return x.expand(shape).contiguous()


# -- indices ----------------------------------------------------------------

class _Slot:
    """Where an index array goes in an encoded index."""


def _encode_index(idx, like):
    """``idx`` with its array parts (NDArrays, tensors, numpy arrays and
    lists) replaced by :class:`_Slot`s, and those parts as a list (NDArrays
    or tensors; float arrays truncate to int64, as MXNet reads them)."""
    arrays = []

    def enc(i):
        if isinstance(i, (bool, int, np.integer, slice)) or i is None \
                or i is Ellipsis:
            return int(i) if isinstance(i, np.integer) else i
        if isinstance(i, tuple):
            return tuple(enc(j) for j in i)
        if isinstance(i, (NDArray, torch.Tensor)):
            t = i.data if isinstance(i, NDArray) else i
        elif isinstance(i, (np.ndarray, list)):
            t = torch.as_tensor(np.asarray(i))
        else:
            raise MXNetError(f"unsupported index component {i!r}")
        if t.is_floating_point():
            t = t.to(torch.int64)
        arrays.append(i if isinstance(i, NDArray) and t is i.data
                      else t.to(like.device))
        return _Slot
    return enc(idx), arrays


def _fill_index(tree, arrays):
    if tree is _Slot:
        return next(arrays)
    if isinstance(tree, tuple):
        return tuple(_fill_index(t, arrays) for t in tree)
    return tree


def _positive_steps(x, idx):
    """``(idx', dims)``: ``idx`` with each negative-step slice replaced by
    the positive-step slice over the same elements (torch slices take
    positive steps only), and the output axes to flip so that ``x[idx']``
    flipped along ``dims`` is ``x[idx]``.  Negative steps beside array
    indices are refused."""
    parts = idx if isinstance(idx, tuple) else (idx,)
    if not any(isinstance(p, slice) and p.step is not None and p.step < 0
               for p in parts):
        return idx, ()
    if any(isinstance(p, (torch.Tensor, list)) for p in parts):
        raise MXNetError("an index with a negative slice step and array "
                         "components is not supported; flip() first")
    rest = x.dim() - sum(1 for p in parts
                         if isinstance(p, (int, slice)) and
                         not isinstance(p, bool))
    out, flips, axis, out_axis = [], [], 0, 0
    for p in parts:
        if p is Ellipsis:
            axis += rest
            out_axis += rest
        elif p is None or isinstance(p, bool):
            out_axis += 1
        elif isinstance(p, slice):
            if p.step is not None and p.step < 0:
                r = range(x.shape[axis])[p]
                p = slice(r[-1], r[0] + 1, -p.step) if r else slice(0, 0)
                flips.append(out_axis)
            axis += 1
            out_axis += 1
        else:
            axis += 1
        out.append(p)
    return tuple(out), tuple(flips)


def _k_setitem(x, value, *arrays, index):
    """Writes ``value`` into ``x`` at ``index`` in place."""
    idx, flips = _positive_steps(x, _fill_index(index, iter(arrays)))
    if flips and isinstance(value, torch.Tensor):
        value = value.expand(x[idx].shape).flip(flips)
    x[idx] = value


def _on(t, ctx):
    """Does tensor ``t`` live on the torch device ``ctx`` names?"""
    if ctx.device_type == "cpu":
        return not t.is_cuda
    return t.is_cuda and (t.device.index or 0) == ctx.device_id


class NDArray:
    """An n-dimensional array on a device, wrapping ``data``, a tensor, and
    the context it was made on (``ctx``; default: the tensor's device)."""

    __slots__ = ("data", "_ctx", "__weakref__")
    # numpy scalars and arrays on the left defer to the reflected operators
    __array_priority__ = 1000.0

    def __init__(self, data, ctx=None):
        if not isinstance(data, torch.Tensor):
            raise MXNetError(f"NDArray wraps a torch.Tensor, got {type(data)}")
        if ctx is not None:
            ctx = Context(ctx)
            if not _on(data, ctx):
                raise MXNetError(f"NDArray: a tensor on {data.device} "
                                 f"cannot be on {ctx}")
        self.data = data
        self._ctx = ctx

    # -- properties -----------------------------------------------------------

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def dtype(self):
        """numpy dtype (bfloat16 has none and reads as float32, the
        dtype ``asnumpy`` returns for it)."""
        if self.data.dtype == torch.bfloat16:
            return np.dtype(np.float32)
        return np.dtype(str(self.data.dtype).replace("torch.", ""))

    @property
    def size(self):
        return self.data.numel()

    @property
    def ndim(self):
        return self.data.dim()

    @property
    def context(self):
        if self._ctx is not None:
            return self._ctx
        return Context.from_device(self.data.device)

    ctx = context

    @property
    def T(self):
        return self.transpose()

    @property
    def stype(self):
        return "default"

    # -- copies and conversion ------------------------------------------------

    def as_in_context(self, context):
        """This array if it is on ``context``, else a copy there (ref:
        NDArray.as_in_context)."""
        context = Context(context)
        if context == self.context:
            return self
        return self.copyto(context)

    as_in_ctx = as_in_context

    def as_nd_ndarray(self):
        return self

    def tostype(self, stype):
        """``'default'`` only: the sparse storage types come with a later
        slice (queue 1, "Ops and NDArray, the rest")."""
        if stype == "default":
            return self
        raise MXNetError(f"tostype({stype!r}): sparse storage is not ported "
                         "yet (ROADMAP.md queue 1, slice 9)")

    def copyto(self, other):
        """A copy on the context ``other``, or the values copied into the
        NDArray ``other`` in place (ref: NDArray.copyto); returns the copy."""
        if isinstance(other, NDArray):
            if other.shape != self.shape:
                raise MXNetError(f"copyto: shape {self.shape} into "
                                 f"{other.shape}")
            with torch.no_grad():
                other.data.copy_(self.data)
            return other
        other = Context(other)
        return NDArray(self.data.detach().to(other.torch_device(), copy=True),
                       other)

    def copy(self):
        """A copy on the same context."""
        return self.copyto(self.context)

    def astype(self, dtype, copy=True):
        """The values as ``dtype``; this array's tensor itself when it has
        the dtype already and ``copy`` is False."""
        return _call(_k_astype, self, dtype=to_torch_dtype(dtype),
                     copy=bool(copy))

    def asnumpy(self):
        """Blocking copy to the host (bfloat16 arrives as float32); a copy
        on the CPU too, so that later in-place writes leave it as it is."""
        t = self.data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        elif not t.is_cuda:
            t = t.clone()
        return t.cpu().numpy()

    def asscalar(self):
        """The value of a one-element array as a Python number (blocking)."""
        if self.data.numel() != 1:
            raise MXNetError(f"asscalar needs a one-element array, not "
                             f"shape {self.shape}")
        return self.data.detach().reshape(()).item()

    def item(self):
        return self.asscalar()

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __bool__(self):
        if self.size == 0:
            return False
        if self.size == 1:
            return bool(self.asscalar())
        raise MXNetError("ambiguous truth value of multi-element NDArray")

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of 0-d array")
        return self.shape[0]

    def wait_to_read(self):
        """Block until the work producing this array is done (ref:
        WaitToRead): synchronises the tensor's device."""
        if self.data.is_cuda:
            torch.cuda.synchronize(self.data.device)

    wait_to_write = wait_to_read

    # -- autograd -----------------------------------------------------------

    def attach_grad(self, grad_req="write", stype=None):
        """Make this array a variable with a zero gradient buffer (ref:
        NDArray.attach_grad).  An array computed under ``record()`` is
        detached from its graph first, as in MXNet."""
        from .. import autograd

        self.data = self.data.detach()
        autograd.mark_variables([self.data], [torch.zeros_like(self.data)],
                                grad_req)

    @property
    def grad(self):
        """The gradient buffer as an NDArray, or None."""
        g = self.data.grad
        return None if g is None else NDArray(g, self._ctx)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        """Run the reverse pass from this array (ref: NDArray.backward)."""
        from .. import autograd

        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph=retain_graph, train_mode=train_mode)

    def detach(self):
        """The same values, cut from the graph."""
        return NDArray(self.data.detach(), self._ctx)

    # -- arithmetic (ref: NDArray._binary, ndarray.py:367) -----------------

    def _binary(self, other, fn):
        if isinstance(other, (NDArray, torch.Tensor)):
            return _call(fn, self, other)
        if isinstance(other, (int, float, bool, np.generic)):
            return _call(fn, self, _scalar(other))
        if isinstance(other, (np.ndarray, list, tuple)):
            return _call(fn, self, array(other, ctx=self.context,
                                         dtype=self.dtype))
        return NotImplemented

    def __add__(self, o): return self._binary(o, _k_add)
    def __radd__(self, o): return self._binary(o, _k_add)
    def __sub__(self, o): return self._binary(o, _k_sub)
    def __rsub__(self, o): return self._binary(o, _k_rsub)
    def __mul__(self, o): return self._binary(o, _k_mul)
    def __rmul__(self, o): return self._binary(o, _k_mul)
    def __truediv__(self, o): return self._binary(o, _k_div)
    def __rtruediv__(self, o): return self._binary(o, _k_rdiv)
    def __mod__(self, o): return self._binary(o, _k_mod)
    def __rmod__(self, o): return self._binary(o, _k_rmod)
    def __pow__(self, o): return self._binary(o, _k_pow)
    def __rpow__(self, o): return self._binary(o, _k_rpow)
    def __neg__(self): return _call(torch.neg, self)
    def __abs__(self): return self.abs()
    def __matmul__(self, o): return self.dot(o)

    def __eq__(self, o): return self._binary(o, _k_eq)
    def __ne__(self, o): return self._binary(o, _k_ne)
    def __gt__(self, o): return self._binary(o, _k_gt)
    def __ge__(self, o): return self._binary(o, _k_ge)
    def __lt__(self, o): return self._binary(o, _k_lt)
    def __le__(self, o): return self._binary(o, _k_le)

    def __hash__(self):
        return id(self)

    # -- in-place writes: into the same tensor --------------------------------

    def _write(self, fn, *args, **attrs):
        """Run ``fn(self.data, ...)``, which writes into the tensor in
        place: outside ``record()`` with no tape; inside it, recorded by
        torch, or refused for a variable."""
        from .. import autograd

        t = self.data
        if not autograd.is_recording():
            with torch.no_grad():
                _call(fn, t, *args, **attrs)
            return
        if t.requires_grad and t.is_leaf:
            raise MXNetError(
                f"in-place write into a variable under autograd.record(): "
                f"the {_describe(self)} has attach_grad(), and torch cannot "
                "record an in-place change of a leaf it differentiates; "
                "write outside record(), or into a copy")
        _call(fn, t, *args, **attrs)

    def _inplace(self, result):
        if result is NotImplemented:
            return NotImplemented
        if result.shape != self.shape:
            raise MXNetError(f"in-place result of shape {result.shape} does "
                             f"not fit {_describe(self)}")
        self._write(torch.Tensor.copy_, result)
        return self

    def __iadd__(self, o): return self._inplace(self.__add__(o))
    def __isub__(self, o): return self._inplace(self.__sub__(o))
    def __imul__(self, o): return self._inplace(self.__mul__(o))
    def __itruediv__(self, o): return self._inplace(self.__truediv__(o))

    # -- indexing (ref: ndarray.py:413-431) -----------------------------------

    def __getitem__(self, idx):
        tree, arrays = _encode_index(idx, self.data)
        return _call(_k_getitem, self, *arrays, index=tree)

    def __setitem__(self, idx, value):
        t = self.data
        if isinstance(value, NDArray):
            value = value.data
        if isinstance(value, torch.Tensor):
            value = value.to(device=t.device, dtype=t.dtype)
            if value.untyped_storage().data_ptr() == \
                    t.untyped_storage().data_ptr():
                value = value.clone()   # a view of this array
        elif isinstance(value, (np.ndarray, list, tuple)):
            value = torch.as_tensor(np.asarray(value), dtype=t.dtype,
                                    device=t.device)
        else:
            value = _scalar(value)
        tree, arrays = _encode_index(idx, t)
        self._write(_k_setitem, value, *arrays, index=tree)

    def __iter__(self):
        for i in range(self.shape[0]):
            yield self[i]

    # -- shape (ref: ndarray.py:435-520) --------------------------------------

    def reshape(self, *shape, **kwargs):
        """With MXNet's codes 0, -1, -2, -3, -4 and ``reverse=``."""
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = kwargs.get("shape", shape)
        return _op("reshape", self, shape=tuple(shape),
                   reverse=bool(kwargs.get("reverse", False)))

    def reshape_like(self, other):
        return _op("reshape", self, shape=other.shape)

    def transpose(self, *axes, **kwargs):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return _op("transpose", self, axes=tuple(kwargs.get("axes", axes)))

    def flatten(self):
        n = self.shape[0] if self.ndim else 1
        return _op("reshape", self, shape=(n, self.size // max(n, 1)))

    def expand_dims(self, axis):
        return _op("expand_dims", self, axis=axis)

    def squeeze(self, axis=None):
        return _op("squeeze", self, axis=axis)

    def broadcast_to(self, shape):
        return _call(_k_expand, self, shape=tuple(shape))

    def broadcast_like(self, other):
        return _op("broadcast_like", self, other)

    def swapaxes(self, dim1, dim2):
        return _op("swapaxes", self, dim1=dim1, dim2=dim2)

    def split(self, num_outputs, axis=0):
        out = _op("split", self, num_outputs=num_outputs, axis=axis)
        return out[0] if len(out) == 1 else out

    def slice(self, begin, end, step=None):
        return _op("slice", self, begin=tuple(begin), end=tuple(end),
                   step=tuple(step or ()))

    def slice_axis(self, axis, begin, end):
        return _op("slice_axis", self, axis=axis, begin=begin, end=end)

    def slice_like(self, other, axes=()):
        return _op("slice_like", self, other, axes=tuple(axes))

    def take(self, indices, axis=0, mode="clip"):
        return _op("take", self, indices, axis=axis, mode=mode)

    def pick(self, index, axis=-1, keepdims=False, mode="clip"):
        return _op("pick", self, index, axis=axis, keepdims=keepdims,
                   mode=mode)

    def one_hot(self, depth, on_value=1.0, off_value=0.0):
        return _op("one_hot", self, depth=depth, on_value=on_value,
                   off_value=off_value)

    def tile(self, reps):
        return _op("tile", self, reps=reps)

    def repeat(self, repeats, axis=None):
        return _op("repeat", self, repeats=repeats, axis=axis)

    def flip(self, axis):
        return _op("flip", self, axis=axis)

    def moveaxis(self, source, destination):
        return _call(torch.movedim, self, source, destination)

    # -- reductions and math (ref: ndarray.py:575-690) ------------------------

    def sum(self, axis=None, keepdims=False, **kw):
        return _op("sum", self, axis=axis, keepdims=keepdims)

    def mean(self, axis=None, keepdims=False, **kw):
        return _op("mean", self, axis=axis, keepdims=keepdims)

    def max(self, axis=None, keepdims=False, **kw):
        return _op("max", self, axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False, **kw):
        return _op("min", self, axis=axis, keepdims=keepdims)

    def prod(self, axis=None, keepdims=False, **kw):
        return _op("prod", self, axis=axis, keepdims=keepdims)

    def norm(self, ord=2, axis=None, keepdims=False):
        return _op("norm", self, ord=ord, axis=axis, keepdims=keepdims)

    def argmax(self, axis=None, **kw):
        """Float32 indices, as MXNet's."""
        return _op("argmax", self, axis=axis)

    def argmin(self, axis=None, **kw):
        return _op("argmin", self, axis=axis)

    def clip(self, a_min=None, a_max=None):
        return _op("clip", self, a_min=a_min, a_max=a_max)

    def abs(self):
        return _call(torch.abs, self)

    def sqrt(self):
        return _op("sqrt", self)

    def exp(self):
        return _op("exp", self)

    def log(self):
        return _op("log", self)

    def sigmoid(self):
        return _op("sigmoid", self)

    def relu(self):
        return _op("relu", self)

    def softmax(self, axis=-1):
        return _op("softmax", self, axis=axis)

    def log_softmax(self, axis=-1):
        return _op("log_softmax", self, axis=axis)

    def dot(self, other):
        return _op("dot", self, other)

    def square(self):
        return _op("square", self)

    def __repr__(self):
        return (f"\n{self.asnumpy()}\n<NDArray {'x'.join(map(str, self.shape))}"
                f" @{self.context}>")


# ---------------------------------------------------------------------------
# creation (ref: ndarray.py:624-693)


def array(source_array, ctx=None, dtype=None):
    """An NDArray holding a copy of ``source_array`` on ``ctx`` (default
    :func:`current_context`); float64 sources become float32."""
    ctx = _ctx_of(ctx)
    if isinstance(source_array, NDArray):
        source_array = source_array.data
    if isinstance(source_array, torch.Tensor):
        t = source_array.detach()
        if dtype is not None:
            t = t.to(to_torch_dtype(dtype))
        return NDArray(t.to(ctx.torch_device(), copy=True), ctx)
    src = np.asarray(source_array)
    if dtype is None:
        dtype = np.float32 if src.dtype == np.float64 else src.dtype
    # ascontiguousarray makes a 0-d array 1-d: keep the source's shape
    t = torch.from_numpy(np.ascontiguousarray(
        src.astype(dtype, copy=False))).reshape(src.shape)
    return NDArray(t.to(ctx.torch_device(), copy=True), ctx)


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _filled(make, shape, ctx, dtype):
    ctx = _ctx_of(ctx)
    return NDArray(make(_shape(shape), dtype=to_torch_dtype(dtype),
                        device=ctx.torch_device()), ctx)


def zeros(shape, ctx=None, dtype=None, **kwargs):
    return _filled(torch.zeros, shape, ctx, dtype)


def ones(shape, ctx=None, dtype=None, **kwargs):
    return _filled(torch.ones, shape, ctx, dtype)


def empty(shape, ctx=None, dtype=None):
    """Zeros, as the JAX package's."""
    return zeros(shape, ctx=ctx, dtype=dtype)


def full(shape, val, ctx=None, dtype=None):
    ctx = _ctx_of(ctx)
    return NDArray(torch.full(_shape(shape), val, dtype=to_torch_dtype(dtype),
                              device=ctx.torch_device()), ctx)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    """``start, start + step, ...`` below ``stop``, each ``repeat`` times.
    Given a ``torch.device`` as ``ctx`` (the ``F.arange`` of
    ``hybrid_forward``), the tensor itself."""
    from ..ops import registry

    t = registry.get("arange")(start, stop, step, dtype=dtype,
                               ctx=ctx if isinstance(ctx, torch.device)
                               else _ctx_of(ctx))
    if repeat > 1:
        t = torch.repeat_interleave(t, int(repeat))
    if isinstance(ctx, torch.device):
        return t
    return NDArray(t, _ctx_of(ctx))


def zeros_like(other, **kw):
    """Zeros of ``other``'s shape, dtype and context (a tensor for a
    tensor)."""
    if isinstance(other, torch.Tensor):
        return torch.zeros_like(other)
    return NDArray(torch.zeros_like(other.data), other._ctx)


def ones_like(other, **kw):
    if isinstance(other, torch.Tensor):
        return torch.ones_like(other)
    return NDArray(torch.ones_like(other.data), other._ctx)


def eye(N, M=0, k=0, ctx=None, dtype=None):
    ctx = _ctx_of(ctx)
    dev = ctx.torch_device()
    M = M or N
    t = (torch.arange(M, device=dev)[None, :]
         - torch.arange(N, device=dev)[:, None]) == k
    return NDArray(t.to(to_torch_dtype(dtype)), ctx)


def linspace(start, stop, num, endpoint=True, ctx=None, dtype=None):
    ctx = _ctx_of(ctx)
    dt = to_torch_dtype(dtype)
    if endpoint:
        t = torch.linspace(start, stop, num, dtype=torch.float64)
    else:
        t = torch.linspace(start, stop, num + 1, dtype=torch.float64)[:-1]
    return NDArray(t.to(dt).to(ctx.torch_device()), ctx)


def histogram(a, bins=10, range=None):
    """``(counts, bin_edges)`` as numpy's, the counts in float32 as the
    JAX package's (ref: mx.nd.histogram): ``bins`` is a count (over
    ``range``, default the data's min and max) or the edges themselves;
    the last bin holds its right edge."""
    x = as_tensor(a).detach().reshape(-1).float()
    if not isinstance(bins, int):
        edges = as_tensor(bins)
        edges = torch.as_tensor(edges if isinstance(edges, torch.Tensor)
                                else np.asarray(edges), dtype=torch.float32,
                                device=x.device)
    else:
        if range is None:
            lo, hi = x.min(), x.max()
        else:
            lo, hi = (torch.tensor(float(v), device=x.device) for v in range)
        same = hi == lo
        lo, hi = torch.where(same, lo - 0.5, lo), torch.where(same, hi + 0.5,
                                                              hi)
        edges = lo + (hi - lo) * torch.linspace(0, 1, bins + 1,
                                                device=x.device)
    n = edges.numel() - 1
    idx = torch.bucketize(x, edges, right=True) - 1
    idx = torch.where(x == edges[-1], n - 1, idx)
    keep = (idx >= 0) & (idx < n)
    counts = torch.bincount(idx[keep], minlength=n).to(torch.float32)
    ctx = a.context if isinstance(a, NDArray) else None
    return NDArray(counts, ctx), NDArray(edges, ctx)


def concatenate(arrays, axis=0):
    return _op("concat", *arrays, dim=axis)


def moveaxis(x, source, destination):
    return x.moveaxis(source, destination)


def waitall():
    """Block until every device's queued work is done (ref: mx.nd.waitall)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
