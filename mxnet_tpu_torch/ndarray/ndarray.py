"""NDArray: the public array boundary over a ``torch.Tensor``.

Ref: include/mxnet/ndarray.h.  Inside blocks and ops the port computes
on plain ``torch.Tensor``s; ``NDArray`` is kept only where the MXNet
surface hands arrays to and from user code (``nd.array``,
``.asnumpy()``, ``.wait_to_read()``, ``.context``), as ``ModelServer``
does, and where the training loop touches them (``attach_grad``,
``.grad``, ``.backward()``, ``detach``, ``asscalar``).  The tensor is
``.data``.

An NDArray keeps the :class:`~mxnet_tpu_torch.context.Context` it was made
on (``array(..., ctx=)``, ``zeros``, ``as_in_context``, ``copyto``,
``gluon.utils.split_and_load``, and a block's outputs take their first
NDArray input's): the port's ``cpu(i)`` are one torch device, so
``cpu(1)`` cannot be read back from the tensor.  An NDArray made from a
bare tensor reads its context from the tensor's device (``gpu(i)`` for
``cuda:i``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from ..context import Context, current_context

__all__ = ["NDArray", "array", "zeros", "arange", "to_torch_dtype",
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


def _on(t, ctx):
    """Does tensor ``t`` live on the torch device ``ctx`` names?"""
    if ctx.device_type == "cpu":
        return not t.is_cuda
    return t.is_cuda and (t.device.index or 0) == ctx.device_id


class NDArray:
    """An n-dimensional array on a device, wrapping ``data``, a tensor, and
    the context it was made on (``ctx``; default: the tensor's device)."""

    __slots__ = ("data", "_ctx", "__weakref__")

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
    def context(self):
        if self._ctx is not None:
            return self._ctx
        return Context.from_device(self.data.device)

    ctx = context

    def as_in_context(self, context):
        """This array if it is on ``context``, else a copy there (ref:
        NDArray.as_in_context)."""
        context = Context(context)
        if context == self.context:
            return self
        return self.copyto(context)

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

    def asnumpy(self):
        """Blocking copy to the host (bfloat16 arrives as float32)."""
        t = self.data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def asscalar(self):
        """The value of a one-element array as a Python number (blocking)."""
        if self.data.numel() != 1:
            raise MXNetError(f"asscalar needs a one-element array, not "
                             f"shape {self.shape}")
        return self.data.detach().reshape(()).item()

    def wait_to_read(self):
        """Block until the work producing this array is done (ref:
        WaitToRead): synchronises the tensor's device."""
        if self.data.is_cuda:
            torch.cuda.synchronize(self.data.device)

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

    def __repr__(self):
        return (f"\n{self.asnumpy()}\n<NDArray {'x'.join(map(str, self.shape))}"
                f" @{self.context}>")


def array(source_array, ctx=None, dtype=None):
    """An NDArray holding a copy of ``source_array`` on ``ctx`` (default
    :func:`current_context`); float64 sources become float32."""
    ctx = _ctx_of(ctx)
    if isinstance(source_array, NDArray):
        source_array = source_array.data
    if isinstance(source_array, torch.Tensor):
        t = source_array
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


def zeros(shape, ctx=None, dtype=None):
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    ctx = _ctx_of(ctx)
    return NDArray(torch.zeros(shape, dtype=to_torch_dtype(dtype),
                               device=ctx.torch_device()), ctx)


def arange(start, stop=None, step=1.0, ctx=None, dtype=None):
    if stop is None:
        start, stop = 0, start
    ctx = _ctx_of(ctx)
    return NDArray(torch.arange(start, stop, step,
                                dtype=to_torch_dtype(dtype),
                                device=ctx.torch_device()), ctx)
