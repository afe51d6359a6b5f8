"""NDArray: the public array boundary over a ``torch.Tensor``.

Ref: include/mxnet/ndarray.h.  Inside blocks and ops the port computes
on plain ``torch.Tensor``s; ``NDArray`` is kept only where the MXNet
surface hands arrays to and from user code (``nd.array``,
``.asnumpy()``, ``.wait_to_read()``, ``.context``), as ``ModelServer``
does, and where the training loop touches them (``attach_grad``,
``.grad``, ``.backward()``, ``detach``, ``asscalar``).  The tensor is
``.data``.
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


def _device_of(ctx):
    return (ctx or current_context()).torch_device()


class NDArray:
    """An n-dimensional array on a device, wrapping ``data``, a tensor."""

    __slots__ = ("data", "__weakref__")

    def __init__(self, data):
        if not isinstance(data, torch.Tensor):
            raise MXNetError(f"NDArray wraps a torch.Tensor, got {type(data)}")
        self.data = data

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
        return Context.from_device(self.data.device)

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
        return None if g is None else NDArray(g)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        """Run the reverse pass from this array (ref: NDArray.backward)."""
        from .. import autograd

        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph=retain_graph, train_mode=train_mode)

    def detach(self):
        """The same values, cut from the graph."""
        return NDArray(self.data.detach())

    def __repr__(self):
        return (f"\n{self.asnumpy()}\n<NDArray {'x'.join(map(str, self.shape))}"
                f" @{self.context}>")


def array(source_array, ctx=None, dtype=None):
    """An NDArray holding a copy of ``source_array`` on ``ctx`` (default
    :func:`current_context`); float64 sources become float32."""
    if isinstance(source_array, NDArray):
        source_array = source_array.data
    if isinstance(source_array, torch.Tensor):
        t = source_array
        if dtype is not None:
            t = t.to(to_torch_dtype(dtype))
        return NDArray(t.to(_device_of(ctx), copy=True))
    src = np.asarray(source_array)
    if dtype is None:
        dtype = np.float32 if src.dtype == np.float64 else src.dtype
    # ascontiguousarray makes a 0-d array 1-d: keep the source's shape
    t = torch.from_numpy(np.ascontiguousarray(
        src.astype(dtype, copy=False))).reshape(src.shape)
    return NDArray(t.to(_device_of(ctx), copy=True))


def zeros(shape, ctx=None, dtype=None):
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return NDArray(torch.zeros(shape, dtype=to_torch_dtype(dtype),
                               device=_device_of(ctx)))


def arange(start, stop=None, step=1.0, ctx=None, dtype=None):
    if stop is None:
        start, stop = 0, start
    return NDArray(torch.arange(start, stop, step,
                                dtype=to_torch_dtype(dtype),
                                device=_device_of(ctx)))
