"""mx.nd: the imperative NDArray API, and the ``F`` namespace that
``hybrid_forward`` receives (ref: ``mxnet_tpu/ndarray/__init__.py``).

Every registered op is an attribute here (``nd.relu``, ``nd.dot``,
``nd.FullyConnected``, ...), made by ``ndarray/ops.py``.  The rule that
lets one namespace serve both: a call with an NDArray argument is
imperative (NDArrays in, NDArrays out, recorded under
``autograd.record()``); a call with none is the registered function on
tensors, exactly as a block's ``hybrid_forward`` calls it.  Ops that take
no array (``arange``, the draws) return tensors when their ``ctx`` is a
``torch.device`` and NDArrays otherwise.

``contrib.X`` is the op registered as ``_contrib_X``; ``random.X`` is
``mx.random``'s sampler ``X`` where there is one, else the op
``_random_X``; ``image`` holds the functional image transforms.  The
creation helpers (``array``, ``zeros``, ``ones``, ``full``, ``arange``
with ``repeat=``, ``eye``, ``linspace``, ...), ``maximum``/``minimum``/
``power``/``hypot`` and ``waitall`` are here too.  ``save``/``load``
write and read the JAX package's ``.params`` container
(``utils.serialization``).
"""
import torch

from .. import random as _random
from ..base import MXNetError
# the legacy flat names of nd.random.normal, uniform and randint
from ..random import normal as random_normal  # noqa: F401
from ..random import randint as random_randint  # noqa: F401
from ..random import uniform as random_uniform  # noqa: F401
from .ndarray import (NDArray, arange, array, concatenate, empty,  # noqa: F401
                      eye, full, histogram, linspace, moveaxis, ones,
                      ones_like, to_torch_dtype, waitall, zeros, zeros_like)
from . import ops as _ops

_LATER = ("a later slice (ROADMAP.md queue 1, slice 9: \"Ops and NDArray, "
          "the rest\")")


def save(fname, data):
    """Save a list of arrays or a dict str -> array (ref: mx.nd.save)."""
    from ..utils import serialization

    serialization.save_ndarrays(fname, data)


def load(fname):
    """Load what :func:`save` wrote: NDArrays on the CPU, in a list or a
    dict (ref: mx.nd.load)."""
    from ..utils import serialization

    return serialization.load_ndarrays(fname)


class _OpNamespace:
    """``mx.nd.<namespace>.X`` -> the op registered as ``_<namespace>_X``
    (ref: ``mxnet_tpu/ndarray/__init__.py:17-38``)."""

    def __init__(self, namespace):
        self._namespace = namespace

    def __getattr__(self, name):
        from ..ops import registry

        if self._namespace == "contrib" and \
                name in ("foreach", "while_loop", "cond"):
            raise MXNetError(f"nd.contrib.{name} (ndarray/control_flow.py) "
                             f"is not ported yet; it comes with {_LATER}")
        key = f"_{self._namespace}_{name}"
        if not registry.exists(key):
            raise AttributeError(
                f"{self._namespace} namespace has no operator {name!r}")
        return _ops.get(key)


class _RandomNamespace(_OpNamespace):
    """``mx.nd.random``: ``mx.random``'s samplers, and the ops registered
    as ``_random_X`` for the other names."""

    _SAMPLERS = ("uniform", "normal", "randn", "randint", "poisson",
                 "exponential", "gamma", "bernoulli", "multinomial",
                 "shuffle")

    def __init__(self):
        super().__init__("random")

    def __getattr__(self, name):
        if name in self._SAMPLERS:
            return getattr(_random, name)
        return super().__getattr__(name)


class _Unported:
    def __init__(self, what):
        self._what = what

    def __getattr__(self, name):
        raise AttributeError(f"{self._what}.{name}: {self._what} is not "
                             f"ported yet; it comes with {_LATER}")


contrib = _OpNamespace("contrib")
random = _RandomNamespace()
linalg = _Unported("nd.linalg")


class _ImageNamespace:
    """mx.nd.image.X (ref: ``mxnet_tpu/ndarray/__init__.py:66-120``): the
    functional forms of the vision transforms, on NDArrays."""

    @staticmethod
    def to_tensor(src):
        """HWC (or NHWC) uint8 -> CHW (NCHW) float32 in [0, 1]."""
        x = src.data.to(torch.float32) / 255.0
        x = x.permute(2, 0, 1) if x.dim() == 3 else x.permute(0, 3, 1, 2)
        return NDArray(x.contiguous(), src._ctx)

    @staticmethod
    def normalize(src, mean=0.0, std=1.0):
        """``(src - mean) / std``, per channel of a CHW or NCHW array for
        sequences."""
        t = src.data
        mean = torch.as_tensor(mean, dtype=t.dtype, device=t.device)
        std = torch.as_tensor(std, dtype=t.dtype, device=t.device)
        if mean.dim() == 1:
            shape = (1,) * (t.dim() - 3) + (-1, 1, 1)
            mean, std = mean.reshape(shape), std.reshape(shape)
        return NDArray((t - mean) / std, src._ctx)

    @staticmethod
    def resize(src, size, keep_ratio=False, interp=1):
        from ..image.image import imresize, resize_short

        if isinstance(size, int):
            if keep_ratio:
                return resize_short(src, size, interp)
            size = (size, size)
        return imresize(src, size[0], size[1], interp)

    @staticmethod
    def crop(src, x, y, width, height):
        from ..image.image import fixed_crop

        return fixed_crop(src, x, y, width, height)

    @staticmethod
    def random_flip_left_right(src):
        """``src`` mirrored along its width axis with probability 0.5."""
        if float(_random.uniform(0, 1, shape=(1,),
                                 ctx=src.context).asscalar()) < 0.5:
            return NDArray(torch.flip(src.data, (-2,)), src._ctx)
        return src


image = _ImageNamespace()


def _binary(op_name):
    def helper(lhs, rhs):
        # a scalar beside a tensor becomes a tensor of its dtype (F path)
        if isinstance(lhs, torch.Tensor) and not isinstance(
                rhs, (torch.Tensor, NDArray)):
            rhs = torch.tensor(rhs, dtype=lhs.dtype, device=lhs.device)
        elif isinstance(rhs, torch.Tensor) and not isinstance(
                lhs, (torch.Tensor, NDArray)):
            lhs = torch.tensor(lhs, dtype=rhs.dtype, device=rhs.device)
        return _ops.get(op_name)(lhs, rhs)
    helper.__name__ = op_name.removeprefix("broadcast_")
    helper.__doc__ = (f"``{op_name}``, with scalar or array operands "
                      "(ref: mx.nd.maximum and its kin).")
    return helper


maximum = _binary("broadcast_maximum")
minimum = _binary("broadcast_minimum")
power = _binary("broadcast_power")
hypot = _binary("broadcast_hypot")


def one_hot(indices, depth=None, on_value=1.0, off_value=0.0,
            dtype="float32"):
    """``mx.nd.one_hot(indices, depth, ...)``: ``depth`` positional, as in
    MXNet's signature."""
    if depth is None:
        raise TypeError("one_hot requires depth")
    return _ops.get("one_hot")(indices, depth=int(depth), on_value=on_value,
                               off_value=off_value, dtype=dtype)


def __getattr__(name):
    # the ops register after this package is imported: their wrappers are
    # made on first use, every registered name at once (the helpers above
    # keep their names)
    from ..ops import registry

    for op_name in registry.list_ops():
        if op_name not in globals():
            globals()[op_name] = _ops.get(op_name)
    if name in globals():
        return globals()[name]
    raise AttributeError(f"mx.nd has no operator {name!r}")
