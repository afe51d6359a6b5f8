"""The ``mx.nd`` op namespace: one wrapper per registered op (ref:
``mxnet_tpu/ndarray/ops.py:61-128``).

``mx.nd`` is also the ``F`` that ``hybrid_forward`` receives, where the
ops take and give plain tensors.  So a wrapper decides with one scan of
its arguments:

- no NDArray among them: the registered function itself, called with the
  arguments as given (tensors in, tensors out, no copy and no
  synchronisation, so a CUDA-graph capture holds it).  An op that takes no
  array (``arange``, the ``_random_*`` draws) belongs to ``F`` when its
  ``ctx`` is a ``torch.device``, as blocks pass it; with a Context, or
  none, it returns an NDArray on that context (default
  :func:`current_context`);
- an NDArray among them: the imperative call.  Array inputs may come by
  keyword (``arg_names``); scalars and numpy arrays in an array slot
  become arrays of the first NDArray's dtype (numpy arrays keep theirs)
  on its device; attributes are normalised as a graph keeps them
  (``symbol._norm_attr``); ops that take ``_train`` get the autograd
  scope's training flag; ``out=`` receives the first output in place;
  an op that updates auxiliary states (BatchNorm's moving statistics,
  ``mutate_aux``) commits them into those NDArrays in place and returns
  only its primary outputs.  Positional arguments past the array slots
  pass through as attributes (``nd.one_hot(x, 10)``,
  ``nd.slice_axis(x, 1, 0, 2)``).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import autograd
from .ndarray import NDArray, _call, _ctx_of, array


def _coerce(a, first):
    if a is None or isinstance(a, (NDArray, torch.Tensor)):
        return a
    if isinstance(a, (np.ndarray, list, tuple)):
        return array(a, ctx=first.context)
    if isinstance(a, (int, float, bool, np.generic)):
        return NDArray(torch.tensor(a, dtype=first.data.dtype,
                                    device=first.data.device), first._ctx)
    return a


def _has_ndarray(args, kwargs):
    for a in args:
        if isinstance(a, NDArray):
            return True
    for a in kwargs.values():
        if isinstance(a, NDArray):
            return True
    return False


def make_op_wrapper(entry):
    """The ``mx.nd`` function of the registry entry ``entry``."""
    from ..symbol.symbol import _norm_attr

    fn = entry.fn
    creates = not entry.arg_names and not entry.variadic
    n_slots = len(entry.arg_names)

    def wrapper(*args, **kwargs):
        if not _has_ndarray(args, kwargs):
            if not creates or isinstance(kwargs.get("ctx"), torch.device):
                return fn(*args, **kwargs)
            kwargs.pop("name", None)
            ctx = _ctx_of(kwargs.pop("ctx", None))
            return NDArray(fn(*args, ctx=ctx, **{k: _norm_attr(v) for k, v
                                                 in kwargs.items()}), ctx)
        out_arr = kwargs.pop("out", None)
        kwargs.pop("name", None)
        arrays = list(args)
        for k in list(kwargs):
            if k in entry.arg_names:
                i = entry.arg_names.index(k)
                arrays.extend([None] * (i + 1 - len(arrays)))
                arrays[i] = kwargs.pop(k)
        first = next(a for a in arrays + list(kwargs.values())
                     if isinstance(a, NDArray))
        n = len(arrays) if entry.variadic else min(n_slots, len(arrays))
        arrays[:n] = [_coerce(a, first) for a in arrays[:n]]
        attrs = {k: v.data if isinstance(v, NDArray) else _norm_attr(v)
                 for k, v in kwargs.items()}
        if entry.takes_train:
            attrs.setdefault("_train", autograd.is_training())
        res = _call(fn, *arrays, **attrs)
        if entry.mutate_aux and isinstance(res, tuple):
            with torch.no_grad():
                for in_idx, out_idx in entry.mutate_aux:
                    if in_idx < len(arrays) and \
                            isinstance(arrays[in_idx], NDArray):
                        arrays[in_idx].data.copy_(res[out_idx].data)
            n_primary = len(res) - len(entry.mutate_aux)
            res = res[0] if n_primary == 1 else res[:n_primary]
        if out_arr is not None:
            out_arr[:] = res[0] if isinstance(res, tuple) else res
            return out_arr
        if isinstance(res, tuple) and len(res) == 1:
            return res[0]
        return res

    wrapper.__name__ = wrapper.__qualname__ = entry.name
    wrapper.__doc__ = fn.__doc__
    return wrapper


_wrappers = {}


def get(name):
    """The ``mx.nd`` wrapper of the op registered as ``name`` (an alias
    gives its op's wrapper)."""
    from ..ops import registry

    entry = registry.entry(name)
    w = _wrappers.get(entry.name)
    if w is None:
        w = _wrappers[entry.name] = make_op_wrapper(entry)
    return w
