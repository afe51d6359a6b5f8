"""Imperative autograd on ``torch.autograd`` (ref: python/mxnet/autograd.py;
``mxnet_tpu/autograd.py`` in the JAX package).

``record()`` turns gradient tracking on for the blocks called inside it
(outside ``record`` every block runs under ``torch.no_grad``), and the
recording scopes set PyTorch's grad mode to match.  torch's graph is the
tape.

A *variable* is a leaf tensor with a gradient buffer and a ``grad_req``:
a Parameter's value (``grad_req`` other than ``'null'``) or an array
after ``attach_grad()``.  :func:`backward` takes the gradients of every
live variable with ``torch.autograd.grad`` and deposits them as MXNet
does (ref: ``_deposit``), not as torch accumulates into ``.grad``:

- ``'write'`` overwrites the buffer, so two backward passes in a row give
  the same gradient;
- ``'add'`` adds to it, so they give twice the gradient;
- a variable the backward does not reach keeps its previous gradient.

The buffer is updated in place, so a reference to it stays valid.
"""
from __future__ import annotations

import threading
import weakref

import torch

from .base import MXNetError
from .ndarray.ndarray import as_tensor as _tensor

_state = threading.local()

#: live variables: id(tensor) -> tensor, each with ``_mx_grad_req``
_variables = weakref.WeakValueDictionary()
_variables_lock = threading.Lock()


def _st():
    if not hasattr(_state, "recording"):
        _state.recording = False
        _state.training = False
    return _state


# ---------------------------------------------------------------------------
# Scopes (ref: record/pause/train_mode/predict_mode)


class _RecordingScope:
    """Sets the training flag, and the recording flag with PyTorch's grad
    mode to match (None keeps a flag as it is), restoring them on exit."""

    def __init__(self, recording, training):
        self._rec, self._train = recording, training

    def __enter__(self):
        st = _st()
        rec = st.recording if self._rec is None else self._rec
        train = st.training if self._train is None else self._train
        self._old = (st.recording, st.training, torch.is_grad_enabled())
        st.recording, st.training = rec, train
        if self._rec is not None:
            torch.set_grad_enabled(rec)
        return self

    def __exit__(self, *exc):
        st = _st()
        st.recording, st.training, grad_mode = self._old
        torch.set_grad_enabled(grad_mode)


def record(train_mode=True):
    return _RecordingScope(True, train_mode)


def pause(train_mode=False):
    return _RecordingScope(False, train_mode)


def train_mode():
    return _RecordingScope(None, True)


def predict_mode():
    return _RecordingScope(None, False)


def is_recording():
    return _st().recording


def is_training():
    return _st().training


def set_recording(is_rec):
    """Set the recording flag; returns the previous one."""
    st = _st()
    prev, st.recording = st.recording, bool(is_rec)
    return prev


def set_training(train):
    """Set the training flag; returns the previous one."""
    st = _st()
    prev, st.training = st.training, bool(train)
    return prev


# ---------------------------------------------------------------------------
# Variables


def mark_variables(variables, gradients, grad_reqs="write"):
    """Make each of ``variables`` (leaf tensors or NDArrays) a variable
    whose gradient lands in the matching buffer of ``gradients`` (ref:
    autograd.mark_variables).  ``'null'`` unmarks it."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        t = _tensor(v)
        if req not in ("write", "add", "null"):
            raise MXNetError(f"grad_req must be 'write', 'add' or 'null', "
                             f"not {req!r}")
        if t.grad_fn is not None:
            raise MXNetError("mark_variables takes leaf arrays; detach() "
                             "an array computed under record() first")
        with _variables_lock:
            if req == "null":
                t.requires_grad_(False)
                t.grad = None
                _variables.pop(id(t), None)
                continue
            t.requires_grad_(True)
            t.grad = _tensor(g)
            t._mx_grad_req = req
            t._mx_fresh_grad = False
            _variables[id(t)] = t


def _live_variables():
    with _variables_lock:
        return [t for t in list(_variables.values()) if t.requires_grad]


# ---------------------------------------------------------------------------
# Backward


def _heads_and_seeds(heads, head_grads):
    from .ndarray.ndarray import NDArray

    if isinstance(heads, (NDArray, torch.Tensor)):
        heads = [heads]
    if head_grads is not None and not isinstance(head_grads, (list, tuple)):
        head_grads = [head_grads]
    outs, seeds = [], []
    for i, h in enumerate(heads):
        t = _tensor(h)
        if not t.requires_grad:
            continue  # not computed from any variable under record()
        hg = None if head_grads is None else head_grads[i]
        outs.append(t)
        seeds.append(torch.ones_like(t) if hg is None
                     else torch.as_tensor(_tensor(hg), dtype=t.dtype,
                                          device=t.device))
    if not outs:
        raise MXNetError("cannot differentiate: no head was computed under "
                         "autograd.record() from a variable with a gradient")
    return outs, seeds


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Run the reverse pass from ``heads`` (ref: autograd.backward) and
    deposit each live variable's gradient by its ``grad_req``."""
    outs, seeds = _heads_and_seeds(heads, head_grads)
    variables = _live_variables()
    if not variables:
        return
    grads = torch.autograd.grad(outs, variables, seeds,
                                retain_graph=bool(retain_graph),
                                allow_unused=True)
    write, write_src, add, add_src = [], [], [], []
    with torch.no_grad():
        for t, g in zip(variables, grads):
            if g is None:
                continue  # not reached: the previous gradient stays
            t._mx_fresh_grad = True
            if t.grad is None:
                t.grad = g.detach().clone()
            elif t._mx_grad_req == "add":
                add.append(t.grad)
                add_src.append(g)
            else:
                write.append(t.grad)
                write_src.append(g)
        if write:
            torch._foreach_copy_(write, write_src)
        if add:
            torch._foreach_add_(add, add_src)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables``, without
    touching any gradient buffer (ref: autograd.grad, first order).  A
    variable the heads do not reach gets zeros.  NDArray variables give
    NDArray gradients."""
    from .ndarray.ndarray import NDArray

    if create_graph:
        raise MXNetError("autograd.grad(create_graph=True) is not ported "
                         "yet; higher-order gradients come with a later "
                         "slice (ROADMAP.md queue 1)")
    if isinstance(variables, (NDArray, torch.Tensor)):
        variables = [variables]
    outs, seeds = _heads_and_seeds(heads, head_grads)
    ts = [_tensor(v) for v in variables]
    gs = torch.autograd.grad(outs, ts, seeds,
                             retain_graph=bool(retain_graph),
                             allow_unused=True)
    res = [torch.zeros_like(t) if g is None else g.detach()
           for t, g in zip(ts, gs)]
    return [NDArray(g) if isinstance(v, NDArray) else g
            for v, g in zip(variables, res)]


# ---------------------------------------------------------------------------
# Custom differentiable functions (ref: autograd.Function)


class _FunctionAdapter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fn, *inputs):
        ctx.fn = fn
        with pause():
            outs = fn.forward(*inputs)
        ctx.multi = isinstance(outs, (tuple, list))
        return tuple(outs) if ctx.multi else outs

    @staticmethod
    def backward(ctx, *out_grads):
        with pause():
            gs = ctx.fn.backward(*out_grads)
        if not isinstance(gs, (tuple, list)):
            gs = (gs,)
        return (None, *(_tensor(g) for g in gs))


class Function:
    """User-defined op with its own forward and backward (ref:
    autograd.Function).

    Subclass and implement ``forward(self, *inputs)`` and
    ``backward(self, *output_grads)``.  Both receive and return tensors
    (blocks compute on tensors in this port); ``save_for_backward`` keeps
    what ``backward`` reads in ``saved_tensors``.  Called with NDArrays,
    the outputs come back as NDArrays."""

    def __init__(self):
        self.saved_tensors = ()

    def save_for_backward(self, *arrays):
        self.saved_tensors = arrays

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray
        from ._imperative import invoke

        if any(isinstance(a, NDArray) for a in inputs):
            return invoke(self.__call__, *inputs)
        return _FunctionAdapter.apply(self, *inputs)

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError
