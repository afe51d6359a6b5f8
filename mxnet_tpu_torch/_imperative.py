"""The NDArray boundary of an imperative call (ref: mxnet_tpu/_imperative.py
``invoke``).

Blocks and ops compute on ``torch.Tensor``s.  A call that arrives with
NDArray inputs (user code, ``ModelServer``) is unwrapped here, and its
tensor outputs are wrapped back, keeping the nesting of tuples and lists,
on the first NDArray input's context.  The outermost call also sets the
replica context (``context.replica_scope``): that NDArray's context, or
the first tensor's device, so that every block inside reads the
parameters' copies on it.

It also keeps the process's dispatch counters of the captured training
step (ref: ``compiled_executable_count`` and ``device_dispatch_count``):
the step signatures seen for the first time (on any device), the steps
dispatched as one unit (a CUDA-graph replay on the card, the step body on
the CPU), and the CUDA graphs captured and replayed.
"""
from __future__ import annotations

import threading

import torch

from .context import Context, current_replica, replica_scope
from .ndarray.ndarray import NDArray, _on


def _wrap(out, ctx):
    if isinstance(out, torch.Tensor):
        return NDArray(out, ctx if _on(out, ctx) else None)
    if isinstance(out, (list, tuple)):
        return type(out)(_wrap(o, ctx) for o in out)
    return out


def invoke(fn, *args):
    """Call ``fn`` on the tensors inside NDArray ``args``; return NDArray
    outputs when any input was an NDArray, else ``fn``'s own outputs."""
    first = next((a for a in args if isinstance(a, NDArray)), None)
    if first is None:
        if current_replica() is not None:
            return fn(*args)
        t = next((a for a in args if isinstance(a, torch.Tensor)), None)
        if t is None:
            return fn(*args)
        with replica_scope(Context.from_device(t.device)):
            return fn(*args)
    ctx = first.context
    with replica_scope(ctx):
        out = fn(*(a.data if isinstance(a, NDArray) else a for a in args))
    return _wrap(out, ctx)


_counters = {"step_signatures": 0, "step_dispatches": 0,
             "graphs_captured": 0, "graph_replays": 0}
_counters_lock = threading.Lock()


def count(name, n=1):
    """Add ``n`` to the dispatch counter ``name``."""
    with _counters_lock:
        _counters[name] += n


def dispatch_counts():
    """The dispatch counters: ``step_signatures``, ``step_dispatches``,
    ``graphs_captured`` and ``graph_replays``."""
    with _counters_lock:
        return dict(_counters)


def compiled_executable_count():
    """Step signatures seen for the first time, the port's counterpart of
    the JAX package's compiled executables: one per (step structure,
    input shapes and dtypes), on any device."""
    return dispatch_counts()["step_signatures"]


def device_dispatch_count():
    """Steps dispatched as one unit: one per captured whole step."""
    return dispatch_counts()["step_dispatches"]


def graph_capture_count():
    return dispatch_counts()["graphs_captured"]


def graph_replay_count():
    return dispatch_counts()["graph_replays"]
