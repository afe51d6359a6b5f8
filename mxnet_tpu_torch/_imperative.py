"""The NDArray boundary of an imperative call (ref: mxnet_tpu/_imperative.py
``invoke``).

Blocks and ops compute on ``torch.Tensor``s.  A call that arrives with
NDArray inputs (user code, ``ModelServer``) is unwrapped here, and its
tensor outputs are wrapped back, keeping the nesting of tuples and lists.

It also keeps the process's dispatch counters of the captured training
step (ref: ``compiled_executable_count`` and ``device_dispatch_count``):
the step signatures seen for the first time (on any device), the steps
dispatched as one unit (a CUDA-graph replay on the card, the step body on
the CPU), and the CUDA graphs captured and replayed.
"""
from __future__ import annotations

import threading

import torch

from .ndarray.ndarray import NDArray


def _wrap(out):
    if isinstance(out, torch.Tensor):
        return NDArray(out)
    if isinstance(out, (list, tuple)):
        return type(out)(_wrap(o) for o in out)
    return out


def invoke(fn, *args):
    """Call ``fn`` on the tensors inside NDArray ``args``; return NDArray
    outputs when any input was an NDArray, else ``fn``'s own outputs."""
    boundary = any(isinstance(a, NDArray) for a in args)
    if not boundary:
        return fn(*args)
    out = fn(*(a.data if isinstance(a, NDArray) else a for a in args))
    return _wrap(out)


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
