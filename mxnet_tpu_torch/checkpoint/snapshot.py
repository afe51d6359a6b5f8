"""Copies of live tensors for an asynchronous save.

The port updates weights, optimizer states and moving statistics in
place: a captured step writes them at every replay.  So a save cannot
hold references to them, as the JAX package does with its immutable
arrays (``mxnet_tpu/checkpoint/manager.py:21-25``): the next step would
overwrite what the save has not written yet.  A :class:`Snapshot` copies
them instead, in two parts:

- :meth:`Snapshot.take`, on the caller's thread, copies each CUDA tensor
  on the current stream into a device buffer the snapshot keeps between
  saves, and records an event after the copies.  A step queued after it
  cannot change the copy, and this is all the caller pays.  CPU tensors
  are copied there and then.
- :meth:`Pending.fetch`, on a writer thread, has a side stream wait for
  that event and copy the buffers into pinned host memory, also kept
  between saves, and returns the tree with CPU tensors in place of the
  device ones.

The buffers are reused, so one snapshot is in flight at a time: ``take``
waits for the previous fetch to finish.
"""
from __future__ import annotations

import concurrent.futures
import threading

import numpy as np
import torch

from ..ndarray.ndarray import NDArray


def writer():
    """A background thread that serialises and commits saves, one at a
    time (each saver owns one)."""
    return concurrent.futures.ThreadPoolExecutor(
        max_workers=1, thread_name_prefix="mxtt-checkpoint")


def _flatten(tree, path, out):
    """Replace each tensor leaf of ``tree`` by its path; collect
    ``(path, tensor)`` in ``out``."""
    if isinstance(tree, NDArray):
        tree = tree.data
    if isinstance(tree, torch.Tensor):
        out.append((path, tree.detach()))
        return _Leaf(path)
    if isinstance(tree, dict):
        return {k: _flatten(v, path + (k,), out) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_flatten(v, path + (i,), out)
                          for i, v in enumerate(tree))
    return tree


def _unflatten(tree, values):
    if isinstance(tree, _Leaf):
        return values[tree.path]
    if isinstance(tree, dict):
        return {k: _unflatten(v, values) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, values) for v in tree)
    return tree


def host_leaves(tree, copy=True):
    """``tree`` with numpy leaves in place of tensors and NDArrays, as a
    pickle holds them (no torch object, so the JAX package reads it);
    bfloat16 is widened to float32, which holds it exactly.  ``copy=False``
    lets a leaf share a CPU tensor's memory."""
    if isinstance(tree, NDArray):
        tree = tree.data
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        a = t.cpu().numpy()
        return np.array(a) if copy else a
    if isinstance(tree, dict):
        return {k: host_leaves(v, copy) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_leaves(v, copy) for v in tree)
    return tree


class _Leaf:
    __slots__ = ("path",)

    def __init__(self, path):
        self.path = path


def _kept(store, path, like, make):
    """The buffer kept at ``path``, made anew when ``like``'s shape or
    dtype changed."""
    buf = store.get(path)
    if buf is None or buf.shape != like.shape or buf.dtype != like.dtype:
        buf = store[path] = make()
    return buf


class Snapshot:
    """Device and pinned host buffers kept between saves (module
    docstring)."""

    def __init__(self):
        self._device = {}
        self._host = {}
        self._streams = {}
        self._pending = None

    def take(self, tree):
        """Copy the tensors of ``tree`` (nested dicts, lists and tuples;
        tensor or NDArray leaves) as they are now; returns a
        :class:`Pending` whose :meth:`~Pending.fetch` gives them on the
        host."""
        if self._pending is not None:
            self._pending.fetch()
        leaves = []
        shape = _flatten(tree, (), leaves)
        host, on_card, srcs = {}, {}, {}
        for path, t in leaves:
            if t.is_cuda:
                buf = _kept(self._device, (t.device, path), t,
                            lambda t=t: torch.empty_like(
                                t, memory_format=torch.contiguous_format))
                on_card.setdefault(t.device, []).append((path, buf))
                srcs.setdefault(t.device, []).append(t)
            else:
                host[path] = t.clone()
        events = {}
        for dev, bufs in on_card.items():
            # one multi-tensor call a device: a few launches, not one a
            # tensor, while the caller waits
            torch._foreach_copy_([b for _, b in bufs], srcs[dev])
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            events[dev] = ev
        self._pending = Pending(self, shape, host, on_card, events)
        return self._pending

    def _stream(self, dev):
        if dev not in self._streams:
            self._streams[dev] = torch.cuda.Stream(dev)
        return self._streams[dev]


class Pending:
    """One snapshot on its way to the host."""

    def __init__(self, owner, shape, host, on_card, events):
        self._owner = owner
        self._shape = shape
        self._host = host
        self._on_card = on_card
        self._events = events
        self._lock = threading.Lock()

    def fetch(self):
        """The snapshot with CPU tensors (the pinned buffers, valid until
        the next snapshot is fetched); the first call runs the
        device-to-host copies."""
        with self._lock:
            for dev, bufs in self._on_card.items():
                side = self._owner._stream(dev)
                side.wait_event(self._events[dev])
                for path, buf in bufs:
                    self._host[path] = _kept(
                        self._owner._host, path, buf,
                        lambda b=buf: torch.empty(b.shape, dtype=b.dtype,
                                                  pin_memory=True))
                with torch.cuda.stream(side):
                    torch._foreach_copy_([self._host[p] for p, _ in bufs],
                                         [b for _, b in bufs],
                                         non_blocking=True)
                side.synchronize()
            self._on_card = {}
        return _unflatten(self._shape, self._host)
