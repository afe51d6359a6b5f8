"""Host-side execution engine (ref: ``mxnet_tpu/engine.py``; MXNet's
src/engine/threaded_engine.{h,cc}, naive_engine.cc and
include/mxnet/engine.h).

CUDA streams order the device's work, so what survives of MXNet's
threaded engine is host-side scheduling: (a) a *naive/sync* mode for
debugging (``MXTPU_ENGINE_TYPE=NaiveEngine``), (b) ``waitall`` and
``wait_for_var`` barriers, (c) a host pool and the native C++ dependency
engine (``src/engine.cc``: ThreadedVar RAW/WAR/WAW) for host work, with
FIFO lanes per (context, kind) (:class:`Stream`), and (d)
:func:`batched_put`, one submission that stages a batch's arrays in
pinned host memory and copies them to a CUDA device on a copy stream.

The JAX package's live-buffer list for ``waitall`` (``track``) has no
counterpart: ``waitall`` synchronises the CUDA devices instead, so its
``_compact_live`` race is not copied.  Fault points
(:func:`fault_point`) are no-op hooks until ``resilience.faults`` arms a
plan (``install_plan`` or ``MXTPU_FAULT_PLAN``).
"""
from __future__ import annotations

import atexit
import concurrent.futures
import threading

import numpy as np
import torch

from .base import MXNetError, getenv

# 'ThreadedEngine' (async, default) or 'NaiveEngine' (every op synchronous)
_engine_type = getenv("ENGINE_TYPE", "ThreadedEngine")


def engine_type():
    return _engine_type


def set_engine_type(name):
    """Switch between async ('ThreadedEngine') and sync ('NaiveEngine')."""
    global _engine_type
    assert name in ("ThreadedEngine", "NaiveEngine"), name
    _engine_type = name


def is_naive():
    return _engine_type == "NaiveEngine"


def waitall():
    """Block until all outstanding host ops and device work complete (ref:
    Engine::WaitForAll / mx.nd.waitall()); errors of the device work
    surface here."""
    if _native is not None:
        _native.wait_all()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def wait_for_var(var):
    """Ref: Engine::WaitForVar.  An engine variable (an int from
    :func:`new_variable`): block until every op pushed on it has run; an
    array (NDArray or tensor): block until the work producing it on its
    device is done."""
    if isinstance(var, (int, np.integer)):
        eng = native_engine()
        if eng is None:
            raise MXNetError("wait_for_var on an engine variable needs the "
                             "native engine (lib/libmxtpu_engine.so)")
        eng.wait_for_var(int(var))
        return
    t = getattr(var, "data", var)
    if isinstance(t, torch.Tensor) and t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()


# ---------------------------------------------------------------------------
# Host-side scheduling: overlap host work (batch building, checkpoint
# writes, H2D staging) with device steps.  Backed by the native C++
# dependency engine (src/engine.cc) when built; a plain thread pool
# otherwise.

_pool = None
_pool_lock = threading.Lock()
_native = None
_native_tried = False
_native_lock = threading.Lock()


def host_pool():
    global _pool
    with _pool_lock:
        if _pool is None:
            n = getenv("CPU_WORKER_NTHREADS", 4, int)
            _pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=n, thread_name_prefix="mxtpu-host-worker")
        return _pool


def native_engine():
    """The C++ threaded engine, or None when unavailable."""
    global _native, _native_tried
    with _native_lock:
        if _native is None and not _native_tried:
            _native_tried = True
            try:
                from .utils import native_engine as ne

                if ne.load() is not None:
                    _native = ne.NativeEngine()
                    # C++ workers must not call back into Python during
                    # interpreter finalization: drain and free first
                    atexit.register(_shutdown_native)
            except Exception:
                _native = None
        return _native


def _shutdown_native():
    global _native
    if _native is not None:
        _native.close()
        _native = None


def _sync_future(fn, *args, **kwargs):
    f = concurrent.futures.Future()
    try:
        f.set_result(fn(*args, **kwargs))
    except BaseException as e:  # noqa: BLE001 - mirror future semantics
        f.set_exception(e)
    return f


def new_variable():
    """Engine variable for dependency-tracked host ops (ref: NewVariable)."""
    eng = native_engine()
    if eng is None:
        raise MXNetError("engine variables need the native engine "
                         "(lib/libmxtpu_engine.so)")
    return eng.new_variable()


def push(fn, const_vars=(), mutable_vars=()):
    """Push host work with explicit read/write variable dependencies (ref:
    PushAsync): concurrent readers, exclusive writers, FIFO grants per
    variable.  Runs synchronously when the native library is missing
    (correct, not overlapped)."""
    if is_naive():
        return push_host(fn)
    eng = native_engine()
    if eng is None:
        return _sync_future(fn)
    return eng.push(fn, const_vars, mutable_vars)


def push_host(fn, *args, **kwargs):
    """Run host work asynchronously (ref: Engine::PushAsync on a CPU
    context); returns a future."""
    if is_naive():
        return _sync_future(fn, *args, **kwargs)
    eng = native_engine()
    if eng is not None:
        return eng.push(lambda: fn(*args, **kwargs))
    return host_pool().submit(fn, *args, **kwargs)


# ---------------------------------------------------------------------------
# Streams (ref: src/engine/stream_manager.h): per-(context, kind) FIFO
# lanes of host work, so H2D staging, D2H reads and IO ordering overlap
# each other while staying ordered within themselves.  A lane is one
# mutable variable of the native engine (its per-variable FIFO grant is
# the order; distinct variables run in parallel), else a single-thread
# executor of its own.


class Stream:
    """One FIFO lane.  Ops pushed to the same stream run in push order;
    different streams run concurrently."""

    def __init__(self, name):
        self.name = name
        eng = native_engine()
        if eng is not None:
            self._var = eng.new_variable()
            self._exec = None
        else:
            self._var = None
            self._exec = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix=f"mxtpu-stream-{name}")

    def push(self, fn, *args, **kwargs):
        """Enqueue fn on this lane; returns a future."""
        if is_naive():
            return _sync_future(fn, *args, **kwargs)
        if self._var is not None:
            return native_engine().push(
                lambda: fn(*args, **kwargs), (), (self._var,))
        return self._exec.submit(fn, *args, **kwargs)

    def wait(self):
        """Block until everything pushed so far has run (ref: Stream::Wait,
        a lane-local barrier, unlike waitall)."""
        self.push(lambda: None).result()


class StreamManager:
    """Per-(context, kind) lane registry.  Kinds: 'h2d' (host-to-device
    staging), 'd2h' (checkpoint and eval reads), 'io' (decode output
    order), 'aux' (anything else)."""

    _KINDS = ("h2d", "d2h", "io", "aux")

    def __init__(self):
        self._streams = {}
        self._mu = threading.Lock()

    def get(self, ctx=None, kind="h2d"):
        if kind not in self._KINDS:
            raise ValueError(f"unknown stream kind {kind!r}; "
                             f"valid: {self._KINDS}")
        key = (str(ctx), kind)
        with self._mu:
            s = self._streams.get(key)
            if s is None:
                s = self._streams[key] = Stream(f"{ctx}-{kind}")
            return s


_stream_manager = None
_stream_manager_lock = threading.Lock()


def stream_manager():
    global _stream_manager
    with _stream_manager_lock:
        if _stream_manager is None:
            _stream_manager = StreamManager()
        return _stream_manager


def d2h_stream(ctx=None):
    """The device-to-host lane of ``ctx``."""
    return stream_manager().get(ctx, "d2h")


def h2d_stream(ctx=None):
    """The host-to-device lane of ``ctx``: the pipeline's device prefetcher
    builds and stages batches here (a pull and a :func:`batched_put` a
    batch, FIFO within the lane)."""
    return stream_manager().get(ctx, "h2d")


# ---------------------------------------------------------------------------
# Flat-buffer helpers (ref: engine.py:308-390, the fused trainer step and
# ZeRO's flat buckets): many same-dtype tensors packed into one flat
# buffer and back, as torch ops.


def flatten_arrays(tensors):
    """Pack same-device, same-dtype tensors into one flat buffer."""
    tensors = list(tensors)
    if len(tensors) == 1:
        return tensors[0].reshape(-1).clone()
    return torch.cat([t.reshape(-1) for t in tensors])


def unflatten_array(flat, shapes):
    """Inverse of :func:`flatten_arrays`: views of ``flat`` reshaped to
    ``shapes``."""
    outs, off = [], 0
    for shp in shapes:
        n = 1
        for s in shp:
            n *= int(s)
        outs.append(flat[off:off + n].reshape(tuple(int(s) for s in shp)))
        off += n
    return outs


def flatten_pad(tensors, padded):
    """:func:`flatten_arrays` zero-padded to ``padded`` elements (ZeRO's
    flat buckets: a multiple of the world size)."""
    flat = flatten_arrays(tensors)
    pad = int(padded) - flat.shape[0]
    if pad <= 0:
        return flat
    return torch.cat([flat, flat.new_zeros(pad)])


def slice_flat(flat, start, size):
    """The ``[start, start + size)`` window of a flat buffer."""
    return flat[int(start):int(start) + int(size)]


# ---------------------------------------------------------------------------
# Host-to-device transfers


_copy_streams = {}
_copy_streams_lock = threading.Lock()


def copy_stream(device):
    """The side stream host-to-device copies of ``device`` run on."""
    device = torch.device(device)
    with _copy_streams_lock:
        s = _copy_streams.get(device)
        if s is None:
            s = _copy_streams[device] = torch.cuda.Stream(device)
        return s


def _host_tensor(a):
    """A CPU tensor over a leaf (numpy array, CPU tensor or NDArray)."""
    t = getattr(a, "data", a) if not isinstance(a, np.ndarray) else a
    if isinstance(t, torch.Tensor):
        return t.detach()
    return torch.from_numpy(np.ascontiguousarray(t))


class StagedBatch(list):
    """The tensors of one :func:`batched_put`, with the CUDA event recorded
    on the copy stream after their copies (None for a CPU destination).
    :meth:`wait` makes a stream (default: the calling thread's current
    stream of the device) wait for the event and marks the tensors as
    used by that stream (``record_stream``), so the allocator does not
    hand their memory to the next copy while that stream still reads
    them.  Read the tensors only after :meth:`wait`."""

    event = None
    device = None

    def wait(self, stream=None):
        if self.event is None:
            return self
        stream = stream or torch.cuda.current_stream(self.device)
        stream.wait_event(self.event)
        for t in self:
            t.record_stream(stream)
        return self


def batched_put(arrays, device, wait=True):
    """One transfer submission moving every array of ``arrays`` to
    ``device`` (ref: ``engine.batched_put``, CopyFromTo batched per
    destination); returns a :class:`StagedBatch`.

    To a CUDA device: each host array is copied into pinned staging memory
    from :class:`~mxnet_tpu_torch.storage.Storage`, then to the device
    with ``non_blocking`` copies on :func:`copy_stream`; one event is
    recorded after them, and the staging blocks return to the pool only
    once it has completed.  With ``wait`` the calling thread's current
    stream waits for it at once; a producer on another thread passes
    ``wait=False`` and the consumer calls :meth:`StagedBatch.wait`.  A
    tensor already on the device is handed through as it is.  To the CPU:
    copies.  No fallback: a CUDA destination without a CUDA device
    raises."""
    from .context import Context
    from .storage import Storage

    if isinstance(device, Context):
        device = device.torch_device()
    device = torch.device(device)
    fault_point("engine.h2d", n=len(arrays), device=str(device))
    out = StagedBatch()
    out.device = device
    if device.type != "cuda":
        out.extend(_host_tensor(a).to(device, copy=True) for a in arrays)
        return out
    if not torch.cuda.is_available():
        raise MXNetError(f"batched_put to {device}: no CUDA device is "
                         "visible")
    store = Storage.get()
    stream = copy_stream(device)
    handles = []
    with torch.cuda.stream(stream):
        for a in arrays:
            src = _host_tensor(a)
            if src.is_cuda:
                if src.device != device:  # after its producer's work
                    stream.wait_stream(torch.cuda.current_stream(src.device))
                    src = src.to(device, non_blocking=True)
                out.append(src)
                continue
            h = store.alloc(src.numel() * src.element_size(), ctx=device)
            handles.append(h)
            staged = h.tensor(src.dtype, src.shape)
            staged.copy_(src)
            dst = torch.empty(src.shape, dtype=src.dtype, device=device)
            dst.copy_(staged, non_blocking=True)
            out.append(dst)
        ev = torch.cuda.Event()
        ev.record(stream)
    out.event = ev
    for h in handles:
        store.free(h, after=ev)
    if wait:
        out.wait()
    return out


# ---------------------------------------------------------------------------
# Fault points (``resilience.faults``' chaos-injection sites: transfers,
# collectives, checkpoint commits, pipeline map batches).  The default
# binding is a no-op; ``resilience.faults.install_plan`` rebinds the
# global through set_fault_dispatcher, and callers look it up as
# ``engine.fault_point(...)`` so they see the current binding.
# ``MXTPU_FAULT_PLAN`` (JSON, inline or a file path) arms a plan at the
# first fire without import-order coupling.


def _fault_noop(site, /, **ctx):
    """Disarmed fault point: nothing beyond the call is evaluated."""
    return None


fault_point = _fault_noop


def set_fault_dispatcher(fn):
    """Rebind the fault-point hook (``None`` restores the no-op)."""
    global fault_point
    fault_point = _fault_noop if fn is None else fn


def fault_points_armed():
    return fault_point is not _fault_noop


if getenv("FAULT_PLAN"):
    def _fault_bootstrap(site, /, **ctx):
        # first fire installs the env plan (lazy: resilience imports
        # engine, so the import must not happen at engine-import time),
        # which rebinds `fault_point`; dispatch through the new binding
        from .resilience import faults

        faults.install_from_env()
        return fault_point(site, **ctx)

    fault_point = _fault_bootstrap
