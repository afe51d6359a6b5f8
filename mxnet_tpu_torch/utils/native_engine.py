"""ctypes binding of the native dependency engine (``src/engine.cc`` ->
``lib/libmxtpu_engine.so``; ref: ``mxnet_tpu/utils/native_engine.py``).

Ref: include/mxnet/engine.h — Engine::PushAsync/NewVariable/WaitForVar/
WaitForAll, with the ThreadedVar RAW/WAR/WAW contract enforced in C++.
The port uses it for host work (batch building, the h2d lane, checkpoint
writes); device work is ordered by CUDA streams.  ``load()`` returns None
when the library is unavailable (``MXTPU_NO_NATIVE=1`` forces the pure
Python paths)."""
from __future__ import annotations

import concurrent.futures
import ctypes
import itertools
import threading

from ..base import getenv

_lib = None
_tried = False

_EngineFn = ctypes.CFUNCTYPE(None, ctypes.c_void_p)


def load():
    """The native engine library handle, or None."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    from .libloader import load_native_lib

    lib = load_native_lib("libmxtpu_engine.so")
    if lib is None:
        return None
    lib.MXTPUEngineCreate.restype = ctypes.c_void_p
    lib.MXTPUEngineCreate.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.MXTPUEngineFree.argtypes = [ctypes.c_void_p]
    lib.MXTPUEngineNewVariable.restype = ctypes.c_uint64
    lib.MXTPUEngineNewVariable.argtypes = [ctypes.c_void_p]
    lib.MXTPUEngineDeleteVariable.argtypes = [ctypes.c_void_p,
                                              ctypes.c_uint64]
    lib.MXTPUEnginePushAsync.argtypes = [
        ctypes.c_void_p, _EngineFn, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int]
    lib.MXTPUEngineWaitForVar.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.MXTPUEngineWaitForAll.argtypes = [ctypes.c_void_p]
    lib.MXTPUEngineSelfTest.restype = ctypes.c_int
    lib.MXTPUEngineSelfTest.argtypes = [ctypes.c_uint64, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int]
    _lib = lib
    return _lib


class NativeEngine:
    """Python handle on the C++ threaded engine.

    Ops are Python callables; the C++ side enforces the variables'
    dependencies and runs them on its worker pool.  Each push returns a
    Future whose result or exception comes from the callable."""

    def __init__(self, num_workers=None, naive=False):
        lib = load()
        assert lib is not None, "native engine library unavailable"
        self._lib = lib
        if num_workers is None:
            num_workers = getenv("CPU_WORKER_NTHREADS", 4, int)
        self._handle = ctypes.c_void_p(
            lib.MXTPUEngineCreate(num_workers, int(naive)))
        self._ops = {}
        self._ops_lock = threading.Lock()
        self._ids = itertools.count(1)
        # one static trampoline; ctx carries the op id, so no per-op
        # CFUNCTYPE object lifetime to manage
        self._trampoline = _EngineFn(self._run_op)

    def _run_op(self, ctx):
        with self._ops_lock:
            fn, fut = self._ops.pop(int(ctx))
        if not fut.set_running_or_notify_cancel():
            return
        try:
            fut.set_result(fn())
        except BaseException as e:  # noqa: BLE001 - future semantics
            fut.set_exception(e)

    def new_variable(self):
        return self._lib.MXTPUEngineNewVariable(self._handle)

    def delete_variable(self, var):
        self._lib.MXTPUEngineDeleteVariable(self._handle, var)

    def push(self, fn, const_vars=(), mutable_vars=()):
        fut = concurrent.futures.Future()
        op_id = next(self._ids)
        with self._ops_lock:
            self._ops[op_id] = (fn, fut)
        cv = (ctypes.c_uint64 * len(const_vars))(*const_vars)
        mv = (ctypes.c_uint64 * len(mutable_vars))(*mutable_vars)
        self._lib.MXTPUEnginePushAsync(
            self._handle, self._trampoline, ctypes.c_void_p(op_id),
            cv, len(const_vars), mv, len(mutable_vars))
        return fut

    def wait_for_var(self, var):
        self._lib.MXTPUEngineWaitForVar(self._handle, var)

    def wait_all(self):
        self._lib.MXTPUEngineWaitForAll(self._handle)

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.MXTPUEngineWaitForAll(self._handle)
            self._lib.MXTPUEngineFree(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def self_test(seed=0, n_vars=16, n_ops=2000, num_workers=8):
    """The random-DAG naive-vs-threaded equivalence check that runs inside
    the C++ library (ref: tests/cpp/engine/threaded_engine_test.cc)."""
    lib = load()
    assert lib is not None, "native engine library unavailable"
    return lib.MXTPUEngineSelfTest(seed, n_vars, n_ops, num_workers)
