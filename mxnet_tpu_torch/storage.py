"""Host-staging storage manager — ``mx.storage`` (ref:
``mxnet_tpu/storage.py``; include/mxnet/storage.h
``Storage::Get()->Alloc/Free/DirectFree`` and
src/storage/pooled_storage_manager.h).

A staging block's kind is decided by its destination alone:

- bound for a CUDA device (``alloc(n, ctx=gpu(i))``): pinned (page-locked)
  host memory, so a ``non_blocking`` copy to the card is a real DMA that
  overlaps the device's work.  Blocks are pooled by size; a block freed
  with ``after=<CUDA event>`` (the event of the copy that reads it)
  returns to its pool only once that event has completed, so the next
  batch cannot overwrite it while the copy still runs.
- bound for the CPU (the default): the native pool of ``src/storage.cc``
  (``lib/libmxtpu_storage.so``: size-class free lists over 64-byte-aligned
  memory), else plain numpy memory.

Pool policy of the native pool via ``MXTPU_MEM_POOL_TYPE``: Pooled
(default) | RoundedMany | Unpooled.
"""
from __future__ import annotations

import collections
import ctypes
import threading

import numpy as np
import torch

from .base import MXNetError, getenv
from .utils.libloader import load_native_lib

_POOL_TYPES = {"Pooled": 0, "Round": 0, "RoundedMany": 1, "Naive": 0,
               "Unpooled": 2}
_sigs_done = False
# pinned blocks are rounded up to a multiple of this, so batches of one
# shape reuse one block
_PINNED_ROUND = 1 << 16


def _load_native():
    global _sigs_done
    lib = load_native_lib("libmxtpu_storage.so")
    if lib is None or _sigs_done:
        return lib
    _sigs_done = True
    lib.MXTPUStorageCreate.restype = ctypes.c_void_p
    lib.MXTPUStorageCreate.argtypes = [ctypes.c_int]
    lib.MXTPUStorageAlloc.restype = ctypes.c_void_p
    lib.MXTPUStorageAlloc.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    for name in ("MXTPUStorageFree", "MXTPUStorageDirectFree"):
        getattr(lib, name).restype = None
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.MXTPUStorageReleaseAll.restype = None
    lib.MXTPUStorageReleaseAll.argtypes = [ctypes.c_void_p]
    lib.MXTPUStorageDestroy.restype = None
    lib.MXTPUStorageDestroy.argtypes = [ctypes.c_void_p]
    for name in ("MXTPUStorageUsedBytes", "MXTPUStoragePoolBytes",
                 "MXTPUStorageHits", "MXTPUStorageMisses"):
        getattr(lib, name).restype = ctypes.c_uint64
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    return lib


def _is_cuda(ctx):
    """Is the destination ``ctx`` (a Context, torch.device or string) a
    CUDA device?"""
    if ctx is None:
        return False
    dtype = getattr(ctx, "device_type", None)
    if dtype is not None:
        return dtype == "gpu"
    return torch.device(ctx).type == "cuda"


class Handle:
    """An allocation handle (ref: Storage::Handle).  ``pinned`` handles
    own a pinned torch tensor (``_block``)."""

    __slots__ = ("ptr", "size", "_owner", "_block", "pinned")

    def __init__(self, ptr, size, owner, block=None):
        self.ptr = ptr
        self.size = size
        self._owner = owner
        self._block = block
        self.pinned = block is not None and block.is_pinned()

    def as_numpy(self, dtype=np.uint8):
        """Zero-copy numpy view over the staged buffer.

        The view aliases pooled memory: it must NOT outlive
        ``Storage.free(handle)``, after which the pool may hand the block
        to another batch.  Copy it first if the data must persist."""
        if self.ptr is None:
            raise MXNetError("as_numpy on a freed storage handle")
        dt = np.dtype(dtype)
        count = self.size // dt.itemsize
        buf = (ctypes.c_uint8 * self.size).from_address(self.ptr)
        return np.frombuffer(buf, dtype=dt, count=count)

    def tensor(self, dtype=torch.uint8, shape=None):
        """A torch view of the first bytes of the block as ``dtype`` in
        ``shape`` (default: the whole block, flat); the same lifetime rule
        as :meth:`as_numpy`."""
        if self.ptr is None:
            raise MXNetError("tensor on a freed storage handle")
        if self._block is not None:
            raw = self._block[:self.size]
        else:
            raw = torch.from_numpy(self.as_numpy(np.uint8))
        if shape is None:
            return raw.view(dtype)
        n = 1
        for s in shape:
            n *= int(s)
        item = torch.empty((), dtype=dtype).element_size()
        return raw[:n * item].view(dtype).view(tuple(shape))


class Storage:
    """Singleton staging allocator (ref: Storage::Get())."""

    _instance = None
    _instance_lock = threading.Lock()

    def __init__(self):
        self._lib = _load_native()
        pool_name = getenv("MEM_POOL_TYPE", "Pooled")
        if pool_name not in _POOL_TYPES:
            raise MXNetError(
                f"unknown MXTPU_MEM_POOL_TYPE {pool_name!r}; "
                f"one of {sorted(_POOL_TYPES)}")
        self._pool_type = _POOL_TYPES[pool_name]
        self._handle = (self._lib.MXTPUStorageCreate(self._pool_type)
                        if self._lib is not None else None)
        self._py_live = {}  # fallback: ptr -> numpy buffer
        self._mu = threading.Lock()
        # pinned pool: rounded size -> free blocks; blocks waiting for
        # the event of the copy that reads them; counters
        self._pinned_free = collections.defaultdict(list)
        self._pinned_waiting = []
        self._pinned = {"live": 0, "pooled": 0, "hits": 0, "misses": 0}

    @classmethod
    def get(cls):
        # the first callers are concurrent prefetch workers: one pool only
        if cls._instance is None:
            with cls._instance_lock:
                if cls._instance is None:
                    cls._instance = cls()
        return cls._instance

    @property
    def native(self):
        return self._handle is not None

    def alloc(self, nbytes, ctx=None):
        """A block of ``nbytes`` staging memory for the destination
        ``ctx``: pinned for a CUDA device, the native pool (or numpy)
        otherwise."""
        if nbytes < 0:
            raise MXNetError("negative allocation size")
        if _is_cuda(ctx):
            return self._alloc_pinned(int(nbytes))
        if self._handle is not None:
            p = self._lib.MXTPUStorageAlloc(self._handle, nbytes)
            if not p and nbytes:
                raise MXNetError(f"staging allocation of {nbytes}B failed")
            return Handle(p, nbytes, self)
        buf = np.empty(nbytes, np.uint8)
        h = Handle(buf.ctypes.data, nbytes, self)
        with self._mu:
            self._py_live[h.ptr] = buf
        return h

    def _reap(self):
        """Return the blocks whose copies have completed to the pool."""
        still = []
        for ev, rounded, block in self._pinned_waiting:
            if ev.query():
                self._pinned_free[rounded].append(block)
            else:
                still.append((ev, rounded, block))
        self._pinned_waiting = still

    def _alloc_pinned(self, nbytes):
        rounded = max(_PINNED_ROUND, -(-nbytes // _PINNED_ROUND)
                      * _PINNED_ROUND)
        with self._mu:
            self._reap()
            free = self._pinned_free.get(rounded)
            if free:
                block = free.pop()
                self._pinned["hits"] += 1
                self._pinned["pooled"] -= rounded
            else:
                block = None
                self._pinned["misses"] += 1
            self._pinned["live"] += rounded
        if block is None:
            block = torch.empty(rounded, dtype=torch.uint8, pin_memory=True)
        return Handle(block.data_ptr(), nbytes, self, block)

    @staticmethod
    def _free_impl(handle, native_fn, after=None):
        # always into the handle's OWNING pool (a handle may outlive a
        # Storage-instance swap); a double free is a no-op
        owner = handle._owner
        if handle.ptr is None:
            return
        if handle._block is not None:
            block = handle._block
            rounded = block.numel()
            with owner._mu:
                owner._pinned["live"] -= rounded
                if native_fn == "MXTPUStorageDirectFree":
                    pass  # dropped: torch's host allocator takes it back
                elif after is not None:
                    owner._pinned["pooled"] += rounded
                    owner._pinned_waiting.append((after, rounded, block))
                else:
                    owner._pinned["pooled"] += rounded
                    owner._pinned_free[rounded].append(block)
            handle._block = None
        elif owner._handle is not None:
            getattr(owner._lib, native_fn)(owner._handle, handle.ptr)
        else:
            with owner._mu:
                owner._py_live.pop(handle.ptr, None)
        handle.ptr = None

    def free(self, handle, after=None):
        """Return to the pool (ref: Storage::Free).  ``after``, a CUDA event,
        holds a pinned block out of the pool until it has completed."""
        self._free_impl(handle, "MXTPUStorageFree", after)

    def direct_free(self, handle):
        """Bypass the pool (ref: Storage::DirectFree)."""
        self._free_impl(handle, "MXTPUStorageDirectFree")

    def release_all(self):
        if self._handle is not None:
            self._lib.MXTPUStorageReleaseAll(self._handle)
        with self._mu:
            for ev, _, _ in self._pinned_waiting:
                ev.synchronize()
            self._pinned_waiting = []
            self._pinned_free.clear()
            self._pinned["pooled"] = 0

    def stats(self):
        with self._mu:
            self._reap()
            pinned = {"pinned_" + k: v for k, v in self._pinned.items()}
            if self._handle is None:
                return {"native": False,
                        "used_bytes": sum(b.nbytes
                                          for b in self._py_live.values()),
                        **pinned}
        return {
            "native": True,
            "used_bytes": self._lib.MXTPUStorageUsedBytes(self._handle),
            "pool_bytes": self._lib.MXTPUStoragePoolBytes(self._handle),
            "hits": self._lib.MXTPUStorageHits(self._handle),
            "misses": self._lib.MXTPUStorageMisses(self._handle),
            **pinned,
        }
