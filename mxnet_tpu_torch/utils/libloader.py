"""Shared native-library loader (ref: ``mxnet_tpu/utils/libloader.py``).

One cached find / build / CDLL path for the host-side C++ components the
port shares with the JAX package, ``libmxtpu_engine.so``,
``libmxtpu_storage.so`` and ``libmxtpu_io.so`` (``src/engine.cc``,
``src/storage.cc``, ``src/recordio.cc``, which links libjpeg).  The
repository root is found from this file's own path.  ``lib/<so>`` (what
the repository's ``Makefile`` builds) loads as it is when it is newer than
``src/``; otherwise the same source is built with the ``Makefile``'s
flags into ``mxnet_tpu_torch/_build/native/`` (git-ignored), under a file
lock and through an atomic rename, so concurrent processes never load a
half-written library and never race the JAX package's ``make`` on
``lib/``.  Why a library is unavailable (the compiler's or the dynamic
loader's own message) is kept: :func:`load_error`."""
from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import threading

from ..base import getenv

_cache = {}  # so_name -> CDLL | None (None = tried and unavailable)
_errors = {}  # so_name -> why it is unavailable
_lock = threading.Lock()
# the Makefile's CXXFLAGS, and each library's source and link flags
_CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]
_SOURCES = {"libmxtpu_engine.so": ("engine.cc", []),
            "libmxtpu_storage.so": ("storage.cc", []),
            "libmxtpu_io.so": ("recordio.cc", ["-ljpeg"])}


def repo_root():
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _stale(so, root):
    """True when any ``src/*.{cc,h,cpp}`` is newer than the built .so: a
    stale binary would run an old C ABI under new ctypes signatures."""
    if not os.path.exists(so):
        return True
    so_mtime = os.path.getmtime(so)
    src = os.path.join(root, "src")
    try:
        for f in os.listdir(src):
            if f.endswith((".cc", ".h", ".cpp")) and \
                    os.path.getmtime(os.path.join(src, f)) > so_mtime:
                return True
    except OSError:
        pass
    return False


def _build(so_name, root):
    """Build ``src/<source>`` into ``mxnet_tpu_torch/_build/native/`` and
    return the path, or None when it cannot be built (the reason in
    ``_errors``)."""
    source_name, link = _SOURCES[so_name]
    source = os.path.join(root, "src", source_name)
    out_dir = os.path.join(root, "mxnet_tpu_torch", "_build", "native")
    target = os.path.join(out_dir, so_name)
    if not _stale(target, root):
        return target
    if not os.path.exists(source):
        _errors[so_name] = f"{source} is missing"
        return None
    if not shutil.which("g++"):
        _errors[so_name] = "g++ is not on PATH"
        return None
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _stale(target, root):
            tmp = f"{target}.{os.getpid()}.tmp"
            try:
                subprocess.run(["g++", *_CXXFLAGS, source, "-o", tmp, *link],
                               check=True, capture_output=True, text=True,
                               timeout=120)
                os.replace(tmp, target)
            except subprocess.CalledProcessError as e:
                _errors[so_name] = (f"g++ {source_name} failed: "
                                    f"{(e.stderr or '').strip()}")
                return None
            except Exception as e:  # noqa: BLE001 - kept as the reason
                _errors[so_name] = f"g++ {source_name} failed: {e!r}"
                return None
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
    return target


def load_native_lib(so_name):
    """The CDLL of ``so_name`` (``lib/`` when fresh, else built as the
    module docstring says), or None when native code is unavailable or
    disabled (``MXTPU_NO_NATIVE=1``)."""
    if getenv("NO_NATIVE", False, bool):
        return None  # the env wins over the cache (tests toggle it)
    with _lock:
        if so_name in _cache:
            return _cache[so_name]
        _cache[so_name] = None
        root = repo_root()
        so = os.path.join(root, "lib", so_name)
        if _stale(so, root):
            so = _build(so_name, root)
        if so is None:
            return None
        try:
            _cache[so_name] = ctypes.CDLL(so)
        except OSError as e:
            _errors[so_name] = f"loading {so} failed: {e}"
            return None
        return _cache[so_name]


def load_error(so_name):
    """Why ``so_name`` did not load (the build's or the loader's message),
    or None when it loaded or was not tried; ``MXTPU_NO_NATIVE=1`` says
    so."""
    if getenv("NO_NATIVE", False, bool):
        return "disabled by MXTPU_NO_NATIVE=1"
    return _errors.get(so_name)
