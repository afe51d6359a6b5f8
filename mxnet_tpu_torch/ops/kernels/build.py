"""Build the port's CUDA kernels from the sources in the checkout.

Each ``mxnet_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface and
loaded with ``ctypes``; headers under ``csrc/`` (``*.cuh``) hold device
code that several sources include.  Nothing is built at import: a kernel
library builds at its first launch (or ahead of time through
:func:`build_all`, one ``nvcc`` per source, all started together).
Libraries go to ``mxnet_tpu_torch/_build/``, named by a hash of the
source, the headers and the flags, so an edited source is rebuilt;
``.gitignore`` lists the directory.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from ...base import MXNetError

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path():
    """``nvcc`` from PATH, else ``$CUDA_HOME/bin`` (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise MXNetError("nvcc not found: the CUDA kernels are built on a "
                     "machine with the CUDA toolkit")


class KernelLibrary:
    """One ``csrc/<source>`` compiled to a ctypes-loaded shared library.

    ``build_log`` holds nvcc's output (``-Xptxas -v``: registers, shared
    memory and spills per kernel) once the library is built."""

    def __init__(self, source):
        self.source = CSRC_DIR / source
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    def _target(self):
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC_DIR.glob("*.cuh")):  # shared device code
            h.update(header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.source.stem}-{h.hexdigest()[:12]}.so"

    def start_build(self):
        """Start nvcc for this library, unless it is already built;
        returns the process (or None) for :meth:`finish_build`."""
        target = self._target()
        if target.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    def finish_build(self, proc):
        """Wait for ``proc`` (from :meth:`start_build`) and install its output."""
        target = self._target()
        if proc is None:
            log = target.with_suffix(".log")
            self.build_log = log.read_text() if log.exists() else ""
            return target
        out, _ = proc.communicate()
        self.build_log = out
        tmp = Path(proc.args[proc.args.index("-o") + 1])
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise MXNetError(f"nvcc failed for {self.source.name} "
                             f"(exit {proc.returncode}):\n{out}")
        target.with_suffix(".log").write_text(out)
        os.replace(tmp, target)
        return target

    def load(self):
        """The loaded ``ctypes.CDLL``, building it first if needed."""
        with self._lock:
            if self._lib is None:
                path = self.finish_build(self.start_build())
                self._lib = ctypes.CDLL(str(path))
                fn = self._lib.mxtt_cuda_error_string
                fn.argtypes = [ctypes.c_int]
                fn.restype = ctypes.c_char_p
            return self._lib

    def raise_on_error(self, err, what):
        """Raise :class:`MXNetError` for a non-zero ``cudaError_t`` that a
        launch function of this library returned."""
        if err != 0:
            msg = self.load().mxtt_cuda_error_string(err).decode()
            raise MXNetError(f"{what} kernel launch failed: {msg} "
                             f"(cudaError {err})")


class KernelCounts:
    """Launch counters of one kernel wrapper.

    ``launches`` grows by one per call that launches the kernel.
    ``plain_calls_on_cuda`` grows by one each time an entry sends CUDA
    tensors to the plain version by one of the JAX package's shape rules,
    decided before any launch.  ``extra`` names further counters, such as
    a wrapper's launches on one of its routes."""

    def __init__(self, *extra):
        self._lock = threading.Lock()
        self._names = ("launches", "plain_calls_on_cuda", *extra)
        self.reset()

    def add(self, name):
        with self._lock:
            setattr(self, name, getattr(self, name) + 1)

    def reset(self):
        with self._lock:
            for name in self._names:
                setattr(self, name, 0)


def build_all(libraries):
    """Build every library in ``libraries`` in parallel and load each."""
    procs = []
    try:
        for lib in libraries:
            procs.append((lib, lib.start_build()))
        for lib, proc in procs:
            lib.finish_build(proc)
    finally:  # a failed build stops the others
        for _, proc in procs:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
    for lib in libraries:
        lib.load()
