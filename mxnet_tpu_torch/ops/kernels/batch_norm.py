"""BatchNorm statistics: the Hopper kernel, its plain version, its wrapper.

Replaces ``_stats_kernel`` of ``mxnet_tpu/ops/pallas/batch_norm.py`` with
``csrc/batch_norm.cu``: per-channel ``(sum, sumsq)`` in fp32 of an
``(M, C)`` channel-last activation, read once.  The source's header says
what bounds it on an H100 and how it is built.

- :func:`bn_stats_plain` is the same function in plain PyTorch: the CPU
  path, and what the kernel is held against on the card.
- :func:`bn_stats_fwd` is the wrapper.  It dispatches on the tensor's
  device alone: a CPU tensor takes the plain version, a CUDA tensor
  launches the kernel or raises for what the kernel does not take.
- :class:`BnStatsFunction` is its ``torch.autograd.Function``, with the
  JAX package's backward ``dx = ds + 2*x*dq`` (``_bn_stats_bwd``).
- :func:`bn_stats` is the entry the ops call (ref: the ``jax.custom_vjp``
  ``bn_stats``).  As the JAX package's ops do, it sends a shape that
  :func:`stats_supported` refuses to the plain sums before any launch; on
  CUDA tensors such a call counts in ``counts.plain_calls_on_cuda``.
"""
from __future__ import annotations

import ctypes

import torch

from ...base import MXNetError
from .build import KernelCounts, KernelLibrary

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: row slabs are sized for about 8 blocks of the first launch per SM
_TARGET_BLOCKS = 8 * 132

counts = KernelCounts()
library = KernelLibrary("batch_norm.cu")


def _block_rows(M, C):
    """Ref: ``_block_rows`` (``ops/pallas/batch_norm.py:23``), the TPU
    kernel's VMEM budget, kept only as the gate's rule."""
    budget = 2 * 1024 * 1024
    for bm in (8192, 4096, 2048, 1024, 512, 256, 128, 64, 32, 16, 8):
        if M % bm == 0 and bm * C * 4 <= budget:
            return bm
    return None


def stats_supported(M, C):
    """The JAX package's gate (``stats_supported``, ``ops/pallas/
    batch_norm.py:84``): True when its kernel takes an ``(M, C)`` input."""
    return C % 8 == 0 and _block_rows(M, C) is not None


def bn_stats_plain(x2d):
    """Plain PyTorch version of the kernel: ``(sum[C], sumsq[C])`` fp32."""
    xf = x2d.float()
    return xf.sum(dim=0), (xf * xf).sum(dim=0)


def _bind(lib):
    fn = lib.mxtt_bn_stats
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, ctypes.c_longlong, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def bn_stats_fwd(x2d):
    """``(sum, sumsq)`` of ``x2d`` as :func:`bn_stats_plain`.

    A CPU tensor takes the plain version.  A CUDA tensor launches the
    kernel on the current stream (two launches: partial sums per row slab,
    then their fixed-order sum), or raises :class:`MXNetError` for what it
    does not take (not 2-D, not contiguous, dtype other than float32 or
    bfloat16) and for a failed launch."""
    if not x2d.is_cuda:
        return bn_stats_plain(x2d)
    if x2d.dim() != 2 or not x2d.is_contiguous():
        raise MXNetError(f"bn_stats kernel takes a contiguous (M, C) tensor, "
                         f"got shape {tuple(x2d.shape)} strides "
                         f"{x2d.stride()}")
    if x2d.dtype not in _DTYPE_CODES:
        raise MXNetError(f"bn_stats kernel takes float32 or bfloat16, not "
                         f"{x2d.dtype}")
    M, C = x2d.shape
    strips = -(-C // 64)
    slabs = max(1, min(-(-M // 256), -(-_TARGET_BLOCKS // strips)))
    part = torch.empty((2, slabs, C), dtype=torch.float32, device=x2d.device)
    s = torch.empty(C, dtype=torch.float32, device=x2d.device)
    q = torch.empty(C, dtype=torch.float32, device=x2d.device)
    fn = _bind(library.load())
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        err = fn(x2d.data_ptr(), part.data_ptr(), s.data_ptr(), q.data_ptr(),
                 M, C, slabs, _DTYPE_CODES[x2d.dtype], stream)
    library.raise_on_error(err, "bn_stats")
    counts.add("launches")
    return s, q


class BnStatsFunction(torch.autograd.Function):
    """:func:`bn_stats_fwd` for autograd; the backward is the JAX
    package's ``_bn_stats_bwd`` (``ops/pallas/batch_norm.py:74``):
    ``dx = ds + 2*x*dq`` in fp32, in x's dtype."""

    @staticmethod
    def forward(ctx, x2d):
        ctx.save_for_backward(x2d)
        return bn_stats_fwd(x2d)

    @staticmethod
    def backward(ctx, ds, dq):
        (x2d,) = ctx.saved_tensors
        dx = ds[None, :].float() + 2.0 * x2d.float() * dq[None, :]
        return dx.to(x2d.dtype)


def bn_stats(x2d):
    """``(M, C) -> (sum[C], sumsq[C])`` fp32, differentiable (ref:
    ``bn_stats``, ``ops/pallas/batch_norm.py:64``): the kernel where
    :func:`stats_supported` takes the shape, else the plain sums."""
    if x2d.is_cuda and not stats_supported(*x2d.shape):
        counts.add("plain_calls_on_cuda")
        return bn_stats_plain(x2d)
    return BnStatsFunction.apply(x2d)
