"""BatchNorm statistics: the Hopper kernel, its plain version, its wrapper.

Replaces ``_stats_kernel`` of ``mxnet_tpu/ops/pallas/batch_norm.py`` with
``csrc/batch_norm.cu``: per-channel ``(sum, sumsq)`` in fp32 of an
``(M, C)`` channel-last activation, read once, in one launch.  The
source's header says what bounds it on an H100 and how it is built.

- :func:`bn_stats_plain` is the same function in plain PyTorch: the CPU
  path, and what the kernel is held against on the card.
- :func:`bn_stats_fwd` is the wrapper.  It dispatches on the tensor's
  device alone: a CPU tensor takes the plain version, a CUDA tensor
  launches the kernel or raises for what the kernel does not take.  Its
  launch plan (:func:`row_blocks`) is cached per device and shape, so a
  call costs one allocation (the sums and the partials in one buffer) and
  one ctypes call.  A 16-byte aligned tensor whose C is a multiple of 8
  (bf16, fp16) or 4 (fp32) takes 16-byte loads; any other takes the
  kernel's scalar route, counted in ``counts.scalar_launches``.  A float16
  launch also counts in ``counts.float16_launches``.
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

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: channels a 16-byte load reads, by dtype code
_VEC = (4, 8, 8)
# the kernel's shape (csrc/batch_norm.cu: kThreads, kStrip, kUnroll)
THREADS, STRIP, UNROLL = 512, 64, 8
counts = KernelCounts("scalar_launches", "float16_launches")
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


def row_groups(code, vec):
    """Row groups of a block: its threads over the threads along a strip
    of 64 channels (64, 32 with 16-byte loads of bf16 or fp16, fp32; 8 on
    the scalar route)."""
    return THREADS * (_VEC[code] if vec else 1) // STRIP


def row_blocks(M, C, groups, resident):
    """P, the blocks along M: ``resident`` blocks (SMs x blocks an SM)
    shared over the ``ceil(C / 64)`` strips, so all P x strips blocks run
    at once, and no more than gives each thread of ``groups`` row groups a
    full unrolled load of rows."""
    strips = -(-C // STRIP)
    return max(1, min(resident // strips, -(-M // (groups * UNROLL))))


_fn = None
_raw_stream = None
_plans = {}  # (device, M, C, dtype code, vec) -> plan
_tickets = {}  # device -> the kernel's int32 strip counters


def _bind():
    global _fn, _raw_stream
    lib = library.load()
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mxtt_bn_stats_occupancy.argtypes = [i, i, i, ctypes.POINTER(i)]
    lib.mxtt_bn_stats_occupancy.restype = i
    fn = lib.mxtt_bn_stats
    fn.argtypes = [p, p, p, ll, i, ll, i, i, i, p]
    fn.restype = i
    _raw_stream = torch._C._cuda_getCurrentRawStream  # device -> stream
    _fn = fn


def _plan(key):
    """The launch plan of ``key``: ``(P, the offset of the sums in the
    output buffer, the device's strip counters, the device)``, for a grid
    of the kernel's resident blocks (the SMs times its occupancy, one
    block an SM at its 82-128 registers a thread).  The counters are
    zeroed once and kept for the process (a captured graph holds their
    address), so the first launch of a device, or of a C wider than its
    counters, must come before any CUDA-graph capture."""
    if _fn is None:
        _bind()
    idx, M, C, code, vec = key
    dev = torch.device("cuda", idx)
    blocks = ctypes.c_int()
    library.raise_on_error(library.load().mxtt_bn_stats_occupancy(
        code, vec, idx, ctypes.byref(blocks)), "bn_stats occupancy")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    P = row_blocks(M, C, row_groups(code, vec), sms * blocks.value)
    strips = -(-C // STRIP)
    tickets = _tickets.get(idx)
    if tickets is None or tickets.numel() < strips:
        if torch.cuda.is_current_stream_capturing():
            raise MXNetError(f"bn_stats: call the kernel once on {dev} at "
                             f"C={C} before capturing a CUDA graph (its "
                             f"counters are allocated and zeroed then)")
        tickets = _tickets[idx] = torch.zeros(max(1024, strips),
                                              dtype=torch.int32, device=dev)
    # the output buffer: the partials (strips, 2, P, 64), then sum and sumsq
    got = _plans[key] = (P, strips * 2 * P * STRIP, tickets, dev)
    return got


def _plan_of(x2d, code):
    """``(key, plan)`` of a launch on ``x2d``, a contiguous (M, C) CUDA
    tensor of dtype ``code``: 16-byte loads (vec) where its pointer is
    16-byte aligned and C a multiple of the channels a load reads."""
    M, C = x2d.shape
    vec = int(x2d.data_ptr() % 16 == 0 and C % _VEC[code] == 0)
    key = (x2d.get_device(), M, C, code, vec)
    return key, _plans.get(key) or _plan(key)


def launch_plan(x2d):
    """``(P, vec, row groups)`` of a launch on the CUDA tensor ``x2d``: the
    blocks along M, whether it takes 16-byte loads, and its row groups
    (what a model of the kernel's summation order needs)."""
    code = _DTYPE_CODES[x2d.dtype]
    key, plan = _plan_of(x2d, code)
    return plan[0], key[4], row_groups(code, key[4])


def bn_stats_fwd(x2d):
    """``(sum, sumsq)`` of ``x2d`` as :func:`bn_stats_plain`.

    A CPU tensor takes the plain version.  A CUDA tensor launches the
    kernel on the current stream (one launch: the partial sums of row
    blocks and their fixed-order sum), or raises :class:`MXNetError` for
    what it does not take (not 2-D, not contiguous, no channels, dtype
    other than float32, bfloat16 or float16) and for a failed launch."""
    if not x2d.is_cuda:
        return bn_stats_plain(x2d)
    if x2d.dim() != 2 or not x2d.is_contiguous():
        raise MXNetError(f"bn_stats kernel takes a contiguous (M, C) tensor, "
                         f"got shape {tuple(x2d.shape)} strides "
                         f"{x2d.stride()}")
    code = _DTYPE_CODES.get(x2d.dtype)
    if code is None:
        raise MXNetError(f"bn_stats kernel takes float32, bfloat16 or "
                         f"float16, not {x2d.dtype}")
    if x2d.shape[1] < 1:
        raise MXNetError("bn_stats kernel takes C >= 1 channels")
    (idx, M, C, _, vec), (P, n, tickets, dev) = _plan_of(x2d, code)
    out = torch.empty(n + 2 * C, dtype=torch.float32, device=dev)
    err = _fn(x2d.data_ptr(), out.data_ptr(), tickets.data_ptr(), M, C, P,
              code, vec, idx, _raw_stream(idx))
    if err:
        library.raise_on_error(err, "bn_stats")
    counts.add("launches", *(() if vec else ("scalar_launches",)),
               *(("float16_launches",) if code == 2 else ()))
    return out[n:n + C], out[n + C:]


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
