"""Fused 1x1-convolution + BatchNorm kernels: the Hopper kernels, their
plain versions, their wrappers.

Replaces the Pallas kernels of ``mxnet_tpu/ops/pallas/conv_fused.py`` with
the kernels of ``csrc/conv_fused.cu``, in three kinds:

- ``matmul_bn_stats`` (``_mm_stats_kernel``): ``y = x @ w`` plus the
  per-column ``(sum, sumsq)`` of the stored y;
- ``bn_act_matmul`` (``_bn_act_mm_kernel``): ``y = act(x*scale + shift)
  @ w``, the previous BatchNorm (and ReLU) applied as x is read;
- ``bn_act_matmul_stats`` (``_bn_act_mm_stats_kernel``): both at once.

x is ``(M, K)``, w ``(K, N)``, y ``(M, N)`` in x's dtype with fp32
accumulation; scale and shift are the folded BatchNorm ``(1, K)`` fp32;
the sums are ``(1, N)`` fp32.  The source's header says what bounds the
kernels on an H100 and what their design does about it.

Each kind has two routes, chosen by :func:`route` before any launch from
dtype, shape and pointer alignment: ``"tma"``, the persistent TMA/wgmma
kernel, for every bf16 call whose operands a TMA tensor map can address
(K and N multiples of 8, x, wt and y 16-byte aligned) and whose plan fits
a block's shared memory (K up to about 20,000; every ResNet-50 training
shape); ``"simple"``, the tiled template, for the rest
(fp32, ragged K or N, misaligned views).  Each launch counts in
``launches`` and, on the simple route, in ``simple_launches`` too.

For each of the three:

- ``<name>_plain`` is the same function in plain PyTorch: the CPU path,
  and what the kernel is held against on the card;
- ``<name>_fwd`` is the wrapper: a CPU tensor takes the plain version, a
  CUDA tensor launches the kernel (counted in ``<name>_counts``) or
  raises for what it does not take;
- a ``torch.autograd.Function`` joins the wrapper to the JAX package's
  backward rule (``_mm_stats_bwd``, ``_bn_act_mm_bwd``,
  ``_bn_act_mm_stats_bwd``), plain products;
- ``<name>`` is the entry the ops call.  As in the JAX package, it sends a
  shape that :func:`_tile_plan` refuses to the plain version before any
  launch; on CUDA tensors such a call counts in ``plain_calls_on_cuda``.
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

from ...base import MXNetError
from .build import KernelCounts, KernelLibrary

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KINDS = {"matmul_bn_stats": 0, "bn_act_matmul": 1, "bn_act_matmul_stats": 2}
_ROUTES = {"simple": 0, "tma": 1}  # ROUTE_SIMPLE, ROUTE_TMA in the source

matmul_bn_stats_counts = KernelCounts("simple_launches")
bn_act_matmul_counts = KernelCounts("simple_launches")
bn_act_matmul_stats_counts = KernelCounts("simple_launches")
library = KernelLibrary("conv_fused.cu")


def route(x, wt, y, has_plan=None):
    """The route of a launch on contiguous ``x (M, K)``, ``wt (N, K)`` and
    ``y (M, N)``: ``"tma"`` for bf16 with K and N multiples of 8 and all
    three 16-byte aligned (what a TMA tensor map addresses) and, where
    ``has_plan(M, K, N)`` is given, a TMA plan that fits the device; else
    ``"simple"``."""
    M, K, N = x.shape[0], x.shape[1], wt.shape[0]
    if (x.dtype == torch.bfloat16 and K % 8 == 0 and N % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in (x, wt, y))
            and (has_plan is None or has_plan(M, K, N))):
        return "tma"
    return "simple"


def _pick(total, candidates, limit_bytes, row_bytes):
    for c in candidates:
        if total % c == 0 and c * row_bytes <= limit_bytes:
            return c
    return None


def _tile_plan(M, K, N, itemsize):
    """Ref: ``_tile_plan`` (``ops/pallas/conv_fused.py:52``): the TPU
    kernels' ``(bm, bk, bn)`` within a VMEM budget, or None.  The port keeps
    it only as the gate; the Hopper kernel picks its own tiles."""
    bk = _pick(K, (512, 256, 128, 64), 2 ** 30, 1)
    bn = _pick(N, (256, 128, 64), 2 ** 30, 1)
    if bk is None or bn is None:
        return None
    bm = _pick(M, (1024, 512, 256, 128, 64, 32, 16, 8),
               2 * 1024 * 1024, bk * itemsize + bn * 4)
    if bm is None:
        return None
    return bm, bk, bn


def _gate(x, w, counts):
    """True when the kernel path is taken: on the CPU always (the wrapper
    takes the plain version there), on CUDA when :func:`_tile_plan`
    accepts the shape; otherwise count the plain call."""
    if not x.is_cuda:
        return True
    if _tile_plan(x.shape[0], x.shape[1], w.shape[1], x.element_size()):
        return True
    counts.add("plain_calls_on_cuda")
    return False


# -- plain versions ----------------------------------------------------------


def _stats(y):
    yf = y.float()
    return yf.sum(dim=0, keepdim=True), (yf * yf).sum(dim=0, keepdim=True)


def _bn_act_plain(x, scale, shift, relu):
    """``act(x*scale + shift)`` in fp32, rounded to x's dtype (ref:
    ``_bn_act_ref``)."""
    a = x.float() * scale.reshape(1, -1) + shift.reshape(1, -1)
    if relu:
        a = torch.relu(a)
    return a.to(x.dtype)


def _product(x, w):
    """``x @ w`` with fp32 accumulation, stored in x's dtype."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def matmul_bn_stats_plain(x, w):
    """``(y, sum, sumsq)``: ``y = x @ w`` and the column sums of the stored
    y (ref: ``_mm_stats_ref``)."""
    y = _product(x, w)
    return (y, *_stats(y))


def bn_act_matmul_plain(x, scale, shift, w, relu=True):
    """``y = act(x*scale + shift) @ w``."""
    return _product(_bn_act_plain(x, scale, shift, relu), w)


def bn_act_matmul_stats_plain(x, scale, shift, w, relu=True):
    """``(y, sum, sumsq)`` of ``act(x*scale + shift) @ w``."""
    return matmul_bn_stats_plain(_bn_act_plain(x, scale, shift, relu), w)


# -- the wrappers -------------------------------------------------------------


def _bind(lib):
    fn = lib.mxtt_conv_fused
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [i, i, i, p, p, p, p, p, p, p, p, ll, i, i, i, p]
        fn.restype = ctypes.c_int
        parts = lib.mxtt_conv_fused_partials
        parts.argtypes = [i, ll, i, i]
        parts.restype = ll
    return fn


def _vector(v, K, x, name):
    if v.dtype != torch.float32 or v.numel() != K or v.device != x.device:
        raise MXNetError(f"{name} must be {K} float32 values on {x.device}, "
                         f"got {v.dtype} {tuple(v.shape)} on {v.device}")
    return v.reshape(K).contiguous()


def _launch(kind, counts, x, w, scale=None, shift=None, relu=False,
            forced=None):
    """Check the operands and launch kernel ``kind`` on CUDA tensors on the
    route :func:`route` picks (or ``forced``, which only the card tests
    pass), and count the launch in ``counts``; returns ``(y, sum, sumsq)``
    (the sums None for ``bn_act_matmul``)."""
    what = kind.replace("_", " ")
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise MXNetError(f"{what}: x must be (M, K) and w (K, N), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise MXNetError(f"{what} kernel takes float32 or bfloat16 x and w of "
                         f"one dtype, got {x.dtype} and {w.dtype}")
    if w.device != x.device:
        raise MXNetError(f"{what}: w is on {w.device}, x on {x.device}")
    M, K = x.shape
    N = w.shape[1]
    if M < 1 or K < 1 or N < 1:
        raise MXNetError(f"{what} kernel needs M, K, N >= 1, got "
                         f"{(M, K, N)}")
    x = x.contiguous()
    wt = w.t().contiguous()  # (N, K): a 1x1 conv weight already is
    code = _KINDS[kind]
    if code:
        scale = _vector(scale, K, x, f"{what}: scale")
        shift = _vector(shift, K, x, f"{what}: shift")
    dev = x.device
    y = torch.empty((M, N), dtype=x.dtype, device=dev)
    lib = library.load()
    fn = _bind(lib)
    # the plans and the launch read the current device
    here = torch.cuda.current_device() == dev.index
    with contextlib.nullcontext() if here else torch.cuda.device(dev):
        chosen = route(x, wt, y, lambda *mkn: lib.mxtt_conv_fused_partials(
            _ROUTES["tma"], *mkn) > 0)
        if forced not in (None, "simple", chosen):
            raise MXNetError(f"{what}: the {forced} route takes bfloat16 "
                             f"with K and N multiples of 8, 16-byte aligned "
                             f"operands and a plan that fits, got {x.dtype} "
                             f"{(M, K, N)}")
        chosen = forced or chosen
        stats = code != 1
        if stats:
            P = lib.mxtt_conv_fused_partials(_ROUTES[chosen], M, K, N)
            # one allocation: the (2, P, N) partials, then sum and sumsq
            part = torch.empty((2 * P + 2, N), dtype=torch.float32,
                               device=dev)
            s, q = part[2 * P:2 * P + 1], part[2 * P + 1:]
        else:
            part = s = q = None

        def ptr(t):
            return None if t is None else t.data_ptr()

        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_ROUTES[chosen], code, int(bool(relu)), x.data_ptr(),
                 ptr(scale), ptr(shift), wt.data_ptr(), y.data_ptr(),
                 ptr(part), ptr(s), ptr(q), M, K, N, _DTYPE_CODES[x.dtype],
                 stream)
    library.raise_on_error(err, what)
    counts.add("launches")
    if chosen == "simple":
        counts.add("simple_launches")
    return y, s, q


def matmul_bn_stats_fwd(x, w):
    """``(y, sum, sumsq)`` as :func:`matmul_bn_stats_plain`: the plain
    version for CPU tensors, the kernel for CUDA tensors (raises for what
    it does not take: not (M, K) @ (K, N), dtypes other than one of
    float32/bfloat16, mixed devices, a failed launch)."""
    if not x.is_cuda:
        return matmul_bn_stats_plain(x, w)
    return _launch("matmul_bn_stats", matmul_bn_stats_counts, x, w)


def bn_act_matmul_fwd(x, scale, shift, w, relu=True):
    """``y`` as :func:`bn_act_matmul_plain`; dispatch as
    :func:`matmul_bn_stats_fwd`, and scale and shift must be K fp32
    values."""
    if not x.is_cuda:
        return bn_act_matmul_plain(x, scale, shift, w, relu)
    y, _, _ = _launch("bn_act_matmul", bn_act_matmul_counts, x, w, scale,
                      shift, relu)
    return y


def bn_act_matmul_stats_fwd(x, scale, shift, w, relu=True):
    """``(y, sum, sumsq)`` as :func:`bn_act_matmul_stats_plain`; dispatch
    as :func:`bn_act_matmul_fwd`."""
    if not x.is_cuda:
        return bn_act_matmul_stats_plain(x, scale, shift, w, relu)
    return _launch("bn_act_matmul_stats", bn_act_matmul_stats_counts, x, w,
                   scale, shift, relu)


# -- autograd: the JAX package's backward rules -------------------------------


def _stats_cotangent(y, gy, gs, gq, dtype):
    """``dy = gy + gs + 2*y*gq`` (s = sum_m y, q = sum_m y^2)."""
    return (gy.float() + gs.reshape(1, -1)
            + 2.0 * y.float() * gq.reshape(1, -1)).to(dtype)


def _bn_act_backward(x, scale, shift, w, gy, relu):
    """Ref: ``_bn_act_mm_bwd``: ``(dx, dscale, dshift, dw)``."""
    sc, sh = scale.reshape(1, -1), shift.reshape(1, -1)
    a = x.float() * sc + sh
    h = torch.relu(a) if relu else a
    gh = torch.matmul(gy.float(), w.t().float())
    if relu:
        gh = gh * (a > 0)
    dx = (gh * sc).to(x.dtype)
    dscale = (gh * x.float()).sum(dim=0, keepdim=True).reshape(scale.shape)
    dshift = gh.sum(dim=0, keepdim=True).reshape(shift.shape)
    dw = torch.matmul(h.to(x.dtype).t(), gy).to(w.dtype)
    return dx, dscale, dshift, dw


class MatmulBnStatsFunction(torch.autograd.Function):
    """``matmul_bn_stats`` for autograd; backward ``_mm_stats_bwd``
    (``ops/pallas/conv_fused.py:207``).  ``use_kernel`` False takes the
    plain forward (a shape the gate refused)."""

    @staticmethod
    def forward(ctx, x, w, use_kernel):
        fwd = matmul_bn_stats_fwd if use_kernel else matmul_bn_stats_plain
        y, s, q = fwd(x, w)
        ctx.save_for_backward(x, w, y)
        return y, s, q

    @staticmethod
    def backward(ctx, gy, gs, gq):
        x, w, y = ctx.saved_tensors
        dy = _stats_cotangent(y, gy, gs, gq, x.dtype)
        dx = torch.matmul(dy, w.t()).to(x.dtype)
        dw = torch.matmul(x.t(), dy).to(w.dtype)
        return dx, dw, None


class BnActMatmulFunction(torch.autograd.Function):
    """``bn_act_matmul`` for autograd; backward ``_bn_act_mm_bwd``
    (``ops/pallas/conv_fused.py:299``)."""

    @staticmethod
    def forward(ctx, x, scale, shift, w, relu, use_kernel):
        fwd = bn_act_matmul_fwd if use_kernel else bn_act_matmul_plain
        y = fwd(x, scale, shift, w, relu)
        ctx.save_for_backward(x, scale, shift, w)
        ctx.relu = relu
        return y

    @staticmethod
    def backward(ctx, gy):
        x, scale, shift, w = ctx.saved_tensors
        return (*_bn_act_backward(x, scale, shift, w, gy, ctx.relu), None,
                None)


class BnActMatmulStatsFunction(torch.autograd.Function):
    """``bn_act_matmul_stats`` for autograd; backward
    ``_bn_act_mm_stats_bwd`` (``ops/pallas/conv_fused.py:404``)."""

    @staticmethod
    def forward(ctx, x, scale, shift, w, relu, use_kernel):
        fwd = bn_act_matmul_stats_fwd if use_kernel \
            else bn_act_matmul_stats_plain
        y, s, q = fwd(x, scale, shift, w, relu)
        ctx.save_for_backward(x, scale, shift, w, y)
        ctx.relu = relu
        return y, s, q

    @staticmethod
    def backward(ctx, gy, gs, gq):
        x, scale, shift, w, y = ctx.saved_tensors
        dy = _stats_cotangent(y, gy, gs, gq, x.dtype)
        return (*_bn_act_backward(x, scale, shift, w, dy, ctx.relu), None,
                None)


# -- the entries --------------------------------------------------------------


def matmul_bn_stats(x, w):
    """``y = x @ w`` plus per-column ``(sum, sumsq)`` of y (ref:
    ``matmul_bn_stats``, ``ops/pallas/conv_fused.py:190``).

    x ``(M, K)``, w ``(K, N)`` -> ``(y (M, N) in x's dtype, sum (1, N)
    fp32, sumsq (1, N) fp32)``."""
    use = _gate(x, w, matmul_bn_stats_counts)
    return MatmulBnStatsFunction.apply(x, w, use)


def bn_act_matmul(x, scale, shift, w, relu=True):
    """``y = act(x*scale + shift) @ w`` (ref: ``bn_act_matmul``,
    ``ops/pallas/conv_fused.py:279``); scale and shift ``(1, K)`` fp32."""
    use = _gate(x, w, bn_act_matmul_counts)
    return BnActMatmulFunction.apply(x, scale, shift, w, bool(relu), use)


def bn_act_matmul_stats(x, scale, shift, w, relu=True):
    """:func:`bn_act_matmul` plus per-column ``(sum, sumsq)`` of y (ref:
    ``bn_act_matmul_stats``, ``ops/pallas/conv_fused.py:388``)."""
    use = _gate(x, w, bn_act_matmul_stats_counts)
    return BnActMatmulStatsFunction.apply(x, scale, shift, w, bool(relu),
                                          use)
