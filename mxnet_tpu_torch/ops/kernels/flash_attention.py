"""Flash attention: the Hopper kernels, their plain versions, their wrappers.

Replaces the Pallas kernels of ``mxnet_tpu/ops/pallas/flash_attention.py``
with CUDA kernels that stream tiles through shared memory:

- the forward, ``_flash_fwd_kernel`` (K/V resident) and
  ``_flash_fwd_stream_kernel`` (K/V streamed), by one kernel in
  ``csrc/flash_attention_fwd.cu``;
- the backward, ``_flash_dq_kernel``/``_flash_dq_stream_kernel`` and
  ``_flash_dkv_kernel``/``_flash_dkv_stream_kernel``, by a dQ kernel and a
  dK/dV kernel in ``csrc/flash_attention_bwd.cu`` (a second library, so
  the forward's build is unchanged).

The three kernels run on the tensor cores, built on
``csrc/attention_tiles.cuh`` (3xTF32 products in fp32, a ring of rows
copied by ``cp.async.bulk``: K/V for the forward and dQ, Q/dO for dK/dV;
key tiles, or blocks of 64 keys for dK/dV, of padding skipped).  The ring
reads rows in place where each starts on a 16-byte boundary: every
contiguous tensor and every head view of a packed QKV tensor; the wrappers
copy any other view first (:func:`_aligned_rows`).  The sources' headers
say what bounds each kernel on an H100 and what its design does about it.

- :func:`flash_attention_plain` and :func:`flash_attention_bwd_plain` are
  the same functions in plain PyTorch: the CPU path, and what the kernels
  are held against on the card.  The plain backward follows the TPU
  kernels' arithmetic (``p = exp(s - lse)``, ``delta = rowsum(dO*O)``),
  not autograd of the forward.
- :func:`flash_attention_fwd` and :func:`flash_attention_bwd` are the
  wrappers.  They dispatch on the tensors' device alone: CPU tensors go to
  the plain version, CUDA tensors to the kernels, and what the kernels do
  not take raises.  :func:`flash_attention_bwd` launches the dQ and the
  dK/dV kernel through their own wrappers, which count their launches.
- :class:`FlashAttentionFunction` joins them for autograd (ref:
  ``_flash_sdpa``, a ``jax.custom_vjp``).
- :func:`flash_attention` is the entry the attention op calls (ref:
  ``flash_attention`` at ``ops/pallas/flash_attention.py:725``).  It keeps
  the JAX entry's rules that send a case to the oracle
  (``ops.attention.sdpa_reference``) before any launch; the length and
  head-dim rule of ``_tiles_ok`` applies to CPU tensors only, as the
  kernels on the card take every length.

Masking follows the TPU kernels: the additive key-padding row uses -1e9,
not -inf, and the running max starts at -1e9, so a batch row whose keys
are all padding (a dead row of a padded batch) returns the mean of V
instead of NaN; its lse is -1e9 in fp32, so the backward's ``p`` is 1 for
each of its keys and its gradients are non-zero, as the TPU kernels give
them.  Keys past ``sk``, and keys after the query under ``causal``, are
excluded outright in both directions.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ...base import MXNetError, getenv
from .build import KernelCounts, KernelLibrary

NEG_INF = -1e9
#: head dims the kernel is instantiated for (multiples of 64, up to 256)
HEAD_DIMS = (64, 128, 192, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: the forward kernel's counters; ``plain_calls_on_cuda`` counts the
#: entry's oracle routes
counts = KernelCounts()
#: the backward kernels' counters, one per kernel
dq_counts = KernelCounts()
dkv_counts = KernelCounts()
library = KernelLibrary("flash_attention_fwd.cu")
bwd_library = KernelLibrary("flash_attention_bwd.cu")


def _bind(lib):
    fn = lib.mxtt_flash_attention_fwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i,
                       ll, ll, ll, ll, ll, ll, ll, ll, ll,
                       ctypes.c_float, i, i, p, p]
        fn.restype = ctypes.c_int
    return fn


def rows_aligned(t):
    """Whether every row of the (b, h, s, d) head tensor ``t`` starts on a
    16-byte boundary, as the kernels' ring of ``cp.async.bulk`` row copies
    needs: its pointer and its batch, head and sequence strides, in bytes,
    are multiples of 16, where that dim has more than one entry."""
    es = t.element_size()
    return t.data_ptr() % 16 == 0 and not any(
        n > 1 and (st * es) % 16
        for n, st in zip(t.shape[:3], t.stride()[:3]))


def _aligned_rows(t):
    """``t`` itself where :func:`rows_aligned`, else a contiguous copy."""
    return t if rows_aligned(t) else t.clone(
        memory_format=torch.contiguous_format)


def _tile_counter(tiles):
    return ctypes.c_void_p(tiles.data_ptr()) if tiles is not None else None


def flash_attention_plain(q, k, v, kmask=None, *, causal=False, scale=None):
    """Plain PyTorch version of the kernel: ``(o, lse)``.

    q ``(b,h,sq,d)``, k/v ``(b,h,sk,d)``; kmask an additive ``(b, sk)``
    fp32 row or None; ``causal`` is start-aligned (``q_pos >= k_pos``).
    Returns ``o`` in q's dtype and ``lse`` ``(b*h, sq)`` fp32.  The
    arithmetic follows the kernel: q is scaled in its own dtype, scores
    and sums are fp32, the probabilities are rounded to v's dtype before
    the product with V."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qs = (q.float() * scale).to(q.dtype).float()
    s = torch.matmul(qs, k.float().transpose(-1, -2))
    if kmask is not None:
        s = s + kmask.float().reshape(b, 1, 1, sk)
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    lse = (m + torch.log(l)).reshape(b * h, sq)
    return o.to(q.dtype), lse


def _check(q, k, v, kmask):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise MXNetError("flash attention takes (b, h, s, d) q, k and v")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != (b, h, sk, d):
        raise MXNetError(f"flash attention shapes disagree: q {tuple(q.shape)}"
                         f" k {tuple(k.shape)} v {tuple(v.shape)}")
    if sq < 1 or sk < 1:
        raise MXNetError("flash attention needs sq, sk >= 1")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise MXNetError(f"flash attention: {name} is on {t.device}, "
                             f"q on {q.device}")
        if t.dtype != q.dtype:
            raise MXNetError(f"flash attention: {name} is {t.dtype}, "
                             f"q is {q.dtype}")
    if q.dtype not in _DTYPE_CODES:
        raise MXNetError(f"flash attention kernel takes float32 or bfloat16, "
                         f"not {q.dtype}")
    if d not in HEAD_DIMS:
        raise MXNetError(f"flash attention kernel takes head dims {HEAD_DIMS}, "
                         f"not {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise MXNetError(f"flash attention: {name}'s head dim must be "
                             f"contiguous (strides {t.stride()})")
    if kmask is not None:
        if (kmask.shape != (b, sk) or kmask.dtype != torch.float32
                or not kmask.is_contiguous() or kmask.device != q.device):
            raise MXNetError(
                f"flash attention: the key-padding row must be a contiguous "
                f"float32 ({b}, {sk}) tensor on {q.device}, got "
                f"{kmask.dtype} {tuple(kmask.shape)} on {kmask.device}")


def flash_attention_fwd(q, k, v, kmask=None, *, causal=False, scale=None):
    """Flash-attention forward, ``(o, lse)``, as :func:`flash_attention_plain`.

    CPU tensors take the plain version.  CUDA tensors launch the kernel
    on the current stream (a view whose rows are not 16-byte aligned is
    copied first), or raise :class:`MXNetError` for what it does not take
    (dtype other than float32/bfloat16, head dim not in ``HEAD_DIMS``,
    non-contiguous head dim, mismatched shapes or devices) and for a failed
    launch."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, kmask, causal=causal,
                                     scale=scale)
    return _launch_fwd(q, k, v, kmask, causal, scale)


def _launch_fwd(q, k, v, kmask, causal, scale, tiles=None):
    """Launch the forward on CUDA tensors; ``tiles`` is an int32 (2,)
    tensor that the kernel adds its visited and unskipped key tiles to."""
    _check(q, k, v, kmask)
    q, k, v = (_aligned_rows(t) for t in (q, k, v))
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    o = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    fn = _bind(library.load())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 kmask.data_ptr() if kmask is not None else None,
                 o.data_ptr(), lse.data_ptr(), b, h, sq, sk, d,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 float(scale), int(bool(causal)), _DTYPE_CODES[q.dtype],
                 _tile_counter(tiles), stream)
    library.raise_on_error(err, "flash attention")
    counts.add("launches")
    return o, lse


def flash_attention_bwd_plain(q, k, v, o, lse, do, kmask=None, *,
                              causal=False, scale=None):
    """Plain PyTorch version of the backward kernels: ``(dq, dk, dv)``.

    Follows the TPU kernels (ref: ``_flash_backward``, ``ops/pallas/
    flash_attention.py:524``), not autograd of the forward:
    ``delta = rowsum(dO*O)``; ``s = scale*(q k^T) + kmask``, masked as the
    forward masks it; ``p = exp(s - lse)``; ``ds = p*(dO v^T - delta)``;
    ``dq = scale*ds k``, ``dk = scale*ds^T q``, ``dv = p^T dO``.  Every
    product is fp32 (p is not rounded to bf16); the outputs take the
    inputs' dtypes.  ``lse`` is the forward's ``(b*h, sq)`` fp32 tensor."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    delta = (dof * of).sum(dim=-1, keepdim=True)
    s = scale * torch.matmul(qf, kf.transpose(-1, -2))
    if kmask is not None:
        s = s + kmask.float().reshape(b, 1, 1, sk)
    p = torch.exp(s - lse.reshape(b, h, sq, 1))
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        p = p.masked_fill(~keep, 0.0)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta)
    dq = scale * torch.matmul(ds, kf)
    dk = scale * torch.matmul(ds.transpose(-1, -2), qf)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bind_bwd(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, n_out in (("mxtt_flash_attention_bwd_dq", 1),
                        ("mxtt_flash_attention_bwd_dkv", 2)):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = [p] * (7 + n_out) + [i, i, i, i, i, p, f, i, i, p,
                                               p]
            fn.restype = ctypes.c_int
    return lib.mxtt_flash_attention_bwd_dq, lib.mxtt_flash_attention_bwd_dkv


def _bwd_launch(fn, counter, what, q, k, v, do, lse, delta, kmask, outs,
                causal, scale, counter_tensor):
    """Launch one backward kernel on ``outs`` (see the C interface in
    ``csrc/flash_attention_bwd.cu``), with its int32 (2,) tile or block
    counter ``counter_tensor`` or None."""
    b, h, sq, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *do.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(),
                 kmask.data_ptr() if kmask is not None else None,
                 *(t.data_ptr() for t in outs), b, h, sq, k.shape[2], d,
                 ctypes.cast(strides, ctypes.c_void_p), float(scale),
                 int(bool(causal)), _DTYPE_CODES[q.dtype],
                 _tile_counter(counter_tensor), stream)
    bwd_library.raise_on_error(err, what)
    counter.add("launches")


def flash_attention_bwd_dq(q, k, v, do, lse, delta, kmask=None, *,
                           causal=False, scale=None):
    """dQ by the dQ kernel (CUDA tensors only; arguments as checked by
    :func:`flash_attention_bwd`, with ``delta = rowsum(dO*O)`` fp32
    ``(b*h, sq)``; a view whose rows are not 16-byte aligned is copied
    first)."""
    return _launch_dq(q, k, v, do, lse, delta, kmask, causal, scale)


def _launch_dq(q, k, v, do, lse, delta, kmask, causal, scale, tiles=None):
    """Launch the dQ kernel; ``tiles`` as in :func:`_launch_fwd`."""
    fn, _ = _bind_bwd(bwd_library.load())
    q, k, v, do = (_aligned_rows(t) for t in (q, k, v, do))
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _bwd_launch(fn, dq_counts, "flash attention dQ", q, k, v, do, lse,
                delta, kmask, (dq,), causal, scale, tiles)
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, kmask=None, *,
                            causal=False, scale=None):
    """(dK, dV) by the dK/dV kernel, arguments as
    :func:`flash_attention_bwd_dq`."""
    return _launch_dkv(q, k, v, do, lse, delta, kmask, causal, scale)


def _launch_dkv(q, k, v, do, lse, delta, kmask, causal, scale, blocks=None):
    """Launch the dK/dV kernel; ``blocks`` is an int32 (2,) tensor that
    the kernel adds its blocks of 64 keys that were not skipped and all
    its blocks to."""
    _, fn = _bind_bwd(bwd_library.load())
    q, k, v, do = (_aligned_rows(t) for t in (q, k, v, do))
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _bwd_launch(fn, dkv_counts, "flash attention dK/dV", q, k, v, do, lse,
                delta, kmask, (dk, dv), causal, scale, blocks)
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, kmask=None, *, causal=False,
                        scale=None):
    """Flash-attention backward, ``(dq, dk, dv)``, as
    :func:`flash_attention_bwd_plain`.

    CPU tensors take the plain version.  CUDA tensors launch the dQ kernel
    and then the dK/dV kernel on the current stream, or raise
    :class:`MXNetError` for what the forward kernel would not take and for
    a failed launch.  ``delta = rowsum(dO*O)`` is one torch expression, as
    the reference leaves it to XLA (``ops/pallas/flash_attention.py:532``).
    ``do`` may have any strides (autograd hands over views); a head dim
    that is not contiguous is copied.  The gradients come back contiguous.
    """
    if not q.is_cuda:
        return flash_attention_bwd_plain(q, k, v, o, lse, do, kmask,
                                         causal=causal, scale=scale)
    _check(q, k, v, kmask)
    b, h, sq, d = q.shape
    if do.shape != q.shape or do.device != q.device or o.shape != q.shape:
        raise MXNetError(f"flash attention backward: dO {tuple(do.shape)} "
                         f"and O {tuple(o.shape)} must match q "
                         f"{tuple(q.shape)} on {q.device}")
    if lse.shape != (b * h, sq) or lse.dtype != torch.float32:
        raise MXNetError(f"flash attention backward: lse must be float32 "
                         f"({b * h}, {sq}), got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    do = do.to(q.dtype)
    if do.stride(3) != 1:
        do = do.contiguous()
    lse = lse.contiguous()
    delta = (do.float() * o.float()).sum(dim=-1).reshape(b * h, sq)
    args = (q, k, v, do, lse, delta, kmask)
    dq = flash_attention_bwd_dq(*args, causal=causal, scale=scale)
    dk, dv = flash_attention_bwd_dkv(*args, causal=causal, scale=scale)
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention for autograd: the forward wrapper, then the backward
    wrapper on the saved ``(q, k, v, kmask, o, lse)`` (ref: ``_flash_sdpa``
    with ``_flash_sdpa_fwd``/``_flash_sdpa_bwd``, ``ops/pallas/
    flash_attention.py:681-707``).  The key-padding row gets no gradient.
    Both directions dispatch on the device like their wrappers: CPU tensors
    take the plain forward and the plain backward."""

    @staticmethod
    def forward(ctx, q, k, v, kmask, causal, scale):
        o, lse = flash_attention_fwd(q, k, v, kmask, causal=causal,
                                     scale=scale)
        ctx.save_for_backward(q, k, v, kmask, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, kmask, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, kmask,
                                         causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None, None


def as_key_padding_mask(mask, q, k):
    """A ``(b,1,1,sk)`` bool or additive mask as an additive ``(b, sk)``
    fp32 row, or None when the mask is absent or has another shape (ref:
    ``_as_key_padding_mask``, ``ops/pallas/flash_attention.py:710``)."""
    if mask is None:
        return None
    b, sk = q.shape[0], k.shape[2]
    if mask.dim() != 4 or tuple(mask.shape) != (b, 1, 1, sk):
        return None
    row = mask.reshape(b, sk)
    if row.dtype == torch.bool:
        return torch.where(row, 0.0, NEG_INF).to(torch.float32)
    return row.to(torch.float32).contiguous()


def _headdim64_allowed():
    """Whether a head dim that is a multiple of 64 but not of 128 may take
    the kernels: yes unless ``MXTPU_FLASH_HEADDIM64`` (falling back to
    ``MXNET_FLASH_HEADDIM64``) reads false (ref: ``_headdim64_allowed``,
    ``ops/pallas/flash_attention.py:638``, off the TPU).  Read for CPU
    tensors only: on the card every head dim of ``HEAD_DIMS`` launches,
    and a kernel that fails raises."""
    forced = getenv("FLASH_HEADDIM64", None, bool)
    return True if forced is None else forced


def _tiles_ok(q, k, block=128):
    """The JAX entry's shape rule (ref: ``_tiles_ok``, ``ops/pallas/
    flash_attention.py:608``): sq and sk multiples of 128 and at least
    128, and a head dim that is a multiple of 128, or of 64 where
    :func:`_headdim64_allowed`.  The entry applies it to CPU tensors, so
    that the CPU path gives the JAX entry's results."""
    sq, d = q.shape[2], q.shape[3]
    sk = k.shape[2]
    if d % 128 != 0 and (d % 64 != 0 or not _headdim64_allowed()):
        return False
    return sq % block == 0 and sk % block == 0 and sq >= block \
        and sk >= block


def flash_attention(q, k, v, mask=None, scale=None, causal=False):
    """Fused attention, q/k/v ``(batch, heads, seq, head_dim)``.

    Key-padding masks, bool or additive of shape ``(b, 1, 1, sk)``, ride
    inside the kernel.  As in the JAX entry, these cases go to the oracle
    ``sdpa_reference`` instead, decided before any launch: causal
    attention with ``sq != sk`` (the oracle's mask is end-aligned, the
    kernel's start-aligned), a full score mask and a head dim that is not
    a multiple of 64; on CPU tensors also a shape that :func:`_tiles_ok`
    refuses (sq or sk below 128 or not a multiple of 128; a head dim that
    is not a multiple of 128 when ``MXTPU_FLASH_HEADDIM64`` is false).  On
    CUDA tensors each oracle call counts in ``counts.plain_calls_on_cuda``;
    the kernels there take every length, so a dead row of a padded batch
    at a length that is not a multiple of 128 gets the flash formula's
    gradients on the card (``p = 1`` per key) where the JAX entry and the
    CPU give the oracle's (ROADMAP.md, deliberate differences).

    When autograd records and q, k or v needs a gradient, the call goes
    through :class:`FlashAttentionFunction`, which keeps what the backward
    reads; otherwise (serving, under ``no_grad``) only the forward runs and
    nothing is kept.
    """
    from ..attention import sdpa_reference

    km = as_key_padding_mask(mask, q, k)
    to_oracle = (q.shape[-1] % 64 != 0
                 or (causal and q.shape[2] != k.shape[2])
                 or (mask is not None and km is None)
                 or (not q.is_cuda and not _tiles_ok(q, k)))
    if to_oracle:
        if q.is_cuda:
            counts.add("plain_calls_on_cuda")
        return sdpa_reference(q, k, v, mask, scale=scale, causal=causal)
    s = float(scale) if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, km, bool(causal), s)
    out, _ = flash_attention_fwd(q, k, v, km, causal=bool(causal), scale=s)
    return out
