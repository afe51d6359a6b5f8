"""Flash-attention forward: the Hopper kernel, its plain version, its wrapper.

Replaces the forward Pallas kernels of ``mxnet_tpu/ops/pallas/
flash_attention.py``, ``_flash_fwd_kernel`` (K/V resident) and
``_flash_fwd_stream_kernel`` (K/V streamed), with one CUDA kernel,
``csrc/flash_attention_fwd.cu``, that streams K/V tiles through shared
memory.  The source's header says what bounds it on an H100 and what its
design does about it.

- :func:`flash_attention_plain` is the same function in plain PyTorch:
  the CPU path, and what the kernel is held against on the card.
- :func:`flash_attention_fwd` is the wrapper.  It dispatches on the
  tensors' device alone: CPU tensors go to the plain version, CUDA
  tensors to the kernel, and what the kernel does not take raises.
- :func:`flash_attention` is the entry the attention op calls (ref:
  ``flash_attention`` at ``ops/pallas/flash_attention.py:725``).  It keeps
  the JAX entry's shape rules that send a case to the oracle
  (``ops.attention.sdpa_reference``) before any launch.

Masking follows the TPU kernel: the additive key-padding row uses -1e9,
not -inf, and the running max starts at -1e9, so a batch row whose keys
are all padding (a dead row of a padded serving batch) returns the mean
of V instead of NaN.  Keys past ``sk``, and keys after the query under
``causal``, are excluded outright.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from ...base import MXNetError
from .build import KernelLibrary

NEG_INF = -1e9
#: head dims the kernel is instantiated for (multiples of 64, up to 256)
HEAD_DIMS = (64, 128, 192, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class KernelCounts:
    """Launch counters of one kernel wrapper.

    ``launches`` grows by one per kernel launch.  ``plain_calls_on_cuda``
    grows by one each time the entry sends CUDA tensors to the oracle by
    a shape rule (a full score mask, causal with sq != sk, a head dim the
    kernel does not take)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.launches = 0
        self.plain_calls_on_cuda = 0

    def add(self, name):
        with self._lock:
            setattr(self, name, getattr(self, name) + 1)

    def reset(self):
        with self._lock:
            self.launches = 0
            self.plain_calls_on_cuda = 0


counts = KernelCounts()
library = KernelLibrary("flash_attention_fwd.cu")


def _bind(lib):
    fn = lib.mxtt_flash_attention_fwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i,
                       ll, ll, ll, ll, ll, ll, ll, ll, ll,
                       ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
        lib.mxtt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mxtt_cuda_error_string.restype = ctypes.c_char_p
    return fn


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
    on the current stream, or raise :class:`MXNetError` for what it does
    not take (dtype other than float32/bfloat16, head dim not in
    ``HEAD_DIMS``, non-contiguous head dim, mismatched shapes or devices)
    and for a failed launch."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, kmask, causal=causal,
                                     scale=scale)
    _check(q, k, v, kmask)
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
                 stream)
    if err != 0:
        msg = library.load().mxtt_cuda_error_string(err).decode()
        raise MXNetError(f"flash attention kernel launch failed: {msg} "
                         f"(cudaError {err})")
    counts.add("launches")
    return o, lse


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


def flash_attention(q, k, v, mask=None, scale=None, causal=False):
    """Fused attention, q/k/v ``(batch, heads, seq, head_dim)``.

    Key-padding masks, bool or additive of shape ``(b, 1, 1, sk)``, ride
    inside the kernel.  As in the JAX entry, three cases go to the
    oracle ``sdpa_reference`` instead: a full score mask, causal
    attention with ``sq != sk`` (the oracle's mask is end-aligned, the
    kernel's start-aligned) and a head dim that is not a multiple of 64.
    On CUDA tensors each such call counts in ``counts.plain_calls_on_cuda``.
    """
    from ..attention import sdpa_reference

    km = as_key_padding_mask(mask, q, k)
    to_oracle = (q.shape[-1] % 64 != 0
                 or (causal and q.shape[2] != k.shape[2])
                 or (mask is not None and km is None))
    if to_oracle:
        if q.is_cuda:
            counts.add("plain_calls_on_cuda")
        return sdpa_reference(q, k, v, mask, scale=scale, causal=causal)
    s = float(scale) if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    out, _ = flash_attention_fwd(q, k, v, km, causal=bool(causal), scale=s)
    return out
