"""Attention ops (ref: mxnet_tpu/ops/attention.py).

``scaled_dot_product_attention`` routes as the JAX op does off a TPU
(``mxnet_tpu/ops/attention.py:25-31, 57-67``): CPU tensors take
:func:`sdpa_reference`, the oracle, as the JAX op takes it on any backend
but the TPU; CUDA tensors, the TPU's counterpart, go to the
flash-attention entry (``ops/kernels/flash_attention.py``), which
launches the Hopper kernels or raises.  ``MXTPU_DISABLE_PALLAS`` (falling
back to ``MXNET_DISABLE_PALLAS``), which sends the JAX op to the oracle,
cannot do so on the card, where nothing falls back to a plain version: a
CUDA tensor raises while it is set.  Nothing catches a kernel failure and
quietly computes the oracle instead.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError, getenv
from .kernels.flash_attention import NEG_INF, flash_attention
from .registry import register


def sdpa_reference(q, k, v, mask=None, *, scale=None, causal=False):
    """Scaled dot-product attention, the numeric oracle (ref:
    ``sdpa_reference``, ops/attention.py:34).

    q, k, v: ``(batch, heads, seq, head_dim)``.  mask: additive
    ``(b,1,sq,sk)``-broadcastable, or bool (False masks).  ``causal`` is
    end-aligned: ``tril(ones(sq, sk), sk - sq)``."""
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * s
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~keep, NEG_INF)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, NEG_INF)
        else:
            logits = logits + mask
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def _k_sdpa(q, k, v, mask=None, scale=None, causal=False, dropout_p=0.0):
    """The oracle for CPU tensors; the flash entry for CUDA tensors, which
    raise while ``MXTPU_DISABLE_PALLAS`` is set."""
    if not q.is_cuda:
        return sdpa_reference(q, k, v, mask, scale=scale, causal=causal)
    if getenv("DISABLE_PALLAS", False, bool):
        raise MXNetError(
            "scaled_dot_product_attention: MXTPU_DISABLE_PALLAS is set, but "
            "a CUDA tensor cannot take the oracle: nothing on a CUDA path "
            "falls back to a plain version (ROADMAP.md, the rules for every "
            "slice); unset it to run on the card")
    return flash_attention(q, k, v, mask=mask, scale=scale, causal=causal)


register("scaled_dot_product_attention", _k_sdpa, aliases=("_contrib_sdpa",))


def _k_multihead_attention(query, key, value, in_weight, in_bias,
                           out_weight, out_bias, mask=None, *, num_heads,
                           causal=False):
    """Q/K/V projection + attention + output projection (ref:
    ops/attention.py:75).

    query/key/value ``(batch, seq, model)``; in_weight ``(3*model, model)``
    packs the q, k and v projections in that order; out_weight
    ``(model, model)``.  Self-attention (one tensor for all three) runs
    the packed projection as one product; the heads are strided views of
    it, which the kernel reads in place."""
    b, sq, m = query.shape
    h = num_heads
    hd = m // h

    def heads(x):  # (b, s, h*hd) -> (b, h, s, hd), a view
        return x.reshape(x.shape[0], x.shape[1], h, hd).transpose(1, 2)

    if query is key and key is value:
        qkv = torch.nn.functional.linear(query, in_weight, in_bias)
        qh, kh, vh = (heads(t) for t in qkv.chunk(3, dim=-1))
    else:
        wq, wk, wv = in_weight.chunk(3, dim=0)
        bq, bk, bv = in_bias.chunk(3, dim=0)
        qh = heads(torch.nn.functional.linear(query, wq, bq))
        kh = heads(torch.nn.functional.linear(key, wk, bk))
        vh = heads(torch.nn.functional.linear(value, wv, bv))
    out = _k_sdpa(qh, kh, vh, mask, causal=causal)
    out = out.transpose(1, 2).reshape(b, sq, m)
    return torch.nn.functional.linear(out, out_weight, out_bias)


register("multihead_attention", _k_multihead_attention)
