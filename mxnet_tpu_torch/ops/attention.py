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
    end-aligned: ``tril(ones(sq, sk), sk - sq)``.  Dtypes as the
    reference's: -1e9 in the logits' dtype (-inf in float16), and a
    float32 additive mask over float16 logits makes the rest float32."""
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * s
    neg = torch.full((), NEG_INF, device=q.device).to(logits.dtype)
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~keep, neg)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, neg)
        else:
            logits = logits + mask
    probs = torch.softmax(logits, dim=-1)
    if probs.dtype != v.dtype:
        dt = torch.promote_types(probs.dtype, v.dtype)
        probs, v = probs.to(dt), v.to(dt)
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


register("scaled_dot_product_attention", _k_sdpa, aliases=("_contrib_sdpa",),
         arg_names=("q", "k", "v", "mask"))


def _k_multihead_attention(query, key, value, in_weight, in_bias,
                           out_weight, out_bias, mask=None, *, num_heads,
                           causal=False):
    """Q/K/V projection + attention + output projection (ref:
    ops/attention.py:75).

    query/key/value ``(batch, seq, model)``; in_weight ``(3*model, model)``
    packs the q, k and v projections in that order; out_weight
    ``(model, model)``.  Self-attention (one tensor for all three) runs
    the packed projection as one product; the heads are strided views of
    it, which the kernel reads in place.

    Under AMP, float16 or bfloat16 projection weights pull the inputs
    down to their dtype, as ``FullyConnected`` does (``nn._amp_in``), so
    the attention runs in that dtype, as ``amp.TARGET_DTYPE_OPS`` names
    this op.  The reference's op promotes instead (its ``x @ w.T`` of a
    float32 LayerNorm output and float16 weights is float32), so its
    attention under float16 AMP runs in float32 (ROADMAP.md, caveat (t)).

    Inside the mesh step both projections go through
    ``parallel.spmd.products.linear``, so a projection split over ``mp``
    is computed on its shard.  A packed in-projection split by output rows
    cannot be cut into its q, k and v thirds on one rank: each distinct
    input tensor takes the whole split product once and keeps the thirds
    it feeds.  Cross-attention (key is value) so takes two products of
    the packed width where the unsplit op computes a third of it for the
    query and two thirds for the memory."""
    from ..parallel.spmd.products import full_of, linear, split_of

    from .nn import _amp_in

    cast = {}
    query, key, value = (cast.setdefault(id(x), _amp_in(x, in_weight))
                         for x in (query, key, value))
    b, sq, m = query.shape
    h = num_heads
    hd = m // h

    def heads(x):  # (b, s, h*hd) -> (b, h, s, hd), a view
        return x.reshape(x.shape[0], x.shape[1], h, hd).transpose(1, 2)

    if query is key and key is value:
        qkv = linear(query, in_weight, in_bias)
        qh, kh, vh = (heads(t) for t in qkv.chunk(3, dim=-1))
    elif split_of(in_weight) is not None:
        packed = {}
        for x in (query, key, value):
            if id(x) not in packed:
                packed[id(x)] = linear(x, in_weight, in_bias)
        qh, kh, vh = (heads(packed[id(x)][..., i * m:(i + 1) * m])
                      for i, x in enumerate((query, key, value)))
    else:
        wq, wk, wv = in_weight.chunk(3, dim=0)
        bq, bk, bv = full_of(in_bias).chunk(3, dim=0)
        qh = heads(linear(query, wq, bq))
        kh = heads(linear(key, wk, bk))
        vh = heads(linear(value, wv, bv))
    out = _k_sdpa(qh, kh, vh, mask, causal=causal)
    out = _amp_in(out.transpose(1, 2).reshape(b, sq, m), out_weight)
    return linear(out, out_weight, out_bias)


register("multihead_attention", _k_multihead_attention,
         arg_names=("query", "key", "value", "in_weight", "in_bias",
                    "out_weight", "out_bias", "mask"))


# the interleaved self-attention products of the reference's contrib
# (ref: ops/attention.py:106-140): plain batched products, as there

def _k_interleaved_matmul_selfatt_qk(queries_keys_values, heads):
    """(seq, batch, 3*model), q/k/v interleaved per head -> the scaled
    logits, (batch*heads, seq, seq)."""
    s, b, m3 = queries_keys_values.shape
    hd = m3 // 3 // heads
    x = queries_keys_values.reshape(s, b, heads, 3, hd)
    q = x[:, :, :, 0].permute(1, 2, 0, 3) / math.sqrt(hd)
    k = x[:, :, :, 1].permute(1, 2, 0, 3)
    return torch.matmul(q, k.transpose(-1, -2)).reshape(b * heads, s, s)


def _k_interleaved_matmul_selfatt_valatt(queries_keys_values, attention,
                                         heads):
    """The attention weights (batch*heads, seq, seq) applied to the
    interleaved values -> (seq, batch, model)."""
    s, b, m3 = queries_keys_values.shape
    m = m3 // 3
    v = queries_keys_values.reshape(s, b, heads, 3, m // heads)[:, :, :, 2]
    out = torch.matmul(attention.reshape(b, heads, s, s),
                       v.permute(1, 2, 0, 3))
    return out.permute(2, 0, 1, 3).reshape(s, b, m)


register("_contrib_interleaved_matmul_selfatt_qk",
         _k_interleaved_matmul_selfatt_qk,
         arg_names=("queries_keys_values",))
register("_contrib_interleaved_matmul_selfatt_valatt",
         _k_interleaved_matmul_selfatt_valatt,
         arg_names=("queries_keys_values", "attention"))
