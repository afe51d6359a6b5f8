"""Ring attention: sequence (context) parallelism over the ``sp`` mesh
axis (ref: ``mxnet_tpu/parallel/ring_attention.py``).

q, k and v are sharded over the axis along the sequence dim.  Each of the
P steps attends the local q shard to the k/v shard this rank holds,
merging with the online-softmax ``(m, l, acc)`` recurrence, then passes
k/v one hop around the ring (``parallel.mesh.ring_shift``, the JAX
package's ``ppermute``; k and v travel as one tensor).  A rank holds
O(seq / P) of k/v; the full score matrix never exists.  The JAX function
is plain ``jnp``, so plain torch is its counterpart here, on every device.

:func:`attention_spmd` (the counterpart of ``attention_spmd_jit``) runs a
sharded function from the full (B, H, S, D) q, k, v that every rank holds:
each rank takes its sequence slice and the output is all-gathered back, so
:func:`ring_attention` returns the full output on every rank.  Gradients
flow to the full inputs on every rank (every rank must compute the same
loss of the output); ``parallel.ulysses`` is the all-to-all alternative.
"""
from __future__ import annotations

import math

import torch

from . import mesh as mesh_mod

_NEG_INF = -1e9


def _block_attend(q, k, v, scale, q_offset, k_offset, causal):
    """Scores of local q against one k/v shard, with global positions."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        q_pos = q_offset + torch.arange(sq, device=q.device)[:, None]
        k_pos = k_offset + torch.arange(sk, device=q.device)[None, :]
        s = torch.where(q_pos >= k_pos, s, torch.full_like(s, _NEG_INF))
    m_cur = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m_cur)
    l_cur = p.sum(dim=-1, keepdim=True)
    o_cur = torch.einsum("bhqk,bhkd->bhqd", p, v)
    return m_cur, l_cur, o_cur


def ring_attention_sharded(q, k, v, group, *, causal=False, scale=None):
    """This rank's output shard from its sequence shards (batch, heads,
    seq/P, d) of q, k, v; ``group`` is the ``sp`` axis'
    (``parallel.mesh.Group``).  Every member of the group calls it."""
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    p_size, my_idx = group.size, group.index
    sq = q.shape[2]
    m = torch.full(q.shape[:3] + (1,), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros(q.shape[:3] + (1,), dtype=torch.float32, device=q.device)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    for i in range(p_size):
        # with the j -> j+1 rotation, after i hops rank j holds the shard
        # that started on rank (j - i) mod P
        src = (my_idx - i) % p_size
        m_cur, l_cur, o_cur = _block_attend(q, kv[0], kv[1], s, my_idx * sq,
                                            src * sq, causal)
        m_new = torch.maximum(m, m_cur)
        alpha_p = torch.exp(m - m_new)
        alpha_c = torch.exp(m_cur - m_new)
        l = alpha_p * l + alpha_c * l_cur
        acc = acc * alpha_p + o_cur * alpha_c
        m = m_new
        if i + 1 < p_size:  # the JAX loop's last rotation is never read
            kv = mesh_mod.ring_shift(kv, group)
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


class _SeqSlice(torch.autograd.Function):
    """This rank's slice of dim 2 of a tensor every rank holds alike; the
    backward all-gathers the slices' gradients into the full one."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        n = t.shape[2] // group.size
        return t[:, :, group.index * n:(group.index + 1) * n].clone()

    @staticmethod
    def backward(ctx, g):
        return torch.cat(ctx.group.all_gather(g.contiguous(), "act"),
                         dim=2), None


class _SeqGather(torch.autograd.Function):
    """Every rank's slice concatenated along dim 2; the backward takes this
    rank's slice of the gradient (every rank computes the same loss)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return torch.cat(group.all_gather(t.contiguous(), "act"), dim=2)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[2] // ctx.group.size
        i = ctx.group.index
        return g[:, :, i * n:(i + 1) * n], None


def attention_spmd(sharded_fn, mesh, axis, causal, scale):
    """``(q, k, v) -> out`` over the full (B, H, S, D) tensors that every
    rank holds: each rank runs ``sharded_fn`` on its sequence slices over
    ``axis`` and the output shards are all-gathered (ref:
    ``attention_spmd_jit``).  Ring and Ulysses share it."""
    group = mesh.group((axis,))
    scale = float(scale) if scale is not None else None

    def run(q, k, v):
        if group.size == 1:
            return sharded_fn(q, k, v, group, causal=causal, scale=scale)
        q, k, v = (_SeqSlice.apply(t, group) for t in (q, k, v))
        out = sharded_fn(q, k, v, group, causal=causal, scale=scale)
        return _SeqGather.apply(out, group)

    return run


def _unwrap(q, k, v):
    from ..ndarray.ndarray import NDArray

    if isinstance(q, NDArray):
        return (q.data, k.data, v.data), lambda out: NDArray(out, q.context)
    return (q, k, v), lambda out: out


def ring_attention(q, k, v, mesh=None, axis="sp", causal=False, scale=None):
    """The full attention output, on every rank, of (batch, heads, seq, d)
    q, k, v that every rank holds, sharded over ``axis`` of the mesh
    (default: every rank on ``axis``).  Takes NDArrays or tensors."""
    (q, k, v), wrap = _unwrap(q, k, v)
    if mesh is None:
        mesh = mesh_mod.make_mesh({axis: mesh_mod.dist.num_workers()})
    return wrap(attention_spmd(ring_attention_sharded, mesh, axis, causal,
                               scale)(q, k, v))
