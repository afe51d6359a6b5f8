"""Ulysses all-to-all sequence parallelism over the ``sp`` mesh axis (ref:
``mxnet_tpu/parallel/ulysses.py``).

Activations arrive sharded over the sequence ((B, H, S/P, D) a rank).  One
all-to-all (``parallel.mesh.all_to_all``; q, k and v travel as one tensor)
regroups them so each rank holds the full sequence for H/P heads;
attention runs locally and exactly (any mask, causal included), and a
second all-to-all restores the sequence sharding.  Communication is
2 (B H S D) / P a rank against ring attention's P k/v rotations.  The JAX
function calls ``sdpa_reference`` by name, and so does this one: the
port's own ``ops.attention.sdpa_reference``, plain torch on every device.
"""
from __future__ import annotations

import torch

from . import mesh as mesh_mod


def ulysses_attention_sharded(q, k, v, group, *, causal=False, scale=None):
    """This rank's output shard from its sequence shards (batch, heads,
    seq/P, d); ``group`` is the ``sp`` axis' (``parallel.mesh.Group``)."""
    from ..ops.attention import sdpa_reference

    # heads -> ranks, sequence gathered: (B, H, S/P, D) -> (B, H/P, S, D)
    qkv = mesh_mod.all_to_all(torch.stack([q, k, v]), group, 2, 3)
    out = sdpa_reference(qkv[0], qkv[1], qkv[2], scale=scale, causal=causal)
    # back: sequence -> ranks, heads gathered
    return mesh_mod.all_to_all(out, group, 2, 1)


def ulysses_attention(q, k, v, mesh=None, axis="sp", causal=False,
                      scale=None):
    """The full attention output, on every rank, of (batch, heads, seq, d)
    q, k, v that every rank holds, by all-to-all attention over ``axis``
    of the mesh (default: every rank on ``axis``).  Takes NDArrays or
    tensors; heads and seq must divide by the axis size."""
    from ..base import MXNetError
    from .ring_attention import _unwrap, attention_spmd

    (q, k, v), wrap = _unwrap(q, k, v)
    if mesh is None:
        mesh = mesh_mod.make_mesh({axis: mesh_mod.dist.num_workers()})
    P = mesh.shape[axis]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.shape[1] % P:
            raise MXNetError(
                f"ulysses_attention: {name} heads ({t.shape[1]}) must "
                f"divide by the '{axis}' mesh size ({P}); use "
                f"ring_attention for few-head/long-sequence shapes")
        if t.shape[2] % P:
            raise MXNetError(
                f"ulysses_attention: {name} seq ({t.shape[2]}) must "
                f"divide by the '{axis}' mesh size ({P})")
    return wrap(attention_spmd(ulysses_attention_sharded, mesh, axis,
                               causal, scale)(q, k, v))
