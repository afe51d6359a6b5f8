"""Expert parallelism: the GShard-style Mixture-of-Experts FFN (ref:
``mxnet_tpu/parallel/moe.py``).

Routing builds one-hot dispatch and combine tensors (tokens x experts x
capacity) and the experts are three einsums, GShard's (Mesh-TensorFlow's)
formulation.  Capacity-limited routing keeps every shape static: tokens
beyond an expert's capacity are dropped and pass through the residual
path, as in GShard and Switch.

Routing follows the JAX function exactly: the first choice is
``torch.argmax`` (the first maximal index, as ``jax.lax.top_k`` picks the
lower index on a tie), the second a masked ``argmax``; capacity positions
are a cumsum over int32 one-hots in priority order (every first choice,
then every second choice), so they stay integer on the card.

The ``ep`` axis.  Where the JAX package shards the expert dim of the
einsums over ``ep`` and lets GSPMD insert the exchanges, the port writes
them.  ``ep`` is not a data axis, so the ranks of one ``ep`` group hold
the same tokens and compute the same routing on the full router; each
holds E/ep experts (``gluon_moe_param_spec_fn`` splits the expert-stacked
weights' dim 0 over ``ep``).  When the weights handed to :func:`moe_ffn`
hold fewer experts than the router has columns, it runs that form over
the ``ep`` group (of ``mesh``, else of the mesh scope the
``DataParallelTrainer`` sets around its forward):

- it keeps its own experts' slice of ``expert_in``; the backward of that
  slice is an all-gather over ``ep``, so dx and the router's gradient are
  whole on every rank;
- it computes its experts, then all-gathers ``expert_out`` over ``ep`` for
  the combine; the backward of that gather is the rank's own slice (every
  rank's loss is the same function of the gathered value, so a
  reduce-scatter would count it ``ep`` times).

Everything outside the experts stays replicated, so the data axes' sum of
the router's gradient is still right.  Both collectives count under
``parallel.mesh.comm_stats()["ep"]``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError


class _ExpertSlice(torch.autograd.Function):
    """This rank's experts of a replicated ``(E, ...)`` tensor; the
    backward gathers every rank's slice gradient into the whole one."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        n = t.shape[0] // group.size
        return t[group.index * n:(group.index + 1) * n].clone()

    @staticmethod
    def backward(ctx, g):
        return torch.cat(ctx.group.all_gather(g.contiguous(), "ep")), None


class _ExpertGather(torch.autograd.Function):
    """Every rank's experts, concatenated in group order; the backward is
    this rank's slice of the cotangent."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return torch.cat(group.all_gather(t.contiguous(), "ep"))

    @staticmethod
    def backward(ctx, g):
        n = g.shape[0] // ctx.group.size
        i = ctx.group.index
        return g[i * n:(i + 1) * n].contiguous(), None


def _expert_group(mesh, axis):
    from . import mesh as mesh_mod

    if mesh is None:
        mesh = mesh_mod.scope_mesh()
    if mesh is None or axis not in mesh.axis_names:
        return None
    return mesh.group((axis,))


def route(x, router_w, capacity_factor=1.25, top_k=1):
    """The routing of :func:`moe_ffn` on tokens ``x`` (S, M): a dict with
    ``probs`` (S, E), ``expert_k`` and ``pos_k`` (S, k) int64, ``keep_k``
    (S, k) bool, ``gate_k`` (S, k) (kept gates), ``dispatch`` and
    ``combine`` (S, E, C) and ``C``."""
    if top_k not in (1, 2):
        raise MXNetError(f"top_k must be 1 or 2, got {top_k}")
    S = x.shape[0]
    E = router_w.shape[1]
    C = max(1, int(capacity_factor * top_k * S / E))
    probs = torch.softmax(x @ router_w, dim=-1)
    first = torch.argmax(probs, dim=-1)          # the lower index on a tie
    experts = [first]
    if top_k == 2:
        others = probs.masked_fill(F.one_hot(first, E).bool(), -1.0)
        experts.append(torch.argmax(others, dim=-1))
    expert_k = torch.stack(experts, dim=1)                   # (S, k)
    gate_k = torch.gather(probs, 1, expert_k)
    if top_k == 2:
        # GShard: renormalize the pair so the gates sum to 1
        gate_k = gate_k / torch.clamp(gate_k.sum(dim=-1, keepdim=True),
                                      min=1e-9)
    # capacity accounting in priority order: all first choices, then all
    # second choices (a secondary assignment never evicts a primary one)
    onehot_k = F.one_hot(expert_k, E).to(torch.int32)        # (S, k, E)
    flat = onehot_k.transpose(0, 1).reshape(top_k * S, E)
    pos_flat = torch.cumsum(flat, dim=0, dtype=torch.int32) * flat - 1
    pos_k = pos_flat.amax(dim=-1).reshape(top_k, S).t()      # (S, k)
    keep_k = pos_k < C
    gate_k = gate_k * keep_k
    dispatch = torch.zeros((S, E, C), dtype=x.dtype, device=x.device)
    combine = torch.zeros_like(dispatch)
    for j in range(top_k):
        d_j = (F.one_hot(expert_k[:, j], E).to(x.dtype)[:, :, None]
               * F.one_hot(torch.clamp(pos_k[:, j], 0, C - 1).long(),
                           C).to(x.dtype)[:, None, :]
               * keep_k[:, j, None, None].to(x.dtype))
        dispatch = dispatch + d_j
        combine = combine + d_j * gate_k[:, j, None, None]
    return {"probs": probs, "expert_k": expert_k, "pos_k": pos_k,
            "keep_k": keep_k, "gate_k": gate_k, "onehot": onehot_k[:, 0],
            "dispatch": dispatch, "combine": combine, "C": C}


def moe_ffn(x, router_w, w1, b1, w2, b2, mesh=None, axis="ep",
            capacity_factor=1.25, top_k=1):
    """Top-1 (Switch) or top-2 (GShard) MoE feed-forward (ref:
    ``moe_ffn``, moe.py:29).

    ``x`` (..., M) tokens (leading dims flattened into one token axis and
    restored); ``router_w`` (M, E); ``w1`` (E', M, H); ``b1`` (E', H);
    ``w2`` (E', H, M); ``b2`` (E', M), with E' = E (every expert) or E/ep
    (this rank's experts under the ``axis`` group of ``mesh`` or of the
    mesh scope: the module docstring).  Returns ``(y shaped like x,
    aux_loss scalar)``.

    ``top_k=2`` follows GShard: the two gates are renormalized to sum to
    one, and capacity positions are assigned first-choice-first; tokens
    over capacity drop to the residual path."""
    lead = tuple(x.shape[:-1])
    M = x.shape[-1]
    if x.dim() != 2:
        x = x.reshape(-1, M)
    E = router_w.shape[1]
    r = route(x, router_w, capacity_factor, top_k)
    expert_in = torch.einsum("sec,sm->ecm", r["dispatch"], x)
    local = w1.shape[0]
    group = None
    if local != E:
        group = _expert_group(mesh, axis)
        if group is None or local * group.size != E:
            raise MXNetError(
                f"moe_ffn: the expert weights hold {local} experts and the "
                f"router {E}; {local} local experts need an '{axis}' group "
                f"of {E // max(local, 1)} ranks (a mesh with that axis, "
                "or the DataParallelTrainer's step), found "
                f"{'none' if group is None else group.size}")
        expert_in = _ExpertSlice.apply(expert_in, group)
    h = torch.relu(torch.einsum("ecm,emh->ech", expert_in, w1)
                   + b1[:, None, :])
    expert_out = torch.einsum("ech,ehm->ecm", h, w2) + b2[:, None, :]
    if group is not None:
        expert_out = _ExpertGather.apply(expert_out, group)
    y = torch.einsum("sec,ecm->sm", r["combine"], expert_out)
    # load-balancing auxiliary loss (Switch/GShard): mean gate fraction x
    # mean dispatch fraction per expert, scaled by E
    me = r["probs"].mean(dim=0)
    ce = r["onehot"].to(x.dtype).mean(dim=0)
    aux = E * torch.sum(me * ce)
    return y.reshape(lead + (M,)), aux


class MoEBlock:
    """Parameters and their initialization for :func:`moe_ffn` (ref:
    ``MoEBlock``, moe.py:111), drawn from an explicit ``torch.Generator``
    seeded with ``seed`` (the JAX class splits a PRNG key: the two
    packages' draws differ)."""

    def __init__(self, num_experts, d_model, d_hidden, seed=0, ctx=None):
        if num_experts < 2:
            raise MXNetError("MoE needs >= 2 experts")
        from ..context import Context, current_context

        dev = Context(ctx if ctx is not None else current_context()) \
            .torch_device()
        gen = torch.Generator().manual_seed(int(seed))
        s1 = (2.0 / d_model) ** 0.5

        def normal(*shape):
            return torch.randn(shape, generator=gen).to(dev)

        self.router_w = normal(d_model, num_experts) * s1
        self.w1 = normal(num_experts, d_model, d_hidden) * s1
        self.b1 = torch.zeros((num_experts, d_hidden), device=dev)
        self.w2 = normal(num_experts, d_hidden, d_model) \
            * (2.0 / d_hidden) ** 0.5
        self.b2 = torch.zeros((num_experts, d_model), device=dev)

    def params(self):
        return (self.router_w, self.w1, self.b1, self.w2, self.b2)

    @staticmethod
    def param_specs(axis="ep"):
        """The specs of :meth:`params` over a mesh: the router replicated,
        the expert-stacked weights' dim 0 over ``axis``."""
        return ((), (axis, None, None), (axis, None), (axis, None, None),
                (axis, None))


def gluon_moe_param_spec_fn(mesh, axis="ep"):
    """``(name, shape) -> spec`` for ``DataParallelTrainer(param_spec_fn=)``
    (ref: moe.py:142): gluon ``MoEFFN``'s expert-stacked parameters (w1,
    b1, w2, b2; dim 0 the expert count) split over ``axis``; the router
    and every other parameter fall through to the trainer's default.
    None (no hook) when the mesh has no ``axis`` of more than one rank, so
    ``param_spec_fn=gluon_moe_param_spec_fn(mesh)`` is safe to pass
    always.  An expert count that ``axis`` does not divide raises."""
    if axis not in mesh.axis_names or mesh.shape[axis] <= 1:
        return None
    E = mesh.shape[axis]

    def fn(name, shape):
        if "moeffn" in name and "router" not in name and len(shape) >= 2:
            if shape[0] % E:
                # replicating here would let a run claim expert
                # parallelism while sharding nothing
                raise MXNetError(
                    f"expert dim {shape[0]} of {name} does not divide "
                    f"the '{axis}' mesh axis ({E}); pick num_experts "
                    f"divisible by {axis}")
            return (axis,) + (None,) * (len(shape) - 1)
        return None

    return fn
