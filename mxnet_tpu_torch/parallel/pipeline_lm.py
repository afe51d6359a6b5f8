"""A pipeline-parallel causal transformer LM over dp x [sp x] tp x pp (ref:
``mxnet_tpu/parallel/pipeline_lm.py``).

The JAX package runs one ``shard_map`` program over the whole mesh and
lets autodiff and ``psum`` place the reductions.  The port runs one rank
per device (``parallel.mesh``) and places each collective itself:

- **pp**: the explicit GPipe schedule of ``parallel.spmd.schedule``
  (:func:`~mxnet_tpu_torch.parallel.spmd.schedule.gpipe_forward` and
  ``gpipe_backward``).  Each stage holds its L/P blocks (the ``pp`` slice of
  the stacked tree); the hidden state (mb, S, D) goes to the next stage by
  point-to-point sends, its gradient comes back the same way.  Stage 0
  embeds, the last stage runs the head and the loss.  The embedding lives
  only on stage 0 and the head only on the last stage, so no rank
  reduces their gradients over ``pp``; reading them (:meth:`full_tree`,
  :meth:`save_states`) broadcasts them from their stage.
- **tp**: Megatron inside each block.  ``wqkv`` (D, 3, D) splits its last
  dim (q, k and v on their own axis, so heads divide), ``w1``/``b1`` are
  column-split, ``wo``/``w2`` row-split.  The "f" operator (identity
  forward, all-reduce over ``tp`` backward) feeds each column-split
  product; the "g" operator (all-reduce forward, identity backward) closes
  each row-split one.  Every ``tp`` rank then holds the same activations
  and computes the same (true) gradient of every replicated parameter, so
  nothing else is reduced over ``tp``.
- **sp** (when the mesh's ``sp`` axis is > 1): Ulysses, an all-to-all over
  ``sp`` around each attention (q, k and v as one tensor), the sequence
  sharded everywhere else, positions offset by the shard.
- **dp** and **sp**: the loss is the mean over micro-batches of each
  micro-batch's mean NLL (log-softmax in fp32), averaged over ``dp`` and
  ``sp``; each rank backpropagates its share and the gradients are summed
  over the ``(dp, sp)`` group.

Axes other than these four replicate the whole run.  The attention is
``ops.attention._k_sdpa(causal=True)``: the flash kernels on CUDA
tensors, the oracle on CPU tensors.  Every rank must make the same calls
in the same order (the collectives are blocking and matched by order).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tF
import torch.utils.checkpoint

from ..base import MXNetError
from . import mesh as _mesh_mod
from .spmd.schedule import gpipe_backward, gpipe_forward


def _draws(vocab, d_model, n_layers, d_ff, seq_len, n_stages, seed):
    """The JAX package's tree as float32 numpy, from the same
    ``RandomState`` draws in the same order."""
    if n_layers % n_stages:
        raise MXNetError(f"n_layers {n_layers} must divide into "
                         f"n_stages {n_stages}")
    lp = n_layers // n_stages
    rng = np.random.RandomState(seed)

    def init(*shape, scale=None):
        scale = scale if scale is not None else (2.0 / shape[-2]) ** 0.5
        return rng.normal(0.0, scale, shape).astype(np.float32)

    P, D, F = n_stages, d_model, d_ff
    ones = lambda *s: np.ones(s, np.float32)  # noqa: E731
    zeros = lambda *s: np.zeros(s, np.float32)  # noqa: E731
    embed = {"tok": init(vocab, D, scale=0.02),
             "pos": init(seq_len, D, scale=0.02)}
    blocks = {}
    blocks["ln1_g"], blocks["ln1_b"] = ones(P, lp, D), zeros(P, lp, D)
    # (..., 3, D): q, k and v on their own axis, so the tp split of the
    # last dim divides heads
    blocks["wqkv"] = init(P, lp, D, 3, D)
    blocks["wo"] = init(P, lp, D, D)
    blocks["ln2_g"], blocks["ln2_b"] = ones(P, lp, D), zeros(P, lp, D)
    blocks["w1"], blocks["b1"] = init(P, lp, D, F), zeros(P, lp, F)
    blocks["w2"] = init(P, lp, F, D, scale=(2.0 / F) ** 0.5)
    blocks["b2"] = zeros(P, lp, D)
    return {"embed": embed, "blocks": blocks,
            "head": {"w": init(D, vocab, scale=0.02)}}


def params_from_numpy(tree, ctx=None, dtype=None):
    """A tree in the JAX package's layout (``embed``/``blocks``/``head``,
    numpy or tensor leaves) as the port's: tensors on ``ctx`` (default the
    current context), cast to ``dtype`` where given."""
    from ..context import current_context

    dev = (ctx or current_context()).torch_device()
    return {g: {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(
                    np.array(v))).to(dev, dtype)
                for k, v in sub.items()} for g, sub in tree.items()}


def params_to_numpy(tree):
    """The inverse of :func:`params_from_numpy`: numpy leaves (copies)."""
    return {g: {k: v.detach().cpu().numpy().copy() for k, v in sub.items()}
            for g, sub in tree.items()}


def init_pipeline_lm(vocab, d_model, n_layers, d_ff, n_heads, seq_len,
                     n_stages, seed=0, dtype=torch.float32, ctx=None):
    """The parameter tree of a causal transformer LM with its L layers
    stacked (P, L/P, ...) for the ``pp`` axis, on ``ctx`` (default the
    current context).  The weights are the JAX package's
    (``init_pipeline_lm``), drawn from the same ``RandomState`` sequence."""
    return params_from_numpy(_draws(vocab, d_model, n_layers, d_ff, seq_len,
                                    n_stages, seed), ctx, dtype)


def param_specs(tp_axis="tp", pp_axis="pp"):
    """The ``parallel.mesh`` specs of :func:`init_pipeline_lm`'s tree: the
    blocks over ``pp`` on the stage dim, Megatron's column and row splits
    over ``tp``."""
    return {
        "embed": {"tok": (), "pos": ()},
        "blocks": {
            "ln1_g": (pp_axis, None, None),
            "ln1_b": (pp_axis, None, None),
            "wqkv": (pp_axis, None, None, None, tp_axis),  # column-parallel
            "wo": (pp_axis, None, tp_axis, None),          # row-parallel
            "ln2_g": (pp_axis, None, None),
            "ln2_b": (pp_axis, None, None),
            "w1": (pp_axis, None, None, tp_axis),
            "b1": (pp_axis, None, tp_axis),
            "w2": (pp_axis, None, tp_axis, None),
            "b2": (pp_axis, None, None),
        },
        "head": {"w": ()},
    }


def _ln(x, g, b, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def _causal_attention(q, k, v):
    """Causal attention on (b, h, S, hd) through the op library's dispatch
    (``ops.attention._k_sdpa``): the flash kernels on CUDA tensors, the
    oracle on CPU tensors."""
    from ..ops.attention import _k_sdpa

    return _k_sdpa(q, k, v, causal=True)


class _ToGroup(torch.autograd.Function):
    """Megatron's "f": identity forward, the sum of the cotangents over the
    group backward."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce_(
            g.clone(memory_format=torch.contiguous_format), "act"), None


class _FromGroup(torch.autograd.Function):
    """Megatron's "g": the sum over the group forward, identity
    backward."""

    @staticmethod
    def forward(ctx, t, group):
        return group.all_reduce_(
            t.clone(memory_format=torch.contiguous_format), "act")

    @staticmethod
    def backward(ctx, g):
        return g, None


def _to_tp(t, group):
    return t if group is None or group.size == 1 else _ToGroup.apply(t, group)


def _from_tp(t, group):
    return t if group is None or group.size == 1 else _FromGroup.apply(t,
                                                                       group)


def _block(layer, h, *, n_heads_local, tp_group=None, sp_group=None):
    """One transformer block on this rank's ``tp`` shard of its weights: h
    (mb, S_local, D) the same on every ``tp`` rank, sharded over ``sp`` on
    the sequence."""
    mb, S, D = h.shape
    a = _ln(h, layer["ln1_g"], layer["ln1_b"])
    wqkv = layer["wqkv"]
    qkv = (_to_tp(a, tp_group) @ wqkv.reshape(D, -1)).reshape(
        mb, S, 3, wqkv.shape[-1])
    dl = qkv.shape[-1]
    hd = dl // n_heads_local
    q, k, v = (qkv[:, :, i].reshape(mb, S, n_heads_local, hd).transpose(1, 2)
               for i in range(3))                    # (mb, h, S, hd)
    if sp_group is not None and sp_group.size > 1:
        # heads -> sp groups, sequence shards -> the full sequence
        q, k, v = _mesh_mod.all_to_all(torch.stack([q, k, v]), sp_group, 2,
                                       3).unbind(0)
    ctx = _causal_attention(q, k, v)
    if sp_group is not None and sp_group.size > 1:
        ctx = _mesh_mod.all_to_all(ctx, sp_group, 2, 1)
    ctx = ctx.transpose(1, 2).reshape(mb, S, dl)
    h = h + _from_tp(ctx @ layer["wo"], tp_group)     # row-parallel
    a = _ln(h, layer["ln2_g"], layer["ln2_b"])
    f = tF.gelu(_to_tp(a, tp_group) @ layer["w1"] + layer["b1"],
                approximate="tanh")                  # column-parallel
    return h + _from_tp(f @ layer["w2"], tp_group) + layer["b2"]


def _stage(blocks_local, h, *, n_heads_local, tp_group=None, sp_group=None,
           remat=False):
    """This rank's L/P layers (leaves (lp, ...)) in order.  ``remat`` runs
    each block under ``torch.utils.checkpoint`` (non-reentrant): its
    activations are recomputed, collectives included, in the backward."""
    def blk(layer, x):
        return _block(layer, x, n_heads_local=n_heads_local,
                      tp_group=tp_group, sp_group=sp_group)

    for i in range(blocks_local["wqkv"].shape[0]):
        layer = {k: v[i] for k, v in blocks_local.items()}
        if remat:
            h = torch.utils.checkpoint.checkpoint(blk, layer, h,
                                                  use_reentrant=False)
        else:
            h = blk(layer, h)
    return h


def _nll(h, head_w, tgt):
    logits = h @ head_w
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, tgt[..., None])[..., 0].mean()


def _paths(tree):
    """``[(group, name)]`` in the JAX package's leaf order (sorted)."""
    return [(g, k) for g in sorted(tree) for k in sorted(tree[g])]


def _keystr(g, k):
    return f"['{g}']['{k}']"


def _leaf(v):
    """A tree leaf as a tensor or numpy array (an NDArray's tensor)."""
    from ..ndarray.ndarray import NDArray

    return v.data if isinstance(v, NDArray) else v


def _host(a):
    from ..ndarray.ndarray import NDArray

    if isinstance(a, NDArray):
        return a.asnumpy()
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class PipelineLMTrainer:
    """Causal-LM training over dp x [sp x] tp x pp (ref:
    ``PipelineLMTrainer``, pipeline_lm.py:298).

    ``mesh`` (``parallel.mesh.make_mesh``, one rank per device) must carry
    the axes ``dp``, ``tp`` and ``pp`` (any sizes, 1 allowed) and may carry
    ``sp`` (Ulysses when > 1; ``n_heads % (tp * sp) == 0`` and ``seq_len %
    sp == 0``).  ``params``: :func:`init_pipeline_lm`'s tree (tensors,
    numpy or NDArrays), the same on every rank; each rank copies its part
    to the mesh's device.  ``step(tokens, targets)`` on every rank with the
    global (B, S) batch, ``B % (dp * n_micro) == 0``, returns the float
    loss; :meth:`save_states` and :meth:`load_states` checkpoint the
    parameters, Adam's moments and the step counter in the JAX package's
    ``.npz`` layout, so files move between the packages both ways.

    ``params``, ``opt_m`` and ``opt_v`` are this rank's tensors (the
    stage's blocks, ``tp`` shards; the embedding on stage 0 and the head on
    the last stage only); :meth:`full_params` reads the full tree."""

    def __init__(self, params, mesh, n_heads, n_micro=None, lr=1e-3,
                 dp_axis="dp", tp_axis="tp", pp_axis="pp", sp_axis="sp",
                 remat=False):
        for ax in (dp_axis, tp_axis, pp_axis):
            if ax not in mesh.axis_names:
                raise MXNetError(f"mesh needs axis {ax!r}, has "
                                 f"{mesh.axis_names}")
        self.mesh = mesh
        self.P = mesh.shape[pp_axis]
        self.tp = mesh.shape[tp_axis]
        self.dp = mesh.shape[dp_axis]
        self.sp = mesh.shape.get(sp_axis, 1)
        self.n_heads = n_heads
        if n_heads % (self.tp * self.sp):
            raise MXNetError(
                f"n_heads {n_heads} must be divisible by tp*sp = "
                f"{self.tp}*{self.sp} (Ulysses splits heads over both)")
        n_stages = params["blocks"]["wqkv"].shape[0]
        if n_stages != self.P:
            raise MXNetError(
                f"params stacked for {n_stages} stages but mesh pp axis "
                f"has size {self.P}; re-init with n_stages={self.P}")
        self.n_micro = n_micro if n_micro is not None else max(2, self.P)
        self.lr = lr
        self.remat = bool(remat)
        self._specs = param_specs(tp_axis, pp_axis)
        self._tp_axis = tp_axis
        self._pp = mesh.group((pp_axis,))
        self._tp = mesh.group((tp_axis,))
        self._sp = mesh.group((sp_axis,)) if self.sp > 1 else None
        self._data = mesh.group(tuple(a for a in (dp_axis, sp_axis)
                                      if a in mesh.axis_names))
        self._all = mesh.group(tuple(a for a in (dp_axis, tp_axis, pp_axis,
                                                 sp_axis)
                                     if a in mesh.axis_names))
        self._dp_index = mesh.group((dp_axis,)).index
        self._sp_index = self._sp.index if self._sp is not None else 0
        stage = self._pp.index
        owned = {"embed": stage == 0, "blocks": True,
                 "head": stage == self.P - 1}
        self._shapes = {(g, k): tuple(v.shape) for g, sub in params.items()
                        for k, v in sub.items()}
        self.params = {g: {} for g in params}
        for g, k in _paths(params):
            if not owned[g]:
                continue
            full = _leaf(params[g][k])
            part = full[_mesh_mod.shard_slices(self._specs[g][k],
                                               self._shapes[g, k], mesh)]
            part = torch.as_tensor(np.ascontiguousarray(part) if isinstance(
                part, np.ndarray) else part).to(mesh.device, copy=True)
            self.params[g][k] = part[0] if g == "blocks" else part
        self._dtype = next(iter(self.params["blocks"].values())).dtype
        self.opt_m = {g: {k: torch.zeros_like(v) for k, v in sub.items()}
                      for g, sub in self.params.items()}
        self.opt_v = {g: {k: torch.zeros_like(v) for k, v in sub.items()}
                      for g, sub in self.params.items()}
        self._t = 0

    # -- the schedule ------------------------------------------------------------

    def _local_batch(self, arr):
        """This rank's (n_micro, mb, S_local) of a global (B, S) batch."""
        a = _host(arr)
        B = a.shape[0]
        group = self.dp * self.n_micro
        if B % group:
            raise MXNetError(
                f"batch {B} must divide dp*n_micro = {group}")
        if a.shape[1] % self.sp:
            raise MXNetError(
                f"seq_len {a.shape[1]} must be divisible by the "
                f"sp axis size {self.sp}")
        mb, s = B // group, a.shape[1] // self.sp
        a = a.reshape(self.n_micro, self.dp * mb, -1)
        a = a[:, self._dp_index * mb:(self._dp_index + 1) * mb,
              self._sp_index * s:(self._sp_index + 1) * s]
        return torch.as_tensor(np.ascontiguousarray(a).astype(np.int64),
                               device=self.mesh.device)

    def loss_and_grads(self, tokens, targets):
        """The global loss (float, on every rank) and this rank's gradients
        (the tree of :attr:`params`) of one step, without updating."""
        toks, tgts = self._local_batch(tokens), self._local_batch(targets)
        leaves = {(g, k): v.detach().requires_grad_()
                  for g, sub in self.params.items() for k, v in sub.items()}
        tree = {g: {k: leaves[g, k] for k in sub}
                for g, sub in self.params.items()}
        emb, head, blocks = tree["embed"], tree["head"], tree["blocks"]
        mb, S = toks.shape[1], toks.shape[2]
        D = self._shapes["embed", "tok"][1]
        off = self._sp_index * S
        heads_local = self.n_heads // self.tp

        def embed(t):
            pos = emb["pos"][off:off + S]
            return tF.embedding(toks[t], emb["tok"]) + pos[None]

        def stage(h):
            return _stage(blocks, h, n_heads_local=heads_local,
                          tp_group=self._tp, sp_group=self._sp,
                          remat=self.remat)

        seed = 1.0 / (self.n_micro * self.dp * self.sp)
        with torch.enable_grad():
            records = gpipe_forward(
                self._pp, self.n_micro, (mb, S, D), self._dtype,
                self.mesh.device, embed, stage,
                lambda t, h: _nll(h, head["w"], tgts[t]))
            gpipe_backward(self._pp, records,
                           lambda t, loss: torch.full_like(loss, seed))
        grads = {g: {k: (leaves[g, k].grad if leaves[g, k].grad is not None
                         else torch.zeros_like(leaves[g, k])) for k in sub}
                 for g, sub in self.params.items()}
        _mesh_mod.sum_in_place(self._data, [grads[g][k] for g, k in
                                            _paths(grads)])
        last = self._pp.index == self.P - 1
        loss = torch.zeros(1, dtype=torch.float64)
        if last:
            loss[0] = sum(float(l.detach()) for _, l in records) / self.n_micro
        self._all.all_reduce_(loss, "loss")
        return float(loss[0]) / (self.dp * self.sp * self.tp), grads

    def step(self, tokens, targets):
        """One Adam step on the global (B, S) ``tokens`` and ``targets``
        (the same on every rank); returns the loss."""
        loss, grads = self.loss_and_grads(tokens, targets)
        self._t += 1
        t = torch.tensor(float(self._t), dtype=torch.float32,
                         device=self.mesh.device)
        b1, b2, eps = 0.9, 0.999, 1e-8
        with torch.no_grad():
            for g, k in _paths(self.params):
                p, gr = self.params[g][k], grads[g][k]
                m, v = self.opt_m[g][k], self.opt_v[g][k]
                m2 = b1 * m + (1 - b1) * gr
                v2 = b2 * v + (1 - b2) * gr * gr
                mh = m2 / (1 - b1 ** t)
                vh = v2 / (1 - b2 ** t)
                p.sub_(self.lr * mh / (torch.sqrt(vh) + eps))
                m.copy_(m2)
                v.copy_(v2)
        return loss

    # -- reads and checkpoints ---------------------------------------------------

    def full_tree(self, tree):
        """The full arrays (numpy, the JAX package's layout) of a tree of
        this rank's tensors (:attr:`params`, :attr:`opt_m`, :attr:`opt_v`
        or :meth:`loss_and_grads`' gradients), on every rank: the blocks
        all-gathered over ``tp`` and ``pp``, the embedding and head
        broadcast from their stage.  Every rank calls it."""
        out = {g: {} for g in self._specs}
        for g, k in _paths(self._specs):
            shape = self._shapes[g, k]
            if g == "blocks":
                spec, tp_axis = self._specs[g][k], self._tp_axis
                part = tree[g][k].detach().contiguous()
                if tp_axis in spec:
                    part = torch.cat(self._tp.all_gather(part, "param"),
                                     dim=spec.index(tp_axis) - 1)
                full = torch.stack(self._pp.all_gather(part, "param"))
            else:
                owner = 0 if g == "embed" else self.P - 1
                full = (tree[g][k].detach().clone() if self._pp.index == owner
                        else torch.empty(shape, dtype=self._dtype,
                                         device=self.mesh.device))
                self._pp.broadcast_(full, owner)
            out[g][k] = full.detach().cpu().numpy().copy()
        return out

    def full_params(self):
        """The full parameter tree as numpy (a collective: every rank)."""
        return self.full_tree(self.params)

    def save_states(self, path):
        """Write the parameters, Adam's moments and the step counter to one
        ``.npz`` in the JAX package's layout (``p``/``m``/``v`` plus the
        ``keystr`` path, and ``__step__``).  Every rank calls it (the full
        arrays are gathered); the first rank of the trainer's axes writes,
        and every rank returns once the file is written.  ``load_states``
        then ``step`` reproduces the unbroken run."""
        flat = {}
        for name, tree in (("p", self.params), ("m", self.opt_m),
                           ("v", self.opt_v)):
            for g, sub in self.full_tree(tree).items():
                for k, v in sub.items():
                    flat[name + _keystr(g, k)] = v
        if self._all.index == 0:
            np.savez(path, __step__=self._t, **{k: flat[k] for k in sorted(
                flat)})
        self._all.all_reduce_(torch.zeros(1), "param")  # the file is there

    def load_states(self, path):
        """The inverse of :meth:`save_states`: every rank reads the file
        and takes its part.  The whole checkpoint is validated first (a
        missing key, a shape or a dtype), so a bad file leaves the trainer
        as it was."""
        with np.load(path) as z:
            step = int(z["__step__"])
            blobs = {k: z[k] for k in z.files if k != "__step__"}
        want = np.dtype(str(self._dtype).replace("torch.", ""))
        for name in ("p", "m", "v"):
            for g, k in _paths(self._specs):
                key = name + _keystr(g, k)
                if key not in blobs:
                    raise MXNetError(f"checkpoint missing {key}")
                if blobs[key].shape != self._shapes[g, k]:
                    raise MXNetError(
                        f"checkpoint {key} shape {blobs[key].shape} != "
                        f"{self._shapes[g, k]}")
                if blobs[key].dtype != want:
                    raise MXNetError(
                        f"checkpoint {key} dtype {blobs[key].dtype} != "
                        f"trainer dtype {want}")
        for name, tree in (("p", self.params), ("m", self.opt_m),
                           ("v", self.opt_v)):
            for g, k in _paths(tree):
                sl = _mesh_mod.shard_slices(self._specs[g][k],
                                            self._shapes[g, k], self.mesh)
                part = torch.as_tensor(np.ascontiguousarray(
                    blobs[name + _keystr(g, k)][sl]))
                tree[g][k].copy_(part[0] if g == "blocks" else part)
        self._t = step


def reference_lm_loss(params, tokens, targets, n_heads):
    """The one-device oracle: the same model, no mesh (for parity tests).
    ``params`` a tree of tensors; ``tokens``/``targets`` (B, S)."""
    emb, head, blocks = params["embed"], params["head"], params["blocks"]
    dev = emb["tok"].device
    tokens = torch.as_tensor(_host(tokens).astype(np.int64), device=dev)
    targets = torch.as_tensor(_host(targets).astype(np.int64), device=dev)
    P, lp = blocks["wqkv"].shape[0], blocks["wqkv"].shape[1]
    S = tokens.shape[1]
    h = tF.embedding(tokens, emb["tok"]) + emb["pos"][None, :S]
    for p in range(P):
        for i in range(lp):
            layer = {k: v[p, i] for k, v in blocks.items()}
            h = _block(layer, h, n_heads_local=n_heads)
    return _nll(h, head["w"], targets)
