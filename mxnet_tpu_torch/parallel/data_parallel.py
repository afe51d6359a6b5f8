"""Data-parallel training step over a device mesh (ref:
``mxnet_tpu/parallel/data_parallel.py``).

``DataParallelTrainer`` is ResNet's and BERT's training entry point in the
JAX package (``examples/image-classification/train_imagenet.py``,
``bench.py``).  Like the JAX class it keeps its own copies of the
parameters (fp32 masters) and of the optimizer states, runs the block's
forward on those copies, and writes them back into the block's Parameters
only in :meth:`~DataParallelTrainer.sync_to_block`.  The update rules are
its own (``apply_opt``), not ``optimizer.py``'s.

The mesh (``parallel.mesh``) is one rank per device; ``mesh=None`` is
``make_mesh()``, ``{"dp": world size}``.  Where GSPMD decides the JAX
class's collectives, this class writes them, each route decided at
:meth:`~DataParallelTrainer.build`:

- build broadcasts rank 0's parameter values to every rank (the JAX class
  assumes every process holds the same host value) and places each master
  by its spec: replicated, over ``tp`` by ``shard_param_spec`` under
  ``shard_params=True``, or by ``param_spec_fn(name, shape)``;
- :meth:`~DataParallelTrainer.step` takes the GLOBAL batch on every rank,
  and each rank its rows by ``batch_sharding`` (data index ``dcn_idx * dp
  + dp_idx``); with ``accum_steps`` a rank's micro-batch ``i`` is its slice
  of global micro-batch ``i``;
- a parameter sharded at rest is all-gathered over its axes for the
  forward (the tp ranks of one data group compute the same rows), except
  one split over ``ep`` only (``EXPERT_AXES``): the MoE experts, which the
  forward runs as this rank's shard (``parallel.moe``, whose ``ep`` group
  comes from the :func:`parallel.mesh.data_scope` set around the forward
  on a mesh of more than one rank); its gradient and optimizer states are
  the shard's;
- BatchNorm statistics are summed over the data axes inside the forward
  (``parallel.mesh.data_scope``), as the sharded batch's are in the JAX
  step;
- the local mean loss's gradients are summed over the data axes in flat
  same-dtype buckets (one collective a bucket) and divided by their size:
  the global batch's mean gradient; the reported loss is the data group's
  mean;
- ``shard_opt_states`` (ZeRO-1): each state tensor is split over ``dp`` on
  its largest dim that ``dp`` divides, and a rank reduce-scatters the
  gradient, updates its slice, and all-gathers the parameter; ``lamb``'s
  norms sum the slices' squares over the group first.

``remat`` wraps each direct child whose parameters all take gradients in
``torch.utils.checkpoint`` (non-reentrant); the recompute restores the
dropout generators of the trainer's device, the parameters the child read,
the training flag and the BatchNorm scope as the forward had them.  A
model with no such child gets one checkpoint around its whole forward.

Capture.  A one-rank mesh's step is captured as the JAX class compiles it
into one ``jax.jit`` call (ref: ``step``, :489-517): on the card, the first
call of an input signature runs the step eagerly on a side stream (the
warm-up), the next captures it in a CUDA graph
(``gluon.whole_step.CapturedStep``) and replays it, and every later call
copies its batch and its scalars (lr, t and Adam's bias corrections, in
one small device buffer) into the graph's static buffers and replays it.
On a mesh of more than one rank the step runs eagerly: capturing a step
with collectives inside it (NCCL) comes with part 2b of the distributed
slice, and under gloo (several ranks on one card) it cannot be captured at
all.  ``remat`` also runs eagerly (a capture cannot restore generator
states).  Both are decided at build, logged once and counted in
``stats``.  On the CPU every step runs eagerly.
:meth:`~DataParallelTrainer.step_many` is K steps with no host
synchronisation between them beyond the collectives.

:meth:`~DataParallelTrainer.save_states` writes the JAX class's sharded
checkpoint (``{prefix}-meta.npz`` from rank 0 and
``{prefix}-shards-p{rank}.npz`` with the shards a rank is replica 0 of),
so either package resumes the other's on the same mesh;
:meth:`~DataParallelTrainer.load_states` copies into the masters and
states in place.  Resharding onto another mesh, the Trainer's ZeRO and the
captured step with collectives come with part 2b of the distributed slice
(ROADMAP queue 1).
"""
from __future__ import annotations

import contextlib
import glob
import logging

import numpy as np
import torch

from .. import _imperative
from .. import autograd
from .. import optimizer as _opt
from .. import random as _random
from ..base import MXNetError
from ..gluon import whole_step as _ws
from ..ndarray.ndarray import NDArray, to_torch_dtype
from . import dist
from . import mesh as mesh_mod

_log = logging.getLogger("mxnet_tpu_torch.parallel.data_parallel")

#: mesh axes over which a parameter is computed on as its shard: the
#: expert-stacked MoE weights over ``ep`` (``parallel.moe``)
EXPERT_AXES = ("ep",)


def _f32_correction(beta, t):
    """``1 - beta**t`` computed in float32, as the reference's float32 step
    computes it."""
    b = torch.tensor(beta, dtype=torch.float32)
    return float(1.0 - b ** torch.tensor(float(t), dtype=torch.float32))


def _block_device(block):
    for p in block.collect_params().values():
        if p._data is not None:
            return p._data.device
        if p._deferred_init is not None:  # (init, ctx, default_init)
            ctx = p._deferred_init[1]
            return (ctx[0] if isinstance(ctx, list) else ctx).torch_device()
    raise MXNetError("DataParallelTrainer: initialize() the block first")


def _as_tensor(x, device):
    if isinstance(x, NDArray):
        x = x.data
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x))
    return x.to(device)


def _host(x):
    """``x`` as a tensor where it lies (numpy on the host)."""
    if isinstance(x, NDArray):
        return x.data
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.asarray(x))


class DataParallelTrainer:
    """A training step over ``block`` on ``mesh``: forward, ``loss_fn``,
    backward and the optimizer update on the trainer's copies of the
    parameters.

    ``optimizer`` is ``sgd`` (with or without ``momentum``), ``adam``,
    ``adamw`` or ``lamb``; ``optimizer_params`` take ``learning_rate``,
    ``momentum``, ``wd``, ``beta1``, ``beta2``, ``epsilon`` and
    ``clip_gradient``.  With ``compute_dtype`` the trainable parameters and
    the inputs are cast to it for the forward and backward, the
    non-trainable ones (BatchNorm's moving statistics) stay fp32, and the
    gradients land in fp32 on the masters.  ``accum_steps`` splits the
    batch into that many micro-batches whose mean gradient makes one
    update; the moving statistics are those of the last micro-batch.
    ``shard_params``, ``param_spec_fn``, ``shard_opt_states`` and
    ``remat`` are the JAX class's (module docstring).  ``capture=False``
    runs the step body eagerly at every call on the card too (the eager
    twin of the captured step, bit for bit).  ``donate`` is taken for the
    API: the masters are always updated in place."""

    def __init__(self, block, loss_fn, optimizer="sgd", optimizer_params=None,
                 mesh=None, shard_params=False, donate=True,
                 shard_opt_states=False, compute_dtype=None, remat=False,
                 param_spec_fn=None, accum_steps=1, capture=True):
        if optimizer not in ("sgd", "adam", "adamw", "lamb"):
            raise MXNetError(f"DataParallelTrainer supports sgd/adam/adamw/"
                             f"lamb, got {optimizer!r}")
        if mesh is None:
            mesh = mesh_mod.make_mesh()
        elif not isinstance(mesh, mesh_mod.Mesh):
            raise MXNetError(f"DataParallelTrainer: mesh must be a "
                             f"parallel.mesh.Mesh (make_mesh), got "
                             f"{type(mesh).__name__}")
        self.block = block
        self.loss_fn = loss_fn
        self.mesh = mesh
        self._accum = int(accum_steps)
        if self._accum < 1:
            raise MXNetError(f"accum_steps must be >= 1, got {accum_steps}")
        self._compute_dtype = to_torch_dtype(compute_dtype) \
            if compute_dtype is not None else None
        opt_params = dict(optimizer_params or {})
        self._lr = float(opt_params.pop("learning_rate", 0.01))
        self._opt_name = optimizer
        self._opt_params = opt_params
        self._shard_params = bool(shard_params)
        self._param_spec_fn = param_spec_fn
        self._shard_opt_states = bool(shard_opt_states)
        self._remat = bool(remat)
        self._remat_flat = False
        self._named = None    # [(name, Parameter)]
        self._params = None   # the masters: this rank's shard of each
        self._states = None   # optimizer state per parameter (its shard)
        self._specs = None        # each parameter's spec
        self._state_specs = None  # each optimizer state's spec
        self._trainable = None
        self._device = None
        self._t = 0
        self._capture = bool(capture)
        #: why the step runs eagerly on the card (None: it is captured)
        self.eager_reason = None
        #: steps by rule: ``mesh_eager_steps`` (a mesh of more than one
        #: rank), ``remat_eager_steps`` (remat on one rank)
        self.stats = {"mesh_eager_steps": 0, "remat_eager_steps": 0}
        self._seen_sigs = set()
        self._graphs = {}      # input signature -> CapturedStep
        self._snapshot = None  # checkpoint.Snapshot of save_states
        self._writer = None    # its writer thread
        self._saving = None    # the future of the last save_states

    # -- set-up ---------------------------------------------------------------

    def _opt_state_spec(self, shape):
        """ZeRO-1 (ref: ``_opt_state_sharding``, :149-161): the largest dim
        of ``shape`` that ``dp`` divides (and is >= dp) over ``dp``;
        replicated otherwise."""
        dp = self.mesh.shape.get("dp", 1)
        dims = [None] * len(shape)
        if self._shard_opt_states and dp > 1:
            for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
                if shape[i] % dp == 0 and shape[i] >= dp:
                    dims[i] = "dp"
                    break
        return tuple(dims) if any(d is not None for d in dims) else ()

    def build(self, x):
        """Finish the block's deferred shapes with one forward in predict
        mode on the first two samples of ``x``, take this rank's copies of
        the parameters (rank 0's values, placed by their specs) and the
        optimizer states, and decide how the step runs.  Idempotent."""
        if self._params is not None:
            return
        if not self.block._active:
            self.block.hybridize()
        device = _block_device(self.block)
        multi = isinstance(x, (tuple, list))
        xs = tuple(x) if multi else (x,)
        probe = [_as_tensor(v, device)[:2] for v in xs]
        with autograd.pause(train_mode=False):
            self.block(*probe)
        mesh = self.mesh
        self._device = device
        self._named = self.block._ordered_params()
        with torch.no_grad():
            values = [p.data().detach().clone() for _, p in self._named]
        specs, custom = [], []
        for (name, _), v in zip(self._named, values):
            spec = None
            if self._param_spec_fn is not None:
                spec = self._param_spec_fn(name, tuple(v.shape))
            custom.append(spec is not None)
            if spec is None:
                spec = mesh_mod.shard_param_spec(tuple(v.shape), mesh) \
                    if self._shard_params else ()
            specs.append(tuple(spec) if mesh_mod.spec_mesh_axes(spec)
                         else ())
        if self._param_spec_fn is not None and not any(custom):
            # ref :137-146: a spec fn that placed nothing would silently
            # replicate what the user asked to shard
            raise MXNetError(
                "param_spec_fn matched no parameters; check the parameter "
                "names it filters on (e.g. gluon_moe_param_spec_fn expects "
                "the default 'moeffn' prefix)")
        self._specs = specs
        # parameters split over expert axes only are computed on as their
        # shards (parallel.moe), never gathered
        self._local = [bool(sp) and set(mesh_mod.spec_mesh_axes(sp))
                       <= set(EXPERT_AXES) for sp in specs]
        self._full_shapes = [tuple(v.shape) for v in values]
        with torch.no_grad():
            self._params = mesh_mod.place(mesh, values, specs)
        self._trainable = [p.grad_req != "null" for _, p in self._named]
        # a parameter param_spec_fn placed keeps its states under its own
        # spec; every other one takes the ZeRO rule (ref: _place_state)
        self._state_specs = [sp if cu and sp else self._opt_state_spec(shape)
                             for sp, cu, shape in zip(specs, custom,
                                                      self._full_shapes)]
        momentum = float(self._opt_params.get("momentum", 0.0))
        states = []
        for shape, ssp, tr, v in zip(self._full_shapes, self._state_specs,
                                     self._trainable, values):
            if not tr or (self._opt_name == "sgd" and not momentum):
                states.append(None)
                continue
            sl = mesh_mod.shard_slices(ssp, shape, mesh)
            z = torch.zeros_like(v[sl])
            states.append(z if self._opt_name == "sgd"
                          else (z, torch.zeros_like(z)))
        self._states = states
        if mesh.size > 1:
            _random.default_pool.set_stream(mesh.data_index)
        if self._remat:
            self._remat_flat = self._apply_child_remat() == 0
        if mesh.size > 1:
            self.eager_reason = (
                f"a mesh of {mesh.size} ranks ({mesh.shape}, backend "
                f"{mesh.backend}): the step holds collectives, which are "
                "captured with part 2b of the distributed slice")
        elif self._remat:
            self.eager_reason = ("remat: the recompute restores generator "
                                 "states, which a captured graph cannot")
        if self.eager_reason is not None:
            _log.info("DataParallelTrainer: rank %d runs its steps eagerly: "
                      "%s", mesh.rank, self.eager_reason)

    # -- remat (ref: _apply_child_remat, :428-466) -----------------------------

    def _apply_child_remat(self):
        """Wrap each direct child of the block whose parameters all take
        gradients in a checkpoint; returns how many.  Children holding
        moving statistics stay exact.  Idempotent per trainer."""
        if getattr(self, "_remat_count", None) is not None:
            return self._remat_count
        self._remat_count = 0
        for _, child in list(self.block._children.items()):
            params = list(child.collect_params().values())
            if any(p.grad_req == "null" for p in params):
                continue
            child.forward = self._remat_forward(child.forward, params)
            self._remat_count += 1
        return self._remat_count

    def _remat_contexts(self, params, aux=()):
        """``(forward, recompute)`` contexts for ``torch.utils.checkpoint``:
        the forward one notes the device's generator states, the values
        ``params`` read, the training flag and the BatchNorm scope; the
        recompute one puts them back for the recompute and restores what
        it found (and ``aux``'s values, which a recomputed BatchNorm would
        move again) after it."""
        snap = {}
        dev = self._device

        @contextlib.contextmanager
        def forward():
            _random.generator(dev)  # made before the first draw
            snap["gens"] = [(g, g.get_state())
                            for g in _random.default_pool.generators(dev)]
            snap["traced"] = [(p, p._traced_value) for p in params]
            snap["train"] = autograd.is_training()
            snap["scope"] = getattr(mesh_mod._scope, "mesh", None)
            yield

        @contextlib.contextmanager
        def recompute():
            now_gens = [(g, g.get_state()) for g, _ in snap["gens"]]
            now_traced = [(p, p._traced_value) for p in params]
            with torch.no_grad():
                now_aux = [(a, a.clone()) for a in aux]
            for g, st in snap["gens"]:
                g.set_state(st)
            for p, v in snap["traced"]:
                p._traced_value = v
            try:
                with autograd.record(train_mode=snap["train"]), \
                        mesh_mod.data_scope(snap["scope"]):
                    yield
            finally:
                for g, st in now_gens:
                    g.set_state(st)
                for p, v in now_traced:
                    p._traced_value = v
                with torch.no_grad():
                    for a, v in now_aux:
                        a.copy_(v)

        return forward(), recompute()

    def _remat_forward(self, orig, params):
        from torch.utils.checkpoint import checkpoint

        def fwd(*args, **kwargs):
            if not (autograd.is_recording() and torch.is_grad_enabled()):
                return orig(*args, **kwargs)
            return checkpoint(orig, *args, use_reentrant=False,
                              preserve_rng_state=False,
                              context_fn=lambda: self._remat_contexts(params),
                              **kwargs)

        return fwd

    # -- the step -------------------------------------------------------------

    def _forward_loss(self, x, y, values):
        """The mean loss of one (micro-)batch, the block reading ``values``
        (the full parameters): trainable ones cast to the compute dtype
        inside the graph, so their gradients come back in fp32."""
        cdt = self._compute_dtype
        masters = [p.requires_grad_(tr) for p, tr in zip(values,
                                                         self._trainable)]
        values = [m.to(cdt) if cdt is not None and tr
                  and m.is_floating_point() else m
                  for m, tr in zip(masters, self._trainable)]
        if cdt is not None:
            x = tuple(v.to(cdt) if v.is_floating_point() else v for v in x)
        params = [p for _, p in self._named]
        try:
            for p, v in zip(params, values):
                p._traced_value = v
            with autograd.record(train_mode=True):
                out = self.block(*x)
                loss = self.loss_fn(out, y)
        finally:
            for p in params:
                p._traced_value = None
        return loss.float().mean()

    def _loss_of(self, x, y, values):
        if not self._remat_flat:
            return self._forward_loss(x, y, values)
        from torch.utils.checkpoint import checkpoint

        aux = [v for v, tr in zip(values, self._trainable) if not tr]
        return checkpoint(self._forward_loss, x, y, values,
                          use_reentrant=False, preserve_rng_state=False,
                          context_fn=lambda: self._remat_contexts((), aux))

    @staticmethod
    def _backward(loss, masters):
        """fp32 gradients of ``loss``; zeros for a master it does not
        reach, as the reference's value_and_grad gives."""
        grads = torch.autograd.grad(loss, masters, allow_unused=True)
        return [torch.zeros_like(m) if g is None else g
                for g, m in zip(grads, masters)]

    def _grads(self, x, y, values):
        """``(loss, fp32 gradients of the trainable values)`` on this
        rank's rows; with ``accum_steps`` > 1 the means over the
        micro-batches, each started from the same moving statistics (the
        last one's update stays)."""
        trainable = [m for m, tr in zip(values, self._trainable) if tr]
        if self._accum == 1:
            loss = self._loss_of(x, y, values)
            return loss.detach(), self._backward(loss, trainable)
        b = y.shape[0]
        if b % self._accum:
            raise MXNetError(f"batch {b} not divisible by accum_steps "
                             f"{self._accum}")
        aux = [m for m, tr in zip(values, self._trainable) if not tr]
        aux0 = [a.clone() for a in aux]
        xs = [v.chunk(self._accum) for v in x]
        ys = y.chunk(self._accum)
        gsum = [torch.zeros_like(m, dtype=torch.float32) for m in trainable]
        loss_sum = torch.zeros((), dtype=torch.float32, device=y.device)
        for i in range(self._accum):
            with torch.no_grad():
                for a, a0 in zip(aux, aux0):
                    a.copy_(a0)
            loss = self._loss_of(tuple(v[i] for v in xs), ys[i], values)
            grads = self._backward(loss, trainable)
            for s, g in zip(gsum, grads):
                s.add_(g.float())
            loss_sum += loss.detach()
        return (loss_sum / self._accum,
                [(s / self._accum).to(m.dtype)
                 for s, m in zip(gsum, trainable)])

    def _apply_opt(self, raw, g, state, sv, group=None):
        """The update of one master (ref: ``apply_opt``, data_parallel.py:
        266-290); returns ``(new_raw, new_state)``.  ``sv`` holds the step's
        scalars as 0-d tensors: lr, t and the bias corrections.  ``group``:
        the ranks whose slices make the whole tensor, over which ``lamb``
        sums the squares behind its norms."""
        op = self._opt_params
        name = self._opt_name
        lr = sv[0]
        wd = float(op.get("wd", 0.0))
        clip = op.get("clip_gradient")
        if clip is not None:
            g = torch.clamp(g, -clip, clip)
        if name == "sgd":
            g = g + wd * raw
            momentum = float(op.get("momentum", 0.0))
            if momentum:
                new_m = momentum * state - lr * g
                return raw + new_m, new_m
            return raw - lr * g, None
        beta1 = float(op.get("beta1", 0.9))
        beta2 = float(op.get("beta2", 0.999))
        eps = float(op.get("epsilon", 1e-8))
        m, v = state
        if name != "adamw":
            g = g + wd * raw
        nm = beta1 * m + (1 - beta1) * g
        nv = beta2 * v + (1 - beta2) * torch.square(g)
        mhat = nm / sv[2]
        vhat = nv / sv[3]
        upd = mhat / (torch.sqrt(vhat) + eps)
        if name == "adamw":
            upd = upd + wd * raw
        if name == "lamb":
            if group is None:
                wn = torch.linalg.vector_norm(raw)
                un = torch.linalg.vector_norm(upd)
            else:
                sq = torch.stack([torch.square(raw).sum(),
                                  torch.square(upd).sum()])
                wn, un = torch.sqrt(group.all_reduce_(sq, "grad"))
            ratio = torch.where((wn > 0) & (un > 0), wn / un,
                                torch.ones_like(wn))
            upd = ratio * upd
        return raw - lr * upd, (nm, nv)

    def _sliced(self, i, spec, rank=None):
        return mesh_mod.shard_slices(spec, self._full_shapes[i], self.mesh,
                                     rank)

    def _gather(self, pieces, spec_of, kind):
        """``pieces``: ``[(i, this rank's shard under spec_of(i))]``;
        returns ``{i: full tensor}``, one all-gather a flat same-dtype
        bucket over each spec's axes."""
        out = {}
        by_axes = {}
        for i, t in pieces:
            out[i] = torch.empty(self._full_shapes[i], dtype=t.dtype,
                                 device=t.device)
            by_axes.setdefault(mesh_mod.spec_mesh_axes(spec_of(i)),
                               []).append((i, t))
        for axes, items in by_axes.items():
            group = self.mesh.group(axes)

            def put(i, k, piece, group=group):
                out[i][self._sliced(i, spec_of(i), group.members[k])] = piece

            mesh_mod.gather_pieces(group, items, put, kind)
        return out

    def _full_values(self, compute=False):
        """The full parameters: a replicated master itself, a sharded one
        all-gathered over its axes.  ``compute``: the values the step's
        forward reads, where a master split over expert axes stays this
        rank's shard."""
        values = list(self._params)
        sharded = [(i, m.detach()) for i, m in enumerate(self._params)
                   if self._specs[i] and not (compute and self._local[i])]
        if sharded:
            with torch.no_grad():
                for i, full in self._gather(sharded, lambda i: self._specs[i],
                                            "param").items():
                    values[i] = full
        return values

    def _zero(self, i):
        """Whether parameter ``i``'s states are ZeRO-split over ``dp``."""
        return bool(self._trainable[i] and self._state_specs[i]
                    and self._state_specs[i] != self._specs[i])

    def _reduce_grads(self, grads):
        """The data group's mean of each trainable gradient (``{i: g}``):
        the full gradient, or for a ZeRO-split state its ``dp`` slice
        (``parallel.mesh.reduce_over_data``)."""
        D = self.mesh.data_size
        zero = {}
        if any(self._zero(i) for i in grads):
            dp = self.mesh.group(("dp",))
            zero = {i: (lambda k, i=i: self._sliced(
                i, self._state_specs[i], dp.members[k]))
                for i in grads if self._zero(i)}
        out = mesh_mod.reduce_over_data(self.mesh, grads, zero)
        if D > 1:
            for g in out.values():
                g.div_(D)
        return out

    def _body(self, *inputs):
        """The step on tensors (this rank's rows, its labels and the scalar
        buffer): gradients, their mean over the data group, then every
        trainable master and its state updated in place; returns the
        mean loss over the data group."""
        xs, y, sv = inputs[:-2], inputs[-2], inputs[-1]
        mesh = self.mesh
        values = self._full_values(compute=True)
        scope = mesh_mod.data_scope(mesh) if mesh.size > 1 \
            else contextlib.nullcontext()
        with scope:
            loss, grads = self._grads(xs, y, values)
        idx = [i for i, tr in enumerate(self._trainable) if tr]
        grads = self._reduce_grads(dict(zip(idx, grads)))
        if mesh.data_size > 1:
            loss = mesh.data_group.all_reduce_(
                loss.reshape(1).clone(), "loss")[0] / mesh.data_size
        gathers = []
        with torch.no_grad():
            for i in idx:
                spec, sspec = self._specs[i], self._state_specs[i]
                raw, master = values[i].detach(), self._params[i]
                if self._local[i]:  # the shard itself, its own states
                    new_raw, new_state = self._apply_opt(
                        raw, grads[i], self._states[i], sv,
                        mesh.group(mesh_mod.spec_mesh_axes(spec)))
                    master.copy_(new_raw)
                elif not sspec:
                    new_raw, new_state = self._apply_opt(
                        raw, grads[i], self._states[i], sv)
                    master.copy_(new_raw[self._sliced(i, spec)] if spec
                                 else new_raw)
                else:
                    sl = self._sliced(i, sspec)
                    g = grads[i] if self._zero(i) else grads[i][sl]
                    new_raw, new_state = self._apply_opt(
                        raw[sl], g, self._states[i], sv,
                        mesh.group(mesh_mod.spec_mesh_axes(sspec)))
                    if sspec == spec:
                        master.copy_(new_raw)
                    else:
                        gathers.append((i, new_raw))
                if isinstance(new_state, tuple):
                    for dst, src in zip(self._states[i], new_state):
                        dst.copy_(src)
                elif new_state is not None:
                    self._states[i].copy_(new_state)
            for i, full in self._gather(
                    gathers, lambda i: self._state_specs[i],
                    "param").items():
                spec = self._specs[i]
                self._params[i].copy_(full[self._sliced(i, spec)] if spec
                                      else full)
            for i, tr in enumerate(self._trainable):
                if not tr and self._specs[i] and not self._local[i]:
                    # moving statistics, sharded
                    self._params[i].copy_(
                        values[i][self._sliced(i, self._specs[i])])
        return loss

    def _step_scalars(self):
        """This step's lr, t and Adam's bias corrections (float32, as the
        reference's float32 step computes them), as a float32 tensor on the
        trainer's device."""
        op = self._opt_params
        return _opt.device_scalars(
            [self._lr, float(self._t),
             _f32_correction(float(op.get("beta1", 0.9)), self._t),
             _f32_correction(float(op.get("beta2", 0.999)), self._t)],
            self._device)

    def _step_tensors(self, xs, y):
        """One step on tensors already on the device; returns the loss as
        a tensor of its own."""
        self._t += 1
        sv = self._step_scalars()
        values = xs + (y, sv)
        sig = _ws.signature(values)
        first = sig not in self._seen_sigs
        if first:
            self._seen_sigs.add(sig)
            _imperative.count("step_signatures")
        _imperative.count("step_dispatches")
        if self.eager_reason is not None:
            self.stats["mesh_eager_steps" if self.mesh.size > 1
                       else "remat_eager_steps"] += 1
        if self._device.type != "cuda" or not self._capture \
                or self.eager_reason is not None:
            return self._body(*values).detach()
        if first:  # the warm-up
            return _ws.side_stream_run(lambda: self._body(*values),
                                       self._device).detach()
        graph = self._graphs.get(sig)
        if graph is None:
            graph = self._graphs[sig] = _ws.CapturedStep(
                self._body, [v.clone() for v in values], self._device)
        return graph.replay(values).clone()

    def _rows(self, v):
        """This rank's rows of the global batch ``v``: its data shard of
        each global micro-batch (ref: the JAX step reshapes to
        ``(accum, B/accum)`` and shards dim 1, :304-338)."""
        D = self.mesh.data_size
        if D == 1:
            return v
        t = _host(v)
        B, A = t.shape[0], self._accum
        if B % (A * D):
            raise MXNetError(f"global batch {B} does not split into "
                             f"{A} micro-batch(es) over {D} data ranks")
        (rows,) = mesh_mod.batch_sharding(self.mesh).slices((B // A,))
        return t.reshape(A, B // A, *t.shape[1:])[:, rows] \
            .reshape(-1, *t.shape[1:])

    def step(self, x, y):
        """One training step on the global batch ``x`` (an array, or a
        tuple of arrays for a block of several inputs) with labels ``y``,
        the same on every rank; returns the mean loss as a scalar
        NDArray."""
        self.build(x)
        xs = tuple(x) if isinstance(x, (tuple, list)) else (x,)
        xs = tuple(_as_tensor(self._rows(v), self._device) for v in xs)
        return NDArray(self._step_tensors(
            xs, _as_tensor(self._rows(y), self._device)))

    def step_many(self, x, y, n_steps=None):
        """``n_steps`` steps on the same batch, or, with ``n_steps`` None,
        one step per leading index of ``x`` and ``y`` (one staged stack);
        returns the losses as a ``(K,)`` NDArray.  The same as as many
        :meth:`step` calls; on the card each is one replay of the captured
        step, with no host synchronisation between them."""
        multi = isinstance(x, (tuple, list))
        if n_steps is None:
            n_steps = (x[0] if multi else x).shape[0]
            batches = [((tuple(v[i] for v in x) if multi else x[i]), y[i])
                       for i in range(n_steps)]
        else:
            batches = [(x, y)] * int(n_steps)
        if n_steps < 1:
            raise MXNetError(f"step_many needs n_steps >= 1, got {n_steps}")
        self.build(batches[0][0])
        losses = []
        for xb, yb in batches:
            xs = tuple(xb) if multi else (xb,)
            losses.append(self._step_tensors(
                tuple(_as_tensor(self._rows(v), self._device) for v in xs),
                _as_tensor(self._rows(yb), self._device)))
        return NDArray(torch.stack(losses))

    @property
    def learning_rate(self):
        return self._lr

    def set_learning_rate(self, lr):
        self._lr = float(lr)

    def sync_to_block(self):
        """Write the trained parameters back into the block's Parameters;
        a sharded master is all-gathered first, so on a mesh every rank
        calls it."""
        if self._named is None:
            return
        for (_, p), raw in zip(self._named, self._full_values()):
            p.set_data(raw.detach())

    # -- checkpoints (ref: data_parallel.py:586-716) ---------------------------

    def _ckpt_items(self):
        """``[(key, this rank's tensor, spec, full shape)]`` over the
        masters (moving statistics included) and the optimizer states,
        keyed as the JAX class keys them."""
        out = []
        for i, ((name, _), raw) in enumerate(zip(self._named, self._params)):
            out.append((f"param::{name}", raw, self._specs[i],
                        self._full_shapes[i]))
        for i, st in enumerate(self._states):
            if st is None:
                continue
            for j, leaf in enumerate(st if isinstance(st, tuple) else (st,)):
                out.append((f"state::{i}::{j}", leaf, self._state_specs[i],
                            self._full_shapes[i]))
        return out

    def save_states(self, prefix, async_save=False):
        """Checkpoint the masters, the optimizer states, the step counter
        and the learning rate (ref: DataParallelTrainer.save_states):
        ``{prefix}-meta.npz`` (``t``, ``lr``, ``mesh_shape``,
        ``mesh_axes``; rank 0 writes it) and ``{prefix}-shards-p{rank}.npz``
        (``param::{name}@@{shard}``, ``state::{i}::{j}@@{shard}``) with the
        shards this rank is replica 0 of.  On a mesh every rank calls it.

        The values are those at the call: they are copied on the current
        stream before this returns (the step writes them in place).  With
        ``async_save=True`` the copy to the host and the writes run on a
        writer thread and a future is returned; call ``.result()`` before
        relying on the files (it re-raises a write error).  A second save
        first waits for the first."""
        from ..checkpoint.snapshot import Snapshot, host_leaves, writer

        if self._params is None:
            raise MXNetError("save_states before the first step: nothing "
                             "to checkpoint yet")
        if self._saving is not None:
            self._saving.result()
        if self._snapshot is None:
            self._snapshot, self._writer = Snapshot(), writer()
        mesh = self.mesh
        mine, sids = {}, {}
        for key, t, spec, shape in self._ckpt_items():
            if mesh_mod.is_replica0(spec, shape, mesh):
                mine[key] = t
                sids[key] = mesh_mod.shard_id(
                    mesh_mod.shard_slices(spec, shape, mesh), shape)
        pending = self._snapshot.take(mine)
        meta = dict(t=np.int64(self._t), lr=np.float64(self._lr),
                    mesh_shape=np.array([mesh.shape[a]
                                         for a in mesh.axis_names], np.int64),
                    mesh_axes=np.array(list(mesh.axis_names)))
        rank = mesh.rank

        def _write():
            shards = {f"{k}@@{sids[k]}": v for k, v in
                      host_leaves(pending.fetch(), copy=False).items()}
            np.savez(f"{prefix}-shards-p{rank}.npz", **shards)
            if rank == 0:
                np.savez(f"{prefix}-meta.npz", **meta)

        self._saving = self._writer.submit(_write)
        if async_save:
            return self._saving
        self._saving.result()
        return None

    def load_states(self, prefix):
        """Restore :meth:`save_states`' checkpoint (either package's) onto
        the same mesh: each rank reads the shards it holds, from whichever
        file has them.  The trainer must be built; on a mesh every rank
        calls it (a barrier first lets every rank's save finish).  The
        values are copied into the masters, moving statistics and
        optimizer states in place, so a captured step replays on them."""
        if self._params is None:
            raise MXNetError("load_states requires a built trainer: call "
                             "trainer.build(example_x) first")
        if self._saving is not None:
            self._saving.result()
        mesh = self.mesh
        if mesh.size > 1:
            dist.barrier("load_states")
        meta = np.load(f"{prefix}-meta.npz", allow_pickle=False)
        saved_axes = [str(a) for a in meta["mesh_axes"]]
        saved_shape = [int(v) for v in meta["mesh_shape"]]
        cur = [(a, mesh.shape[a]) for a in mesh.axis_names]
        if list(zip(saved_axes, saved_shape)) != cur:
            raise MXNetError(
                f"checkpoint mesh {list(zip(saved_axes, saved_shape))} != "
                f"current mesh {cur}; resharding on load isn't supported")
        where = {}
        files = [np.load(f, allow_pickle=False)
                 for f in sorted(glob.glob(f"{prefix}-shards-p*.npz"))]
        try:
            for z in files:
                where.update({k: z for k in z.files})
            loads = []
            for key, dst, spec, shape in self._ckpt_items():
                sid = mesh_mod.shard_id(
                    mesh_mod.shard_slices(spec, shape, mesh), shape)
                z = where.get(f"{key}@@{sid}")
                if z is None:
                    raise MXNetError(
                        f"checkpoint {prefix} missing shard {sid} of {key}")
                loads.append((dst, z[f"{key}@@{sid}"]))
        finally:
            for z in files:
                z.close()
        with torch.no_grad():
            for dst, src in loads:
                dst.copy_(torch.from_numpy(src).to(dst.dtype))
        self._t = int(meta["t"])
        self._lr = float(meta["lr"])
