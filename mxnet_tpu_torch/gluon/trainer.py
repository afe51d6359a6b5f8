"""gluon.Trainer (ref: python/mxnet/gluon/trainer.py; ``mxnet_tpu/gluon/
trainer.py:55-197,607-760``).

Applies an Optimizer to a set of Parameters, with their gradients summed
through a KVStore (``kvstore.py``).  As in the reference
(``_init_kvstore``, ``:141-161``), a Trainer whose parameters live on one
context and whose kvstore is not ``dist_*`` creates no kvstore: its step
is the update alone.  Parameters on several contexts
(``initialize(ctx=[...])``, a forward a context on ``split_and_load``'s
slices) or a ``dist_*`` kvstore make one at the first step, and
:meth:`Trainer.step` then

- sums each parameter's gradients over the contexts (and, for
  ``dist_*``, the processes) into every context's gradient buffer: the
  fused multi-key ``pushpull`` (one reduce a bucket), or one key at a
  time with ``aggregate_num=1``, bit-identical;
- updates the first context's copy once and copies it to the others.

With ``update_on_kvstore`` (the default for ``dist_*``) push runs the
optimizer on the kvstore's copy and pull writes the result into every
context's value.  ``compression_params`` turns on the kvstore's 2-bit
compression.  The update is fused by default (one multi-tensor call per
group of parameters, :meth:`Optimizer.fused_update`); ``aggregate_num=1``
or ``MXNET_OPTIMIZER_AGGREGATION_SIZE=1`` gives the sequential path,
which the fused one equals bit for bit.

:meth:`Trainer.whole_step` runs forward, loss, backward and update as one
step; with ``Trainer(..., whole_step=True)`` or ``MXTPU_WHOLE_STEP=1``
that step is one CUDA-graph replay on the card after a warm-up and a
capture per input signature (``gluon/whole_step.py``), bit-identical to
the eager step.  Over several contexts, and over the ranks of a
``dist_sync`` job, the whole step runs eagerly (the JAX package traces the
collectives into its step; a captured step with collectives inside it is
piece 4 of slice 7, part 2b): over contexts it is the eager split step,
over ranks ``gluon/whole_step.py``'s world step, which sums flat buckets
of the gradients over the process group.

ZeRO-1 (arXiv 2004.13336; ``zero_shard=True`` or ``MXTPU_ZERO_SHARD=1``):
the gradients of each flat bucket are reduce-scattered, each rank updates
its 1/world slice with the same rule, holding 1/world of the optimizer
state, and the updated slices are all-gathered.  Over several contexts
this is :meth:`Trainer.step` itself (the kvstore's ``zero_*``
collectives); across processes it is the world step.  Both are
bit-identical to their unsharded steps (under NCCL the world step's
reduce-scatter may add in another order; ``gluon/whole_step.py`` says what
then holds).  A configuration ZeRO cannot shard takes the unsharded step,
warns once per reason and counts ``zero_fallbacks``; one replica is the
identity and counts nothing.

:meth:`Trainer.save_states`/:meth:`Trainer.load_states` write and read
the JAX package's versioned pickle, so either package resumes the
other's optimizer; loading copies into the existing state tensors in
place, so a captured whole step keeps replaying on them.  With
``update_on_kvstore`` the states are the kvstore updater's: the blob's
``"kvstore"`` entry is its pickled states, and the files are the
updater's (``KVStore.save_optimizer_states``), as in the JAX package.
ZeRO's shards travel in the blob's ``"zero"`` entry, in the JAX layout
(world, chunks, per-rank shards), and load sharded or unsharded.

A mesh (``mesh_shape='dp=2,mp=2'`` or ``MXTPU_MESH_SHAPE``, with an
optional ``parallel.spmd.ShardingPlan`` as ``sharding_plan``) routes
:meth:`Trainer.whole_step` through ``parallel.spmd.SpmdStepCompiler``: one
rank a device (start the ranks with the port's launcher), each holding its
shard of every parameter split over ``mp`` and of every optimizer state
(plus ``dp`` under ``zero_shard``), the batch split over the data axes,
``FullyConnected`` and attention projections computed on their shards.
Reads of a parameter on a mesh (``p.data()``, ``save_parameters``,
``CheckpointManager``) return the full value and are collectives: every
rank reads, in the same order.  :meth:`Trainer.states_dict` gathers full
states and records ``"mesh_shape"``; :meth:`Trainer.load_states_dict`
checks a saved shape against this one (``checkpoint.reshard.
check_mesh_change``) and the next step slices what it loaded.

``kvstore='dist_async'`` across processes pushes every gradient to the
parameter servers, which update on each push (``update_on_kvstore``, its
default there, as for every ``dist_*``), and pulls their current values;
the JAX package's rules hold, caveat (q) included (``kvstore.py``).  The
servers hold the optimizer states, so :meth:`Trainer.states_dict` raises
there, as the JAX package's does.
"""
from __future__ import annotations

import logging
import pickle

import numpy as np
import torch

from .. import autograd
from .. import kvstore as _kvstore
from .. import optimizer as _opt
from .. import profiler as _profiler
from ..telemetry import health as _health
from ..base import MXNetError, getenv
from ..ndarray.ndarray import NDArray, as_tensor
from .parameter import ParameterDict, _ctx_list

_log = logging.getLogger("mxnet_tpu_torch.trainer")

# step counters (ref: trainer.py:23-52), those of the paths the port has
_step_stats = {"steps": 0, "params_fused": 0, "buckets_built": 0,
               "dispatches": 0, "whole_step_steps": 0,
               "whole_step_compiles": 0, "whole_step_fallbacks": 0,
               "whole_step_eager": 0, "zero_steps": 0, "zero_fallbacks": 0,
               "spmd_steps": 0}


def trainer_step_stats():
    """Counters since the last reset: steps, params_fused (parameters
    updated by a multi-tensor call), buckets_built (flat buckets the
    kvstore reduced), dispatches (update calls: one per fused group, one
    per sequential parameter, one per whole step; plus the kvstore's
    reduces, moves and copies, and one broadcast per extra context),
    dispatches_per_step, whole_step_steps (steps through
    :meth:`Trainer.whole_step` with the whole step on), whole_step_compiles
    (input signatures the captured step saw first), whole_step_fallbacks
    (calls a :class:`~.whole_step.Bypass` sent to the eager step),
    whole_step_eager (whole steps over several contexts or ranks, which
    run eagerly), zero_steps (steps whose update ran ZeRO-sharded),
    zero_fallbacks (``zero_shard`` steps that ran unsharded for a
    configuration ZeRO cannot shard) and spmd_steps (whole steps that ran
    on a ``mesh_shape`` mesh)."""
    s = dict(_step_stats)
    s["dispatches_per_step"] = (round(s["dispatches"] / s["steps"], 2)
                                if s["steps"] else 0.0)
    return s


def reset_trainer_step_stats():
    for k in _step_stats:
        _step_stats[k] = 0


def _is_dist(kvstore):
    if isinstance(kvstore, _kvstore.KVStore):
        return kvstore._is_dist()
    return str(kvstore).startswith("dist")


def _check_zero_blob(zero, source):
    """The world of a ``"zero"`` snapshot, checked to hold every rank's
    shards (the JAX package's message for a partial one)."""
    if not isinstance(zero, dict) or not {"world", "chunks",
                                          "shards"} <= set(zero):
        raise MXNetError(
            f"{source}: malformed ZeRO-1 optimizer-state snapshot (it "
            "needs 'world', 'chunks' and 'shards', as states_dict() "
            "writes them)")
    world = int(zero["world"])
    have = {int(r) for r in zero["shards"]}
    if have != set(range(world)):
        raise MXNetError(
            f"{source}: ZeRO-1 optimizer-state snapshot was sharded "
            f"across {world} rank(s) but only rank(s) "
            f"{sorted(have)} are present in this blob — restore "
            "through CheckpointManager, which gathers every rank's "
            "trainer-shard<r>.states from the checkpoint directory")
    return world


def states_file_blob(blob):
    """A states blob with numpy leaves as the files hold it: a
    kvstore-side updater's states pickled to bytes, as
    ``Updater.get_states`` writes them."""
    if isinstance(blob.get("kvstore"), dict):
        blob = dict(blob, kvstore=pickle.dumps(blob["kvstore"]))
    return blob


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None, whole_step=None,
                 zero_shard=None, mesh_shape=None, sharding_plan=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise MXNetError("params must be a ParameterDict or list")
        if isinstance(kvstore, str):
            if kvstore not in _kvstore._VALID:
                raise MXNetError(f"unknown kvstore type {kvstore!r}; "
                                 f"valid: {_kvstore._VALID}")
        if compression_params:
            ctype = dict(compression_params).get("type", "2bit")
            if ctype not in ("2bit", "none"):
                raise MXNetError(f"unsupported compression type {ctype!r}")
        # ZeRO-1: the constructor's value, else MXTPU_ZERO_SHARD
        if zero_shard is None:
            zero_shard = getenv("ZERO_SHARD", False, bool)
        self._zero_shard = bool(zero_shard)
        whole_step_default = whole_step is None
        if whole_step is None:
            whole_step = getenv("WHOLE_STEP", False, bool)
        self._whole_step = bool(whole_step)
        # a mesh: the constructor's shape, else MXTPU_MESH_SHAPE; a shape
        # implies the whole step unless the argument turned it off
        from ..parallel.spmd import mesh as _spmd_mesh

        self._mesh_shape = _spmd_mesh.mesh_shape_from_env() \
            if mesh_shape is None else _spmd_mesh.parse_mesh_shape(mesh_shape)
        self._sharding_plan = sharding_plan
        if self._mesh_shape is not None and whole_step_default:
            self._whole_step = True
        if sharding_plan is not None and self._mesh_shape is None:
            raise MXNetError(
                "sharding_plan given but no mesh_shape — pass "
                "mesh_shape='dp=...,mp=...' (or set MXTPU_MESH_SHAPE) "
                "to route steps onto the multi-axis mesh the plan "
                "shards over")
        self._whole_step_compiler = None
        self._params = [p for p in params if p.grad_req != "null"]
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._optimizer = _opt.create(
            optimizer, param_dict=dict(enumerate(self._params)),
            **optimizer_params)
        self._kv_type = kvstore
        self._kvstore = None
        self._update_on_kvstore = update_on_kvstore
        self._compression_params = compression_params
        self._kv_initialized = False
        self._contexts = None
        self._states = [None] * len(self._params)
        self._zero_states = {}   # chunk -> {rank: tuple of shard tensors}
        self._zero_layout = None  # (the plan's chunk layout, world)
        self._zero_warned = set()
        self._dispatches = 0
        self._buckets = 0
        self._params_fused = 0

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def _fusion_enabled(self):
        """The fused step is on by default; ``aggregate_num=1`` (or
        ``MXNET_OPTIMIZER_AGGREGATION_SIZE=1``) gives the sequential one."""
        return self._optimizer.aggregate_num > 1

    # -- the kvstore (ref: gluon/trainer.py:141-161) ---------------------------

    def _param_contexts(self):
        """The contexts of the first parameter (those its deferred init
        will use, before it is initialized)."""
        if not self._params:
            return []
        p = self._params[0]
        if p._data is not None:
            return p.list_ctx()
        if p._deferred_init is not None:
            return _ctx_list(p._deferred_init[1])
        return []

    def _init_kvstore(self):
        """Create the kvstore at the first step, as the reference does: none
        for one context unless ``dist_*``; ``update_on_kvstore`` defaults to
        whether it is ``dist_*``.  Waits while the parameters' shapes are
        deferred."""
        if self._kv_initialized:
            return
        if self._params and self._params[0]._data is None:
            return
        ctxs = self._param_contexts()
        self._contexts = ctxs
        if self._kv_type is None or (len(ctxs) <= 1
                                     and not _is_dist(self._kv_type)):
            self._kvstore = None
        else:
            self._kvstore = _kvstore.create(self._kv_type)
            if self._compression_params:
                self._kvstore.set_gradient_compression(
                    self._compression_params)
            if self._update_on_kvstore is None:
                self._update_on_kvstore = self._kvstore._is_dist()
            if self._update_on_kvstore:
                self._kvstore.set_optimizer(self._optimizer)
            for i, p in enumerate(self._params):
                self._kvstore.init(i, _on_ctx(p, p.list_data()[0:1]))
                if self._update_on_kvstore:
                    p._kv_trainers.add(self)
        self._kv_initialized = True

    def _refresh_kv_value(self, param):
        """``param``'s value was set (``set_data``, a load): write it into
        the kvstore's copy, which the next push updates and pulls."""
        for i, p in enumerate(self._params):
            if p is param:
                store = self._kvstore._store[i].data
                with torch.no_grad():
                    store.copy_(p.data(p.context).to(store.device))

    # -- stepping -------------------------------------------------------------

    def step(self, batch_size, ignore_stale_grad=False):
        """Sum the gradients over the contexts and processes (where there
        is a kvstore), then update every parameter, with gradients rescaled
        by ``1/batch_size``."""
        self._check_unplaced("step")
        self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._dispatches = self._buckets = self._params_fused = 0
        with _profiler.op_scope("trainer.step", cat="trainer"):
            ran_zero = self._zero_shard and self._try_zero_step()
            if not ran_zero:
                self._allreduce_grads()
                self._update(ignore_stale_grad)
        _step_stats["steps"] += 1
        _step_stats["dispatches"] += self._dispatches
        _step_stats["buckets_built"] += self._buckets
        _step_stats["params_fused"] += self._params_fused
        _step_stats["zero_steps"] += int(ran_zero)

    def allreduce_grads(self):
        """Sum the gradients over the contexts and processes, into every
        context's gradient buffer (the first half of :meth:`step`)."""
        self._check_unplaced("allreduce_grads")
        self._init_kvstore()
        if self._update_on_kvstore:
            raise MXNetError("allreduce_grads() is illegal with "
                             "update_on_kvstore=True")
        self._allreduce_grads()

    def _allreduce_grads(self):
        kv = self._kvstore
        if kv is None:
            return
        if self._update_on_kvstore:
            for i, p in enumerate(self._params):
                grads = _on_ctx(p, p.list_grad())
                # push the gradients: the kvstore sums them and updates
                # its copy; pull the new weights into every context
                kv.push(i, grads)
                kv.pull(i, out=_on_ctx(p, p.list_data()))
                self._dispatches += 2 * len(grads) - 1
            return
        if self._fusion_enabled() and len(self._params) > 1:
            # every parameter in one multi-key pushpull: the kvstore packs
            # same-dtype gradients into flat buckets, one reduce a bucket
            grads_per_key = [_on_ctx(p, p.list_grad()) for p in self._params]
            with _profiler.op_scope("allreduce", cat="trainer"):
                kvs = kv.pushpull(list(range(len(self._params))),
                                  grads_per_key, out=grads_per_key)
            if kvs:
                self._dispatches += kvs["dispatches"]
                self._buckets += kvs["buckets"]
            return
        for i, p in enumerate(self._params):
            grads = _on_ctx(p, p.list_grad())
            with _profiler.op_scope("allreduce", cat="trainer"):
                kv.pushpull(i, grads, out=grads)
            # an add and a copy back per extra context
            self._dispatches += 2 * (len(grads) - 1)

    def update(self, batch_size, ignore_stale_grad=False):
        """The update half of :meth:`step`, after :meth:`allreduce_grads`."""
        self._check_unplaced("update")
        self._init_kvstore()
        if self._update_on_kvstore:
            raise MXNetError("update() is illegal with "
                             "update_on_kvstore=True")
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        """Update every parameter on its first context, then copy it to the
        others.  With ``ignore_stale_grad`` a parameter whose gradient no
        backward has written since its last update is skipped, as MXNet
        does; without it, it is updated with the gradient it holds, as the
        reference does."""
        if self._update_on_kvstore and self._kvstore is not None:
            return  # updated by the kvstore during push
        # live ZeRO shards and an unsharded update (a fallback, or a
        # direct step): gather the shards back into per-parameter states
        # first, so the same trajectory goes on instead of zeroed states
        self._unshard_zero_states()
        entries = []
        for i, p in enumerate(self._params):
            w = p.data()
            if ignore_stale_grad and not getattr(w, "_mx_fresh_grad", False):
                continue
            g = p.grad()
            if self._states[i] is None:
                self._states[i] = \
                    self._optimizer.create_state_multi_precision(i, w)
            entries.append((i, w, g, self._states[i]))
            w._mx_fresh_grad = False
        if not entries:
            return
        if self._fusion_enabled():
            with _profiler.op_scope("fused_update", cat="trainer"):
                stats = self._optimizer.fused_update(
                    *map(list, zip(*entries)))
            self._dispatches += stats["fused_calls"] + stats["seq_updates"]
            self._params_fused += stats["params_fused"]
        else:
            for i, w, g, st in entries:
                self._optimizer.update_multi_precision(i, w, g, st)
                self._dispatches += 1
        self._broadcast_updated()

    def _broadcast_updated(self):
        """Copy each parameter's first copy to its other contexts: one
        multi-tensor copy per extra context (ref: trainer.py:737-760)."""
        per_ctx = {}
        for p in self._params:
            values = p.list_data()
            for c, v in zip(p.list_ctx()[1:], values[1:]):
                per_ctx.setdefault(c, []).append((v, values[0]))
        with torch.no_grad():
            for pairs in per_ctx.values():
                with _profiler.op_scope("broadcast", cat="trainer"):
                    torch._foreach_copy_([d for d, _ in pairs],
                                         [s for _, s in pairs])
                self._dispatches += 1

    # -- ZeRO-1, the eager tier (ref: gluon/trainer.py:201-470) -------------

    def _zero_fallback(self, reason):
        """Warn once per reason that a ``zero_shard`` step ran unsharded,
        count it; returns False for :meth:`_try_zero_step`."""
        if reason not in self._zero_warned:
            self._zero_warned.add(reason)
            _log.warning("ZeRO-1 sharded update bypassed -> unsharded path: "
                         "%s", reason)
        _step_stats["zero_fallbacks"] += 1
        return False

    def _zero_ineligible_reason(self, ctxs):
        """Why the eager sharded step cannot run, or None (checked before
        the plan ticks anything); the JAX package's reasons, word for
        word."""
        if not self._fusion_enabled():
            return "aggregate_num == 1 (sequential step requested)"
        scaler = getattr(self, "_amp_loss_scaler", None)
        if scaler is not None and scaler.enabled:
            return "amp dynamic loss scaling (the overflow skip is a " \
                "host-side decision)"
        if self._update_on_kvstore and self._kvstore is not None:
            return "update_on_kvstore=True (server-side optimizer)"
        if self._kvstore is None:
            return "no kvstore to reduce over"
        if self._kvstore._compression is not None:
            return "gradient compression (per-key error feedback)"
        if self._kvstore._is_dist():
            return "dist kvstore (the eager sharded step is single-" \
                "process; multi-process ZeRO rides the whole-step path)"
        ctxs0 = tuple(ctxs)
        for p in self._params:
            if getattr(p, "grad_stype", "default") != "default":
                return f"sparse-grad parameter {p.name}"
            if getattr(p, "stype", "default") != "default":
                return f"sparse parameter {p.name}"
            if p.grad_req == "add":
                return f"grad_req='add' on {p.name}"
            if tuple(p.list_ctx()) != ctxs0:
                return "parameters span different context sets"
        return None

    def _try_zero_step(self):
        """One ZeRO-1 eager step over the contexts; True when it ran (False:
        run the unsharded step; with one replica sharding is the identity
        and nothing is counted)."""
        ctxs = list(self._contexts or [])
        if len(ctxs) <= 1:
            return False
        reason = self._zero_ineligible_reason(ctxs)
        if reason is not None:
            return self._zero_fallback(reason)
        plan, svals, reason = self._optimizer.whole_step_plan(
            list(range(len(self._params))),
            [p.data(ctxs[0]) for p in self._params],
            [None] * len(self._params), zero_world=len(ctxs))
        if reason is not None:
            return self._zero_fallback(reason)
        self._ensure_zero_states(plan, len(ctxs), dict(enumerate(ctxs)))
        self._zero_eager_run(plan, svals, ctxs)
        return True

    def _zero_eager_run(self, plan, svals, ctxs):
        """Reduce-scatter, the shard update, then the weights' all-gather:
        the sharded twin of :meth:`_allreduce_grads` and :meth:`_update`,
        bit-identical to them (the same pairwise adds, the same rule over
        the same elements); each context holds 1/world of the state."""
        n = len(ctxs)
        kv = self._kvstore
        stats = {"buckets": 0, "dispatches": 0}
        g_shards, w_shards = [], []
        with _profiler.op_scope("reduce_scatter", cat="trainer"):
            for chunk in plan:
                idxs, padded = chunk[4], chunk[7]
                vlists = [_on_ctx(self._params[j],
                                  self._params[j].list_grad())
                          for j in idxs]
                g_shards.append(kv.zero_reduce_scatter(vlists, padded,
                                                       ctxs, stats))
                shard_n = padded // n
                per_rank = []
                for r, ctx in enumerate(ctxs):
                    flat = _kvstore.flatten_pad(
                        [self._params[j].data(ctx) for j in idxs], padded)
                    per_rank.append(flat[r * shard_n:(r + 1) * shard_n])
                    stats["dispatches"] += 2
                w_shards.append(per_rank)
        with _profiler.op_scope("fused_update", cat="trainer"):
            for c, chunk in enumerate(plan):
                for r in range(n):
                    self._optimizer.zero_fused_update(
                        (chunk,), (svals[c],), [w_shards[c][r]],
                        [g_shards[c][r]], [self._zero_states[c][r]])
                    stats["dispatches"] += 1
        with torch.no_grad(), _profiler.op_scope("allgather", cat="trainer"):
            for c, chunk in enumerate(plan):
                idxs = chunk[4]
                shapes = [tuple(self._params[j].shape) for j in idxs]
                outs = kv.zero_allgather(w_shards[c], shapes, ctxs, stats)
                for r, ctx in enumerate(ctxs):
                    for jj, j in enumerate(idxs):
                        w = self._params[j].data(ctx)
                        w.copy_(outs[r][jj])
                        w._mx_fresh_grad = False
        self._dispatches += stats["dispatches"]
        self._buckets += stats["buckets"]
        self._params_fused = len(self._params)

    # -- ZeRO-1 states, shared by the eager tier and the world step -----------

    @staticmethod
    def _zero_layout_of(plan, world):
        """``(n_states, dtype, idxs, total, padded)`` of each chunk, and the
        world."""
        return (tuple((c[2], c[3], c[4], c[6], c[7]) for c in plan),
                int(world))

    def _ensure_zero_states(self, plan, world, rank_ctx):
        """Make the shard-sized states of every chunk for each rank of
        ``rank_ctx`` (rank -> context) that has none.  Full per-parameter
        states (an unsharded run, a loaded snapshot) are flattened,
        zero-padded and sliced, which is exact, then released, so each
        replica holds ~1/world of the state."""
        layout = self._zero_layout_of(plan, world)
        if self._zero_layout is not None and self._zero_layout != layout \
                and self._zero_states:
            raise MXNetError(
                "ZeRO-1 shard layout changed mid-run (params, "
                "aggregate_num, MXTPU_KVSTORE_BUCKET_MB, hyperparameter "
                "grouping or world size changed since the shards were "
                "allocated); snapshot with states_dict() and reload "
                "into a fresh Trainer")
        self._zero_layout = layout
        for c, (_r, _s, n_states, dt, idxs, _n, _total, padded) in \
                enumerate(plan):
            entry = dict(self._zero_states.get(c) or {})
            missing = [r for r in rank_ctx if r not in entry]
            if not missing:
                continue
            shard_n = padded // world
            full = None
            if n_states and any(self._states[j] is not None for j in idxs):
                full = []
                for slot in range(n_states):
                    parts = []
                    for j in idxs:
                        st = _opt._state_list(self._states[j])
                        w = self._params[j].data()
                        parts.append(st[slot] if st else torch.zeros_like(w))
                    full.append(_kvstore.flatten_pad(parts, padded))
            for r in missing:
                dev = rank_ctx[r].torch_device()
                entry[r] = tuple(
                    torch.zeros(shard_n, dtype=dt, device=dev) if full is None
                    else full[slot][r * shard_n:(r + 1) * shard_n].to(
                        dev, copy=True)
                    for slot in range(n_states))
            self._zero_states[c] = entry
            for j in idxs:
                self._states[j] = None  # release the full copies

    def _unshard_zero_states(self):
        """Gather the live shards back into per-parameter states (exact)
        and drop them, so an unsharded update after sharded steps goes on
        from the same states.  Raises where this process does not hold
        every rank's shards (a rank of a multi-process job)."""
        if self._zero_states:
            self._load_zero_states(
                self._zero_snapshot(),
                source="<live ZeRO-1 shards: an unsharded update path "
                "engaged after sharded steps>", adopt=False)

    def _zero_snapshot(self):
        """The ``"zero"`` entry of a states blob, in the JAX package's
        layout: ``world``, ``chunks`` (indices, n_states, dtype, total,
        padded, shapes) and ``shards`` ({rank: {chunk: [slot tensors]}},
        the live tensors)."""
        layout, world = self._zero_layout
        ranks = sorted({r for e in self._zero_states.values() for r in e})
        return {
            "world": world,
            "chunks": [
                {"indices": list(idxs), "n_states": n_states,
                 "dtype": str(dt).replace("torch.", ""), "total": total,
                 "padded": padded,
                 "shapes": [[int(d) for d in self._params[j].shape]
                            for j in idxs]}
                for (n_states, dt, idxs, total, padded) in layout],
            "shards": {r: {c: list(entry[r])
                           for c, entry in sorted(self._zero_states.items())
                           if r in entry}
                       for r in ranks},
        }

    def optimizer_state_bytes(self):
        """The optimizer state held: ``{"per_replica": the most one
        replica holds, "total": over the replicas}`` in bytes.  Sharded
        runs hold ~1/world a replica; an unsharded run the full state on
        its first context (a rank of a multi-process job counts its own)."""
        if self._zero_states:
            per_rank = {}
            for entry in self._zero_states.values():
                for r, slots in entry.items():
                    per_rank[r] = per_rank.get(r, 0) + sum(
                        t.numel() * t.element_size() for t in slots)
            vals = list(per_rank.values()) or [0]
            return {"per_replica": max(vals), "total": sum(vals)}
        total = sum(t.numel() * t.element_size()
                    for st in self._states for t in _opt._state_list(st))
        return {"per_replica": total, "total": total}

    def _try_adopt_zero_snapshot(self, zero):
        """Install a snapshot's shards as the live ones where its world is
        this trainer's number of contexts and its chunks those of the plan
        this trainer would build (the same bytes the gather and the next
        step's re-slice would give); returns whether it did."""
        from ..checkpoint.reshard import _chunk_of, _shard_np

        ctxs = self._param_contexts()
        world = int(zero["world"])
        if not self._zero_shard or world <= 1 or len(ctxs) != world:
            return False
        shards = {int(r): v for r, v in zero["shards"].items()}
        try:
            plan = self._optimizer.zero_layout(
                list(range(len(self._params))),
                [p.data(ctxs[0]) for p in self._params], world)
        except MXNetError:  # uninitialized parameters: nothing to adopt
            return False
        if set(shards) != set(range(world)) or plan is None \
                or len(plan) != len(zero["chunks"]):
            return False
        for chunk, (_r, _s, n_states, dt, idxs, _n, total, padded) in zip(
                zero["chunks"], plan):
            if (int(chunk["n_states"]) != n_states
                    or str(chunk["dtype"]) != str(dt).replace("torch.", "")
                    or [int(j) for j in chunk["indices"]] != list(idxs)
                    or int(chunk["total"]) != total
                    or int(chunk["padded"]) != padded):
                return False
        new_states = {}
        for c, (_r, _s, n_states, dt, idxs, _n, _t, padded) in \
                enumerate(plan):
            entry = {}
            for r, ctx in enumerate(ctxs):
                arrs = [_shard_np(_chunk_of(shards[r], c)[slot])
                        for slot in range(n_states)]
                if any(a.shape != (padded // world,) for a in arrs):
                    return False
                entry[r] = tuple(torch.from_numpy(np.array(a)).to(
                    device=ctx.torch_device(), dtype=dt) for a in arrs)
            new_states[c] = entry
        self._zero_states = new_states
        self._zero_layout = self._zero_layout_of(plan, world)
        for chunk in plan:
            for j in chunk[4]:
                self._states[j] = None
        return True

    def _load_zero_states(self, zero, source, adopt=True):
        """Load a ``"zero"`` snapshot: with ``adopt`` and a matching
        sharded trainer its shards become the live ones; else every rank's
        shards of a chunk are concatenated, the pad dropped, and the result
        cut into per-parameter states on the first context, copied in
        place where states exist (exact either way).  Needs every rank's
        shards: a multi-process restore goes through
        ``CheckpointManager``, which gathers them."""
        from ..checkpoint.reshard import _chunk_of, _shard_np

        world = _check_zero_blob(zero, source)
        if adopt and self._try_adopt_zero_snapshot(zero):
            return
        shards = {int(r): v for r, v in zero["shards"].items()}
        loads = []
        for c, chunk in enumerate(zero["chunks"]):
            n_states = int(chunk["n_states"])
            idxs = [int(j) for j in chunk["indices"]]
            shapes = [tuple(int(d) for d in sh) for sh in chunk["shapes"]]
            fulls = [np.concatenate([
                _shard_np(_chunk_of(shards[r], c)[slot])
                for r in range(world)])[:int(chunk["total"])]
                for slot in range(n_states)]
            off = 0
            for j, shape in zip(idxs, shapes):
                n = int(np.prod(shape, dtype=np.int64))
                saved = tuple(f[off:off + n].reshape(shape) for f in fulls)
                off += n
                if not n_states:
                    loads.append((j, None, []))
                    continue
                loads.append((j, *self._check_state(
                    j, self._params[j],
                    saved[0] if n_states == 1 else saved, source)))
        self._apply_state_loads(loads)
        # the loaded snapshot supersedes any live shards
        self._zero_states = {}
        self._zero_layout = None

    # -- the whole step (ref: gluon/trainer.py:472-596) ------------------------

    @property
    def whole_step_enabled(self):
        return self._whole_step

    def whole_step(self, block, loss_fn, x, y=None, batch_size=None):
        """One full training step of ``block``: forward, ``loss_fn``,
        backward and the update.  Returns the loss summed to a scalar.

        ``x`` is one array or a tuple of arrays (a block of several
        inputs); ``loss_fn(out, y)``, or ``loss_fn(out)`` with ``y`` None,
        maps the block's output to a loss of any shape, and the gradients
        are those of its sum (``loss.backward()``'s all-ones seed).
        ``batch_size`` (default ``x``'s first dimension) sets
        ``rescale_grad`` as in :meth:`step`.

        With the whole step enabled the step runs through
        ``gluon/whole_step.py``: on one context, on the card, after one
        eager warm-up step and one capture per input signature, each call
        is one CUDA-graph replay; on the CPU the same body runs eagerly.
        Over several contexts it is the eager split step (the first axis of
        the inputs split into equal slices, one a context in order), and
        over the ranks of a ``dist_sync`` job each rank steps on its own
        batch and the gradients are summed over the process group (the
        world step; the loss returned is the sum over the ranks).  Both run
        eagerly, which is decided at the first call, logged once and
        counted in ``whole_step_eager``.  With ``zero_shard`` both shard the
        update (ZeRO-1).  Disabled, or for a configuration it bypasses
        (``grad_req='add'``, ``update_on_kvstore``, compression, several
        contexts in each of several processes, a trainer parameter outside
        ``block``), the call runs :meth:`_eager_whole_step`, which gives
        the same result; a bypass warns once per reason and counts in
        ``whole_step_fallbacks``.  Pass stable ``block`` and ``loss_fn``
        objects: the captured graphs are cached by their identity."""
        inputs = tuple(x) if isinstance(x, (list, tuple)) else (x,)
        if batch_size is None:
            batch_size = int(inputs[0].shape[0])
        self._init_kvstore()
        if not self._whole_step:
            return self._eager_whole_step(block, loss_fn, inputs, y,
                                          batch_size)
        from . import whole_step as _ws

        self._compiler()
        if self._mesh_shape is not None:
            return self._spmd_whole_step(block, loss_fn, inputs, y,
                                         batch_size)
        if any(p._data is None for p in self._params):
            # deferred shapes: the eager step completes them; it is this
            # signature's warm-up
            loss = self._eager_whole_step(block, loss_fn, inputs, y,
                                          batch_size)
            self._whole_step_compiler.note_warm(block, loss_fn, inputs, y)
            _step_stats["whole_step_steps"] += 1
            return loss
        if self._whole_step_compiler.route() == "contexts":
            # the eager split step, which books its own step
            _step_stats["whole_step_steps"] += 1
            _step_stats["whole_step_eager"] += 1
            return self._eager_whole_step(block, loss_fn, inputs, y,
                                          batch_size)
        self._optimizer.rescale_grad = self._scale / batch_size
        try:
            with _profiler.op_scope("whole_step", cat="trainer"):
                loss, wstats = self._whole_step_compiler.step(
                    block, loss_fn, inputs, y, batch_size)
        except _ws.Bypass as b:
            self._whole_step_compiler.warn_fallback(b.reason)
            _step_stats["whole_step_fallbacks"] += 1
            return self._eager_whole_step(block, loss_fn, inputs, y,
                                          batch_size)
        self._book_whole_step(wstats)
        # health-monitor FLOP geometry (the analytic MFU count);
        # disarmed this is the module no-op
        _health.note_whole_step(self, batch_size)
        return loss

    def _compiler(self):
        """The whole step's compiler, made at its first use: an
        ``SpmdStepCompiler`` where a mesh shape is set."""
        if self._whole_step_compiler is None:
            if self._mesh_shape is not None:
                from ..parallel.spmd import SpmdStepCompiler

                self._whole_step_compiler = SpmdStepCompiler.from_shape(
                    self, self._mesh_shape, self._sharding_plan)
            else:
                from . import whole_step as _ws

                self._whole_step_compiler = _ws.WholeStepCompiler(self)
        return self._whole_step_compiler

    def _book_whole_step(self, wstats):
        """Count one whole step that a compiler ran (its ``stats``)."""
        _step_stats["steps"] += 1
        _step_stats["dispatches"] += wstats.get("dispatches", 1)
        _step_stats["params_fused"] += len(self._params)
        _step_stats["buckets_built"] += wstats.get("buckets", 0)
        _step_stats["zero_steps"] += int(wstats.get("zero", False))
        _step_stats["whole_step_steps"] += 1
        _step_stats["whole_step_eager"] += int(wstats.get("eager", False))
        _step_stats["whole_step_compiles"] += wstats.get("compiles", 0)
        _step_stats["spmd_steps"] += int(wstats.get("spmd", False))
        _step_stats["whole_step_fallbacks"] += int("fallback" in wstats)

    def _spmd_whole_step(self, block, loss_fn, inputs, y, batch_size):
        """:meth:`whole_step` on the mesh (``parallel.spmd.lowering``); a
        bypass runs :meth:`_eager_whole_step` on the full parameters and
        states of every rank, which the next mesh step slices again."""
        from . import whole_step as _ws

        comp = self._whole_step_compiler
        self._optimizer.rescale_grad = self._scale / batch_size
        try:
            with _profiler.op_scope("whole_step", cat="trainer"):
                loss, wstats = comp.step(block, loss_fn, inputs, y,
                                         batch_size)
        except _ws.Bypass as b:
            comp.warn_fallback(b.reason)
            _step_stats["whole_step_fallbacks"] += 1
            with comp.unplaced(block):
                return self._eager_whole_step(block, loss_fn, inputs, y,
                                              batch_size)
        self._book_whole_step(wstats)
        _health.note_whole_step(self, batch_size)
        return loss

    def _check_unplaced(self, what):
        """A parameter held sharded by the mesh step reads as a gathered
        copy, which no backward reaches: the eager step cannot update it."""
        if any(p._placement is not None for p in self._params):
            raise MXNetError(
                f"Trainer.{what}: the parameters are sharded over the mesh "
                f"{self._mesh_shape}; a Trainer with mesh_shape steps "
                "through whole_step(net, loss_fn, x, y)")

    def _placed_compiler(self):
        """The mesh step's compiler where it holds this trainer's states
        sharded, else None."""
        comp = self._whole_step_compiler
        return comp if getattr(comp, "_placed_states", None) else None

    # -- state io (ref: gluon/trainer.py:764-885, 1037-1072) -----------------

    # Pickle-blob layout version: {"version": 1, "states": {i: {ctx:
    # state}}, "num_update", "index_update_count"}; the round-0 layout
    # without "version" loads as v1.
    STATES_FORMAT_VERSION = 1

    def _kv_updater(self):
        """The kvstore's updater when the kvstore updates, else None."""
        if self._update_on_kvstore and self._kvstore is not None:
            return self._kvstore._updater
        return None

    def _states_blob(self):
        """The states layout with the live state tensors as leaves (the
        checkpoint manager copies them before the next step).  With
        ``update_on_kvstore`` the ``"kvstore"`` entry holds the updater's
        states, by key, and the counters of the optimizer it shares (a
        resumed Adam would otherwise restart its bias corrections);
        :func:`states_file_blob` pickles them as the files hold them."""
        self._init_kvstore()
        kv = self._kvstore
        if self._update_on_kvstore and kv is not None and kv._updater is None:
            raise MXNetError(
                "cannot snapshot optimizer states: this kvstore updates "
                "server-side with no local updater (async PS); checkpoint "
                "from rank 0 via kvstore.save_optimizer_states instead")
        counters = {"num_update": self._optimizer.num_update,
                    "index_update_count":
                        dict(self._optimizer._index_update_count)}
        updater = self._kv_updater()
        if updater is not None:
            return {"version": self.STATES_FORMAT_VERSION,
                    "kvstore": dict(updater.states), **counters}
        comp = self._placed_compiler()
        full = [comp.full_state(i) for i in range(len(self._params))] \
            if comp is not None else self._states
        states = {i: ({} if st is None else {str(p.context): st})
                  for i, (p, st) in enumerate(zip(self._params, full))}
        blob = {"version": self.STATES_FORMAT_VERSION, "states": states,
                **counters}
        if self._mesh_shape is not None:
            # the leaves are full arrays whatever the mesh: the shape is
            # recorded so that a restore at another one is checked
            from ..parallel.spmd.mesh import format_mesh_shape

            blob["mesh_shape"] = format_mesh_shape(self._mesh_shape)
        if self._zero_states:
            # this process's ranks' shards (a rank of a multi-process job
            # holds its own; CheckpointManager gathers them on restore)
            blob["zero"] = self._zero_snapshot()
        return blob

    def states_dict(self):
        """Versioned optimizer-state snapshot with numpy leaves (ref:
        Trainer.states_dict).  The JAX package's leaves are its immutable
        device arrays; the port's states are written in place by every
        later step, so the snapshot holds host copies.  On a mesh the
        leaves are the full states, gathered (a collective: every rank
        calls it), and ``"mesh_shape"`` records the mesh."""
        from ..checkpoint.snapshot import host_leaves

        return states_file_blob(host_leaves(self._states_blob()))

    def load_states_dict(self, blob, source="<states blob>"):
        """Inverse of :meth:`states_dict` (leaves numpy arrays, NDArrays or
        tensors): restores the update counters and copies each saved state
        into the existing state tensor in place (one is created where none
        exists yet), so a captured step replays on the loaded values.
        Everything is checked before anything is changed.  A blob with a
        ``"kvstore"`` entry loads into the kvstore's updater, and needs a
        Trainer that updates on the kvstore; the other way round raises
        too, as in the JAX package."""
        self._init_kvstore()
        if isinstance(blob, dict) and "version" not in blob and set(
                blob) == {"states", "num_update", "index_update_count"}:
            # the round-0 layout is exactly v1 minus the version key
            blob = dict(blob, version=self.STATES_FORMAT_VERSION)
        if not isinstance(blob, dict) or "version" not in blob:
            raise MXNetError(
                f"{source}: unversioned Trainer states blob with an "
                "unrecognized layout — not written by any "
                "save_states; if it predates state versioning, load "
                "the parameters alone and let the optimizer restart.")
        if blob["version"] != self.STATES_FORMAT_VERSION:
            raise MXNetError(
                f"{source}: Trainer states format v{blob['version']} "
                f"does not match this build's "
                f"v{self.STATES_FORMAT_VERSION}; save and load with "
                "matching mxnet_tpu versions.")
        updater = self._kv_updater()
        if "kvstore" in blob:
            if updater is None:
                raise MXNetError(
                    f"{source}: states were saved from a kvstore-side "
                    "updater but this Trainer has none (local updates); "
                    "recreate it with a matching update_on_kvstore setup")
            kv = blob["kvstore"]
            updater.set_states(kv if isinstance(kv, (bytes, bytearray))
                               else pickle.dumps(kv))
            if "num_update" in blob:  # the updater shares this optimizer
                self._optimizer.num_update = blob["num_update"]
                self._optimizer._index_update_count = dict(
                    blob["index_update_count"])
            return
        if updater is not None:
            raise MXNetError(
                f"{source}: states were saved from a local-update "
                "Trainer but this Trainer updates on the kvstore — "
                "loading would silently leave the kvstore updater's "
                "optimizer at step 0; recreate the Trainer with "
                "update_on_kvstore=False to resume these states")
        if blob.get("mesh_shape"):
            from ..checkpoint.reshard import check_mesh_change

            check_mesh_change(blob["mesh_shape"], self._mesh_shape,
                              source=source)
        if blob.get("zero"):
            # ZeRO shards: adopted as live shards, or gathered into
            # per-parameter states (a sharded run resumes unsharded and
            # back; a sharded trainer re-slices at its next step)
            self._load_zero_states(blob["zero"], source)
        else:
            loads = []
            for i, p in enumerate(self._params):
                saved = blob["states"].get(i, {})
                if saved:
                    loads.append((i, *self._check_state(
                        i, p, next(iter(saved.values())), source)))
            # an unsharded snapshot supersedes live shards too
            self._zero_states = {}
            self._zero_layout = None
            self._apply_state_loads(loads)
        self._optimizer.num_update = blob["num_update"]
        self._optimizer._index_update_count = dict(
            blob["index_update_count"])

    def _apply_state_loads(self, loads):
        """Set each ``(i, state, leaves)`` of :meth:`_check_state`: the
        saved values copied into the state tensors in place."""
        for i, state, leaves in loads:
            self._states[i] = state
            with torch.no_grad():
                for dst, src in zip(_opt._state_list(state), leaves):
                    dst.copy_(src.to(dst.dtype))

    def _check_state(self, i, p, saved, source):
        """``(state, leaves)``: the state tensors of parameter ``i`` (the
        existing ones, or new ones where none exist) and the saved values
        as CPU tensors, checked against them; ``(None, [])`` for a saved
        None."""
        if saved is None:
            return None, []
        leaves = []
        for v in (saved if isinstance(saved, (tuple, list)) else (saved,)):
            if isinstance(v, NDArray):
                v = v.data
            leaves.append(v.detach().cpu() if isinstance(v, torch.Tensor)
                          else torch.from_numpy(np.array(v)))
        state = self._states[i]
        comp = self._placed_compiler()
        if state is None or (comp is not None and comp._placed(i)):
            # new full states (a mesh step's shards are replaced, and its
            # next step slices them); a sharded parameter gives a
            # full-shaped template, since its read would be a collective
            w = p.data() if p._placement is None else torch.empty(
                p.shape, dtype=p._data.dtype, device=p._data.device)
            state = self._optimizer.create_state_multi_precision(i, w)
        want = [tuple(t.shape) for t in _opt._state_list(state)]
        if want != [tuple(t.shape) for t in leaves]:
            raise MXNetError(
                f"{source}: the saved optimizer state of {p.name} holds "
                f"arrays of shapes {[tuple(t.shape) for t in leaves]}, "
                f"but this optimizer keeps {want}")
        return state, leaves

    def save_states(self, fname):
        """Pickle :meth:`states_dict` to ``fname`` atomically (a temp file
        renamed over it), in the JAX package's layout; with
        ``update_on_kvstore`` the kvstore updater's file instead."""
        from ..checkpoint import atomic_file

        self._init_kvstore()
        if self._kv_updater() is not None:
            self._kvstore.save_optimizer_states(fname)
            return
        payload = self.states_dict()
        with atomic_file(fname) as tmp:
            with open(tmp, "wb") as f:
                pickle.dump(payload, f)

    def load_states(self, fname):
        self._init_kvstore()
        if self._kv_updater() is not None:
            self._kvstore.load_optimizer_states(fname)
            return
        with open(fname, "rb") as f:
            blob = pickle.load(f)
        self.load_states_dict(blob, source=fname)

    def _eager_whole_step(self, block, loss_fn, inputs, y, batch_size):
        """The eager twin of :meth:`whole_step`: ``autograd.record``, the
        forward and loss, ``backward`` of the loss's sum, then
        :meth:`step`.  With parameters on several contexts the first axis
        of the inputs is split into equal slices, one a context in order
        (ref: ``_eager_whole_step``, trainer.py:560-605), and the summed
        losses are returned on the first context."""
        from .whole_step import as_step_tensor

        ctxs = self._param_contexts()
        if len(ctxs) > 1:
            return self._split_whole_step(block, loss_fn, inputs, y,
                                          batch_size, ctxs)
        device = next((p._data.device for p in self._params
                       if p._data is not None), None)
        if device is None:  # deferred shapes: the inputs' device
            first = as_tensor(inputs[0])
            device = first.device if isinstance(first, torch.Tensor) \
                else torch.device("cpu")
        xs = [as_step_tensor(v, device) for v in inputs]
        with autograd.record():
            out = block(*xs)
            loss = loss_fn(out, as_step_tensor(y, device)) \
                if y is not None else loss_fn(out)
            loss = as_tensor(loss).sum()
        autograd.backward(loss)
        self.step(batch_size)
        return NDArray(loss.detach())

    def _split_whole_step(self, block, loss_fn, inputs, y, batch_size, ctxs):
        n = len(ctxs)
        b = int(inputs[0].shape[0])
        if b % n:
            raise MXNetError(f"whole_step batch {b} is not divisible across "
                             f"{n} replica contexts")
        shard = b // n

        def part(v, r, ctx):
            t = as_tensor(v)
            if not isinstance(t, torch.Tensor):
                t = torch.as_tensor(np.asarray(t))
            return NDArray(t[r * shard:(r + 1) * shard].to(
                ctx.torch_device(), copy=True), ctx)

        losses = []
        with autograd.record():
            for r, ctx in enumerate(ctxs):
                out = block(*(part(v, r, ctx) for v in inputs))
                loss = loss_fn(out, part(y, r, ctx)) if y is not None \
                    else loss_fn(out)
                losses.append(as_tensor(loss).sum())
        autograd.backward(losses)
        self.step(batch_size)
        total = losses[0].detach()
        for loss in losses[1:]:
            total = total + loss.detach().to(total.device)
        return NDArray(total, ctxs[0])


def _on_ctx(p, tensors):
    """``tensors`` (one a context of ``p``, in order) as NDArrays on their
    contexts, the kvstore's slots."""
    return [NDArray(t, c) for c, t in zip(p.list_ctx(), tensors)]
