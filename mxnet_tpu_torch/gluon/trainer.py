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
the eager step.  Over a kvstore (several contexts or ``dist_*``) the
captured step raises: the JAX package traces the collective into its
step, which comes with slice 7, part 2b; the eager whole step splits the
batch across the contexts.

:meth:`Trainer.save_states`/:meth:`Trainer.load_states` write and read
the JAX package's versioned pickle, so either package resumes the
other's optimizer; loading copies into the existing state tensors in
place, so a captured whole step keeps replaying on them.  With
``update_on_kvstore`` the states are the kvstore updater's: the blob's
``"kvstore"`` entry is its pickled states, and the files are the
updater's (``KVStore.save_optimizer_states``), as in the JAX package.

What later slices bring raises :class:`MXNetError` here instead of being
ignored: ZeRO (``zero_shard``), ``mesh_shape``/``sharding_plan`` and
states blobs of those (slice 7, part 2b), and ``dist_async`` (part 3).
"""
from __future__ import annotations

import pickle

import numpy as np
import torch

from .. import autograd
from .. import kvstore as _kvstore
from .. import optimizer as _opt
from ..base import MXNetError, getenv
from ..ndarray.ndarray import NDArray, as_tensor
from .parameter import ParameterDict, _ctx_list

# step counters (ref: trainer.py:23-52), those of the paths the port has
_step_stats = {"steps": 0, "params_fused": 0, "buckets_built": 0,
               "dispatches": 0, "whole_step_steps": 0,
               "whole_step_compiles": 0, "whole_step_fallbacks": 0}


def trainer_step_stats():
    """Counters since the last reset: steps, params_fused (parameters
    updated by a multi-tensor call), buckets_built (flat buckets the
    kvstore reduced), dispatches (update calls: one per fused group, one
    per sequential parameter, one per whole step; plus the kvstore's
    reduces, moves and copies, and one broadcast per extra context),
    dispatches_per_step, whole_step_steps (steps through
    :meth:`Trainer.whole_step` with the whole step on), whole_step_compiles
    (input signatures it saw first) and whole_step_fallbacks (calls a
    :class:`~.whole_step.Bypass` sent to the eager step)."""
    s = dict(_step_stats)
    s["dispatches_per_step"] = (round(s["dispatches"] / s["steps"], 2)
                                if s["steps"] else 0.0)
    return s


def reset_trainer_step_stats():
    for k in _step_stats:
        _step_stats[k] = 0


def _later(what, part):
    return MXNetError(f"Trainer: {what} is not ported yet; it comes with "
                      f"part {part} of the distributed slice (slice 7, part "
                      f"{part}; ROADMAP.md queue 1)")


def _is_dist(kvstore):
    if isinstance(kvstore, _kvstore.KVStore):
        return kvstore._is_dist()
    return str(kvstore).startswith("dist")


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
            if kvstore in _kvstore._ASYNC:
                raise _later(f"kvstore={kvstore!r} (asynchronous updates "
                             "on a parameter server)", 3)
        if compression_params:
            ctype = dict(compression_params).get("type", "2bit")
            if ctype not in ("2bit", "none"):
                raise MXNetError(f"unsupported compression type {ctype!r}")
        if zero_shard or (zero_shard is None
                          and getenv("ZERO_SHARD", False, bool)):
            raise _later("ZeRO (zero_shard / MXTPU_ZERO_SHARD)", "2b")
        if mesh_shape is not None or sharding_plan is not None or \
                getenv("MESH_SHAPE", None):
            raise _later("mesh_shape / sharding_plan (MXTPU_MESH_SHAPE)", "2b")
        if whole_step is None:
            whole_step = getenv("WHOLE_STEP", False, bool)
        self._whole_step = bool(whole_step)
        if self._whole_step and _is_dist(kvstore):
            raise _later(f"the captured whole step over kvstore={kvstore!r} "
                         f"(update_on_kvstore={update_on_kvstore})", "2b")
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
        self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._dispatches = self._buckets = self._params_fused = 0
        self._allreduce_grads()
        self._update(ignore_stale_grad)
        _step_stats["steps"] += 1
        _step_stats["dispatches"] += self._dispatches
        _step_stats["buckets_built"] += self._buckets
        _step_stats["params_fused"] += self._params_fused

    def allreduce_grads(self):
        """Sum the gradients over the contexts and processes, into every
        context's gradient buffer (the first half of :meth:`step`)."""
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
            kvs = kv.pushpull(list(range(len(self._params))), grads_per_key,
                              out=grads_per_key)
            if kvs:
                self._dispatches += kvs["dispatches"]
                self._buckets += kvs["buckets"]
            return
        for i, p in enumerate(self._params):
            grads = _on_ctx(p, p.list_grad())
            kv.pushpull(i, grads, out=grads)
            # an add and a copy back per extra context
            self._dispatches += 2 * (len(grads) - 1)

    def update(self, batch_size, ignore_stale_grad=False):
        """The update half of :meth:`step`, after :meth:`allreduce_grads`."""
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
            stats = self._optimizer.fused_update(*map(list, zip(*entries)))
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
                torch._foreach_copy_([d for d, _ in pairs],
                                     [s for _, s in pairs])
                self._dispatches += 1

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
        ``gluon/whole_step.py``: on the card, after one eager warm-up step
        and one capture per input signature, each call is one CUDA-graph
        replay; on the CPU the same body runs eagerly.  Disabled, or for a
        configuration it bypasses (``grad_req='add'``, parameters on
        several devices, a trainer parameter outside ``block``), the call
        runs :meth:`_eager_whole_step`, which gives the same result; a
        bypass warns once per reason and counts in
        ``whole_step_fallbacks``.  Pass stable ``block`` and ``loss_fn``
        objects: the captured graphs are cached by their identity.  Over a
        kvstore (several contexts or ``dist_*``) the captured step raises,
        naming slice 7, part 2b; the eager one splits the batch's first
        axis into equal slices, one a context in order."""
        inputs = tuple(x) if isinstance(x, (list, tuple)) else (x,)
        if batch_size is None:
            batch_size = int(inputs[0].shape[0])
        self._init_kvstore()
        if not self._whole_step:
            return self._eager_whole_step(block, loss_fn, inputs, y,
                                          batch_size)
        ctxs = self._param_contexts()
        if self._kvstore is not None or len(ctxs) > 1:
            raise _later(f"the captured whole step over {len(ctxs)} "
                         f"contexts with kvstore={self._kv_type!r} "
                         f"(update_on_kvstore={self._update_on_kvstore})", "2b")
        from . import whole_step as _ws

        if self._whole_step_compiler is None:
            self._whole_step_compiler = _ws.WholeStepCompiler(self)
        if any(p._data is None for p in self._params):
            # deferred shapes: the eager step completes them; it is this
            # signature's warm-up
            loss = self._eager_whole_step(block, loss_fn, inputs, y,
                                          batch_size)
            self._whole_step_compiler.note_warm(block, loss_fn, inputs, y)
            _step_stats["whole_step_steps"] += 1
            return loss
        self._optimizer.rescale_grad = self._scale / batch_size
        try:
            loss, wstats = self._whole_step_compiler.step(
                block, loss_fn, inputs, y)
        except _ws.Bypass as b:
            self._whole_step_compiler.warn_fallback(b.reason)
            _step_stats["whole_step_fallbacks"] += 1
            return self._eager_whole_step(block, loss_fn, inputs, y,
                                          batch_size)
        _step_stats["steps"] += 1
        _step_stats["dispatches"] += 1
        _step_stats["params_fused"] += len(self._params)
        _step_stats["whole_step_steps"] += 1
        _step_stats["whole_step_compiles"] += wstats["compiles"]
        return loss

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
        counters = {"num_update": self._optimizer.num_update,
                    "index_update_count":
                        dict(self._optimizer._index_update_count)}
        updater = self._kv_updater()
        if updater is not None:
            return {"version": self.STATES_FORMAT_VERSION,
                    "kvstore": dict(updater.states), **counters}
        states = {i: ({} if st is None else {str(p.context): st})
                  for i, (p, st) in enumerate(zip(self._params,
                                                  self._states))}
        return {"version": self.STATES_FORMAT_VERSION, "states": states,
                "num_update": self._optimizer.num_update,
                "index_update_count":
                    dict(self._optimizer._index_update_count)}

    def states_dict(self):
        """Versioned optimizer-state snapshot with numpy leaves (ref:
        Trainer.states_dict).  The JAX package's leaves are its immutable
        device arrays; the port's states are written in place by every
        later step, so the snapshot holds host copies."""
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
        for key, what in (("zero", "ZeRO-sharded states"),
                          ("mesh_shape", "states saved on a mesh")):
            if blob.get(key) is not None:
                raise _later(f"{source}: loading {what} ({key!r})", "2b")
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
        loads = []
        for i, p in enumerate(self._params):
            saved = blob["states"].get(i, {})
            if saved:
                loads.append((i, *self._check_state(
                    i, p, next(iter(saved.values())), source)))
        self._optimizer.num_update = blob["num_update"]
        self._optimizer._index_update_count = dict(
            blob["index_update_count"])
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
        if state is None:
            state = self._optimizer.create_state_multi_precision(i, p.data())
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
