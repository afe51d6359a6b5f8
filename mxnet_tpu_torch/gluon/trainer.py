"""gluon.Trainer (ref: python/mxnet/gluon/trainer.py; ``mxnet_tpu/gluon/
trainer.py:55-197,607-735``).

Applies an Optimizer to a set of Parameters.  The port keeps one device
per parameter, so there is nothing to reduce across devices:
``kvstore='device'``/``'local'`` are accepted and, as in the reference for
a single device, no kvstore is created.  The update is fused by default
(one multi-tensor call per group of parameters, :meth:`Optimizer.
fused_update`); ``aggregate_num=1`` or ``MXNET_OPTIMIZER_AGGREGATION_SIZE=1``
gives the sequential path, which the fused one equals bit for bit.

:meth:`Trainer.whole_step` runs forward, loss, backward and update as one
step; with ``Trainer(..., whole_step=True)`` or ``MXTPU_WHOLE_STEP=1``
that step is one CUDA-graph replay on the card after a warm-up and a
capture per input signature (``gluon/whole_step.py``), bit-identical to
the eager step.

:meth:`Trainer.save_states`/:meth:`Trainer.load_states` write and read
the JAX package's versioned pickle, so either package resumes the
other's optimizer; loading copies into the existing state tensors in
place, so a captured whole step keeps replaying on them.

What later slices bring raises :class:`MXNetError` here instead of being
ignored: a distributed kvstore, ``update_on_kvstore``, gradient
compression, ZeRO (``zero_shard``) and ``mesh_shape``, and states blobs
of those.
"""
from __future__ import annotations

import pickle

import numpy as np
import torch

from .. import autograd
from .. import optimizer as _opt
from ..base import MXNetError, getenv
from .parameter import ParameterDict

# step counters (ref: trainer.py:23-52), those of the paths the port has
_step_stats = {"steps": 0, "params_fused": 0, "dispatches": 0,
               "whole_step_steps": 0, "whole_step_compiles": 0,
               "whole_step_fallbacks": 0}


def trainer_step_stats():
    """Counters since the last reset: steps, params_fused (parameters
    updated by a multi-tensor call), dispatches (update calls: one per
    fused group, one per sequential parameter, one per whole step),
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


def _later(what, slice_name):
    return MXNetError(f"Trainer: {what} is not ported yet; it comes with "
                      f"the {slice_name} slice (ROADMAP.md queue 1)")


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None, whole_step=None,
                 zero_shard=None, mesh_shape=None, sharding_plan=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise MXNetError("params must be a ParameterDict or list")
        if kvstore not in (None, "device", "local"):
            raise _later(f"kvstore={kvstore!r}", "distributed")
        if compression_params:
            raise _later("gradient compression", "distributed")
        if update_on_kvstore:
            raise _later("update_on_kvstore", "distributed")
        if zero_shard or (zero_shard is None
                          and getenv("ZERO_SHARD", False, bool)):
            raise _later("ZeRO (zero_shard / MXTPU_ZERO_SHARD)",
                         "distributed")
        if mesh_shape is not None or sharding_plan is not None or \
                getenv("MESH_SHAPE", None):
            raise _later("mesh_shape / sharding_plan (MXTPU_MESH_SHAPE)",
                         "distributed")
        if whole_step is None:
            whole_step = getenv("WHOLE_STEP", False, bool)
        self._whole_step = bool(whole_step)
        self._whole_step_compiler = None
        self._params = [p for p in params if p.grad_req != "null"]
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._optimizer = _opt.create(
            optimizer, param_dict=dict(enumerate(self._params)),
            **optimizer_params)
        self._states = [None] * len(self._params)
        self._dispatches = 0
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

    def step(self, batch_size, ignore_stale_grad=False):
        """Update every parameter, with gradients rescaled by
        ``1/batch_size`` (there is nothing to reduce on one device)."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self._dispatches = self._params_fused = 0
        self._update(ignore_stale_grad)
        _step_stats["steps"] += 1
        _step_stats["dispatches"] += self._dispatches
        _step_stats["params_fused"] += self._params_fused

    def allreduce_grads(self):
        """Reduce the gradients across devices: with one device per
        parameter there is nothing to reduce."""

    def update(self, batch_size, ignore_stale_grad=False):
        """The update half of :meth:`step`, after :meth:`allreduce_grads`."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        """Update every parameter.  With ``ignore_stale_grad`` a parameter
        whose gradient no backward has written since its last update is
        skipped, as MXNet does; without it, it is updated with the
        gradient it holds, as the reference does."""
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
        objects: the captured graphs are cached by their identity."""
        inputs = tuple(x) if isinstance(x, (list, tuple)) else (x,)
        if batch_size is None:
            batch_size = int(inputs[0].shape[0])
        if not self._whole_step:
            return self._eager_whole_step(block, loss_fn, inputs, y,
                                          batch_size)
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

    def _states_blob(self):
        """The states layout with the live state tensors as leaves (the
        checkpoint manager copies them before the next step)."""
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

        return host_leaves(self._states_blob())

    def load_states_dict(self, blob, source="<states blob>"):
        """Inverse of :meth:`states_dict` (leaves numpy arrays, NDArrays or
        tensors): restores the update counters and copies each saved state
        into the existing state tensor in place (one is created where none
        exists yet), so a captured step replays on the loaded values.
        Everything is checked before anything is changed."""
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
        for key, what in (("kvstore", "a kvstore-side updater's states"),
                          ("zero", "ZeRO-sharded states"),
                          ("mesh_shape", "states saved on a mesh")):
            if blob.get(key) is not None:
                raise _later(f"{source}: loading {what} ({key!r})",
                             "distributed")
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
        from ..ndarray.ndarray import NDArray

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
        renamed over it), in the JAX package's layout."""
        from ..checkpoint import atomic_file

        payload = self.states_dict()
        with atomic_file(fname) as tmp:
            with open(tmp, "wb") as f:
                pickle.dump(payload, f)

    def load_states(self, fname):
        with open(fname, "rb") as f:
            blob = pickle.load(f)
        self.load_states_dict(blob, source=fname)

    def _eager_whole_step(self, block, loss_fn, inputs, y, batch_size):
        """The eager twin of :meth:`whole_step`: ``autograd.record``, the
        forward and loss, ``backward`` of the loss's sum, then
        :meth:`step`."""
        from ..ndarray.ndarray import NDArray, as_tensor
        from .whole_step import as_step_tensor

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
