"""gluon.Trainer (ref: python/mxnet/gluon/trainer.py; ``mxnet_tpu/gluon/
trainer.py:55-197,607-735``).

Applies an Optimizer to a set of Parameters.  The port keeps one device
per parameter, so there is nothing to reduce across devices:
``kvstore='device'``/``'local'`` are accepted and, as in the reference for
a single device, no kvstore is created.  The update is fused by default
(one multi-tensor call per group of parameters, :meth:`Optimizer.
fused_update`); ``aggregate_num=1`` or ``MXNET_OPTIMIZER_AGGREGATION_SIZE=1``
gives the sequential path, which the fused one equals bit for bit.

What later slices bring raises :class:`MXNetError` here instead of being
ignored: a distributed kvstore, ``update_on_kvstore``, gradient
compression, ZeRO (``zero_shard``), ``whole_step`` and ``mesh_shape``.
"""
from __future__ import annotations

from .. import optimizer as _opt
from ..base import MXNetError, getenv
from .parameter import ParameterDict

# step counters (ref: trainer.py:23-52), those of the paths the port has
_step_stats = {"steps": 0, "params_fused": 0, "dispatches": 0}


def trainer_step_stats():
    """Counters since the last reset: steps, params_fused (parameters
    updated by a multi-tensor call), dispatches (update calls: one per
    fused group, one per sequential parameter) and dispatches_per_step."""
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
        if whole_step or (whole_step is None
                          and getenv("WHOLE_STEP", False, bool)):
            raise _later("whole_step (MXTPU_WHOLE_STEP)",
                         "whole step and checkpoints")
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
