"""Optimizers (ref: python/mxnet/optimizer/optimizer.py; ``mxnet_tpu/
optimizer.py``): SGD (with momentum), NAG, Adam and AdamW, the ``Optimizer``
base, ``register``/``create`` and ``Updater``.

Each update rule (``_k_sgd``, ``_k_sgd_mom``, ``_k_nag``, ``_k_adam``,
``_k_adamw``; ref :27-118) is one function over *lists* of weights,
gradients and state tensors, written with ``torch._foreach_*`` ops that
update the weights and states in place (PyTorch's tensors are mutable, so
no second copy of the model is held).  The update math has one source:

- :meth:`Optimizer.fused_update` groups parameters by (rule, dtype,
  device, hyper-parameters, scalar values) and calls the rule once per
  group of at most ``aggregate_num`` parameters;
- :meth:`Optimizer.update`, the sequential path, calls the same rule on
  one-element lists.

Every op is elementwise, so the fused step equals the sequential step bit
for bit (the reference's contract, ``tests/test_trainer_fused.py:88``).
The step count ``t`` and the lr are read after the tick, as at :584-590.
Adam's bias corrections ``1 - beta**t`` are computed in float32, as the
reference computes them in its float32 graph.

The per-step scalars (lr, t, wd, rescale and Adam's two bias corrections)
are computed on the host and reach the rules as 0-d views of one small
float32 tensor on the weights' device, never as Python numbers, on every
path: a CUDA graph that captures the update
(:func:`whole_step_plan`, :func:`apply_whole_step_plan`, the whole step
of ``gluon.whole_step``) then reads each step's values from that buffer
instead of baking one step's into the graph, and the eager and captured
steps do the same arithmetic.  What changes the graph's structure (the
rule, its constants, whether an L2 decay term runs) is part of the plan.
"""
from __future__ import annotations

import functools
import pickle

import numpy as np
import torch

from .base import MXNetError, getenv
from .ndarray.ndarray import as_tensor as _tensor

_registry = {}


def register(name=None):
    """Register an Optimizer class under ``name`` (default: its class name,
    lowercased).  Use as ``@register("sgd")`` or ``@register``."""

    def _reg(cls):
        key = (name if isinstance(name, str) else cls.__name__).lower()
        if key in _registry:
            raise MXNetError(f"optimizer '{key}' already registered")
        _registry[key] = cls
        return cls

    return _reg(name) if isinstance(name, type) else _reg


def create(name, **kwargs):
    """An Optimizer from a registered name, or ``name`` itself when it is
    already one (ref: mx.optimizer.create)."""
    if isinstance(name, Optimizer):
        return name
    key = str(name).lower()
    if key not in _registry:
        raise MXNetError(f"unknown optimizer '{name}'; known: "
                         f"{sorted(_registry)}")
    return _registry[key](**kwargs)


# ---------------------------------------------------------------------------
# update rules: lists of tensors, updated in place (ref: optimizer_op-inl.h)


def device_scalars(values, device, out=None):
    """``values`` as one float32 tensor on ``device`` (or copied into
    ``out``, a float32 tensor there); to a CUDA device through pinned
    memory, without a host synchronisation."""
    host = torch.tensor(values, dtype=torch.float32)
    device = torch.device(device)
    if device.type == "cuda":
        host = host.pin_memory()
    if out is not None:
        return out.copy_(host, non_blocking=True)
    return host.to(device, non_blocking=True)


def _prep(ws, gs, s, *, clip, decay):
    """``clip(g * rescale) + wd * w``, as new tensors; the decay term runs
    only where ``decay`` (the host's ``wd != 0``) says so."""
    gp = torch._foreach_mul(gs, s["rescale"])
    if clip is not None:
        torch._foreach_clamp_min_(gp, -clip)
        torch._foreach_clamp_max_(gp, clip)
    if decay:
        torch._foreach_add_(gp, torch._foreach_mul(ws, s["wd"]))
    return gp


def _k_sgd(ws, gs, states, s, *, clip, decay):
    """``w -= lr * g'``."""
    gp = _prep(ws, gs, s, clip=clip, decay=decay)
    torch._foreach_mul_(gp, s["lr"])
    torch._foreach_sub_(ws, gp)


def _k_sgd_mom(ws, gs, states, s, *, clip, decay, momentum):
    """``mom = momentum * mom - lr * g'; w += mom``."""
    (moms,) = states
    gp = _prep(ws, gs, s, clip=clip, decay=decay)
    torch._foreach_mul_(moms, momentum)
    torch._foreach_mul_(gp, s["lr"])
    torch._foreach_sub_(moms, gp)
    torch._foreach_add_(ws, moms)


def _k_nag(ws, gs, states, s, *, clip, decay, momentum):
    """``mom = momentum * mom + g'; w -= lr * (g' + momentum * mom)``."""
    (moms,) = states
    gp = _prep(ws, gs, s, clip=clip, decay=decay)
    torch._foreach_mul_(moms, momentum)
    torch._foreach_add_(moms, gp)
    step = torch._foreach_mul(moms, momentum)
    torch._foreach_add_(step, gp)
    torch._foreach_mul_(step, s["lr"])
    torch._foreach_sub_(ws, step)


@functools.lru_cache(maxsize=1024)
def _bias_correction(beta, t):
    """``1 - beta**t`` in float32 (kept per (beta, t): every parameter of a
    step asks for the same one)."""
    b = torch.tensor(beta, dtype=torch.float32)
    return float(1.0 - b ** torch.tensor(float(t), dtype=torch.float32))


def _adam_direction(gp, means, variances, s, *, beta1, beta2, epsilon):
    """Update the moments in place; return ``mhat`` and
    ``sqrt(vhat) + eps`` as new tensors (the bias corrections ``c1``,
    ``c2`` come with the scalars)."""
    torch._foreach_mul_(means, beta1)
    torch._foreach_add_(means, torch._foreach_mul(gp, 1 - beta1))
    torch._foreach_mul_(variances, beta2)
    sq = torch._foreach_mul(gp, gp)
    torch._foreach_mul_(sq, 1 - beta2)
    torch._foreach_add_(variances, sq)
    mhat = torch._foreach_div(means, s["c1"])
    denom = torch._foreach_div(variances, s["c2"])
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, epsilon)
    return mhat, denom


def _k_adam(ws, gs, states, s, *, clip, decay, beta1, beta2, epsilon):
    """Adam with L2 weight decay folded into the gradient:
    ``w -= lr * mhat / (sqrt(vhat) + eps)``."""
    means, variances = states
    gp = _prep(ws, gs, s, clip=clip, decay=decay)
    mhat, denom = _adam_direction(gp, means, variances, s, beta1=beta1,
                                  beta2=beta2, epsilon=epsilon)
    torch._foreach_mul_(mhat, s["lr"])
    torch._foreach_div_(mhat, denom)
    torch._foreach_sub_(ws, mhat)


def _k_adamw(ws, gs, states, s, *, clip, decay, beta1, beta2, epsilon):
    """Adam with decoupled weight decay:
    ``w -= lr * (mhat / (sqrt(vhat) + eps) + wd * w)``."""
    means, variances = states
    gp = _prep(ws, gs, s, clip=clip, decay=False)
    mhat, denom = _adam_direction(gp, means, variances, s, beta1=beta1,
                                  beta2=beta2, epsilon=epsilon)
    torch._foreach_div_(mhat, denom)
    torch._foreach_add_(mhat, torch._foreach_mul(ws, s["wd"]))
    torch._foreach_mul_(mhat, s["lr"])
    torch._foreach_sub_(ws, mhat)


def _run_rule(rule, static, names, sv, ws, gs, states):
    """One call of ``rule`` over lists, its scalars the 0-d views of the
    float32 tensor ``sv`` (in the order of ``names``)."""
    cols = [list(c) for c in zip(*states)] if states and states[0] else []
    scalars = {n: sv[j] for j, n in enumerate(names)}
    with torch.no_grad():
        rule(ws, gs, cols, scalars, **dict(static))


def _state_list(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [_tensor(s) for s in state]
    return [_tensor(state)]


# ---------------------------------------------------------------------------


class Optimizer:
    """Base optimizer (ref: mx.optimizer.Optimizer).

    ``rescale_grad`` multiplies every gradient, ``clip_gradient`` clips it
    to ``[-c, c]``, ``wd`` is the weight decay; per-parameter lr and wd
    multipliers come from ``param_dict`` (a Parameter's ``lr_mult`` and
    ``wd_mult``) or from :meth:`set_lr_mult`/:meth:`set_wd_mult`.
    ``aggregate_num`` caps the parameters of one fused update: the
    ``MXTPU_``/``MXNET_OPTIMIZER_AGGREGATION_SIZE`` knob wins over the
    argument, and the default is 64; 1 gives the sequential path."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 multi_precision=False, param_dict=None, begin_num_update=0,
                 aggregate_num=None):
        if multi_precision:
            raise MXNetError("multi_precision (float16 master weights) is "
                             "not ported yet; it comes with the mixed-"
                             "precision work of the ResNet-50 slice")
        env_agg = getenv("OPTIMIZER_AGGREGATION_SIZE", None, int)
        if env_agg is not None:
            self.aggregate_num = int(env_agg)
        elif aggregate_num is not None:
            self.aggregate_num = int(aggregate_num)
        else:
            self.aggregate_num = 64
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.multi_precision = False
        self.param_idx2name = param_idx2name or {}
        self.idx2name = self.param_idx2name
        self.param_dict = param_dict or {}
        self.num_update = begin_num_update
        self.begin_num_update = begin_num_update
        self._index_update_count = {}
        self._lr_mult = {}
        self._wd_mult = {}

    # -- config -------------------------------------------------------------

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise MXNetError("LRScheduler of the optimizer has already been "
                             "defined; cannot set_learning_rate")
        self.lr = lr

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_lr_mult(self, args_lr_mult):
        self._lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self._wd_mult = dict(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self.num_update,
                              self._index_update_count[index])

    def _get_lr(self, index):
        lr = (self.lr_scheduler(self.num_update)
              if self.lr_scheduler is not None else self.lr)
        if index in self.param_dict:
            lr *= self.param_dict[index].lr_mult
        elif index in self._lr_mult:
            lr *= self._lr_mult[index]
        elif index in self.idx2name:
            lr *= self._lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.param_dict:
            wd *= self.param_dict[index].wd_mult
        elif index in self._wd_mult:
            wd *= self._wd_mult[index]
        elif index in self.idx2name:
            wd *= self._wd_mult.get(self.idx2name[index], 1.0)
        return wd

    # -- state --------------------------------------------------------------

    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        return self.create_state(index, _tensor(weight))

    # -- the update ---------------------------------------------------------

    def _rule(self, index):
        """``(rule, hyper-parameters)`` of this optimizer's update."""
        raise NotImplementedError

    def _extra_scalars(self, t):
        """Per-step scalars of a rule beyond lr, t, wd and rescale."""
        return {}

    def _tick(self, index):
        """Count one update of ``index``; its scalars, read after the tick,
        as ``{name: float}``."""
        self._update_count(index)
        t = self._index_update_count[index]
        return {"lr": self._get_lr(index), "t": t,
                "wd": self._get_wd(index),
                "rescale": float(self.rescale_grad),
                **self._extra_scalars(t)}

    def _static(self, index, scalars):
        """What the update's graph depends on beyond its tensors: the
        rule's constants, ``clip`` and whether the L2 decay term runs."""
        _rule, hyper = self._rule(index)
        return hyper + (("clip", self.clip_gradient),
                        ("decay", scalars["wd"] != 0))

    def update(self, index, weight, grad, state):
        """One parameter's update, in place: the sequential path."""
        rule, _ = self._rule(index)
        scalars = self._tick(index)
        w = _tensor(weight)
        names = tuple(scalars)
        _run_rule(rule, self._static(index, scalars), names,
                  device_scalars([scalars[n] for n in names], w.device),
                  [w], [_tensor(grad)], [_state_list(state)])

    def update_multi_precision(self, index, weight, grad, state):
        self.update(index, weight, grad, state)

    def fused_update(self, indices, weights, grads, states):
        """Aggregate update: group the parameters by (rule, dtype, device,
        hyper-parameters, scalars) and run each group of at most
        ``aggregate_num`` as one call of the rule.  A parameter whose
        gradient differs in dtype or shape from its weight takes
        :meth:`update`.  Returns ``{fused_calls, params_fused,
        seq_updates}``; the result equals :meth:`update` on each parameter
        bit for bit."""
        stats = {"fused_calls": 0, "params_fused": 0, "seq_updates": 0}
        groups = {}
        for i, w, g, st in zip(indices, weights, grads, states):
            w, g = _tensor(w), _tensor(g)
            if g.dtype != w.dtype or g.shape != w.shape:
                self.update(i, w, g, st)
                stats["seq_updates"] += 1
                continue
            rule, _ = self._rule(i)
            scalars = self._tick(i)
            key = (rule, self._static(i, scalars), w.dtype, w.device,
                   tuple(scalars.items()))
            groups.setdefault(key, []).append((w, g, _state_list(st)))
        agg = max(1, int(self.aggregate_num))
        for (rule, static, _dt, dev, scalars), members in groups.items():
            names = tuple(n for n, _ in scalars)
            sv = device_scalars([v for _, v in scalars], dev)
            for c0 in range(0, len(members), agg):
                chunk = members[c0:c0 + agg]
                _run_rule(rule, static, names, sv, [m[0] for m in chunk],
                          [m[1] for m in chunk], [m[2] for m in chunk])
                stats["fused_calls"] += 1
                stats["params_fused"] += len(chunk)
        return stats

    # -- the whole step's update (ref: optimizer.py:609-754) ------------------

    def whole_step_plan(self, indices, weights, states):
        """The grouping of :meth:`fused_update` for an update that a CUDA
        graph captures (``gluon.whole_step``): the same (rule, dtype,
        device, constants, scalar values) groups in the same order, chunked
        by ``aggregate_num``, without running them.

        Returns ``(plan, svals, None)``: ``plan`` a hashable tuple of
        ``(rule, static, n_states, dtype, idxs, names)`` chunks (``idxs``
        index into the given order, ``names`` the chunk's scalars) and
        ``svals`` the float scalar values of each chunk; or ``(None, None,
        reason)`` when a parameter has no fused form.  Validation runs
        before any tick, so a refused plan leaves no trace; a plan ticks
        every index exactly as :meth:`fused_update` does."""
        entries = [(i, _tensor(w), _state_list(st))
                   for i, w, st in zip(indices, weights, states)]
        for i, w, sts in entries:
            if not w.is_floating_point():
                return None, None, f"non-float parameter {i} ({w.dtype})"
            if any(s.dtype != w.dtype or s.shape != w.shape
                   or s.device != w.device for s in sts):
                return None, None, (f"parameter {i}'s state layout does "
                                    f"not match its fused rule")
        groups = {}
        for pos, (i, w, sts) in enumerate(entries):
            rule, _ = self._rule(i)
            scalars = self._tick(i)
            key = (rule, self._static(i, scalars), w.dtype, w.device,
                   tuple(scalars.items()), len(sts))
            groups.setdefault(key, []).append(pos)
        agg = max(1, int(self.aggregate_num))
        plan, svals = [], []
        for (rule, static, dt, _dev, scalars, n_states), members in \
                groups.items():
            names = tuple(n for n, _ in scalars)
            for c0 in range(0, len(members), agg):
                plan.append((rule, static, n_states, dt,
                             tuple(members[c0:c0 + agg]), names))
                svals.append(tuple(float(v) for _, v in scalars))
        return tuple(plan), svals, None


def apply_whole_step_plan(plan, ws, gs, states, sval_raws):
    """Run every chunk of a :meth:`Optimizer.whole_step_plan` plan over the
    given tensors, in place: ``ws`` and ``gs`` the weights and gradients
    in the plan's order, ``states[j]`` parameter ``j``'s state tensors,
    ``sval_raws[c]`` chunk ``c``'s scalars as a float32 tensor on the
    weights' device (a CUDA graph reads them from there at each replay).
    The same rule calls over the same chunks as :meth:`Optimizer.
    fused_update`, so the result equals it bit for bit."""
    for (rule, static, n_states, _dt, idxs, names), sv in zip(plan,
                                                             sval_raws):
        _run_rule(rule, static, names, sv, [ws[j] for j in idxs],
                  [gs[j] for j in idxs],
                  [list(states[j])[:n_states] for j in idxs])


Optimizer.create_optimizer = staticmethod(create)


def _zeros_like(weight):
    return torch.zeros_like(_tensor(weight),
                            memory_format=torch.contiguous_format)


@register("sgd")
class SGD(Optimizer):
    """SGD with optional momentum.  ``lazy_update`` is accepted: the port's
    gradients are dense, and a dense update is what MXNet runs for them."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return _zeros_like(weight) if self.momentum != 0.0 else None

    def _rule(self, index):
        if self.momentum == 0.0:
            return _k_sgd, ()
        return _k_sgd_mom, (("momentum", self.momentum),)


@register("nag")
class NAG(Optimizer):
    """Nesterov accelerated gradient."""

    def __init__(self, momentum=0.9, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def _rule(self, index):
        return _k_nag, (("momentum", self.momentum),)


@register("adam")
class Adam(Optimizer):
    """Adam; ``lazy_update`` is accepted as in :class:`SGD`."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def _hyper(self):
        return (("beta1", self.beta1), ("beta2", self.beta2),
                ("epsilon", self.epsilon))

    def _extra_scalars(self, t):
        return {"c1": _bias_correction(self.beta1, t),
                "c2": _bias_correction(self.beta2, t)}

    def _rule(self, index):
        return _k_adam, self._hyper()


@register("adamw")
class AdamW(Adam):
    """Adam with decoupled weight decay."""

    def _rule(self, index):
        return _k_adamw, self._hyper()


class Updater:
    """Applies an optimizer by index, keeping each index's state (ref:
    mx.optimizer.Updater)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state_multi_precision(
                index, weight)
        else:  # states restored by set_states arrive on the CPU
            self.states[index] = _states_to(self.states[index],
                                            _tensor(weight).device)
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def get_states(self, dump_optimizer=False):
        return pickle.dumps({k: _states_to_np(v)
                             for k, v in self.states.items()})

    def set_states(self, states):
        loaded = pickle.loads(states)
        self.states = {k: _states_from_np(v) for k, v in loaded.items()}


def _states_to_np(state):
    if state is None:
        return None
    if isinstance(state, tuple):
        return tuple(_states_to_np(s) for s in state)
    return _tensor(state).detach().cpu().numpy()


def _states_from_np(state):
    if state is None:
        return None
    if isinstance(state, tuple):
        return tuple(_states_from_np(s) for s in state)
    return torch.from_numpy(np.array(state))


def _states_to(state, device):
    if state is None:
        return None
    if isinstance(state, tuple):
        return tuple(_states_to(s, device) for s in state)
    return state.to(device)


def get_updater(optimizer):
    return Updater(optimizer)
