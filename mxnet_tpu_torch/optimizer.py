"""Optimizers (ref: python/mxnet/optimizer/optimizer.py; ``mxnet_tpu/
optimizer.py``): SGD (with momentum), NAG, Adam, AdamW, RMSProp (plain and
centred), AdaGrad, AdaDelta, Ftrl, Signum, LAMB, Adamax, Nadam,
GroupAdaGrad, SGLD, DCASGD and Ftml, the ``Optimizer`` base with
``multi_precision``, ``register``/``create`` and ``Updater``.

Each update rule (``_k_sgd`` ... ``_k_ftml``; ref :27-259) is one function
over *lists* of weights, gradients and state tensors, written with
``torch._foreach_*`` ops (or a loop of tensor ops where a rule reads a
tensor's own norm or mean) that update the weights and states in place
(PyTorch's tensors are mutable, so no second copy of the model is held).
The update math has one source:

- :meth:`Optimizer.fused_update` groups parameters by (rule, dtype,
  device, hyper-parameters, scalar values) and calls the rule once per
  group of at most ``aggregate_num`` parameters; the rules the reference
  keeps sequential (its ``_fused_spec`` of None: the centred RMSProp,
  AdaDelta, Ftrl, Signum, LAMB, Adamax, Nadam, GroupAdaGrad, SGLD, DCASGD,
  Ftml) take the sequential path there, and the whole step refuses them;
- :meth:`Optimizer.update`, the sequential path, calls the same rule on
  one-element lists.

Weight decay and clipping come in the reference's order for each rule:
``clip(g * rescale) + wd * w`` (``_prep``, the C++ kernels'), ``clip(g *
rescale + wd * w)`` (``_prep_wd_first``, Adamax, Nadam and Ftml, the Python
optimizers'), or decoupled (AdamW, LAMB, Ftrl, DCASGD).

``multi_precision=True`` keeps a float32 master copy of each float16
weight (ref :521-541): the state is ``(master, the rule's states)``, the
rule runs on the master with the gradient cast to float32, and the master
is then written back into the float16 weight in place (captured graphs and
NDArray views hold that tensor).  Such parameters take the sequential
path in :meth:`Optimizer.fused_update`, and the whole step refuses them.

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


def _prep_wd_first(ws, gs, s, *, clip, decay):
    """``clip(g * rescale + wd * w)``, as new tensors: the Python
    optimizers' order (ref: ``_prep_wd_first``, optimizer.py:194)."""
    gp = torch._foreach_mul(gs, s["rescale"])
    if decay:
        torch._foreach_add_(gp, torch._foreach_mul(ws, s["wd"]))
    if clip is not None:
        torch._foreach_clamp_min_(gp, -clip)
        torch._foreach_clamp_max_(gp, clip)
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


def _ema_(xs, beta, ys):
    """``x = beta * x + (1 - beta) * y`` in place."""
    torch._foreach_mul_(xs, beta)
    torch._foreach_add_(xs, torch._foreach_mul(ys, 1 - beta))


def _ema_sq_(xs, beta, ys):
    """``x = beta * x + (1 - beta) * y**2`` in place."""
    sq = torch._foreach_mul(ys, ys)
    torch._foreach_mul_(sq, 1 - beta)
    torch._foreach_mul_(xs, beta)
    torch._foreach_add_(xs, sq)


def _adam_direction(gp, means, variances, s, *, beta1, beta2, epsilon):
    """Update the moments in place; return ``mhat`` and
    ``sqrt(vhat) + eps`` as new tensors (the bias corrections ``c1``,
    ``c2`` come with the scalars)."""
    _ema_(means, beta1, gp)
    _ema_sq_(variances, beta2, gp)
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


def _k_rmsprop(ws, gs, states, s, *, clip, decay, gamma1, epsilon):
    """``n = gamma1 n + (1-gamma1) g'^2; w -= lr g' / (sqrt(n) + eps)``."""
    (ns,) = states
    gp = _prep(ws, gs, s, clip=clip, decay=decay)
    _ema_sq_(ns, gamma1, gp)
    denom = torch._foreach_sqrt(ns)
    torch._foreach_add_(denom, epsilon)
    torch._foreach_mul_(gp, s["lr"])
    torch._foreach_div_(gp, denom)
    torch._foreach_sub_(ws, gp)


def _k_rmsprop_alex(ws, gs, states, s, *, clip, decay, gamma1, gamma2,
                    epsilon):
    """The centred RMSProp (ref: ``rmspropalex_update``): ``n``, the mean
    gradient ``g`` and the step ``delta``; ``delta = gamma2 delta - lr g' /
    sqrt(n - g^2 + eps); w += delta``."""
    ns, gmeans, deltas = states
    gp = _prep(ws, gs, s, clip=clip, decay=decay)
    _ema_sq_(ns, gamma1, gp)
    _ema_(gmeans, gamma1, gp)
    denom = torch._foreach_mul(gmeans, gmeans)
    denom = torch._foreach_sub(ns, denom)
    torch._foreach_add_(denom, epsilon)
    torch._foreach_sqrt_(denom)
    torch._foreach_mul_(gp, s["lr"])
    torch._foreach_div_(gp, denom)
    torch._foreach_mul_(deltas, gamma2)
    torch._foreach_sub_(deltas, gp)
    torch._foreach_add_(ws, deltas)


def _k_adagrad(ws, gs, states, s, *, clip, decay, epsilon):
    """``h += g'^2; w -= lr g' / (sqrt(h) + eps)``."""
    (hists,) = states
    gp = _prep(ws, gs, s, clip=clip, decay=decay)
    torch._foreach_add_(hists, torch._foreach_mul(gp, gp))
    denom = torch._foreach_sqrt(hists)
    torch._foreach_add_(denom, epsilon)
    torch._foreach_mul_(gp, s["lr"])
    torch._foreach_div_(gp, denom)
    torch._foreach_sub_(ws, gp)


def _k_adadelta(ws, gs, states, s, *, clip, decay, rho, epsilon):
    """``acc_g = rho acc_g + (1-rho) g'^2; delta = sqrt(acc_d + eps) /
    sqrt(acc_g + eps) g'; acc_d = rho acc_d + (1-rho) delta^2; w -=
    delta`` (no learning rate)."""
    acc_gs, acc_ds = states
    gp = _prep(ws, gs, s, clip=clip, decay=decay)
    _ema_sq_(acc_gs, rho, gp)
    num = torch._foreach_add(acc_ds, epsilon)
    torch._foreach_sqrt_(num)
    den = torch._foreach_add(acc_gs, epsilon)
    torch._foreach_sqrt_(den)
    torch._foreach_div_(num, den)
    torch._foreach_mul_(num, gp)
    _ema_sq_(acc_ds, rho, num)
    torch._foreach_sub_(ws, num)


def _k_ftrl(ws, gs, states, s, *, clip, decay, lamda1, beta):
    """Follow the regularized leader (ref: ``_k_ftrl``): ``n += g'^2;
    z += g' - (sqrt(n) - sqrt(n_old)) / lr * w``; the weight is 0 where
    ``|z| <= lamda1``, else ``-(z - sign(z) lamda1) / ((beta + sqrt(n)) /
    lr + wd)``."""
    zs, ns = states
    gp = _prep(ws, gs, s, clip=clip, decay=False)
    lr, wd = s["lr"], s["wd"]
    for w, g, z, n in zip(ws, gp, zs, ns):
        new_n = n + torch.square(g)
        sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / lr
        z.add_(g).sub_(sigma * w)
        n.copy_(new_n)
        w.copy_(torch.where(torch.abs(z) <= lamda1, torch.zeros_like(w),
                            -(z - torch.sign(z) * lamda1)
                            / ((beta + torch.sqrt(new_n)) / lr + wd)))


def _k_signum(ws, gs, states, s, *, clip, decay, momentum):
    """``mom = momentum mom - (1-momentum) g'; w += lr sign(mom)``."""
    (moms,) = states
    gp = _prep(ws, gs, s, clip=clip, decay=decay)
    torch._foreach_mul_(moms, momentum)
    torch._foreach_sub_(moms, torch._foreach_mul(gp, 1 - momentum))
    step = torch._foreach_sign(moms)
    torch._foreach_mul_(step, s["lr"])
    torch._foreach_add_(ws, step)


def _k_lamb(ws, gs, states, s, *, clip, decay, beta1, beta2, epsilon,
            lower_bound, upper_bound):
    """LAMB (You et al. 2019; ref: ``_k_lamb``): Adam's direction plus
    ``wd w``, scaled per tensor by ``||w|| / ||update||`` (1 where either
    is 0, clamped to the bounds): ``w -= lr ratio update``."""
    means, variances = states
    gp = _prep(ws, gs, s, clip=clip, decay=False)
    mhat, denom = _adam_direction(gp, means, variances, s, beta1=beta1,
                                  beta2=beta2, epsilon=epsilon)
    torch._foreach_div_(mhat, denom)
    if decay:
        torch._foreach_add_(mhat, torch._foreach_mul(ws, s["wd"]))
    for w, upd in zip(ws, mhat):
        wnorm = torch.linalg.vector_norm(w)
        unorm = torch.linalg.vector_norm(upd)
        ratio = torch.where((wnorm > 0) & (unorm > 0), wnorm / unorm,
                            torch.ones_like(wnorm))
        if lower_bound is not None:
            ratio = torch.clamp_min(ratio, lower_bound)
        if upper_bound is not None:
            ratio = torch.clamp_max(ratio, upper_bound)
        w.sub_(s["lr"] * ratio * upd)


def _k_adamax(ws, gs, states, s, *, clip, decay, beta1, beta2, epsilon):
    """``m = beta1 m + (1-beta1) g'; u = max(beta2 u, |g'|); w -= (lr /
    (1 - beta1^t)) m / (u + eps)``, wd before the clip."""
    means, us = states
    gp = _prep_wd_first(ws, gs, s, clip=clip, decay=decay)
    _ema_(means, beta1, gp)
    torch._foreach_mul_(us, beta2)
    torch._foreach_maximum_(us, torch._foreach_abs(gp))
    step = torch._foreach_mul(means, s["lr"] / s["c1"])
    denom = torch._foreach_add(us, epsilon)
    torch._foreach_div_(step, denom)
    torch._foreach_sub_(ws, step)


def _k_nadam(ws, gs, states, s, *, clip, decay, beta1, beta2, epsilon):
    """Nadam (Dozat 2016; ref: ``_k_nadam``), wd before the clip; the
    momentum schedule's values (``msched``, ``msched_next``, ``mt``,
    ``mt1``) come with the scalars."""
    means, variances = states
    gp = _prep_wd_first(ws, gs, s, clip=clip, decay=decay)
    g_prime = torch._foreach_div(gp, 1 - s["msched"])
    _ema_(means, beta1, gp)
    m_prime = torch._foreach_div(means, 1 - s["msched_next"])
    _ema_sq_(variances, beta2, gp)
    v_prime = torch._foreach_div(variances, s["c2"])
    torch._foreach_mul_(g_prime, 1 - s["mt"])
    torch._foreach_mul_(m_prime, s["mt1"])
    torch._foreach_add_(g_prime, m_prime)
    torch._foreach_mul_(g_prime, s["lr"])
    torch._foreach_sqrt_(v_prime)
    torch._foreach_add_(v_prime, epsilon)
    torch._foreach_div_(g_prime, v_prime)
    torch._foreach_sub_(ws, g_prime)


def _k_group_adagrad(ws, gs, states, s, *, clip, decay, epsilon):
    """Row-wise AdaGrad (ref: ``_k_group_adagrad``): ``h`` (rows, 1, ...)
    gains the mean of ``g'^2`` over each row; ``w -= lr g' / (sqrt(h) +
    eps)``; no weight decay."""
    (hists,) = states
    gp = _prep(ws, gs, s, clip=clip, decay=False)
    for w, g, h in zip(ws, gp, hists):
        sq = torch.square(g)
        h.add_(sq.mean(dim=tuple(range(1, g.dim())), keepdim=True)
               if g.dim() > 1 else sq)
        w.sub_(s["lr"] * g / (torch.sqrt(h) + epsilon))


def _k_sgld(ws, gs, states, s, *, clip, decay):
    """Langevin dynamics (ref: ``_k_sgld``): ``w -= lr/2 g'; w +=
    sqrt(lr) noise``, the noise drawn by :class:`SGLD` and passed as the
    state."""
    (noises,) = states
    gp = _prep(ws, gs, s, clip=clip, decay=decay)
    torch._foreach_mul_(gp, s["lr"] / 2)
    torch._foreach_sub_(ws, gp)
    torch._foreach_add_(ws, torch._foreach_mul(noises, torch.sqrt(s["lr"])))


def _k_dcasgd(ws, gs, states, s, *, clip, decay, momentum, lamda):
    """Delay-compensated SGD (ref: ``_k_dcasgd``): ``mom = momentum mom -
    lr (g' + wd w + lamda g'^2 (w - w_prev)); w += mom; w_prev = w``, g'
    the clipped bare gradient."""
    moms, prevs = states
    gp = _prep(ws, gs, s, clip=clip, decay=False)
    for w, g, mom, prev in zip(ws, gp, moms, prevs):
        comp = g + s["wd"] * w if decay else g
        comp = comp + lamda * torch.square(g) * (w - prev)
        mom.mul_(momentum).sub_(s["lr"] * comp)
        w.add_(mom)
        prev.copy_(w)


def _k_ftml(ws, gs, states, s, *, clip, decay, beta1, beta2, epsilon):
    """Follow the moving leader (ref: ``_k_ftml``), wd before the clip:
    ``v = beta2 v + (1-beta2) g'^2; d' = (1 - beta1^t) / lr (sqrt(v /
    (1 - beta2^t)) + eps); z = beta1 z + (1-beta1) g' - (d' - beta1 d) w;
    w = -z / d'; d = d'``."""
    ds, vs, zs = states
    gp = _prep_wd_first(ws, gs, s, clip=clip, decay=decay)
    _ema_sq_(vs, beta2, gp)
    for w, g, d, v, z in zip(ws, gp, ds, vs, zs):
        new_d = s["c1"] / s["lr"] * (torch.sqrt(v / s["c2"]) + epsilon)
        sigma = new_d - beta1 * d
        z.mul_(beta1).add_((1 - beta1) * g).sub_(sigma * w)
        w.copy_(-z / new_d)
        d.copy_(new_d)


def _run_rule(rule, static, names, sv, ws, gs, states):
    """One call of ``rule`` over lists, its scalars the 0-d views of the
    float32 tensor ``sv`` (in the order of ``names``)."""
    cols = [list(c) for c in zip(*states)] if states and states[0] else []
    scalars = {n: sv[j] for j, n in enumerate(names)}
    with torch.no_grad():
        rule(ws, gs, cols, scalars, **dict(static))


def _state_list(state):
    """The tensors of a state, in order: nested tuples (a float32 master
    and the rule's states) flattened, None left out."""
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [t for st in state for t in _state_list(st)]
    return [_tensor(state)]


# ---------------------------------------------------------------------------


class _Mults:
    """A parameter's learning-rate and weight-decay multipliers, as a
    pickled optimizer's ``param_dict`` holds them."""

    def __init__(self, lr_mult, wd_mult):
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult


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
        self.multi_precision = multi_precision
        self.param_idx2name = param_idx2name or {}
        self.idx2name = self.param_idx2name
        self.param_dict = param_dict or {}
        self.num_update = begin_num_update
        self.begin_num_update = begin_num_update
        self._index_update_count = {}
        self._lr_mult = {}
        self._wd_mult = {}

    def __getstate__(self):
        """What ``pickle`` keeps (a ``dist_async`` store sends its
        optimizer to the parameter servers): every attribute, with
        ``param_dict``'s Parameters cut down to their ``lr_mult`` and
        ``wd_mult``, so no tensor of the worker's devices crosses and the
        servers, which stay off the card, apply the same multipliers."""
        state = dict(self.__dict__)
        state["param_dict"] = {k: _Mults(p.lr_mult, p.wd_mult)
                               for k, p in self.param_dict.items()}
        return state

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

    def _get_lr(self, index, num_update=None):
        if num_update is None:
            num_update = self.num_update
        lr = (self.lr_scheduler(num_update)
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

    def _master(self, weight):
        """Whether ``weight`` gets a float32 master copy: a float16 weight
        under ``multi_precision`` (ref: optimizer.py:521-541)."""
        return self.multi_precision and _tensor(weight).dtype == torch.float16

    def create_state_multi_precision(self, index, weight):
        """``(float32 master, the rule's states on it)`` for a weight that
        :meth:`_master` names, else :meth:`create_state`."""
        w = _tensor(weight)
        if self._master(w):
            w32 = w.detach().to(torch.float32, copy=True)
            return (w32, self.create_state(index, w32))
        return self.create_state(index, w)

    # -- the update ---------------------------------------------------------

    #: whether the rule has a fused and a whole-step form (ref: a
    #: ``_fused_spec`` that is not None); the rules the reference keeps
    #: sequential say False
    _fused = True

    def _rule(self, index):
        """``(rule, hyper-parameters)`` of this optimizer's update."""
        raise NotImplementedError

    def _has_rule(self):
        """Whether this optimizer's list rule (``_rule``) has a fused and a
        whole-step form: one without a rule (it overrides only
        :meth:`update`) or with ``_fused`` False runs sequentially (ref: a
        ``_fused_spec`` of None)."""
        return type(self)._rule is not Optimizer._rule and self._fused

    def _extra_scalars(self, t):
        """Per-step scalars of a rule beyond lr, t, wd and rescale."""
        return {}

    def _tick(self, index):
        """Count one update of ``index``; its scalars, read after the tick,
        as ``{name: float}``."""
        self._update_count(index)
        return self._scalars(index, self._index_update_count[index],
                             self.num_update)

    def _scalars(self, index, t, num_update):
        """``index``'s scalars at its ``t``-th update, the optimizer's
        ``num_update`` then."""
        return {"lr": self._get_lr(index, num_update), "t": t,
                "wd": self._get_wd(index),
                "rescale": float(self.rescale_grad),
                **self._extra_scalars(t)}

    def _next_scalars(self, indices):
        """What :meth:`_tick` would give each of ``indices`` in turn, with
        nothing counted."""
        counts, num_update, out = {}, self.num_update, []
        for i in indices:
            t = counts.get(i, self._index_update_count.get(
                i, self.begin_num_update)) + 1
            counts[i] = t
            num_update = max(num_update, t)
            out.append(self._scalars(i, t, num_update))
        return out

    def _static(self, index, scalars):
        """What the update's graph depends on beyond its tensors: the
        rule's constants, ``clip`` and whether the L2 decay term runs."""
        _rule, hyper = self._rule(index)
        return hyper + (("clip", self.clip_gradient),
                        ("decay", scalars["wd"] != 0))

    def update(self, index, weight, grad, state):
        """One parameter's update, in place: the sequential path."""
        self._apply_rule(index, weight, grad, state, self._tick(index))

    def _apply_rule(self, index, weight, grad, state, scalars):
        """The rule on one parameter with the scalars of its update."""
        rule, _ = self._rule(index)
        w = _tensor(weight)
        names = tuple(scalars)
        _run_rule(rule, self._static(index, scalars), names,
                  device_scalars([scalars[n] for n in names], w.device),
                  [w], [_tensor(grad)], [_state_list(state)])

    def update_multi_precision(self, index, weight, grad, state):
        """:meth:`update`; for a weight with a float32 master (its state
        ``(master, states)``), the update of the master with the gradient
        cast to float32, then the master copied into the weight in place
        (ref: optimizer.py:530-541)."""
        w = _tensor(weight)
        if not self._master(w):
            return self.update(index, weight, grad, state)
        w32, inner = state
        self.update(index, w32, _tensor(grad).to(torch.float32), inner)
        with torch.no_grad():
            w.copy_(w32)

    def fused_update(self, indices, weights, grads, states):
        """Aggregate update: group the parameters by (rule, dtype, device,
        hyper-parameters, scalars) and run each group of at most
        ``aggregate_num`` as one call of the rule.  A parameter whose
        gradient differs in dtype or shape from its weight, a float16
        weight with a float32 master and every parameter of a rule without
        a fused form take :meth:`update_multi_precision` (ref: :575).
        Returns ``{fused_calls, params_fused, seq_updates}``; the result
        equals :meth:`update_multi_precision` on each parameter bit for
        bit."""
        stats = {"fused_calls": 0, "params_fused": 0, "seq_updates": 0}
        groups = {}
        for i, w, g, st in zip(indices, weights, grads, states):
            w, g = _tensor(w), _tensor(g)
            if (not self._has_rule() or self._master(w)
                    or g.dtype != w.dtype or g.shape != w.shape):
                self.update_multi_precision(i, w, g, st)
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

    # -- the whole step's update (ref: optimizer.py:609-861) ------------------

    def whole_step_plan(self, indices, weights, states, zero_world=None):
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
        every index exactly as :meth:`fused_update` does.

        With ``zero_world=N`` the plan is ZeRO-1's (arXiv 2004.13336): each
        group's chunks are also capped by the flat-bucket budget
        (``MXTPU_KVSTORE_BUCKET_MB``, default 32: a chunk is one
        reduce-scatter) and end in ``total, padded``, the chunk's element
        count and that count rounded up to a multiple of N
        (``kvstore.zero_padded_size``).  Its states are shard-sized
        buffers the caller makes, so ``states`` is not checked."""
        entries, reason = self._plan_entries(indices, weights, states,
                                             zero_world)
        if reason is not None:
            return None, None, reason
        return self._plan_chunks(entries, [self._tick(i) for i in indices],
                                 zero_world) + (None,)

    def zero_layout(self, indices, weights, world):
        """The chunks of the ZeRO plan :meth:`whole_step_plan` would build
        at ``zero_world=world`` for the next update, with no update counted
        (a layout to check a saved snapshot against); None where it would
        refuse."""
        entries, reason = self._plan_entries(
            indices, weights, [None] * len(indices), world)
        if reason is not None:
            return None
        return self._plan_chunks(entries, self._next_scalars(indices),
                                 world)[0]

    def _plan_entries(self, indices, weights, states, zero_world):
        """``(entries, None)``: ``(index, weight, states)`` of each
        parameter; or ``(None, reason)`` when one has no fused form."""
        if not self._has_rule():
            return None, (f"optimizer {type(self).__name__} has no fused "
                          f"kernel for param {indices[0]}" if indices
                          else "no parameters")
        if any(self._master(w) for w in weights):
            return None, "multi-precision fp16 master-weight params"
        entries = [(i, _tensor(w), _state_list(st))
                   for i, w, st in zip(indices, weights, states)]
        for i, w, sts in entries:
            if not w.is_floating_point():
                return None, f"non-float parameter {i} ({w.dtype})"
            if zero_world is None and any(
                    s.dtype != w.dtype or s.shape != w.shape
                    or s.device != w.device for s in sts):
                return None, (f"parameter {i}'s state layout does not "
                              f"match its fused rule")
        return entries, None

    def _plan_chunks(self, entries, scalars, zero_world):
        """``(plan, svals)`` of :meth:`whole_step_plan` from its entries and
        each entry's scalars."""
        groups = {}
        for pos, ((i, w, sts), sc) in enumerate(zip(entries, scalars)):
            rule, _ = self._rule(i)
            n_states = len(sts)
            if zero_world is not None:  # the states the rule keeps
                n_states = len(_state_list(self.create_state(
                    i, w.new_empty(0))))
            key = (rule, self._static(i, sc), w.dtype, w.device,
                   tuple(sc.items()), n_states)
            groups.setdefault(key, []).append(pos)
        agg = max(1, int(self.aggregate_num))
        cap = max(int(getenv("KVSTORE_BUCKET_MB", 32.0, float) * (1 << 20)),
                  1)
        plan, svals = [], []
        for (rule, static, dt, _dev, sc, n_states), members in \
                groups.items():
            names = tuple(n for n, _ in sc)
            head = (rule, static, n_states, dt)
            if zero_world is None:
                chunks = [members[c0:c0 + agg]
                          for c0 in range(0, len(members), agg)]
            else:
                chunks, chunk, size = [], [], 0
                for pos in members:
                    w = entries[pos][1]
                    nbytes = w.numel() * w.element_size()
                    if chunk and (len(chunk) >= agg or size + nbytes > cap):
                        chunks.append(chunk)
                        chunk, size = [], 0
                    chunk.append(pos)
                    size += nbytes
                chunks.append(chunk)
            for chunk in chunks:
                tail = (tuple(chunk), names)
                if zero_world is not None:
                    from .kvstore import zero_padded_size

                    total = sum(entries[pos][1].numel() for pos in chunk)
                    tail += (total, zero_padded_size(total, zero_world))
                plan.append(head + tail)
                svals.append(tuple(float(v) for _, v in sc))
        return tuple(plan), svals

    def zero_fused_update(self, plan, svals, w_shards, g_shards, st_shards):
        """ZeRO-1's update: each chunk of a ``zero_world`` plan's rule over
        ONE flat shard, in place: ``w_shards[c]`` this rank's slice of the
        chunk's weights, ``g_shards[c]`` its reduced gradients and
        ``st_shards[c]`` its shard-sized states (ref:
        ``zero_fused_update``).  The rule is the one :meth:`fused_update`
        runs, and every op is elementwise, so the slice gets the bits the
        unsharded update gives it.  Returns the weight shards."""
        for (rule, static, _n, _dt, _idxs, names, _total, _padded), sv, w, \
                g, sts in zip(plan, svals, w_shards, g_shards, st_shards):
            _run_rule(rule, static, names, device_scalars(sv, w.device),
                      [w], [g], [list(sts)])
        return list(w_shards)


def apply_whole_step_plan(plan, ws, gs, states, sval_raws):
    """Run every chunk of a :meth:`Optimizer.whole_step_plan` plan over the
    given tensors, in place: ``ws`` and ``gs`` the weights and gradients
    in the plan's order, ``states[j]`` parameter ``j``'s state tensors,
    ``sval_raws[c]`` chunk ``c``'s scalars as a float32 tensor on the
    weights' device (a CUDA graph reads them from there at each replay).
    The same rule calls over the same chunks as :meth:`Optimizer.
    fused_update`, so the result equals it bit for bit.  A ZeRO plan's
    chunks run whole here (every rank's slice at once)."""
    for chunk, sv in zip(plan, sval_raws):
        rule, static, n_states, _dt, idxs, names = chunk[:6]
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


@register("rmsprop")
class RMSProp(Optimizer):
    """RMSProp (Tieleman & Hinton 2012); ``centered=True`` is Graves's
    centred form, which keeps the mean gradient and the step too and runs
    sequentially, as in the reference."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2, self.epsilon = gamma1, gamma2, epsilon
        self.centered = centered
        self._fused = not centered

    def create_state(self, index, weight):
        if self.centered:   # n, the mean gradient, delta
            return tuple(_zeros_like(weight) for _ in range(3))
        return _zeros_like(weight)

    def _rule(self, index):
        if self.centered:
            return _k_rmsprop_alex, (("gamma1", self.gamma1),
                                     ("gamma2", self.gamma2),
                                     ("epsilon", self.epsilon))
        return _k_rmsprop, (("gamma1", self.gamma1),
                            ("epsilon", self.epsilon))


@register("adagrad")
class AdaGrad(Optimizer):
    """AdaGrad (Duchi et al. 2011); ``eps`` is added to the root."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def _rule(self, index):
        return _k_adagrad, (("epsilon", self.float_stable_eps),)


@register("adadelta")
class AdaDelta(Optimizer):
    """AdaDelta (Zeiler 2012): no learning rate."""

    _fused = False

    def __init__(self, rho=0.9, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def _rule(self, index):
        return _k_adadelta, (("rho", self.rho), ("epsilon", self.epsilon))


@register("ftrl")
class Ftrl(Optimizer):
    """Follow the regularized leader, FTRL-Proximal (McMahan et al. 2013);
    states ``z`` and ``n``."""

    _fused = False

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def _rule(self, index):
        return _k_ftrl, (("lamda1", self.lamda1), ("beta", self.beta))


@register("signum")
class Signum(Optimizer):
    """Signum (Bernstein et al. 2018): the sign of the momentum, which
    accumulates the negative gradient.  ``wd_lh`` is accepted and unused,
    as in the reference's optimizer (its op takes it)."""

    _fused = False

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def _rule(self, index):
        return _k_signum, (("momentum", self.momentum),)


@register("lamb")
class LAMB(Optimizer):
    """LAMB (You et al. 2019): Adam's direction with decoupled weight
    decay, its step scaled per tensor by the trust ratio ``||w|| /
    ||update||`` (clamped to ``lower_bound``/``upper_bound`` when given)."""

    _fused = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound, self.upper_bound = lower_bound, upper_bound

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def _extra_scalars(self, t):
        return {"c1": _bias_correction(self.beta1, t),
                "c2": _bias_correction(self.beta2, t)}

    def _rule(self, index):
        return _k_lamb, (("beta1", self.beta1), ("beta2", self.beta2),
                         ("epsilon", self.epsilon),
                         ("lower_bound", self.lower_bound),
                         ("upper_bound", self.upper_bound))


@register("adamax")
class Adamax(Optimizer):
    """Adamax (Kingma & Ba 2015, section 7): the infinity norm in place of
    Adam's second moment.  ``epsilon`` defaults to 0, as the reference's
    update has none; a value is an opt-in guard."""

    _fused = False

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 epsilon=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def _extra_scalars(self, t):
        return {"c1": _bias_correction(self.beta1, t)}

    def _rule(self, index):
        return _k_adamax, (("beta1", self.beta1), ("beta2", self.beta2),
                           ("epsilon", self.epsilon))


@register("nadam")
class Nadam(Optimizer):
    """Nadam (Dozat 2016).  The momentum schedule is the reference's:
    ``m_schedule`` is one product that every parameter's update advances,
    on the host."""

    _fused = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def _rule(self, index):
        return _k_nadam, (("beta1", self.beta1), ("beta2", self.beta2),
                          ("epsilon", self.epsilon))

    def update(self, index, weight, grad, state):
        scalars = self._tick(index)
        t = scalars["t"]
        mt = self.beta1 * (1 - 0.5 * 0.96 ** (t * self.schedule_decay))
        mt1 = self.beta1 * (1 - 0.5 * 0.96 ** ((t + 1)
                                               * self.schedule_decay))
        self.m_schedule *= mt
        scalars.update(c2=_bias_correction(self.beta2, t),
                       msched=self.m_schedule,
                       msched_next=self.m_schedule * mt1, mt=mt, mt1=mt1)
        self._apply_rule(index, weight, grad, state, scalars)


@register("groupadagrad")
class GroupAdaGrad(Optimizer):
    """Row-wise AdaGrad (ref: ``mx.optimizer.contrib.GroupAdaGrad``): one
    accumulated squared gradient a row, for embeddings; no weight decay."""

    _fused = False

    def __init__(self, learning_rate=0.01, epsilon=1e-5, **kwargs):
        if kwargs.get("wd"):
            raise MXNetError("GroupAdaGrad does not support weight decay "
                             "(ref: optimizer/contrib.py assertion)")
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.epsilon = epsilon

    def create_state(self, index, weight):
        w = _tensor(weight)
        return torch.zeros((w.shape[0],) + (1,) * (w.dim() - 1),
                           dtype=w.dtype, device=w.device)

    def _rule(self, index):
        return _k_group_adagrad, (("epsilon", self.epsilon),)


@register("sgld")
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (Welling & Teh 2011): half a
    gradient step plus Gaussian noise of variance lr, drawn from the
    device's explicit generator (``mx.random.seed`` fixes it)."""

    _fused = False

    def _rule(self, index):
        return _k_sgld, ()

    def update(self, index, weight, grad, state):
        from . import random as _random

        w = _tensor(weight)
        noise = torch.randn(w.shape, dtype=w.dtype, device=w.device,
                            generator=_random.generator(w.device))
        self._apply_rule(index, weight, grad, (noise,), self._tick(index))


@register("dcasgd")
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD (Zheng et al. 2017); states the
    momentum and the previous weight."""

    _fused = False

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum, self.lamda = momentum, lamda

    def create_state(self, index, weight):
        return (_zeros_like(weight), _tensor(weight).detach().clone(
            memory_format=torch.contiguous_format))

    def _rule(self, index):
        return _k_dcasgd, (("momentum", self.momentum),
                           ("lamda", self.lamda))


@register("ftml")
class Ftml(Optimizer):
    """Follow the moving leader (Zheng & Kwok 2017); states ``d``, ``v``,
    ``z``."""

    _fused = False

    def __init__(self, learning_rate=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return tuple(_zeros_like(weight) for _ in range(3))

    def _extra_scalars(self, t):
        return {"c1": _bias_correction(self.beta1, t),
                "c2": _bias_correction(self.beta2, t)}

    def _rule(self, index):
        return _k_ftml, (("beta1", self.beta1), ("beta2", self.beta2),
                         ("epsilon", self.epsilon))


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

    def update_many(self, indices, grads, weights):
        """:meth:`__call__` on each ``(index, grad, weight)``, as one
        :meth:`Optimizer.fused_update` (the same result bit for bit, a
        rule call a group instead of one a parameter)."""
        states = []
        for i, w in zip(indices, weights):
            if i not in self.states:
                self.states[i] = self.optimizer.create_state_multi_precision(
                    i, w)
            else:
                self.states[i] = _states_to(self.states[i],
                                            _tensor(w).device)
            states.append(self.states[i])
        return self.optimizer.fused_update(list(indices), list(weights),
                                           list(grads), states)

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
