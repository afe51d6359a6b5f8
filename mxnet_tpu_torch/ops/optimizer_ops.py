"""The optimizer update operators (ref: ``mxnet_tpu/ops/optimizer_ops.py``;
MXNet's ``src/operator/optimizer_op.cc``): ``sgd_update``, ``adam_update``
and the rest, for user code that calls ``mx.nd.sgd_update(w, g, lr=...,
out=w)`` directly.  (``mx.optimizer`` runs its own list rules.)

The reference's semantics: the new weight is returned (``out=w`` writes it
back in place), and the state inputs (momentum, moments, histories, the
``mp_*`` forms' float32 master) are updated in place through
``mutate_aux``.  On tensors (``F``) each op returns the new weight and the
new states, as the JAX ops do.  A clip of 0 or less means none.
"""
from __future__ import annotations

import torch

from .registry import register


def _clip(g, c):
    return torch.clamp(g, -c, c) if c > 0 else g


def _prep(g, w, rescale_grad, clip_gradient, wd):
    return _clip(g * rescale_grad, clip_gradient) + wd * w


def _k_sgd_update(weight, grad, *, lr, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, lazy_update=True):
    """``w - lr * (clip(g*rescale) + wd*w)``."""
    return weight - lr * _prep(grad, weight, rescale_grad, clip_gradient, wd)


def _k_sgd_mom_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0,
                      rescale_grad=1.0, clip_gradient=-1.0,
                      lazy_update=True):
    """``mom = momentum*mom - lr*g'; w + mom``."""
    g = _prep(grad, weight, rescale_grad, clip_gradient, wd)
    new_mom = momentum * mom - lr * g
    return weight + new_mom, new_mom


def _k_nag_mom_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0,
                      rescale_grad=1.0, clip_gradient=-1.0):
    """``mom = momentum*mom + g'; w - lr*(g' + momentum*mom)``."""
    g = _prep(grad, weight, rescale_grad, clip_gradient, wd)
    new_mom = momentum * mom + g
    return weight - lr * (g + momentum * new_mom), new_mom


def _k_mp_sgd_update(weight, grad, weight32, *, lr, wd=0.0,
                     rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    """:func:`_k_sgd_update` on the float32 master ``weight32``; the new
    weight is the master rounded to the weight's dtype."""
    g = _prep(grad.float(), weight32, rescale_grad, clip_gradient, wd)
    new_w32 = weight32 - lr * g
    return new_w32.to(weight.dtype), new_w32


def _k_mp_sgd_mom_update(weight, grad, mom, weight32, *, lr, momentum=0.0,
                         wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                         lazy_update=True):
    """:func:`_k_sgd_mom_update` on the float32 master ``weight32``."""
    g = _prep(grad.float(), weight32, rescale_grad, clip_gradient, wd)
    new_mom = momentum * mom - lr * g
    new_w32 = weight32 + new_mom
    return new_w32.to(weight.dtype), new_mom, new_w32


def _k_adam_update(weight, grad, mean, var, *, lr, beta1=0.9, beta2=0.999,
                   epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, lazy_update=True):
    """Adam without bias corrections (the caller folds them into lr)."""
    g = _prep(grad, weight, rescale_grad, clip_gradient, wd)
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    w = weight - lr * new_mean / (torch.sqrt(new_var) + epsilon)
    return w, new_mean, new_var


def _k_rmsprop_update(weight, grad, n, *, lr, gamma1=0.95, epsilon=1e-8,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                      clip_weights=-1.0):
    """``n = (1-gamma1) g'^2 + gamma1 n; w - lr g' / sqrt(n + eps)``."""
    g = _prep(grad, weight, rescale_grad, clip_gradient, wd)
    new_n = (1 - gamma1) * torch.square(g) + gamma1 * n
    w = _clip(weight - lr * g / torch.sqrt(new_n + epsilon), clip_weights)
    return w, new_n


def _k_rmspropalex_update(weight, grad, n, g_state, delta, *, lr,
                          gamma1=0.95, gamma2=0.9, epsilon=1e-8, wd=0.0,
                          rescale_grad=1.0, clip_gradient=-1.0,
                          clip_weights=-1.0):
    """The centred RMSProp (Graves 2013)."""
    g = _prep(grad, weight, rescale_grad, clip_gradient, wd)
    new_n = (1 - gamma1) * torch.square(g) + gamma1 * n
    new_g = (1 - gamma1) * g + gamma1 * g_state
    new_delta = gamma2 * delta - lr * g / torch.sqrt(
        new_n - torch.square(new_g) + epsilon)
    w = _clip(weight + new_delta, clip_weights)
    return w, new_n, new_g, new_delta


def _k_ftrl_update(weight, grad, z, n, *, lr, lamda1=0.01, beta=1.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """Follow the regularized leader (McMahan et al. 2013)."""
    g = _clip(grad * rescale_grad, clip_gradient)
    new_n = n + torch.square(g)
    sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / lr
    new_z = z + g - sigma * weight
    w = torch.where(
        torch.abs(new_z) <= lamda1, torch.zeros_like(weight),
        -(new_z - torch.sign(new_z) * lamda1)
        / ((beta + torch.sqrt(new_n)) / lr + wd))
    return w, new_z, new_n


def _k_signsgd_update(weight, grad, *, lr, wd=0.0, rescale_grad=1.0,
                      clip_gradient=-1.0):
    """``w - lr (sign(g') + wd w)``."""
    g = _clip(grad * rescale_grad, clip_gradient)
    return weight - lr * (torch.sign(g) + wd * weight)


def _k_signum_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0,
                     rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    """``mom = momentum mom - (1-momentum) g'; (1 - lr wd_lh) w + lr
    sign(mom)``."""
    g = _prep(grad, weight, rescale_grad, clip_gradient, wd)
    new_mom = momentum * mom - (1 - momentum) * g
    w = (1 - lr * wd_lh) * weight + lr * torch.sign(new_mom)
    return w, new_mom


def _k_ftml_update(weight, grad, d, v, z, *, lr, t, beta1=0.6, beta2=0.999,
                   epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_grad=-1.0):
    """Follow the moving leader (Zheng & Kwok 2017); wd enters before the
    clip, as the reference's op has it."""
    g = _clip(grad * rescale_grad + wd * weight, clip_grad)
    new_v = beta2 * v + (1 - beta2) * torch.square(g)
    d_t = (1 - beta1 ** t) / lr * (
        torch.sqrt(new_v / (1 - beta2 ** t)) + epsilon)
    sigma = d_t - beta1 * d
    new_z = beta1 * z + (1 - beta1) * g - sigma * weight
    return -new_z / d_t, d_t, new_v, new_z


def _k_adagrad_update(weight, grad, history, *, lr, epsilon=1e-7, wd=0.0,
                      rescale_grad=1.0, clip_gradient=-1.0):
    """``h += g'^2; w - lr (g' / sqrt(h + eps) + wd w)``."""
    g = _clip(grad * rescale_grad, clip_gradient)
    new_hist = history + torch.square(g)
    w = weight - lr * (g / torch.sqrt(new_hist + epsilon) + wd * weight)
    return w, new_hist


# (name, function, input names, (state input, output) pairs)
_UPDATES = [
    ("sgd_update", _k_sgd_update, ("weight", "grad"), ()),
    ("sgd_mom_update", _k_sgd_mom_update, ("weight", "grad", "mom"),
     ((2, 1),)),
    ("nag_mom_update", _k_nag_mom_update, ("weight", "grad", "mom"),
     ((2, 1),)),
    ("mp_sgd_update", _k_mp_sgd_update, ("weight", "grad", "weight32"),
     ((2, 1),)),
    ("mp_sgd_mom_update", _k_mp_sgd_mom_update,
     ("weight", "grad", "mom", "weight32"), ((2, 1), (3, 2))),
    ("adam_update", _k_adam_update, ("weight", "grad", "mean", "var"),
     ((2, 1), (3, 2))),
    ("rmsprop_update", _k_rmsprop_update, ("weight", "grad", "n"),
     ((2, 1),)),
    ("rmspropalex_update", _k_rmspropalex_update,
     ("weight", "grad", "n", "g", "delta"), ((2, 1), (3, 2), (4, 3))),
    ("ftrl_update", _k_ftrl_update, ("weight", "grad", "z", "n"),
     ((2, 1), (3, 2))),
    ("signsgd_update", _k_signsgd_update, ("weight", "grad"), ()),
    ("signum_update", _k_signum_update, ("weight", "grad", "mom"),
     ((2, 1),)),
    ("ftml_update", _k_ftml_update, ("weight", "grad", "d", "v", "z"),
     ((2, 1), (3, 2), (4, 3))),
    ("adagrad_update", _k_adagrad_update, ("weight", "grad", "history"),
     ((2, 1),)),
]

for _name, _fn, _args, _aux in _UPDATES:
    register(_name, _fn, arg_names=_args, nondiff=True,
             num_outputs=1 + len(_aux), mutate_aux=_aux or None)
