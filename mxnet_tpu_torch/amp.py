"""Automatic mixed precision (ref: ``mxnet_tpu/amp.py``; MXNet 1.x's
``contrib.amp``): the cast lists, ``convert_model`` and dynamic loss
scaling.

``init(target_dtype)`` records the policy; ``convert_model`` casts a Gluon
block's parameters to it, keeping the normalization parameters (names
ending in ``_gamma``, ``_beta``) in float32; the ops then compute in the
weights' dtype (``FullyConnected`` and the convolutions pull their input
down to it, LayerNorm's float32 gamma and beta promote its output back to
float32: ``ops/nn.py``).  float16's 5-bit exponent needs the loss scaled:
``with amp.scale_loss(loss, trainer) as scaled: autograd.backward(scaled)``
multiplies the loss by the trainer's :class:`LossScaler` scale (2**16 at
the start), points the trainer's ``rescale_grad`` at ``1/scale``, and the
trainer's update skips a step whose gradients overflowed and halves the
scale (``gluon.Trainer._update``).  bfloat16 shares float32's exponent
range: its scaler idles at scale 1, disarmed, so nothing changes in the
step (a captured whole step still captures).
"""
from __future__ import annotations

import torch

from .base import MXNetError
from .ndarray.ndarray import as_tensor

_initialized = False
_target_dtype = "bfloat16"

#: ops that run in the low-precision dtype (ref: amp's FP16_FUNCS)
TARGET_DTYPE_OPS = ["FullyConnected", "Convolution", "Deconvolution",
                    "batch_dot", "dot", "RNN",
                    "scaled_dot_product_attention",
                    "multihead_attention"]
#: ops whose results stay float32 (ref: amp's FP32_FUNCS)
FP32_OPS = ["softmax", "log_softmax", "BatchNorm", "LayerNorm", "norm",
            "mean", "sum", "SoftmaxOutput", "exp", "log"]

#: the name stems of the parameters ``convert_model`` leaves in float32
_FP32_STEMS = ("gamma", "beta", "running_mean", "running_var",
               "moving_mean", "moving_var")


def init(target_dtype="bfloat16", target_precision_ops=None,
         conditional_fp32_ops=None, fp32_ops=None):
    """Record the AMP policy (ref: ``amp.init``); blocks are cast by
    :func:`convert_model`."""
    global _initialized, _target_dtype
    if target_dtype not in ("bfloat16", "float16"):
        raise MXNetError("target_dtype must be bfloat16 or float16")
    _target_dtype = target_dtype
    _initialized = True


def convert_model(block, target_dtype=None):
    """Cast ``block``'s parameters to the AMP dtype (the policy's, or
    ``target_dtype``), the normalization parameters left in float32, and
    drop what the block captured.  The split is the reference's, by the
    last ``_``-separated piece of the full name: ``..._gamma`` and
    ``..._beta`` stay float32, while BatchNorm's ``..._running_mean`` and
    ``..._running_var`` (stems ``mean``, ``var``) are cast, as the
    reference casts them (ROADMAP.md, caveat (s))."""
    dt = target_dtype or _target_dtype
    for name, p in block.collect_params().items():
        if name.rsplit("_", 1)[-1] in _FP32_STEMS:
            continue
        p.cast(dt)
    if hasattr(block, "_clear_cache"):
        block._clear_cache()
    return block


convert_hybrid_block = convert_model


class LossScaler:
    """Dynamic loss scaler (ref: ``contrib/amp/loss_scaler.py``).

    The loss is multiplied by ``loss_scale`` so that float16 gradients do
    not underflow, and the optimizer divides it back out.  On overflow (a
    non-finite gradient) the scale halves, down to ``min_scale``, and the
    update is skipped; after ``scale_window`` clean steps it doubles.
    ``enabled`` is whether it was made with a scale other than 1 (bfloat16
    makes it with 1): an armed scaler keeps its dynamics running even
    after overflows bring the scale down to 1."""

    def __init__(self, init_scale=2.0 ** 16, scale_factor=2.0,
                 scale_window=2000, min_scale=1.0):
        self.loss_scale = float(init_scale)
        self._scale_factor = float(scale_factor)
        self._scale_window = int(scale_window)
        self._min_scale = float(min_scale)
        self._unskipped = 0
        self.enabled = self.loss_scale != 1.0

    def scale(self, loss):
        """``loss * loss_scale`` (the loss itself at scale 1), recorded for
        autograd when the loss was."""
        if self.loss_scale == 1.0:
            return loss
        with torch.enable_grad():
            return loss * self.loss_scale

    def unscale(self, grads):
        if self.loss_scale == 1.0:
            return grads
        inv = 1.0 / self.loss_scale
        if isinstance(grads, (list, tuple)):
            return type(grads)(g * inv for g in grads)
        return grads * inv

    def has_overflow(self, grads):
        """Whether any gradient holds a non-finite value: every gradient
        reduced on its device (one multi-tensor max-norm a dtype and
        device; a max propagates NaN and is infinite exactly where an
        element is) to one flag, then a single scalar read back, not a
        copy of each gradient."""
        groups = {}
        for g in grads:
            if g is None:
                continue
            t = as_tensor(g)
            groups.setdefault((t.device, t.dtype), []).append(t)
        if not groups:
            return False
        flags = []
        for ts in groups.values():
            norms = torch._foreach_norm(ts, float("inf"))
            flags.append(torch.isfinite(torch.stack(norms)).all())
        dev = flags[0].device
        ok = torch.stack([f.to(dev) for f in flags]).all()
        return not bool(ok.item())

    def update(self, overflow):
        """Move the scale after a step; True when the step must be skipped
        (ref: ``LossScaler.update_scale``)."""
        if overflow:
            self.loss_scale = max(self.loss_scale / self._scale_factor,
                                  self._min_scale)
            self._unskipped = 0
            return True
        self._unskipped += 1
        if self._unskipped >= self._scale_window:
            self.loss_scale *= self._scale_factor
            self._unskipped = 0
        return False


class _ScaleLossCtx:
    def __init__(self, loss, trainer):
        self._loss = loss
        self._trainer = trainer

    def __enter__(self):
        tr = self._trainer
        if getattr(tr, "_amp_loss_scaler", None) is None:
            # bfloat16 needs no scaling; float16 starts at 2**16
            init_scale = 1.0 if _target_dtype == "bfloat16" else 2.0 ** 16
            tr._amp_loss_scaler = LossScaler(init_scale=init_scale)
        scaler = tr._amp_loss_scaler
        # the optimizer divides the scale back out through rescale_grad
        tr._scale = tr._amp_original_scale / scaler.loss_scale
        if isinstance(self._loss, (list, tuple)):
            return type(self._loss)(scaler.scale(v) for v in self._loss)
        return scaler.scale(self._loss)

    def __exit__(self, *exc):
        return False


def scale_loss(loss, trainer):
    """``with amp.scale_loss(loss, trainer) as scaled: autograd.backward(
    scaled)`` (ref: ``amp.scale_loss``): scales the loss, points the
    trainer's ``rescale_grad`` at ``1/scale`` and arms the overflow skip of
    its update."""
    if not hasattr(trainer, "_amp_original_scale"):
        trainer._amp_original_scale = trainer._scale
    return _ScaleLossCtx(loss, trainer)
