"""Data-parallel training step (ref: ``mxnet_tpu/parallel/data_parallel.py``),
on one device.

``DataParallelTrainer`` is ResNet's training entry point in the JAX
package (``examples/image-classification/train_imagenet.py``,
``bench.py``).  Like the JAX class it keeps its own copies of the
parameters (fp32 masters) and of the optimizer states, runs the block's
forward on those copies, and writes them back into the block's Parameters
only in :meth:`~DataParallelTrainer.sync_to_block`.  The update rules are
its own (``apply_opt``), not ``optimizer.py``'s.

What needs a mesh of more than one device, sharded parameters or states,
rematerialization or checkpoints raises, naming the slice that brings it.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import autograd
from ..base import MXNetError
from ..ndarray.ndarray import NDArray, to_torch_dtype


def _later(what, slice_no):
    return MXNetError(f"DataParallelTrainer: {what} comes with slice "
                      f"{slice_no} of the port (ROADMAP queue 1)")


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
            return p._deferred_init[1].torch_device()
    raise MXNetError("DataParallelTrainer: initialize() the block first")


def _as_tensor(x, device):
    if isinstance(x, NDArray):
        x = x.data
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x))
    return x.to(device)


class DataParallelTrainer:
    """A training step over ``block``: forward, ``loss_fn``, backward and
    the optimizer update on the trainer's copies of the parameters.

    ``optimizer`` is ``sgd`` (with or without ``momentum``), ``adam``,
    ``adamw`` or ``lamb``; ``optimizer_params`` take ``learning_rate``,
    ``momentum``, ``wd``, ``beta1``, ``beta2``, ``epsilon`` and
    ``clip_gradient``.  With ``compute_dtype`` the trainable parameters and
    the inputs are cast to it for the forward and backward, the
    non-trainable ones (BatchNorm's moving statistics) stay fp32, and the
    gradients land in fp32 on the masters.  ``accum_steps`` splits the
    batch into that many micro-batches whose mean gradient makes one
    update; the moving statistics are those of the last micro-batch."""

    def __init__(self, block, loss_fn, optimizer="sgd", optimizer_params=None,
                 mesh=None, shard_params=False, donate=True,
                 shard_opt_states=False, compute_dtype=None, remat=False,
                 param_spec_fn=None, accum_steps=1):
        if mesh is not None:
            raise _later("a device mesh", 7)
        if shard_params or param_spec_fn is not None:
            raise _later("sharded parameters (shard_params, param_spec_fn)",
                         7)
        if shard_opt_states:
            raise _later("sharded optimizer states (shard_opt_states)", 7)
        if remat:
            raise _later("rematerialization (remat)", 7)
        if optimizer not in ("sgd", "adam", "adamw", "lamb"):
            raise MXNetError(f"DataParallelTrainer supports sgd/adam/adamw/"
                             f"lamb, got {optimizer!r}")
        self.block = block
        self.loss_fn = loss_fn
        self._accum = int(accum_steps)
        if self._accum < 1:
            raise MXNetError(f"accum_steps must be >= 1, got {accum_steps}")
        self._compute_dtype = to_torch_dtype(compute_dtype) \
            if compute_dtype is not None else None
        opt_params = dict(optimizer_params or {})
        self._lr = float(opt_params.pop("learning_rate", 0.01))
        self._opt_name = optimizer
        self._opt_params = opt_params
        self._named = None    # [(name, Parameter)]
        self._params = None   # the masters, one tensor per Parameter
        self._states = None   # optimizer state per parameter
        self._trainable = None
        self._device = None
        self._t = 0

    # -- set-up ---------------------------------------------------------------

    def build(self, x):
        """Finish the block's deferred shapes with one forward in predict
        mode on the first two samples of ``x`` and take the copies of the
        parameters and the optimizer states.  Idempotent."""
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
        self._device = device
        self._named = self.block._ordered_params()
        with torch.no_grad():
            self._params = [p.data().detach().clone() for _, p in self._named]
        self._trainable = [p.grad_req != "null" for _, p in self._named]
        momentum = float(self._opt_params.get("momentum", 0.0))
        states = []
        for raw, tr in zip(self._params, self._trainable):
            if not tr or (self._opt_name == "sgd" and not momentum):
                states.append(None)
            elif self._opt_name == "sgd":
                states.append(torch.zeros_like(raw))
            else:
                states.append((torch.zeros_like(raw), torch.zeros_like(raw)))
        self._states = states

    # -- the step -------------------------------------------------------------

    def _forward_loss(self, x, y):
        """The mean loss of one (micro-)batch, the block reading the
        trainer's copies: trainable ones cast to the compute dtype inside
        the graph, so their gradients come back in fp32."""
        cdt = self._compute_dtype
        masters = [p.requires_grad_(tr) for p, tr in zip(self._params,
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

    @staticmethod
    def _backward(loss, masters):
        """fp32 gradients of ``loss``; zeros for a master it does not
        reach, as the reference's value_and_grad gives."""
        grads = torch.autograd.grad(loss, masters, allow_unused=True)
        return [torch.zeros_like(m) if g is None else g
                for g, m in zip(grads, masters)]

    def _grads(self, x, y):
        """``(loss, fp32 gradients of the trainable masters)``; with
        ``accum_steps`` > 1 the means over the micro-batches, each started
        from the same moving statistics (the last one's update stays)."""
        trainable = [m for m, tr in zip(self._params, self._trainable) if tr]
        if self._accum == 1:
            loss = self._forward_loss(x, y)
            return loss.detach(), self._backward(loss, trainable)
        b = y.shape[0]
        if b % self._accum:
            raise MXNetError(f"batch {b} not divisible by accum_steps "
                             f"{self._accum}")
        aux = [m for m, tr in zip(self._params, self._trainable) if not tr]
        aux0 = [a.clone() for a in aux]
        xs = [v.chunk(self._accum) for v in x]
        ys = y.chunk(self._accum)
        gsum = [torch.zeros_like(m, dtype=torch.float32) for m in trainable]
        loss_sum = torch.zeros((), dtype=torch.float32, device=y.device)
        for i in range(self._accum):
            with torch.no_grad():
                for a, a0 in zip(aux, aux0):
                    a.copy_(a0)
            loss = self._forward_loss(tuple(v[i] for v in xs), ys[i])
            grads = self._backward(loss, trainable)
            for s, g in zip(gsum, grads):
                s.add_(g.float())
            loss_sum += loss.detach()
        return (loss_sum / self._accum,
                [(s / self._accum).to(m.dtype)
                 for s, m in zip(gsum, trainable)])

    def _apply_opt(self, raw, g, state, lr, t):
        """The update of one master (ref: ``apply_opt``, data_parallel.py:
        266-290); returns ``(new_raw, new_state)``."""
        op = self._opt_params
        name = self._opt_name
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
        mhat = nm / _f32_correction(beta1, t)
        vhat = nv / _f32_correction(beta2, t)
        upd = mhat / (torch.sqrt(vhat) + eps)
        if name == "adamw":
            upd = upd + wd * raw
        if name == "lamb":
            wn = torch.linalg.vector_norm(raw)
            un = torch.linalg.vector_norm(upd)
            ratio = torch.where((wn > 0) & (un > 0), wn / un,
                                torch.ones_like(wn))
            upd = ratio * upd
        return raw - lr * upd, (nm, nv)

    def step(self, x, y):
        """One training step on batch ``x`` (an array, or a tuple of arrays
        for a block of several inputs) with labels ``y``; returns the mean
        loss as a scalar NDArray."""
        self.build(x)
        xs = tuple(x) if isinstance(x, (tuple, list)) else (x,)
        xs = tuple(_as_tensor(v, self._device) for v in xs)
        y = _as_tensor(y, self._device)
        self._t += 1
        loss, grads = self._grads(xs, y)
        grads = iter(grads)
        with torch.no_grad():
            for i, tr in enumerate(self._trainable):
                if not tr:
                    continue
                raw = self._params[i]
                new_raw, new_state = self._apply_opt(
                    raw.detach(), next(grads), self._states[i], self._lr,
                    self._t)
                raw.copy_(new_raw)
                self._states[i] = new_state
        return NDArray(loss)

    def step_many(self, x, y, n_steps=None):
        """``n_steps`` steps on the same batch, or, with ``n_steps`` None,
        one step per leading index of ``x`` and ``y``; returns the losses as
        a ``(K,)`` NDArray.  The same as as many :meth:`step` calls."""
        multi = isinstance(x, (tuple, list))
        if n_steps is None:
            n_steps = (x[0] if multi else x).shape[0]
            batches = [((tuple(v[i] for v in x) if multi else x[i]), y[i])
                       for i in range(n_steps)]
        else:
            batches = [(x, y)] * int(n_steps)
        if n_steps < 1:
            raise MXNetError(f"step_many needs n_steps >= 1, got {n_steps}")
        losses = [self.step(xb, yb).data for xb, yb in batches]
        return NDArray(torch.stack(losses))

    @property
    def learning_rate(self):
        return self._lr

    def set_learning_rate(self, lr):
        self._lr = float(lr)

    def sync_to_block(self):
        """Write the trained copies back into the block's Parameters."""
        if self._named is None:
            return
        for (_, p), raw in zip(self._named, self._params):
            p.set_data(raw.detach())

    def save_states(self, prefix, async_save=False):
        raise _later("save_states", 6)

    def load_states(self, prefix):
        raise _later("load_states", 6)

