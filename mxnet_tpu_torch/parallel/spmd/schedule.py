"""The pipelined micro-batch schedule over the ``pp`` mesh axis (ref:
``mxnet_tpu/parallel/spmd/schedule.py``).

The JAX package stacks the stages' parameters on a leading axis of size P,
shards it over ``pp`` and runs one ``shard_map`` program: a loop of ticks
in which every device applies its stage and the activations rotate one hop
(``ppermute``); autodiff transposes the rotation into the backward.  The
port runs one rank per stage (``parallel.mesh``) and writes the GPipe
schedule out: :func:`gpipe_forward` feeds each micro-batch through this
rank's stage, receiving its input from the previous stage and sending its
output to the next; :func:`gpipe_backward` takes the micro-batches in
reverse, receiving each output's gradient from the next stage, running
``torch.autograd.backward`` on it and sending the input's gradient back.
Autograd never decides which collective runs: in the JAX program stage 0
ignores the rotated activations, and a naive port whose backward followed
autograd would prune that receive's backward on stage 0 while stage 1
still sent, and hang.  The fill and drain ticks' masked work is not done;
it changes no number the JAX program keeps.  The bubble is unchanged:
``n_micro / (n_micro + P - 1)`` of the time is work.

- :func:`pipeline_apply`: the stacked-stage schedule; every rank returns
  the last stage's outputs (broadcast over ``pp``, where JAX takes a masked
  ``psum``).  It is differentiable: every rank must compute the same loss
  of that output, and the backward runs the reverse schedule on every rank
  (the output's gradient is the last stage's own).
- :class:`PipelineTrainStep`: a training step on a ``('dp', 'pp')`` mesh,
  SGD with momentum.  It returns each rank's stage slice (leading dim 1) of
  the parameters and states, which the next call takes back as they are;
  :meth:`PipelineTrainStep.gather` reads the full stack (an all-gather over
  ``pp``).  The JAX step returns global arrays sharded over ``pp``; handing
  the full stack to every rank would all-gather every stage's weights every
  step.

Stacked parameters (a tuple, list or dict tree of arrays, tensors or
NDArrays) are given either as the full stack (leading dim P: each rank
takes its stage's slice) or as this rank's slice (leading dim 1), as a
previous step returns them.
"""
from __future__ import annotations

import numpy as np
import torch

from ... import _imperative
from ...base import MXNetError, getenv


def default_microbatches(n_stages):
    """Micro-batch count: ``MXTPU_PP_MICROBATCHES`` (``MXNET_`` too) when
    set, else the stage count (one micro-batch in flight per stage, the
    smallest full-pipe schedule)."""
    n = getenv("PP_MICROBATCHES", 0, int)
    return int(n) if n and n > 0 else int(n_stages)


def stage_partition(n_layers, n_stages):
    """Partition ``n_layers`` sequential layers onto ``n_stages`` pipeline
    stages: a tuple of ``(start, stop)`` layer ranges, balanced to within
    one layer (earlier stages take the remainder).

    Raises for a non-positive stage count, or more stages than layers: an
    empty stage would sit in the schedule doing identity work while
    costing a full bubble slot."""
    n_layers, n_stages = int(n_layers), int(n_stages)
    if n_stages < 1:
        raise MXNetError(f"pp stage count must be >= 1, got {n_stages}")
    if n_stages > n_layers:
        raise MXNetError(
            f"pp={n_stages} pipeline stages > {n_layers} layers — an "
            "empty stage wastes a bubble slot; shrink the 'pp' axis in "
            "MXTPU_MESH_SHAPE or deepen the model")
    base, rem = divmod(n_layers, n_stages)
    out, start = [], 0
    for s in range(n_stages):
        stop = start + base + (1 if s < rem else 0)
        out.append((start, stop))
        start = stop
    return tuple(out)


# -- the schedule ---------------------------------------------------------------


def gpipe_forward(group, n_micro, act_shape, dtype, device, first_input,
                  stage, last):
    """This rank's forward of ``n_micro`` micro-batches, ``group`` the
    ``pp`` group (its index is the stage).  Stage 0 takes
    ``first_input(t)``; every other stage receives the previous stage's
    output (``act_shape``, ``dtype``) as a leaf that requires grad when
    grad mode is on.  ``stage(inp)`` is this rank's stage; its output goes
    to the next stage, and on the last stage becomes ``last(t, out)``.
    Returns ``[(inp, out)]`` a micro-batch for :func:`gpipe_backward`."""
    idx, n = group.index, group.size
    records = []
    for t in range(n_micro):
        if idx == 0:
            inp = first_input(t)
        else:
            inp = group.recv(act_shape, dtype, device, idx - 1)
            inp.requires_grad_(torch.is_grad_enabled())
        out = stage(inp)
        if idx < n - 1:
            group.send(out, idx + 1)
        else:
            out = last(t, out)
        records.append((inp, out))
    return records


def gpipe_backward(group, records, seed):
    """The reverse schedule over :func:`gpipe_forward`'s ``records``, last
    micro-batch first: the last stage backpropagates ``seed(t, out)``,
    every other stage the gradient the next stage sends; every stage but
    the first sends its input's gradient back.  Gradients accumulate in
    the leaves the stages used."""
    idx, n = group.index, group.size
    for t in reversed(range(len(records))):
        inp, out = records[t]
        g = seed(t, out) if idx == n - 1 else group.recv(
            out.shape, out.dtype, out.device, idx + 1)
        torch.autograd.backward(out, g)
        if idx > 0:
            group.send(inp.grad if inp.grad is not None
                       else torch.zeros_like(inp), idx - 1)


# -- pytrees ----------------------------------------------------------------------


def tree_flatten(tree):
    """``(leaves, rebuild)`` of a tree of tuples, lists and dicts (sorted
    keys, as JAX orders them); ``rebuild(leaves)`` makes the same tree."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [tree_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (tuple, list)):
        keys = None
        parts = [tree_flatten(v) for v in tree]
    else:
        return [tree], lambda leaves: leaves[0]
    sizes = [len(p[0]) for p in parts]
    kind = type(tree)

    def rebuild(leaves):
        out, off = [], 0
        for (_, rb), n in zip(parts, sizes):
            out.append(rb(leaves[off:off + n]))
            off += n
        return dict(zip(keys, out)) if keys is not None else kind(out)

    return [x for p in parts for x in p[0]], rebuild


def as_tensor(value, device):
    """A tensor of ``value`` (a tensor stays where it is; an NDArray gives
    its tensor; anything else becomes one on ``device``)."""
    from ...ndarray.ndarray import NDArray

    if isinstance(value, NDArray):
        return value.data
    if isinstance(value, torch.Tensor):
        return value
    return torch.as_tensor(np.asarray(value), device=device)


def stage_slice(leaf, n_stages, index):
    """This stage's slice (leading dim 1) of a stacked leaf given as the
    full stack (leading dim ``n_stages``) or as the slice."""
    lead = int(leaf.shape[0]) if leaf.dim() else 0
    if lead == n_stages:
        return leaf[index:index + 1]
    if lead == 1:
        return leaf
    raise MXNetError(
        f"a stacked stage parameter has leading dim {lead}: give the "
        f"{n_stages} stages' stack or this rank's stage slice (leading dim "
        "1)")


# -- pipeline_apply -------------------------------------------------------------


class _Pipeline(torch.autograd.Function):
    """The schedule as one differentiable op: inputs ``xs`` (n_micro, mb,
    ...) and this stage's slices; output every micro-batch's last-stage
    output on every rank."""

    @staticmethod
    def forward(ctx, stage_fn, group, rebuild, xs, *slices):
        grad = any(ctx.needs_input_grad[3:])
        xs_leaf = xs.detach().requires_grad_(ctx.needs_input_grad[3])
        ws = [w.detach().requires_grad_(rg)
              for w, rg in zip(slices, ctx.needs_input_grad[4:])]
        with torch.set_grad_enabled(grad):
            local = rebuild([w[0] for w in ws])
            records = gpipe_forward(
                group, xs.shape[0], tuple(xs.shape[1:]), xs.dtype, xs.device,
                lambda t: xs_leaf[t], lambda h: stage_fn(local, h),
                lambda t, out: out)
        last = group.index == group.size - 1
        outs = (torch.stack([o.detach() for _, o in records]) if last
                else torch.empty_like(xs))
        group.broadcast_(outs, group.size - 1)
        ctx.state = (group, records, xs_leaf, ws) if grad else None
        return outs

    @staticmethod
    def backward(ctx, gy):
        group, records, xs_leaf, ws = ctx.state
        ctx.state = None
        with torch.enable_grad():
            gpipe_backward(group, records, lambda t, out: gy[t])
        gx = None
        if ctx.needs_input_grad[3]:
            gx = (xs_leaf.grad if group.index == 0 and xs_leaf.grad
                  is not None else torch.zeros_like(xs_leaf))
            group.broadcast_(gx, 0)
        return (None, None, None, gx) + tuple(w.grad for w in ws)


def pipeline_apply(stage_fn, stacked_params, x, mesh, axis="pp",
                   n_micro=None):
    """Run ``x`` through the mesh's P pipelined stages.

    ``stage_fn(params_slice, x_mb) -> y_mb``, the same shape in and out;
    ``params_slice`` is the stacked tree with the leading dim taken off.
    ``stacked_params``: the full stack (leading dim P) or this rank's
    slice.  ``x`` (B, ...), the same on every rank, with B divisible by
    ``n_micro`` (>= 1; default ``MXTPU_PP_MICROBATCHES``, else P).
    Returns the (B, ...) outputs of all stages on every rank (an NDArray
    for an NDArray ``x``)."""
    from ...ndarray.ndarray import NDArray

    P = int(mesh.shape[axis])
    n_micro = default_microbatches(P) if n_micro is None else int(n_micro)
    if n_micro < 1:
        raise MXNetError(f"n_micro must be >= 1, got {n_micro}")
    B = int(x.shape[0])
    if B % n_micro:
        raise MXNetError(f"batch {B} must divide into n_micro={n_micro}")
    group = mesh.group((axis,))
    xt = as_tensor(x, mesh.device)
    xs = xt.reshape((n_micro, B // n_micro) + tuple(xt.shape[1:]))
    leaves, rebuild = tree_flatten(stacked_params)
    slices = [stage_slice(as_tensor(w, xt.device), P, group.index)
              for w in leaves]
    out = _Pipeline.apply(stage_fn, group, rebuild, xs, *slices)
    out = out.reshape((B,) + tuple(xt.shape[1:]))
    return NDArray(out, x.context) if isinstance(x, NDArray) else out


# -- the pipelined training step ------------------------------------------------


class PipelineTrainStep:
    """A training step for a stack of P uniform stages on a ``('dp',
    'pp')`` mesh (ref: ``PipelineTrainStep``, schedule.py:196).

    >>> step = PipelineTrainStep(stage_fn, mesh, momentum=0.9)
    >>> loss, params, states = step(params, states, x, y, lr=0.1)

    ``params``: the stacked tree (full stack or this rank's slice);
    ``states`` the momentum buffers of the same structure
    (:meth:`init_states` makes zeros).  ``x`` and ``y`` are the global
    batch on every rank; its micro-batches' rows split over ``dp``.  The
    loss is ``loss_fn(out, y)`` (default ``(out - y) ** 2``) summed over
    the batch; it and the gradients are summed over ``dp``.  The update is
    ``s = momentum * s + g; w = w - lr * s``.  Returns ``(loss, params,
    states)``: the loss on every rank, each tree this rank's stage slice.
    A call counts one dispatch (``_imperative.dispatch_counts()``)."""

    def __init__(self, stage_fn, mesh, loss_fn=None, pp_axis="pp",
                 dp_axis="dp", n_micro=None, momentum=0.9):
        if pp_axis not in mesh.axis_names:
            raise MXNetError(
                f"mesh has no {pp_axis!r} axis (axes: "
                f"{tuple(mesh.axis_names)}) — add pp=N to the mesh "
                "shape to pipeline")
        for a in mesh.axis_names:
            if a not in (pp_axis, dp_axis):
                raise MXNetError(
                    f"PipelineTrainStep runs on ('dp','pp') meshes; "
                    f"axis {a!r} is unsupported here — tensor-parallel "
                    "('mp') composition rides the Trainer whole-step "
                    "path (docs/parallelism.md)")
        self.stage_fn = stage_fn
        self.mesh = mesh
        self.loss_fn = loss_fn or (lambda out, y: (out - y) ** 2)
        self.pp_axis = pp_axis
        self.dp_axis = dp_axis if dp_axis in mesh.axis_names else None
        self.P = int(mesh.shape[pp_axis])
        self.n_micro = (default_microbatches(self.P) if n_micro is None
                        else int(n_micro))
        self.momentum = float(momentum)

    def init_states(self, params):
        """Zero momentum buffers matching ``params``."""
        leaves, rebuild = tree_flatten(params)
        return rebuild([torch.zeros_like(as_tensor(w, self.mesh.device))
                        for w in leaves])

    def gather(self, tree):
        """The full stack (leading dim P) of a tree of stage slices, on
        every rank: one all-gather over ``pp`` a leaf (every rank calls
        it, in the same order)."""
        group = self.mesh.group((self.pp_axis,))
        leaves, rebuild = tree_flatten(tree)
        return rebuild([torch.cat(group.all_gather(
            stage_slice(as_tensor(w, self.mesh.device), self.P,
                        group.index), "param")) for w in leaves])

    def __call__(self, params, states, x, y, lr):
        mb_total = self.n_micro
        B = int(x.shape[0])
        if B % mb_total:
            raise MXNetError(
                f"batch {B} must divide into n_micro={mb_total}")
        dp = (int(self.mesh.shape[self.dp_axis])
              if self.dp_axis else 1)
        if B % (mb_total * dp):
            raise MXNetError(
                f"batch {B} must divide across dp={dp} shards x "
                f"n_micro={mb_total} microbatches")
        pp = self.mesh.group((self.pp_axis,))
        axes = (self.pp_axis,) + ((self.dp_axis,) if self.dp_axis else ())
        dev = self.mesh.device
        mb = B // (mb_total * dp)
        row = (self.mesh.group((self.dp_axis,)).index * mb
               if self.dp_axis else 0)

        def local_rows(a):
            a = as_tensor(a, dev)
            a = a.reshape((mb_total, B // mb_total) + tuple(a.shape[1:]))
            return a[:, row:row + mb]

        xs, ys = local_rows(x), local_rows(y)
        leaves, rebuild = tree_flatten(params)
        w = [stage_slice(as_tensor(v, dev), self.P, pp.index)
             for v in leaves]
        s = [stage_slice(as_tensor(v, dev), self.P, pp.index)
             for v in tree_flatten(states)[0]]
        ws = [v.detach().requires_grad_() for v in w]
        with torch.enable_grad():
            local = rebuild([v[0] for v in ws])
            records = gpipe_forward(
                pp, mb_total, tuple(xs.shape[1:]), xs.dtype, xs.device,
                lambda t: xs[t], lambda h: self.stage_fn(local, h),
                lambda t, out: self.loss_fn(out, ys[t]).sum())
            gpipe_backward(pp, records, lambda t, out: torch.ones_like(out))
        grads = [v.grad if v.grad is not None else torch.zeros_like(v)
                 for v in ws]
        from .. import mesh as mesh_mod

        if self.dp_axis:
            mesh_mod.sum_in_place(self.mesh.group((self.dp_axis,)), grads)
        last = pp.index == pp.size - 1
        loss = (sum(out.detach() for _, out in records) if last
                else torch.zeros((), dtype=xs.dtype, device=dev))
        loss = loss.reshape(1).clone()
        self.mesh.group(axes).all_reduce_(loss, "loss")
        lr = torch.tensor(lr, dtype=torch.float32, device=dev)
        with torch.no_grad():
            new_s = [self.momentum * sv + g for sv, g in zip(s, grads)]
            new_w = [wv.detach() - lr * sv for wv, sv in zip(w, new_s)]
        _imperative.count("step_dispatches")
        return loss[0], rebuild(new_w), rebuild(new_s)
