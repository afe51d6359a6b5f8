"""The captured whole training step for ``gluon.Trainer`` (ref:
``mxnet_tpu/gluon/whole_step.py``, single-device path).

One training step -- forward, loss, backward and the grouped optimizer
update -- runs as one unit.  In the JAX package that unit is one XLA
executable; here, on the card, it is one replay of a CUDA graph:

- the first call of an input signature runs the step eagerly on a side
  stream (the warm-up PyTorch's whole-network capture needs: every
  kernel wrapper makes its lazy allocations and plans there);
- the next call of that signature captures the step body into a
  ``torch.cuda.CUDAGraph`` and replays it; every later call copies its
  inputs and the step's scalars into the graph's static buffers and
  replays it.  So a post-warm-up step is one replay and no Python runs
  between its kernels.

The body is the eager step's own code: the block's forward under
``autograd.record``, ``torch.autograd.grad`` of the loss's sum, and
:func:`optimizer.apply_whole_step_plan` over the chunks
:meth:`Optimizer.whole_step_plan` groups exactly as ``fused_update``
does.  The per-step scalars (lr, t, wd, rescale, Adam's corrections) are
read from a device buffer, so a learning-rate schedule never recaptures,
and the eager and captured steps do the same arithmetic.  Weights,
optimizer states and BatchNorm's moving statistics are updated in place,
so a replay sees what the previous step left.  Each device's random
generators are registered with the graph, so dropout draws at each replay
what the eager step would draw.

On the CPU the same body runs eagerly at every call; the signature cache
and the counters are kept, so the no-recapture contract is testable
there.  On a CUDA tensor a capture or replay that fails raises: only a
:class:`Bypass`, decided before the step has any side effect, sends a
step to the eager path, and the trainer warns once per reason and counts
it in ``whole_step_fallbacks``.

A replay launches the kernels without running their wrappers, so the
launch counters gained during the capture are added again at each replay
(:class:`~mxnet_tpu_torch.ops.kernels.build.CapturedLaunches`).
"""
from __future__ import annotations

import collections
import logging
import warnings

import torch

from .. import _imperative
from .. import autograd
from .. import optimizer as _opt
from .. import random as _random
from ..ndarray.ndarray import NDArray, as_tensor
from ..ops.kernels.build import CapturedLaunches

_log = logging.getLogger("mxnet_tpu_torch.whole_step")


class Bypass(Exception):
    """This configuration must take the eager path instead.

    Raised only before the step has any side effect (no optimizer tick,
    no launch), so the caller can run the eager step for the same batch."""

    def __init__(self, reason):
        super().__init__(reason)
        self.reason = reason


def as_step_tensor(v, device):
    """An input of a step (NDArray, tensor or array-like) as a tensor on
    ``device``."""
    t = as_tensor(v)
    if not isinstance(t, torch.Tensor):
        t = torch.as_tensor(t)
    return t.to(device)


def signature(tensors):
    """The shapes and dtypes of ``tensors`` (None stays None)."""
    return tuple(None if t is None else (tuple(t.shape), t.dtype)
                 for t in tensors)


def side_stream_run(fn, device):
    """``fn()`` on a fresh side stream of ``device``, ordered after the
    current stream's work and before its later work (the warm-up of a
    whole-network capture)."""
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out = fn()
    cur.wait_stream(side)
    return out


def _release_generators(gens):
    """Take ``gens`` out of capture mode after a capture that failed: the
    failed capture ends before it releases the generators registered with
    it, and a generator left so raises at its next draw.  An empty capture
    that registers them releases them, and advances them by nothing."""
    graph = torch.cuda.CUDAGraph()
    for gen in gens:
        graph.register_generator_state(gen)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the graph is empty
        with torch.cuda.graph(graph):
            pass


class CapturedStep:
    """One step body captured in a CUDA graph, with its static inputs.

    ``body(*static)`` is captured once; :meth:`replay` copies new values
    into ``static`` (tensors of the same shapes and dtypes), replays the
    graph, adds the launches recorded at capture to the kernels' counters
    and returns the body's output, the graph's own buffer.  ``pool`` (a
    ``torch.cuda.graph_pool_handle()``) lets several graphs share one
    memory pool.  A capture that fails raises."""

    def __init__(self, body, static, device, pool=None):
        self.static = list(static)
        self.graph = torch.cuda.CUDAGraph()
        gens = _random.default_pool.generators(device)
        for gen in gens:
            self.graph.register_generator_state(gen)
        launches = CapturedLaunches()
        try:
            with torch.cuda.graph(self.graph, pool=pool):
                self.out = body(*self.static)
        except BaseException:
            _release_generators(gens)
            raise
        finally:
            self.launches = launches.finish()
        _imperative.count("graphs_captured")

    def replay(self, values):
        for dst, src in zip(self.static, values):
            if dst is not None and src is not dst:
                dst.copy_(src, non_blocking=True)
        self.graph.replay()
        self.launches.replay()
        _imperative.count("graph_replays")
        return self.out


class _Closure:
    """The step of one (block, loss_fn, update plan) structure: its scalar
    buffer and one captured graph per input signature."""

    def __init__(self, trainer, block, loss_fn, plan, has_y, device):
        self.trainer = trainer
        self.block = block
        self.loss_fn = loss_fn
        self.plan = plan
        self.has_y = has_y
        sizes = [len(chunk[5]) for chunk in plan]
        self.svals = torch.zeros(sum(sizes), dtype=torch.float32,
                                 device=device)
        self.sval_views = []
        start = 0
        for n in sizes:
            self.sval_views.append(self.svals[start:start + n])
            start += n
        self.graphs = {}   # input signature -> (CapturedStep, bound)

    def set_scalars(self, svals):
        _opt.device_scalars([v for chunk in svals for v in chunk],
                            self.svals.device, out=self.svals)

    def body(self, *inputs):
        """The step on tensors: forward, loss, gradients of the loss's sum,
        the plan's update in place; returns the summed loss."""
        t = self.trainer
        xs = inputs[:-1]
        y = inputs[-1]
        ws = [p.data() for p in t._params]
        with autograd.record():
            out = self.block(*xs)
            loss = self.loss_fn(out, y) if self.has_y else self.loss_fn(out)
            loss = as_tensor(loss).sum()
        grads = torch.autograd.grad(loss, ws, allow_unused=True)
        grads = [torch.zeros_like(w) if g is None else g
                 for w, g in zip(ws, grads)]
        states = [_opt._state_list(st) for st in t._states]
        _opt.apply_whole_step_plan(self.plan, ws, grads, states,
                                   self.sval_views)
        return loss.detach()


class WholeStepCompiler:
    """Per-Trainer step cache of the whole-step path: the closures (one per
    update-plan structure, FIFO-bounded at :attr:`MAX_CLOSURES`), the
    input signatures seen and warmed, and the captured graphs."""

    #: each closure pins its captured graphs' memory pools and holds its
    #: block and loss_fn, so unstable identities (a fresh lambda per call)
    #: would otherwise leak one graph per step
    MAX_CLOSURES = 8

    def __init__(self, trainer):
        self.trainer = trainer
        self._closures = collections.OrderedDict()
        self._seen_sigs = set()
        self._warm = collections.OrderedDict()
        self._warned = set()

    # -- public entry -------------------------------------------------------

    def warn_fallback(self, reason):
        """Loud, once-per-reason notice that a whole step ran eagerly."""
        if reason not in self._warned:
            self._warned.add(reason)
            _log.warning("whole step bypassed -> eager step: %s", reason)

    def note_warm(self, block, loss_fn, inputs, y):
        """Record that an eager step ran at this signature (the trainer's
        eager twin, which completes deferred shapes), so the next call
        captures."""
        device = self.trainer._params[0].data().device
        values = tuple(as_step_tensor(v, device) for v in inputs) + (
            None if y is None else as_step_tensor(y, device),)
        self._mark_warm((block, loss_fn, signature(values)))

    def step(self, block, loss_fn, inputs, y):
        """One whole step.  Returns ``(loss, {"compiles": n})``, ``n`` 1
        for a signature not seen before; raises :class:`Bypass` before any
        side effect when the configuration must take the eager path."""
        t = self.trainer
        block_params = list(block.collect_params().values())
        self._check_bypass(block_params)
        device = t._params[0].data().device
        self._ensure_states()
        xs = tuple(as_step_tensor(v, device) for v in inputs)
        yt = as_step_tensor(y, device) if y is not None else None
        values = xs + (yt,)
        plan, svals, reason = t._optimizer.whole_step_plan(
            list(range(len(t._params))), [p.data() for p in t._params],
            t._states)
        if reason is not None:
            raise Bypass(reason)
        skey = (id(block), id(loss_fn), plan, y is not None, len(xs),
                str(device))
        closure = self._closures.get(skey)
        if closure is None:
            closure = _Closure(t, block, loss_fn, plan, y is not None,
                               device)
            self._closures[skey] = closure
            self._evict_stale_closures()
        closure.set_scalars(svals)
        x_sig = signature(values)
        sig = (skey, x_sig)
        compiles = 0
        if sig not in self._seen_sigs:
            self._seen_sigs.add(sig)
            _imperative.count("step_signatures")
            compiles = 1
        warm_key = (block, loss_fn, x_sig)
        if device.type != "cuda":
            loss = closure.body(*values)
        elif warm_key not in self._warm:
            loss = side_stream_run(lambda: closure.body(*values), device)
            self._mark_warm(warm_key)
        else:
            loss = self._replay(closure, x_sig, values, device,
                                block_params).clone()
        _imperative.count("step_dispatches")
        return NDArray(loss), {"compiles": compiles}

    # -- capture and replay -------------------------------------------------

    def _bound(self, block_params):
        """The tensors a captured graph reads and writes in place: the
        trainer's weights and states and the block's other parameters."""
        t = self.trainer
        bound = [p._data for p in t._params]
        for st in t._states:
            if isinstance(st, (tuple, list)):
                bound.extend(st)
            elif st is not None:
                bound.append(st)
        mine = {id(p) for p in t._params}
        bound.extend(p._data for p in block_params if id(p) not in mine)
        return tuple(bound)

    def _replay(self, closure, x_sig, values, device, block_params):
        bound = self._bound(block_params)
        got = closure.graphs.get(x_sig)
        if got is not None and (len(got[1]) != len(bound) or any(
                a is not b for a, b in zip(got[1], bound))):
            got = None   # a weight or state was replaced: capture again
        if got is None:
            static = [None if v is None else v.clone() for v in values]
            got = (CapturedStep(closure.body, static, device), bound)
            closure.graphs[x_sig] = got
        return got[0].replay(values)

    def _mark_warm(self, key):
        self._warm[key] = True
        while len(self._warm) > 4 * self.MAX_CLOSURES:
            self._warm.popitem(last=False)

    def _evict_stale_closures(self):
        while len(self._closures) > self.MAX_CLOSURES:
            old_key, _old = self._closures.popitem(last=False)
            self._seen_sigs = {s for s in self._seen_sigs if s[0] != old_key}
            if "closure-cache-overflow" not in self._warned:
                self._warned.add("closure-cache-overflow")
                _log.warning(
                    "whole-step closure cache overflow (evicting the "
                    "oldest): pass stable block/loss_fn objects; a fresh "
                    "lambda per call warms up and captures again each time")

    # -- bypass and states --------------------------------------------------

    def _check_bypass(self, block_params):
        t = self.trainer
        if not t._params:
            raise Bypass("no trainable parameters")
        device = None
        for p in t._params:
            if getattr(p, "grad_stype", "default") != "default":
                raise Bypass(f"sparse-grad parameter {p.name}")
            if getattr(p, "stype", "default") != "default":
                raise Bypass(f"sparse parameter {p.name}")
            if p.grad_req == "add":
                raise Bypass(f"grad_req='add' on {p.name} (gradient "
                             "accumulation across calls)")
            dev = p.data().device
            if device is None:
                device = dev
            elif dev != device:
                raise Bypass("parameters span different devices "
                             "(model-parallel placement)")
        block_ids = {id(p) for p in block_params}
        for p in t._params:
            if id(p) not in block_ids:
                raise Bypass(f"trainer parameter {p.name} is not a "
                             "parameter of the stepped block")

    def _ensure_states(self):
        """Create missing optimizer states as the eager ``Trainer._update``
        does."""
        t = self.trainer
        for i, p in enumerate(t._params):
            if t._states[i] is None:
                t._states[i] = t._optimizer.create_state_multi_precision(
                    i, p.data())
