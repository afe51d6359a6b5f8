"""The whole training step for ``gluon.Trainer`` (ref:
``mxnet_tpu/gluon/whole_step.py``): captured on one device, eager over
several contexts and over the ranks of a ``dist_sync`` job.

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

Where the JAX package compiles the step over a mesh of replicas, the port
runs it eagerly; which way a trainer goes is decided at its first step
and logged once (:meth:`WholeStepCompiler.route`):

- several contexts in one process: the trainer's eager split step, whose
  ``Trainer.step`` sums the gradients through the kvstore (and, with
  ``zero_shard``, is ZeRO's eager tier);
- one context in each rank of a multi-process ``dist_sync`` job: the
  world step (:class:`WorldStep`), the JAX package's ``'world'`` mesh
  (``whole_step.py:752-766``): each rank steps on its own batch and the
  gradients of each flat bucket are summed over the process group.

Capturing a step with collectives inside it is piece 4 of slice 7, part
2b: gloo's host copies cannot be captured, and NCCL needs a card a rank.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import logging
import threading
import warnings

import torch

from .. import _imperative
from .. import autograd
from .. import optimizer as _opt
from .. import profiler as _profiler
from .. import random as _random
from ..kvstore import flatten_pad, unflatten_flat
from ..ndarray.ndarray import NDArray, as_tensor
from ..ops.kernels.build import CapturedLaunches
from ..telemetry import health as _health

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
        with torch.cuda.graph(graph, capture_error_mode=CAPTURE_MODE):
            pass


#: Captures check for unsafe CUDA calls (allocations, event queries,
#: synchronisations) in the capturing thread only: a host thread staging
#: the next batch (the input pipeline's h2d lane: pinned copies on a copy
#: stream, their events) keeps running during a capture, and its work on
#: other streams is not part of the graph.  The default, "global", fails
#: the capture for such a call on any thread.
CAPTURE_MODE = "thread_local"

_collector_lock = threading.Lock()
_collector_holders = 0      # captures open in the process
_collector_was_on = False   # the collector's state when the first began


@contextlib.contextmanager
def collector_off():
    """Python's cyclic collector off for the body, process-wide and
    counted: the first of overlapping holders (captures on several
    threads) turns it off, and the last to leave turns it back on, and
    only if it was on when the first began."""
    global _collector_holders, _collector_was_on
    with _collector_lock:
        if _collector_holders == 0:
            _collector_was_on = gc.isenabled()
            gc.disable()
        _collector_holders += 1
    try:
        yield
    finally:
        with _collector_lock:
            _collector_holders -= 1
            if _collector_holders == 0 and _collector_was_on:
                gc.enable()


class CapturedStep:
    """One step body captured in a CUDA graph, with its static inputs.

    ``body(*static)`` is captured once; :meth:`replay` copies new values
    into ``static`` (tensors of the same shapes and dtypes), replays the
    graph, adds the launches recorded at capture to the kernels' counters
    and returns the body's output, the graph's own buffer.  ``pool`` (a
    ``torch.cuda.graph_pool_handle()``) lets several graphs share one
    memory pool.  A capture that fails raises.

    Python's cyclic garbage collector is off while the body is captured.
    Blocks and trainers hold their graphs in reference cycles (a block and
    its ``CachedOp``, a trainer and its compiler), so an earlier phase's
    dead graphs wait for a collection; torch no longer collects before a
    capture, and a collection inside one would destroy those graphs in
    the capturing thread, which invalidates the capture
    (``cudaErrorStreamCaptureInvalidated``).  Captures on several threads
    take turns (``random.capture_lock``); other threads' launches and
    replays go on meanwhile."""

    def __init__(self, body, static, device, pool=None):
        self.static = list(static)
        self.graph = torch.cuda.CUDAGraph()
        gens = _random.default_pool.generators(device)
        for gen in gens:
            self.graph.register_generator_state(gen)
        with _random.capture_lock, collector_off():
            launches = CapturedLaunches()
            try:
                with torch.cuda.graph(self.graph, pool=pool,
                                      capture_error_mode=CAPTURE_MODE):
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
        self._route = None
        self._world = None

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

    def route(self):
        """How this trainer's whole step runs, decided at its first step
        and logged once: ``"captured"`` (one context, and no other
        process), ``"contexts"`` (several contexts in one process: the
        eager split step) or ``"world"`` (a rank of a multi-process
        ``dist_sync`` job: :class:`WorldStep`)."""
        if self._route is None:
            from ..parallel import dist

            t = self.trainer
            n = len(t._param_contexts())
            kv = t._kvstore
            if n > 1:
                self._route = "contexts"
                what = f"{n} contexts: the eager split step"
            elif kv is not None and kv._is_dist() and dist.is_multiprocess():
                self._route = "world"
                what = (f"the {dist.num_workers()} ranks of kvstore="
                        f"{kv.type!r} ({dist.backend()}): each rank's batch,"
                        " the gradients summed in flat buckets")
            else:
                self._route = "captured"
            if self._route != "captured":
                _log.info("whole step over %s runs eagerly%s (a captured "
                          "step with collectives inside it comes with slice "
                          "7, part 2b, piece 4)", what,
                          ", ZeRO-sharded" if t._zero_shard else "")
        return self._route

    def step(self, block, loss_fn, inputs, y, batch_size):
        """One whole step of the ``"captured"`` or ``"world"`` route
        (:meth:`route`; the trainer runs the ``"contexts"`` route itself).
        Returns ``(loss, stats)``: ``stats["compiles"]`` 1 for a signature
        the captured route had not seen, ``"eager"`` and ``"zero"`` (the
        world step ran ZeRO-sharded) for the world route.  Raises
        :class:`Bypass` before any side effect when the configuration must
        take the eager path."""
        t = self.trainer
        block_params = list(block.collect_params().values())
        self._check_bypass(block_params)
        if self.route() == "world":
            if not t._zero_shard:
                t._unshard_zero_states()
                self._ensure_states()
            if self._world is None:
                self._world = WorldStep(t)
            loss, stats = self._world.step(block, loss_fn, inputs, y)
            return loss, dict(stats, eager=True)
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
            # the capture is this signature's "compile" (ref:
            # gluon/block.py:571 of the JAX package)
            with _profiler.op_scope(
                    f"cached_op.compile.{closure.block.name}",
                    cat="cached_op"):
                step = CapturedStep(closure.body, static, device)
            got = (step, bound)
            closure.graphs[x_sig] = got
            # an armed health monitor notes the capture (ref:
            # whole_step.py:221); disarmed this is the module no-op
            _health.note_whole_step_compiled(step.graph, static)
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
        """Raise :class:`Bypass` for what the whole step does not take
        (ref: ``_check_bypass`` and ``_mesh_info``, whole_step.py:
        254-310), in the JAX package's order and words."""
        from ..parallel import dist

        t = self.trainer
        if not t._params:
            raise Bypass("no trainable parameters")
        scaler = getattr(t, "_amp_loss_scaler", None)
        if scaler is not None and scaler.enabled:
            raise Bypass("amp dynamic loss scaling (the overflow skip "
                         "is a host-side decision)")
        kv = t._kvstore
        if t._update_on_kvstore and kv is not None:
            raise Bypass("update_on_kvstore=True (server-side optimizer)")
        if kv is not None and kv._compression is not None:
            raise Bypass("gradient compression (per-key error feedback)")
        ctxs0 = None
        for p in t._params:
            if getattr(p, "grad_stype", "default") != "default":
                raise Bypass(f"sparse-grad parameter {p.name}")
            if getattr(p, "stype", "default") != "default":
                raise Bypass(f"sparse parameter {p.name}")
            if p.grad_req == "add":
                raise Bypass(f"grad_req='add' on {p.name} (gradient "
                             "accumulation across calls)")
            ctxs = (tuple(p.list_ctx()), p._data.device)
            if ctxs0 is None:
                ctxs0 = ctxs
            elif ctxs != ctxs0:
                raise Bypass("parameters span different context sets "
                             "(model-parallel placement)")
        block_ids = {id(p) for p in block_params}
        for p in t._params:
            if id(p) not in block_ids:
                raise Bypass(f"trainer parameter {p.name} is not a "
                             "parameter of the stepped block")
        if len(ctxs0[0]) > 1 and kv is not None and kv._is_dist() \
                and dist.is_multiprocess():
            raise Bypass("multi-process job with multiple local replica "
                         "contexts (hierarchical dcn+dp whole-step mesh "
                         "not supported yet)")

    def _ensure_states(self):
        """Create missing optimizer states as the eager ``Trainer._update``
        does."""
        t = self.trainer
        for i, p in enumerate(t._params):
            if t._states[i] is None:
                t._states[i] = t._optimizer.create_state_multi_precision(
                    i, p.data())


class WorldStep:
    """The whole step of one rank of a multi-process ``dist_sync`` job
    (ref: the ``'world'`` mesh, ``whole_step.py:120-154,752-766``), run
    eagerly.

    Each rank runs the forward and backward on its own batch.  Then, for
    each chunk of the optimizer's ZeRO plan at the world size (the fused
    update's groups, cut at ``MXTPU_KVSTORE_BUCKET_MB``), the chunk's
    gradients are packed into one flat buffer zero-padded to a multiple
    of the world size, and

    - unsharded, the buffer is all-reduced over the process group and
      every rank runs the update on its full weights and states;
    - with ``zero_shard`` (ZeRO-1), it is reduce-scattered, each rank runs
      the same rule on its slice of the chunk's flat weights with
      slice-sized states (``Trainer._zero_states``, keyed by its rank),
      and the slices are all-gathered into every rank's weights.

    The loss returned is the sum over the ranks.  Both routes sum the same
    flat buffers through ``parallel.mesh.Group``.  Under gloo its
    reduce-scatter is that all-reduce and a slice, so the sharded step is
    bit-identical to the unsharded one at any world size.  Under NCCL it
    is ``reduce_scatter_tensor``, which may add the ranks in another order
    than ``all_reduce``: the ranks then still hold the same bits as one
    another (each slice reaches every rank through one all-gather), but
    the sharded and unsharded steps agree only to the rounding of that
    sum."""

    def __init__(self, trainer):
        from ..parallel import dist
        from ..parallel import mesh

        self.trainer = trainer
        self.group = mesh.world_group()
        self.rank = dist.rank()
        self.world = dist.num_workers()

    def step(self, block, loss_fn, inputs, y):
        """One step; returns ``(loss, stats)`` (``dispatches``: the
        collectives and update calls; ``buckets``; ``zero``).  Unsharded,
        the trainer's states must exist (``WholeStepCompiler.step`` makes
        them)."""
        t = self.trainer
        ctx = t._param_contexts()[0]
        device = t._params[0].data().device
        zero = t._zero_shard
        ws = [p.data() for p in t._params]
        n = len(ws)
        plan, svals, reason = t._optimizer.whole_step_plan(
            list(range(n)), ws, [None] * n if zero else t._states,
            zero_world=self.world)
        if reason is not None:
            raise Bypass(reason)
        if zero:
            t._ensure_zero_states(plan, self.world, {self.rank: ctx})
        xs = [as_step_tensor(v, device) for v in inputs]
        with autograd.record():
            out = block(*xs)
            loss = loss_fn(out, as_step_tensor(y, device)) \
                if y is not None else loss_fn(out)
            loss = as_tensor(loss).sum()
        grads = torch.autograd.grad(loss, ws, allow_unused=True)
        grads = [torch.zeros_like(w) if g is None else g
                 for w, g in zip(ws, grads)]
        total = self.group.all_reduce_(loss.detach().reshape(1).clone(),
                                       "loss")
        with torch.no_grad():
            if zero:
                self._sharded(plan, svals, ws, grads)
            else:
                gs = list(grads)
                for chunk in plan:
                    idxs = chunk[4]
                    flat = self.group.all_reduce_(flatten_pad(
                        [grads[j] for j in idxs], chunk[7]), "grad")
                    for j, g in zip(idxs, unflatten_flat(
                            flat, [ws[j].shape for j in idxs])):
                        gs[j] = g
                _opt.apply_whole_step_plan(
                    plan, ws, gs, [_opt._state_list(s) for s in t._states],
                    [_opt.device_scalars(sv, device) for sv in svals])
        for w in ws:
            w._mx_fresh_grad = False
        per_chunk = 3 if zero else 2
        return NDArray(total.reshape(()), ctx), {
            "dispatches": per_chunk * len(plan) + 1, "buckets": len(plan),
            "zero": zero}

    def _sharded(self, plan, svals, ws, grads):
        """ZeRO-1 over the process group: reduce-scatter, this rank's slice
        updated, all-gather."""
        t = self.trainer
        r = self.rank
        g_shards, w_shards = [], []
        for chunk in plan:
            idxs, padded = chunk[4], chunk[7]
            g_shards.append(self.group.reduce_scatter(
                flatten_pad([grads[j] for j in idxs], padded), "grad"))
            shard_n = padded // self.world
            w_shards.append(flatten_pad([ws[j] for j in idxs], padded)[
                r * shard_n:(r + 1) * shard_n])
        t._optimizer.zero_fused_update(
            plan, svals, w_shards, g_shards,
            [t._zero_states[c][r] for c in range(len(plan))])
        for chunk, shard in zip(plan, w_shards):
            idxs = chunk[4]
            full = torch.cat(self.group.all_gather(shard, "param"))
            for j, piece in zip(idxs, unflatten_flat(
                    full, [ws[j].shape for j in idxs])):
                ws[j].copy_(piece)
