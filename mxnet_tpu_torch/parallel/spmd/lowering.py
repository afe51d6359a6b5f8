"""The whole step of ``gluon.Trainer`` on a multi-axis mesh (ref:
``mxnet_tpu/parallel/spmd/lowering.py``).

:class:`SpmdStepCompiler` is the mesh sibling of
``gluon.whole_step.WholeStepCompiler`` (it subclasses it for the bypass
checks, the closures and the captured step).  Where the JAX package hands
``jax.jit`` the global program with declared shardings and GSPMD inserts
the collectives, the port runs one rank per device (``parallel.mesh``) and
writes them:

- **placement.**  At rest each parameter of the block holds this rank's
  shard under ``ShardingPlan.param_spec`` (the ``Parameter``'s own tensor
  is the shard; a read of it gathers the full value, see
  ``Parameter.data``), and each optimizer state its shard under
  ``state_spec(zero=trainer._zero_shard)``: ``'mp'`` as its parameter,
  plus ``'dp'`` under ZeRO.  Placement is identity-checked, as JAX's
  ``_spmd_args`` is: a parameter keeps a :class:`Placement` that any new
  value (``set_data``, ``load_parameters``, a restore,
  ``initialize(force_reinit=True)``) drops, and a state is ours while it
  is the object we placed; what is fresh is placed at the next step, and
  a steady step places nothing.  Placing takes rank 0's full value on
  every rank (``parallel.mesh.place``, one broadcast a bucket), for a
  replicated parameter too (one the compiler has not seen, or whose
  tensor was replaced), so ranks whose generators drew different initial
  weights start alike, as ``DataParallelTrainer`` does at build; the
  JAX package's ``global_put`` assumes every process holds the same
  value;
- **the batch.**  Every rank is given the global batch and takes its rows
  over the data axes (``dcn`` outer, ``dp`` inner), as
  ``DataParallelTrainer`` does; the ranks of one ``mp`` group take the same
  rows;
- **the forward and backward** run under ``products.split_scope``:
  ``FullyConnected`` and ``multihead_attention``'s projections compute on
  the shards of weights split over ``mp``; every other consumer of a
  sharded parameter gets its full value, gathered once a forward.
  BatchNorm statistics are those of the global batch (summed over the
  data axes through ``mesh.data_scope``) and the moving statistics are
  committed on every rank.  Dropout draws from generators seeded from
  ``(seed, data coordinate)`` (``DataParallelTrainer``'s rule), equal
  across the ``mp`` ranks of a data group: :meth:`SpmdStepCompiler.
  start_streams` sets them once, at the first step after the deferred
  shapes are drawn, or before a checkpoint restore sets each rank's own
  saved generators;
- **the gradients** are summed over the data axes
  (``parallel.mesh.reduce_over_data``, shared with
  ``DataParallelTrainer``): one all-reduce a flat same-dtype bucket, or
  for a ZeRO state a reduce-scatter along its ``'dp'`` dim (after an
  all-reduce over ``dcn`` where there is one);
- **the update** is ``optimizer.apply_whole_step_plan`` over this rank's
  slices (a shard, or under ZeRO its state's ``'dp'`` slice), with the
  scalars of the plan's chunks; a ZeRO slice is then all-gathered over
  ``dp`` back into the ``mp`` shard (``parallel.mesh.gather_pieces``).
  ``rescale_grad`` is ``scale / batch_size`` of the global batch.  The
  loss returned is the global batch's (summed over the data axes).

Routes.  A one-rank mesh has nothing to shard: its step is the captured
whole step (one replay a step on the card), counted as an spmd step.  A
mesh of more than one rank runs eagerly; that is decided before the first
step, logged once and counted in ``whole_step_eager`` (capturing a step
with collectives inside it is piece 4 of slice 7, part 2b).

Bypasses (the JAX reasons, word for word) take the eager whole step, warn
once a reason and count in ``whole_step_fallbacks``: each rank gathers
the full parameters and states, runs the whole batch (the dropout
generators of rank 0 lent to every rank), so the ranks stay identical,
and the next mesh step slices them again.  A deliberate difference: the
JAX package's bypass for a multi-process ``dist_*`` kvstore cannot keep its
meaning here, where the mesh is the process group; such a trainer warns
with that reason, counts a fallback and takes the world step
(``gluon.whole_step.WorldStep``).

Not supported: a parameter spec over an axis other than ``mp`` (an
override placing a parameter over ``dp`` or ``dcn``, ZeRO-3 style) raises.
"""
from __future__ import annotations

import contextlib
import logging

import numpy as np
import torch

from ... import autograd
from ... import optimizer as _opt
from ... import random as _random
from ...base import MXNetError
from ...gluon.whole_step import Bypass, WholeStepCompiler, as_step_tensor
from ...ndarray.ndarray import NDArray, as_tensor
from .. import dist
from .. import mesh as _mesh
from . import products
from .mesh import format_mesh_shape, make_spmd_mesh, parse_mesh_shape
from .plan import ShardingPlan

_log = logging.getLogger("mxnet_tpu_torch.spmd")


def _same_mesh(a, b):
    """Meshes of the same axes and sizes (JAX interns such meshes into
    one object, so its identity check means this)."""
    return tuple(a.axis_names) == tuple(b.axis_names) and \
        dict(a.shape) == dict(b.shape)


def _map_state(st, fn):
    if st is None:
        return None
    if isinstance(st, (tuple, list)):
        return type(st)(fn(s) for s in st)
    return fn(st)


class Placement:
    """A parameter that holds this rank's shard under ``spec`` (its full
    shape ``shape``), placed by ``compiler``."""

    __slots__ = ("compiler", "spec", "shape")

    def __init__(self, compiler, spec, shape):
        self.compiler, self.spec, self.shape = compiler, spec, tuple(shape)

    def read(self, p):
        """The full value: the step's gathered one inside its forward,
        else an all-gather (a collective)."""
        scope = products.current()
        if scope is not None:
            got = scope.read(p)
            if got is not None:
                return got
        return products.gather_full(p._data, self.spec, self.shape,
                                    self.compiler.mesh)


class SpmdStepCompiler(WholeStepCompiler):
    """The whole step over a named mesh and a :class:`ShardingPlan`."""

    def __init__(self, trainer, mesh, plan=None):
        super().__init__(trainer)
        self.mesh = mesh
        self.plan = plan if plan is not None else ShardingPlan(mesh)
        if not _same_mesh(self.plan.mesh, mesh):
            raise MXNetError(
                "sharding_plan was built for a different mesh than "
                "mesh_shape resolves to — construct the plan from the "
                "trainer's mesh (ShardingPlan(trainer_mesh))")
        self._specs = {}          # (name, shape) -> (spec, state spec)
        # trainer index -> (the state we placed, its spec)
        self._placed_states = {}
        self._announced = False
        self._streams = False
        self._synced = {}         # id(replicated parameter) -> its tensor
        #: ``specs`` resolved, parameters and states ``placed`` (sliced
        #: from a full value), ``gathered``: names gathered for compute by
        #: the last forward
        self.stats = {"specs": 0, "placed": 0, "states_placed": 0}
        self.gathered = []

    @classmethod
    def from_shape(cls, trainer, mesh_shape, plan=None, devices=None):
        """Build from a ``'dp=4,mp=2'`` spec or a shape dict (the Trainer's
        entry).  Raises for a malformed spec, ``pp > 1`` and an axis
        product other than the number of ranks."""
        shape = parse_mesh_shape(mesh_shape)
        if shape.get("pp", 1) > 1:
            raise MXNetError(
                f"mesh shape {format_mesh_shape(shape)!r} has pp="
                f"{shape['pp']}: Trainer.whole_step cannot auto-stage "
                "an arbitrary block into pipeline stages — drive 'pp' "
                "through parallel.spmd.schedule (stage_partition + "
                "PipelineTrainStep), and give the Trainer the "
                "remaining ('dp','mp') axes (docs/parallelism.md)")
        dist.init()
        n = int(np.prod(list(shape.values()), dtype=np.int64))
        world = dist.num_workers()
        if n != world:
            raise MXNetError(
                f"mesh shape {format_mesh_shape(shape)!r} needs {n} devices, "
                f"have {world} rank(s); {_mesh._one_rank_per_device(n)}")
        return cls(trainer, make_spmd_mesh(shape, devices), plan)

    # -- public entry -------------------------------------------------------

    def step(self, block, loss_fn, inputs, y, batch_size):
        """One whole step on the mesh; returns ``(loss, stats)`` (``spmd``,
        ``zero``, ``eager`` and, for the world route, ``fallback``: its
        reason).  Raises :class:`Bypass` before any side effect where the
        configuration must take the eager step."""
        t = self.trainer
        block_params = list(block.collect_params().values())
        if any(p._data is None for p in block_params):
            self._complete_shapes(block, inputs)
        self.start_streams()
        self._check_bypass(block_params)
        if len(t._param_contexts()) > 1:
            raise Bypass(
                "mesh_shape + multiple replica contexts: the spmd path "
                "shards params across the mesh itself — initialize on "
                "ONE context and let MXTPU_MESH_SHAPE place them")
        kv = t._kvstore
        if kv is not None and kv._is_dist() and dist.is_multiprocess():
            reason = ("mesh_shape + multi-process dist kvstore (the spmd "
                      "mesh is single-process; multi-host meshes ride jax "
                      "process groups, not the PS transport)")
            self.warn_fallback(reason)
            loss, stats = super().step(block, loss_fn, inputs, y,
                                       batch_size)
            return loss, dict(stats, fallback=reason)
        dp = self.mesh.data_size
        for v in tuple(inputs) + ((y,) if y is not None else ()):
            if dp > 1 and int(v.shape[0]) % dp:
                raise Bypass(
                    f"batch {int(v.shape[0])} not divisible by the "
                    f"data-axis product {dp} of mesh "
                    f"{format_mesh_shape(dict(self.mesh.shape))}")
        zero = bool(t._zero_shard)
        if self.mesh.size == 1:
            loss, stats = super().step(block, loss_fn, inputs, y,
                                       batch_size)
            return loss, dict(stats, spmd=True, zero=zero)
        self._announce()
        return self._mesh_step(block, loss_fn, inputs, y), {
            "compiles": 0, "spmd": True, "zero": zero, "eager": True}

    def _announce(self):
        if not self._announced:
            self._announced = True
            _log.info(
                "whole step over mesh %s (%d ranks, backend %s, rank %d at "
                "%s) runs eagerly%s (a captured step with collectives inside "
                "it comes with slice 7, part 2b, piece 4)",
                format_mesh_shape(self.mesh.shape), self.mesh.size,
                self.mesh.backend, self.mesh.rank, self.mesh.coords,
                ", ZeRO states over dp" if self.trainer._zero_shard else "")

    def start_streams(self):
        """Give this rank's dropout generators its data coordinate's
        stream (``random.GeneratorPool.set_stream``), once: the first step
        calls it after the deferred shapes are drawn, and a checkpoint
        restore before it sets the saved generators."""
        if not self._streams and self.mesh.size > 1:
            _random.default_pool.set_stream(self.mesh.data_index)
        self._streams = True

    def _complete_shapes(self, block, inputs):
        """Finish deferred shapes with a predict-mode forward on two rows
        (no update, no statistic moves)."""
        from ..data_parallel import _block_device

        device = _block_device(block)
        with autograd.pause(train_mode=False):
            block(*[as_step_tensor(as_tensor(v)[:2], device)
                    for v in inputs])

    # -- specs and placement ------------------------------------------------

    def _specs_of(self, name, shape):
        """``(param spec, state spec)`` of one parameter, each a tuple of
        one entry a dim, or ``()`` where no axis of more than one rank
        splits it."""
        key = (name, tuple(shape))
        got = self._specs.get(key)
        if got is not None:
            return got
        mesh = self.mesh
        pspec = self.plan.param_spec(name, shape)
        bad = [a for a in _mesh.spec_mesh_axes(pspec) if a != "mp"]
        if bad:
            raise MXNetError(
                f"ShardingPlan: parameter {name!r} is placed over mesh "
                f"axis {bad[0]!r}; the port's mesh step splits parameters "
                "over 'mp' only (a parameter sharded over a data axis is "
                "not supported: its states shard over 'dp' with "
                "zero_shard=True)")
        sspec = self.plan.state_spec(name, shape, zero=self.trainer
                                     ._zero_shard)

        def effective(spec):
            spec = tuple(spec) + (None,) * (len(shape) - len(spec))
            axes = _mesh.spec_mesh_axes(spec)
            return spec if any(mesh.shape[a] > 1 for a in axes) else ()

        got = (effective(pspec), effective(sspec))
        self._specs[key] = got
        self.stats["specs"] += 1
        return got

    def _place(self, named):
        """Every parameter of the block on this rank: a fresh one takes
        rank 0's value and, where split, its shard (``parallel.mesh.
        place``); returns the :class:`products.Entry` of each sharded
        one."""
        specs = [(name, p, self._specs_of(name, tuple(p.shape))[0])
                 for name, p in named]
        fresh = [(p, spec) for _, p, spec in specs
                 if getattr(p._placement, "compiler", None) is not self
                 and (spec or self._synced.get(id(p)) is not p._data)]
        if fresh:
            with torch.no_grad():
                shards = _mesh.place(self.mesh,
                                     [p.data().detach() for p, _ in fresh],
                                     [spec for _, spec in fresh])
            for (p, spec), shard in zip(fresh, shards):
                if spec:
                    p._place(p.list_ctx(), shard)
                    p._placement = Placement(self, spec, p.shape)
                    self.stats["placed"] += 1
                else:
                    self._synced[id(p)] = p._data
        return [products.Entry(name, p, p._data, spec, p.shape)
                for name, p, spec in specs if spec]

    def _zero_dim(self, spec, sspec):
        """The dim a ZeRO state adds ``'dp'`` on, or None."""
        if not sspec:
            return None
        spec = spec or (None,) * len(sspec)
        for d, (a, b) in enumerate(zip(spec, sspec)):
            if b == "dp" and a != "dp":
                return d
        return None

    def _layouts(self, block):
        """``[(name, spec, state spec, zero dim)]`` of the trainer's
        parameters, in its order."""
        t = self.trainer
        name_of = {id(p): n for n, p in block._ordered_params()}
        out = []
        for p in t._params:
            name = name_of[id(p)]
            spec, sspec = self._specs_of(name, tuple(p.shape))
            out.append((name, spec, sspec, self._zero_dim(spec, sspec)))
        return out

    def _dp_slice(self, d, shape, member=None):
        """The index of a shard's ``dp`` slice ``member`` (default this
        rank's) along dim ``d`` of a tensor of ``shape``."""
        dp = self.mesh.group(("dp",))
        k = dp.index if member is None else member
        n = shape[d] // dp.size
        return (slice(None),) * d + (slice(k * n, (k + 1) * n),)

    def _place_states(self, layouts):
        """Every optimizer state on its shard: made at the size of the
        slice this rank updates, or a fresh full state sliced."""
        t = self.trainer
        mesh = self.mesh
        for i, (p, (_n, spec, sspec, zd)) in enumerate(zip(t._params,
                                                           layouts)):
            st = t._states[i]
            if st is not None and self._placed(i):
                continue
            if st is None:
                w = p._data
                view = w[self._dp_slice(zd, w.shape)] if zd is not None \
                    else w
                st = t._optimizer.create_state_multi_precision(i, view)
            elif sspec:
                sl = _mesh.shard_slices(sspec, tuple(p.shape), mesh)
                st = _map_state(st, lambda s: s[sl].clone())
                self.stats["states_placed"] += 1
            t._states[i] = st
            self._placed_states[i] = (st, sspec)

    def _placed(self, i):
        got = self._placed_states.get(i)
        return got is not None and got[0] is self.trainer._states[i]

    @contextlib.contextmanager
    def unplaced(self, block):
        """The full parameters and states on every rank (gathered, a
        collective), and rank 0's dropout generators, for an eager step;
        the next mesh step slices them again."""
        t = self.trainer
        if self.mesh.size == 1:
            yield
            return
        for _name, p in block._ordered_params():
            pl = p._placement
            if pl is not None and pl.compiler is self:
                full = pl.read(p)
                p._place(p.list_ctx(), full)
        for i in list(self._placed_states):
            t._states[i] = self.full_state(i)
        self._placed_states = {}
        with self._rank0_generators(t._params[0]._data.device):
            yield

    @contextlib.contextmanager
    def _rank0_generators(self, device):
        gens = _random.default_pool.generators(device)
        saved = [g.get_state() for g in gens]
        world = self.mesh.group(self.mesh.axis_names)
        for g, st in zip(gens, saved):
            buf = st.clone()
            world.broadcast_(buf, 0)
            g.set_state(buf)
        try:
            yield
        finally:
            for g, st in zip(gens, saved):
                g.set_state(st)

    def full_state(self, i):
        """Parameter ``i``'s optimizer state, full (gathered over its
        state spec's axes: a collective), or as it is where not placed."""
        t = self.trainer
        st = t._states[i]
        if st is None or not self._placed(i):
            return st
        sspec = self._placed_states[i][1]
        if not sspec:
            return st
        shape = tuple(t._params[i].shape)
        return _map_state(st, lambda s: products.gather_full(
            s, sspec, shape, self.mesh))

    # -- the step -----------------------------------------------------------

    def _rows(self, v):
        """This rank's rows of the global batch ``v``."""
        t = as_tensor(v)
        if not isinstance(t, torch.Tensor):
            t = torch.as_tensor(np.asarray(t))
        if self.mesh.data_size == 1:
            return t
        (rows,) = _mesh.batch_sharding(self.mesh).slices((int(t.shape[0]),))
        return t[rows]

    def _mesh_step(self, block, loss_fn, inputs, y):
        t = self.trainer
        mesh = self.mesh
        entries = self._place(block._ordered_params())
        layouts = self._layouts(block)
        self._place_states(layouts)
        ws = [p._data for p in t._params]
        views = [w[self._dp_slice(zd, w.shape)] if zd is not None else w
                 for w, (_n, _s, _ss, zd) in zip(ws, layouts)]
        plan, svals, reason = t._optimizer.whole_step_plan(
            list(range(len(ws))), views, t._states)
        if reason is not None:
            raise Bypass(reason)
        device = ws[0].device
        xs = [as_step_tensor(self._rows(v), device) for v in inputs]
        yt = as_step_tensor(self._rows(y), device) if y is not None else None
        scope = products.SplitScope(mesh, entries)
        stats_scope = _mesh.data_scope(mesh) if mesh.data_size > 1 \
            else contextlib.nullcontext()
        with products.split_scope(scope), stats_scope:
            with autograd.record():
                out = block(*xs)
                loss = loss_fn(out, yt) if yt is not None else loss_fn(out)
                loss = as_tensor(loss).sum()
            grads = torch.autograd.grad(loss, ws, allow_unused=True)
        scope.commit()
        self.gathered = list(scope.gathered)
        grads = [torch.zeros_like(w) if g is None else g
                 for w, g in zip(ws, grads)]
        total = mesh.data_group.all_reduce_(
            loss.detach().reshape(1).clone(), "loss")
        with torch.no_grad():
            gviews = self._reduce(grads, layouts)
            # the list rules never concatenate, so each member keeps its
            # own layout (a shard, or a ZeRO slice): JAX's
            # apply_spmd_step_plan, which runs its fused kernels member by
            # member, is this call here; every op is elementwise, so a
            # slice gets the bits the full update gives it
            _opt.apply_whole_step_plan(
                plan, views, gviews,
                [_opt._state_list(st) for st in t._states],
                [_opt.device_scalars(sv, device) for sv in svals])
            self._gather_slices(ws, views, layouts)
        for w in ws:
            w._mx_fresh_grad = False
        return NDArray(total.reshape(()), t._params[0].context)

    def _reduce(self, grads, layouts):
        """Each gradient summed over the data axes: the whole of it, or
        for a ZeRO state this rank's ``dp`` slice (reduce-scatter)."""
        zero = {i: (lambda k, i=i: self._dp_slice(layouts[i][3],
                                                   grads[i].shape, k))
                for i, lay in enumerate(layouts) if lay[3] is not None}
        out = _mesh.reduce_over_data(self.mesh, dict(enumerate(grads)),
                                     zero)
        return [out[i] for i in range(len(grads))]

    def _gather_slices(self, ws, views, layouts):
        """ZeRO: every ``dp`` member's updated slice into each rank's
        shard, one all-gather a flat same-dtype bucket."""
        zero = [i for i, lay in enumerate(layouts) if lay[3] is not None]
        if not zero:
            return

        def put(i, k, piece):
            ws[i][self._dp_slice(layouts[i][3], ws[i].shape, k)] = piece

        _mesh.gather_pieces(self.mesh.group(("dp",)),
                            [(i, views[i]) for i in zero], put)

    # -- telemetry ----------------------------------------------------------

    def state_bytes_per_device(self):
        """The optimizer-state bytes this rank holds (ref: JAX's, which
        sums device 0's addressable shards)."""
        return sum(s.numel() * s.element_size()
                   for st in self.trainer._states
                   for s in _opt._state_list(st))

    def param_bytes_per_device(self, block):
        """The parameter bytes this rank holds at rest."""
        return sum(p._data.numel() * p._data.element_size()
                   for _, p in block._ordered_params() if p._data is not None)
