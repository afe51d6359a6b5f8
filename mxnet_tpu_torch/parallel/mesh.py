"""Device meshes over ranks (ref: ``mxnet_tpu/parallel/mesh.py``).

A JAX mesh is a grid of devices that one program spans, and GSPMD inserts
the collectives its shardings need.  The port follows PyTorch's idiom: one
process per device.  A mesh of N devices is the N ranks of the
``torch.distributed`` process group that :func:`parallel.dist.init
<mxnet_tpu_torch.parallel.dist.init>` forms, laid out row-major over the
mesh's axes as ``np.array(devices).reshape(sizes)`` lays out the JAX
package's devices.  Each axis gets its process groups (the ranks that
differ only in that axis' coordinate), and the data axes ``('dcn', 'dp')``
together get one more.  ``make_mesh()`` is ``{"dp": world size}``; in one
process that is the one-device mesh, which runs no collective at all.  A
mesh of more than one device inside one process is not supported: it
raises, naming the launcher (one rank per device).

Specs are tuples of axis names (or tuples of them) and ``None``, as
``PartitionSpec`` is; :class:`Sharding` pairs one with a mesh, as
``NamedSharding`` does, and gives each rank its slice of a global shape.

Where GSPMD decides the collectives, the port writes them:
:class:`Group` holds one axis set's process group and its collectives, each
staged as the backend needs (``gloo``: through the host; ``nccl``: on the
rank's card).  Its reduce-scatter and all-gather take a route decided when
the mesh is made, from the backend (``nccl``: ``reduce_scatter_tensor`` and
``all_gather_into_tensor``; ``gloo``: an all-reduce and a slice, and
``all_gather`` of a list), never after a failure.  Its point-to-point
calls (:meth:`Group.send`, :meth:`Group.recv` and the ring shift
:meth:`Group.shift`, JAX's ``ppermute``) and its tiled all-to-all
(:meth:`Group.all_to_all`, ``all_to_all_single`` on both backends: gloo has
it) serve the ``pp`` and ``sp`` axes; :func:`ring_shift` and
:func:`all_to_all` are their differentiable forms.  :func:`comm_stats`
counts each kind of traffic (calls, bytes, host milliseconds).

Synchronised BatchNorm statistics: :func:`data_scope` (the
``DataParallelTrainer`` sets it around its forward on a mesh of more than
one rank) makes :func:`stats_group` the data-axes group, and every
BatchNorm statistic of the port is summed over it (:func:`sum_stats`, an
all-reduce whose backward is an all-reduce) before the mean and variance
are taken.  An op's ``axis_name=`` names one mesh axis instead.

``spmd_jit``, ``shard_map``, ``pcast`` and ``vma`` are JAX tracing helpers
and are not ported: the port writes its collectives itself
(``parallel.spmd.products``, ``parallel.spmd.lowering``), and a captured
step with collectives inside it comes with slice 7, part 2b, piece 4.  They
raise saying so.
"""
from __future__ import annotations

import contextlib
import logging
import threading
import time

import numpy as np
import torch

from ..base import MXNetError, getenv
from . import dist

_log = logging.getLogger("mxnet_tpu_torch.parallel.mesh")


def _tracing_helper(what):
    return MXNetError(
        f"parallel.mesh: {what} is a JAX tracing helper and is not ported: "
        "the port writes the collectives of a mesh step itself "
        "(parallel.spmd.products); a captured step with collectives inside "
        "it comes with slice 7, part 2b, piece 4 (ROADMAP.md queue 1)")


def _one_rank_per_device(n):
    return (f"a mesh of {n} devices runs one rank per device: launch "
            f"{n} ranks (python -m mxnet_tpu_torch.tools.launch -n {n} "
            "--launcher local -p PORT python script.py) and make the mesh "
            "in each")


# -- traffic counters ---------------------------------------------------------

_STAT_KINDS = ("grad", "param", "act", "stats", "loss", "broadcast", "p2p",
               "a2a", "ep")
_stats_lock = threading.Lock()
_stats = {}


def reset_comm_stats():
    """Zero every counter of :func:`comm_stats`."""
    with _stats_lock:
        for k in _STAT_KINDS:
            _stats[k] = {"calls": 0, "bytes": 0, "ms": 0.0}


reset_comm_stats()


def comm_stats():
    """``{kind: {"calls", "bytes", "ms"}}`` of this process's collectives
    since :func:`reset_comm_stats`: ``grad`` (gradient all-reduces and
    reduce-scatters), ``param`` (all-gathers of sharded parameters and
    updated slices), ``act`` (the activations and input gradients of the
    products split over ``mp``, ``parallel.spmd.products``), ``stats``
    (BatchNorm statistics, forward and backward), ``loss``,
    ``broadcast``, ``p2p`` (the sends, receives and ring shifts of the
    ``pp`` and ``sp`` axes; bytes sent), ``a2a`` (all-to-alls; bytes
    sent, this rank's own chunk included) and ``ep`` (the all-gathers of
    the experts' inputs and outputs over ``ep``, ``parallel.moe``).  ``ms`` is host wall time from
    the call to the collective's completion (staging copies included)."""
    with _stats_lock:
        return {k: dict(v) for k, v in _stats.items()}


def _count(kind, nbytes, t0):
    with _stats_lock:
        s = _stats[kind]
        s["calls"] += 1
        s["bytes"] += int(nbytes)
        s["ms"] += (time.perf_counter() - t0) * 1e3


# -- process groups -----------------------------------------------------------


class Group:
    """The ranks of one set of mesh axes that share this rank's other
    coordinates, with the collectives the trainer needs.  ``members`` are
    global ranks in group order; ``index`` is this rank's place among them.
    A group of one rank runs no collective."""

    def __init__(self, axes, members, index, pg, route):
        self.axes = tuple(axes)
        self.members = tuple(members)
        self.index = int(index)
        self.size = len(self.members)
        self._pg = pg
        self._route = route

    def __repr__(self):
        return (f"Group(axes={self.axes}, members={self.members}, "
                f"index={self.index})")

    def _staged(self, t):
        dev = dist._comm_device()
        return t if t.device == dev else t.to(dev)

    def all_reduce_(self, t, kind):
        """Sum ``t`` over the group, in place; returns ``t``."""
        if self.size == 1:
            return t
        t0 = time.perf_counter()
        buf = self._staged(t)
        dist._bounded(lambda: torch.distributed.all_reduce(
            buf, op=torch.distributed.ReduceOp.SUM, group=self._pg,
            async_op=True), f"mesh all-reduce of {tuple(t.shape)} over "
            f"{self.axes}")
        if buf is not t:
            t.copy_(buf)
        _count(kind, t.numel() * t.element_size(), t0)
        return t

    def reduce_scatter(self, flat, kind):
        """The sum over the group of ``flat`` (1-D, ``size`` equal chunks),
        this rank's chunk of it, as a new tensor on ``flat``'s device."""
        n = flat.numel() // self.size
        if self.size == 1:
            return flat.clone()
        t0 = time.perf_counter()
        if self._route == "native":
            buf = self._staged(flat)
            out = torch.empty(n, dtype=flat.dtype, device=buf.device)
            dist._bounded(lambda: torch.distributed.reduce_scatter_tensor(
                out, buf, op=torch.distributed.ReduceOp.SUM, group=self._pg,
                async_op=True), f"mesh reduce-scatter over {self.axes}")
        else:  # all-reduce plus a slice
            buf = self._staged(flat)
            if buf is flat:
                buf = flat.clone()
            dist._bounded(lambda: torch.distributed.all_reduce(
                buf, op=torch.distributed.ReduceOp.SUM, group=self._pg,
                async_op=True), f"mesh reduce-scatter over {self.axes}")
            out = buf[self.index * n:(self.index + 1) * n]
        out = out.to(flat.device)
        _count(kind, flat.numel() * flat.element_size(), t0)
        return out

    def all_gather(self, t, kind):
        """Every member's ``t`` (same shape and dtype), in group order, on
        ``t``'s device."""
        if self.size == 1:
            return [t]
        t0 = time.perf_counter()
        buf = self._staged(t.contiguous())
        if self._route == "native":
            out = torch.empty(self.size * buf.numel(), dtype=buf.dtype,
                              device=buf.device)
            dist._bounded(lambda: torch.distributed.all_gather_into_tensor(
                out, buf, group=self._pg, async_op=True),
                f"mesh all-gather over {self.axes}")
            parts = list(out.to(t.device).view(self.size, *t.shape))
        else:
            outs = [torch.empty_like(buf) for _ in range(self.size)]
            dist._bounded(lambda: torch.distributed.all_gather(
                outs, buf, group=self._pg, async_op=True),
                f"mesh all-gather over {self.axes}")
            parts = [o.to(t.device) for o in outs]
        _count(kind, t.numel() * t.element_size() * self.size, t0)
        return parts

    def broadcast_(self, t, src_index, kind="broadcast"):
        """``t`` from member ``src_index``, in place on every member."""
        if self.size == 1:
            return t
        t0 = time.perf_counter()
        buf = self._staged(t)
        dist._bounded(lambda: torch.distributed.broadcast(
            buf, src=self.members[src_index], group=self._pg,
            async_op=True), f"mesh broadcast over {self.axes}")
        if buf is not t:
            t.copy_(buf)
        _count(kind, t.numel() * t.element_size(), t0)
        return t

    # -- point to point and all-to-all (the pp and sp axes) --

    def send(self, t, dst_index, kind="p2p"):
        """Send ``t`` to member ``dst_index``, which posts the matching
        :meth:`recv`; returns once it is sent."""
        t0 = time.perf_counter()
        buf = self._staged(t.detach().contiguous())
        dist._bounded(lambda: torch.distributed.isend(
            buf, self.members[dst_index], group=self._pg),
            f"mesh send of {tuple(t.shape)} over {self.axes}")
        _count(kind, t.numel() * t.element_size(), t0)

    def recv(self, shape, dtype, device, src_index, kind="p2p"):
        """A new tensor of ``shape`` and ``dtype`` on ``device``: the one
        member ``src_index`` sends (:meth:`send`)."""
        t0 = time.perf_counter()
        buf = torch.empty(shape, dtype=dtype, device=dist._comm_device())
        dist._bounded(lambda: torch.distributed.irecv(
            buf, self.members[src_index], group=self._pg),
            f"mesh receive of {tuple(shape)} over {self.axes}")
        _count(kind, buf.numel() * buf.element_size(), t0)
        return buf.to(device)

    def shift(self, t, offset=1, kind="p2p"):
        """The ring shift (ref: ``lax.ppermute(x, axis, [(j, (j + offset) %
        P)])``): this member's ``t`` goes to member ``index + offset``, and
        the result, a new tensor on ``t``'s device, is member ``index -
        offset``'s (every member gives the same shape and dtype).  A group
        of one returns ``t``."""
        if self.size == 1 or offset % self.size == 0:
            return t
        t0 = time.perf_counter()
        buf = self._staged(t.detach().contiguous())
        out = torch.empty_like(buf)
        n = self.size
        ops = [torch.distributed.P2POp(
                   torch.distributed.isend, buf,
                   self.members[(self.index + offset) % n], self._pg),
               torch.distributed.P2POp(
                   torch.distributed.irecv, out,
                   self.members[(self.index - offset) % n], self._pg)]
        dist._bounded(lambda: _Works(torch.distributed.batch_isend_irecv(ops)),
                      f"mesh ring shift of {tuple(t.shape)} over {self.axes}")
        _count(kind, t.numel() * t.element_size(), t0)
        return out.to(t.device)

    def all_to_all(self, t, split_axis, concat_axis, kind="a2a"):
        """Ref: ``lax.all_to_all(x, axis, split_axis, concat_axis,
        tiled=True)``: ``t`` cut into ``size`` equal chunks along
        ``split_axis``, chunk ``j`` sent to member ``j``; the result, a new
        tensor on ``t``'s device, is the chunks received concatenated along
        ``concat_axis`` in member order.  A group of one returns ``t``."""
        if self.size == 1:
            return t
        n = t.shape[split_axis]
        if n % self.size:
            raise MXNetError(f"all_to_all: dim {split_axis} of "
                             f"{tuple(t.shape)} does not split into "
                             f"{self.size} chunks over {self.axes}")
        t0 = time.perf_counter()
        x = t.detach().movedim(split_axis, 0)
        x = x.reshape((self.size, n // self.size) + tuple(x.shape[1:]))
        buf = self._staged(x.contiguous())
        out = torch.empty_like(buf)
        dist._bounded(lambda: torch.distributed.all_to_all_single(
            out, buf, group=self._pg, async_op=True),
            f"mesh all-to-all of {tuple(t.shape)} over {self.axes}")
        _count(kind, t.numel() * t.element_size(), t0)
        return torch.cat([p.movedim(0, split_axis)
                          for p in out.to(t.device)], dim=concat_axis)


class _Works:
    """Several async works waited on as one (``dist._bounded`` waits on
    one)."""

    def __init__(self, works):
        self.works = list(works)

    def wait(self, timeout=None):
        for w in self.works:
            if (w.wait() if timeout is None else w.wait(timeout)) is False:
                return False
        return True


def world_group():
    """The :class:`Group` of every rank, over the default process group
    (so no group is made, and a rank may call this alone), its
    reduce-scatter and all-gather on the backend's route as a mesh's are:
    the gradient collectives of ``gluon.whole_step.WorldStep``."""
    route = "native" if dist.backend() == "nccl" else "allreduce"
    return Group(("world",), range(dist.num_workers()), dist.rank(), None,
                 route)


_last_mesh = None


class Mesh:
    """A mesh of ``shape`` over the ranks of the process group, this rank
    at ``coords`` (ref: ``jax.sharding.Mesh``).

    ``axis_names`` and ``shape`` (a dict) read as the JAX mesh's do;
    ``devices`` is the grid of ranks; ``device`` is this rank's device.
    :meth:`group` gives the process group of a set of axes, made on every
    rank in the same order (``torch.distributed.new_group`` is collective):
    each axis' and the data axes' are made here."""

    def __init__(self, axis_shapes, rank=0, world=1, device=None):
        global _last_mesh
        self.axis_names = tuple(axis_shapes)
        self.shape = {a: int(n) for a, n in axis_shapes.items()}
        sizes = tuple(self.shape.values())
        self.devices = np.arange(int(np.prod(sizes, dtype=np.int64))) \
            .reshape(sizes)
        self.size = int(self.devices.size)
        self.rank = int(rank)
        if self.size != int(world):
            raise MXNetError(f"mesh {self.shape} needs {self.size} devices, "
                             f"have {world} rank(s)")
        self.coords = self.coords_of(self.rank)
        if device is None:
            device = torch.device("cuda", torch.cuda.current_device()) \
                if torch.cuda.is_available() else torch.device("cpu")
        self.device = torch.device(device)
        self.backend = dist.backend()
        # the reduce-scatter / all-gather route, by backend, before any call
        self.route = "native" if self.backend == "nccl" else "allreduce"
        self._groups = {}
        for a in self.axis_names:
            self.group((a,))
        self.group(data_axes(self))
        if self.size > 1:
            _log.info("parallel.mesh: rank %d of %s at %s, backend %s, "
                      "reduce-scatter/all-gather route %s", self.rank,
                      self.shape, self.coords, self.backend, self.route)
        _last_mesh = self

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords})"

    def coords_of(self, rank):
        sizes = tuple(self.shape.values())
        return dict(zip(self.axis_names,
                        (int(i) for i in np.unravel_index(int(rank), sizes))))

    def group(self, axes):
        """The :class:`Group` of ``axes`` (mesh axis names) holding this
        rank: the ranks that share its coordinates on every other axis,
        ordered by their index over ``axes`` (the first axis outermost)."""
        axes = tuple(a for a in self.axis_names if a in tuple(axes))
        got = self._groups.get(axes)
        if got is not None:
            return got
        n = int(np.prod([self.shape[a] for a in axes], dtype=np.int64))
        if self.size == 1 or n == 1:
            got = Group(axes, (self.rank,), 0, None, self.route)
        else:
            keep = [i for i, a in enumerate(self.axis_names) if a in axes]
            other = [i for i, a in enumerate(self.axis_names)
                     if a not in axes]
            grid = np.transpose(self.devices, other + keep).reshape(-1, n)
            got = None
            for members in grid:  # every rank makes every group, in order
                members = [int(r) for r in members]
                pg = torch.distributed.new_group(members)
                if self.rank in members:
                    got = Group(axes, members, members.index(self.rank), pg,
                                self.route)
        self._groups[axes] = got
        return got

    @property
    def data_group(self):
        """The group of the data axes (``dcn`` outer, ``dp`` inner)."""
        return self.group(data_axes(self))

    @property
    def data_size(self):
        return self.data_group.size

    @property
    def data_index(self):
        """This rank's place along the data axes: ``dcn_idx * dp +
        dp_idx``, the batch shard it takes."""
        return self.data_group.index


def current():
    """The mesh of the innermost :func:`data_scope`, else the last mesh made
    in this process, else None."""
    return getattr(_scope, "mesh", None) or _last_mesh


def make_mesh(axis_shapes=None, devices=None):
    """THE mesh constructor (ref: ``make_mesh``, mesh.py:18).

    ``axis_shapes``: a dict ``axis -> size``, a spec string like
    ``'dp=4,mp=2'`` (validated by ``parallel.spmd.mesh.parse_mesh_shape``),
    or None for a one-axis ``{"dp": world size}`` mesh.  The product must
    equal the process group's size (the JAX rule, with ranks in place of
    devices).  ``devices``: this rank's device (a context or torch device),
    or one per rank (this rank takes its own); more than one device in a
    one-process job raises, naming the launcher.  Joins the process group
    first (``dist.init``, a no-op without a coordinator)."""
    if isinstance(axis_shapes, str):
        from .spmd.mesh import parse_mesh_shape

        axis_shapes = parse_mesh_shape(axis_shapes)
    dist.init()
    world, rank = dist.num_workers(), dist.rank()
    device = None
    if devices is not None:
        devs = list(devices) if isinstance(devices, (list, tuple)) \
            else [devices]
        if len(devs) > 1 and world == 1:
            raise MXNetError(_one_rank_per_device(len(devs)))
        if len(devs) not in (1, world):
            raise MXNetError(f"make_mesh: {len(devs)} devices for {world} "
                             "ranks; give this rank's device or one a rank")
        device = devs[rank if len(devs) == world else 0]
        if hasattr(device, "torch_device"):
            device = device.torch_device()
    if axis_shapes is None:
        axis_shapes = {"dp": world}
    n = int(np.prod([int(s) for s in axis_shapes.values()], dtype=np.int64))
    if n != world:
        hint = "; " + _one_rank_per_device(n) if world == 1 and n > 1 else ""
        raise MXNetError(f"mesh {dict(axis_shapes)} needs {n} devices, "
                         f"have {world} rank(s){hint}")
    return Mesh(dict(axis_shapes), rank, world, device)


def replica_mesh(devices, axis="dp"):
    """DEPRECATED alias (ref: mesh.py:55): a one-axis mesh over an explicit
    replica device list; :func:`make_mesh` is the constructor."""
    devices = list(devices)
    return make_mesh({axis: len(devices)}, devices)


def data_axes(mesh):
    """The mesh axes the batch dim shards over, ``dcn`` outside ``dp``
    (ref: mesh.py:65)."""
    return tuple(a for a in ("dcn", "dp") if a in mesh.axis_names)


# -- shardings ----------------------------------------------------------------


def spec_axes(entry):
    """The mesh axes of one spec entry (None, a name, or a tuple)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def spec_mesh_axes(spec):
    """Every mesh axis a spec shards over, in spec order."""
    return tuple(a for e in spec for a in spec_axes(e))


def shard_slices(spec, shape, mesh, rank=None):
    """The slices of a global ``shape`` that ``rank`` (default: this one)
    holds under ``spec``: a dim over axes ``(a, b)`` splits into
    ``|a| * |b|`` equal parts, ``a`` outermost."""
    coords = mesh.coords if rank is None else mesh.coords_of(rank)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, spec):
        axes = spec_axes(entry)
        n, idx = 1, 0
        for a in axes:
            n *= mesh.shape[a]
            idx = idx * mesh.shape[a] + coords[a]
        if n == 1:
            out.append(slice(None))
            continue
        if dim % n:
            raise MXNetError(f"dim {dim} of shape {tuple(shape)} does not "
                             f"split into {n} shards over {axes}")
        step = dim // n
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def shard_id(slices, shape):
    """The on-disk id of one shard: ``start:stop`` per dim, ``"full"`` for
    a 0-d array (the JAX class's ``_shard_id``, data_parallel.py:586)."""
    return "/".join(
        f"{sl.start or 0}:{sl.stop if sl.stop is not None else dim}"
        for sl, dim in zip(slices, shape)) or "full"


def is_replica0(spec, shape, mesh):
    """Whether this rank is the lowest rank holding its shard of
    ``shape`` under ``spec`` (the shard's replica 0)."""
    mine = shard_slices(spec, shape, mesh)
    return all(shard_slices(spec, shape, mesh, r) != mine
               for r in range(mesh.rank))


class Sharding:
    """A spec over a mesh (ref: ``jax.sharding.NamedSharding``)."""

    def __init__(self, mesh, spec=()):
        self.mesh = mesh
        self.spec = tuple(spec)

    def __repr__(self):
        return f"Sharding({self.mesh.shape}, spec={self.spec})"

    def slices(self, shape, rank=None):
        return shard_slices(self.spec, shape, self.mesh, rank)


def replicated(mesh):
    """Ref: mesh.py:49."""
    return Sharding(mesh, ())


def batch_sharding(mesh, axis=None):
    """Dim 0 over the data axes (ref: mesh.py:74): ``('dcn', 'dp')`` where
    a ``dcn`` axis exists, else ``'dp'``."""
    if axis is None:
        axes = data_axes(mesh)
        axis = axes if len(axes) > 1 else (axes[0] if axes else "dp")
    return Sharding(mesh, (axis,))


def global_put(value, sharding, device=None):
    """This rank's slice of the global ``value`` (an array, tensor or
    NDArray that every rank holds alike) under ``sharding``, as a tensor on
    ``device`` (default: the mesh's) (ref: mesh.py:85)."""
    from ..ndarray.ndarray import NDArray

    if isinstance(value, NDArray):
        value = value.data
    if not isinstance(value, torch.Tensor):
        value = torch.from_numpy(np.asarray(value))
    part = value[sharding.slices(tuple(value.shape))]
    return part.to(device if device is not None else sharding.mesh.device)


def shard_param_spec(shape, mesh, tp_axis="tp"):
    """The default tensor-parallel spec (ref: mesh.py:102): the largest dim
    of a >= 2-D parameter that ``tp`` divides and that is at least
    ``2 * tp``, over ``tp_axis``; ``()`` (replicated) otherwise."""
    if tp_axis not in mesh.axis_names or len(shape) < 2:
        return ()
    tp = mesh.shape[tp_axis]
    if tp <= 1:
        return ()
    dims = [None] * len(shape)
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if shape[i] % tp == 0 and shape[i] >= tp * 2:
            dims[i] = tp_axis
            break
    return tuple(dims)


# -- placement and gradient collectives, in flat same-dtype buckets -----------
#
# Shared by the mesh trainers (``DataParallelTrainer`` and the mesh step of
# ``gluon.Trainer``, ``parallel.spmd.lowering``): they differ in how they
# compute, not in how they place values or sum gradients.


def buckets(items, nbytes):
    """``items`` in consecutive runs of at most the bucket cap
    (``MXTPU_KVSTORE_BUCKET_MB``, default 32, the kvstore's) each."""
    cap = max(int(getenv("KVSTORE_BUCKET_MB", 32.0, float) * (1 << 20)), 1)
    run, size = [], 0
    for it in items:
        n = nbytes(it)
        if run and size + n > cap:
            yield run
            run, size = [], 0
        run.append(it)
        size += n
    if run:
        yield run


def by_dtype(items, dtype_of):
    """``items`` grouped by dtype, each group in ``items``' order."""
    out = {}
    for it in items:
        out.setdefault(dtype_of(it), []).append(it)
    return out.values()


def _flat_buckets(items, tensor_of):
    """``items`` in flat same-dtype buckets: ``(bucket, flat)`` pairs, the
    flat tensor the concatenation of ``tensor_of(item)`` over the bucket."""
    for run in by_dtype(items, lambda it: tensor_of(it).dtype):
        for bucket in buckets(run, lambda it: tensor_of(it).numel()
                              * tensor_of(it).element_size()):
            yield bucket, torch.cat([tensor_of(it).reshape(-1)
                                     for it in bucket])


def place(mesh, values, specs):
    """Rank 0's ``values`` (full tensors, overwritten in place on every
    other rank: one broadcast a bucket over the whole mesh), each then cut
    to this rank's shard under its spec (a copy; the value itself where
    the spec is ``()``).  Every rank must place the same parameters in the
    same order.  The JAX package's ``global_put`` assumes every process
    holds the same value; here rank 0's wins, so ranks whose generators
    drew different initial weights start alike."""
    if mesh.size > 1 and values:
        world = mesh.group(mesh.axis_names)
        for bucket, flat in _flat_buckets(values, lambda v: v):
            world.broadcast_(flat, 0)
            off = 0
            for v in bucket:
                v.copy_(flat[off:off + v.numel()].view(v.shape))
                off += v.numel()
    return [v[shard_slices(sp, tuple(v.shape), mesh)].clone() if sp else v
            for v, sp in zip(values, specs)]


def sum_in_place(group, tensors, kind="grad"):
    """Sum each of ``tensors`` over ``group``, in place: one all-reduce a
    flat same-dtype bucket.  Every member passes the same shapes in the
    same order."""
    if group.size == 1:
        return
    for bucket, flat in _flat_buckets(tensors, lambda t: t):
        group.all_reduce_(flat, kind)
        off = 0
        for t in bucket:
            t.copy_(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()


def reduce_over_data(mesh, grads, zero_slice=None):
    """Each gradient of ``grads`` (``{i: g}``) summed over ``mesh``'s data
    axes, one collective a flat same-dtype bucket: the whole of it (an
    all-reduce), or for an ``i`` of ``zero_slice`` this rank's ``dp`` slice
    of the sum (a ZeRO state: an all-reduce over ``dcn`` where there is
    one, then a reduce-scatter over ``dp``).  ``zero_slice[i](k)`` indexes
    ``dp`` member ``k``'s slice of ``grads[i]``.  Returns ``{i: sum}``."""
    zero_slice = zero_slice or {}
    full = [i for i in grads if i not in zero_slice]
    zero = [i for i in grads if i in zero_slice]
    out = {i: grads[i] for i in full}
    if mesh.data_size > 1:
        group = mesh.data_group
        for bucket, flat in _flat_buckets(full, lambda i: grads[i]):
            group.all_reduce_(flat, "grad")
            off = 0
            for i in bucket:
                n = grads[i].numel()
                out[i] = flat[off:off + n].view(grads[i].shape)
                off += n
    if zero:
        dp = mesh.group(("dp",))
        dcn = mesh.group(("dcn",)) if "dcn" in mesh.axis_names else None
        for run in by_dtype(zero, lambda i: grads[i].dtype):
            for bucket in buckets(run, lambda i: grads[i].numel()
                                  * grads[i].element_size()):
                # member k's chunk: every gradient's dp slice k
                flat = torch.cat([grads[i][zero_slice[i](k)].reshape(-1)
                                  for k in range(dp.size) for i in bucket])
                if dcn is not None:
                    dcn.all_reduce_(flat, "grad")
                mine = dp.reduce_scatter(flat, "grad")
                off = 0
                for i in bucket:
                    shape = grads[i][zero_slice[i](dp.index)].shape
                    n = int(np.prod(shape, dtype=np.int64))
                    out[i] = mine[off:off + n].view(shape)
                    off += n
    return out


def gather_pieces(group, pieces, put, kind="param"):
    """Every member's piece of each of ``pieces`` (``[(i, this rank's
    tensor)]``, the same shapes on every member), one all-gather a flat
    same-dtype bucket over ``group``: ``put(i, k, piece)`` receives member
    ``k``'s (its index in the group)."""
    for bucket, flat in _flat_buckets(pieces, lambda it: it[1]):
        for k, part in enumerate(group.all_gather(flat, kind)):
            off = 0
            for i, t in bucket:
                put(i, k, part[off:off + t.numel()].view(t.shape))
                off += t.numel()


# -- synchronised BatchNorm statistics ----------------------------------------

_scope = threading.local()


@contextlib.contextmanager
def data_scope(mesh):
    """Inside it, BatchNorm statistics are summed over ``mesh``'s data
    axes (:func:`stats_group`); the trainer sets it around its forward."""
    prev = getattr(_scope, "mesh", None)
    _scope.mesh = mesh
    try:
        yield
    finally:
        _scope.mesh = prev


def scope_mesh():
    """The mesh of the innermost :func:`data_scope`, or None: the
    ``DataParallelTrainer``'s step sets it on a mesh of more than one
    rank, and the expert-parallel MoE (``parallel.moe``) takes its ``ep``
    group from it."""
    return getattr(_scope, "mesh", None)


def stats_group(axis_name=None):
    """The group BatchNorm statistics are summed over, or None for none:
    the group of mesh axis ``axis_name`` (of :func:`current`), else inside
    :func:`data_scope` its mesh's data-axes group.  A group of one rank is
    None."""
    if axis_name is not None:
        mesh = current()
        axes = spec_axes(axis_name)
        if mesh is None or not all(a in mesh.axis_names for a in axes):
            raise MXNetError(
                f"axis_name={axis_name!r} names no axis of a mesh here "
                f"(current mesh: {mesh}); make one with "
                "parallel.mesh.make_mesh")
        group = mesh.group(axes)
    else:
        mesh = getattr(_scope, "mesh", None)
        group = mesh.data_group if mesh is not None else None
    return group if group is not None and group.size > 1 else None


class SumOverGroup(torch.autograd.Function):
    """The sum of a tensor over a group's ranks; its backward is the sum of
    the cotangents over the same group (every rank's result depends on
    every rank's input)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return group.all_reduce_(t.detach().clone(), "stats")

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce_(g.detach().clone(), "stats"), None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, offset):
        ctx.group, ctx.offset = group, offset
        return group.shift(t, offset)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.shift(g, -ctx.offset), None, None


def ring_shift(t, group, offset=1):
    """:meth:`Group.shift`, differentiable: the backward is the reverse
    shift, so every member must take it (every member's result must reach
    its loss)."""
    return t if group.size == 1 else _RingShift.apply(t, group, offset)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, split_axis, concat_axis):
        ctx.group, ctx.axes = group, (split_axis, concat_axis)
        return group.all_to_all(t, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return (ctx.group.all_to_all(g, concat_axis, split_axis), None, None,
                None)


def all_to_all(t, group, split_axis, concat_axis):
    """:meth:`Group.all_to_all`, differentiable: the backward is the
    all-to-all with the two axes swapped, which every member must take."""
    return t if group.size == 1 else _AllToAll.apply(t, group, split_axis,
                                                      concat_axis)


def sum_stats(tensors, axis_name=None):
    """``(tensors summed over stats_group(axis_name), that group's size)``:
    one all-reduce for all of them (fp32, 1-D), differentiable; the
    tensors themselves and 1 where there is no group."""
    group = stats_group(axis_name)
    if group is None:
        return list(tensors), 1
    sizes = [t.numel() for t in tensors]
    flat = SumOverGroup.apply(torch.cat([t.reshape(-1) for t in tensors]),
                              group)
    return [p.reshape(t.shape) for p, t in
            zip(torch.split(flat, sizes), tensors)], group.size


# -- JAX tracing helpers ------------------------------------------------------


def spmd_jit(sharded_fn, mesh, in_specs, out_specs, **kwargs):
    raise _tracing_helper("spmd_jit (a traced step over a mesh)")


def shard_map():
    raise _tracing_helper("shard_map (per-shard tracing)")


def pcast(x, axis_name, to):
    raise _tracing_helper("pcast (a varying-manual-axes annotation)")


def vma(x):
    raise _tracing_helper("vma (the varying-manual-axes set)")
