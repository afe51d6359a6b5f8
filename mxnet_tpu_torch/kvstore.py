"""KVStore: the string- or int-keyed store that sums gradients over
contexts and processes (ref: ``mxnet_tpu/kvstore.py``; src/kvstore/ and
python/mxnet/kvstore.py).

- ``'local'``/``'device'``/``'nccl'`` (and ``'horovod'``, ``'teststore'``,
  which the JAX package also runs this way): one process, several
  contexts.  A push sums the values of a key over its contexts by
  :func:`_pairwise_tree_reduce`, in slot order.
- ``'dist_sync'``/``'dist'``/``'dist_device_sync'``: also sums over the
  processes with ``parallel.dist.allreduce`` (``torch.distributed``; in
  one process the identity, as in the JAX package).

Values and outs are NDArrays (or tensors, whose context is their
device); each keeps its context, so ``cpu(0)`` and ``cpu(1)`` are two
slots, as they are two devices in the JAX package, and the ``buckets``/
``dispatches`` counts of :meth:`KVStore.pushpull` match its counts.  The
store keeps its own copy of each key; a pull copies into the outs in
place, so a gradient or weight buffer that a reference holds sees the
result.

The sum order has ONE definition, :func:`_pairwise_tree_reduce`: the
per-key path (:func:`_reduce_sum`) and the fused multi-key
:meth:`KVStore.pushpull` (same-dtype values packed into flat buckets
capped by ``MXTPU_KVSTORE_BUCKET_MB``, default 32; one reduce, and under
``dist_*`` one all-reduce, a bucket) add the same pairs in the same
order, and every other op is a copy, so the two are bit-identical.

``set_optimizer`` runs the optimizer on the summed gradient inside push
(``update_on_kvstore``); ``set_gradient_compression`` quantizes each
pushed value to {-t, 0, t} with a per-(key, slot) residual (2-bit with
error feedback), in plain torch ops, as the JAX package computes it in
``jnp`` outside any kernel.

Not ported yet, each raising :class:`MXNetError` naming its slice:
``dist_async``/``dist_device_async`` and the parameter-server client
(slice 7, part 3), ``row_sparse_pull`` and sparse values (slice 9, with
``ndarray/sparse``), and the traced and ZeRO forms (``traced_*``,
``zero_*``; slice 7, part 2).  The JAX package's fault points
(``engine.fault_point``) come with ``engine.py`` in slice 8; there are
none here.
"""
from __future__ import annotations

import torch

from . import optimizer as _opt
from .base import MXNetError, getenv
from .context import Context
from .ndarray.ndarray import NDArray


def _later(what, where):
    return MXNetError(f"kvstore: {what} is not ported yet; it comes with "
                      f"{where} (ROADMAP.md queue 1)")


_PART2 = "part 2 of the distributed slice (slice 7, part 2)"
_PART3 = "part 3 of the distributed slice (slice 7, part 3)"
_SPARSE = "slice 9 (ndarray/sparse)"


def _nd(v):
    """``v`` as an NDArray (a tensor's context is its device)."""
    if isinstance(v, NDArray):
        return v
    if isinstance(v, torch.Tensor):
        return NDArray(v)
    raise _later(f"a value of type {type(v).__name__} (sparse values and "
                 "other array types)", _SPARSE)


def _to(t, src_ctx, dst_ctx, stats=None):
    """``t`` on ``dst_ctx``'s device; a move between contexts counts one
    dispatch (a copy only where the torch devices differ)."""
    if src_ctx == dst_ctx:
        return t
    if stats is not None:
        stats["dispatches"] += 1
    dev = dst_ctx.torch_device()
    return t if t.device == dev else t.to(dev)


def _write(out, t):
    """Copy ``t`` into the NDArray or tensor ``out`` in place."""
    dst = out.data if isinstance(out, NDArray) else out
    if tuple(dst.shape) != tuple(t.shape):
        raise MXNetError(f"kvstore: cannot write shape {tuple(t.shape)} "
                         f"into an out of shape {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(t)


class KVStore:
    """Ref: include/mxnet/kvstore.h KVStore::Create."""

    def __init__(self, kv_type="local"):
        self._type = kv_type
        self._store = {}          # key -> NDArray: the store's own copy
        self._updater = None
        self._optimizer = None
        self._compression = None  # GradientCompression when enabled

    @property
    def type(self):
        return self._type

    @property
    def rank(self):
        from .parallel import dist

        return dist.rank()

    @property
    def num_workers(self):
        from .parallel import dist

        return dist.num_workers()

    # -- init ---------------------------------------------------------------

    @torch.no_grad()
    def init(self, key, value):
        keys, values = _normalize(key, value)
        for k, vlist in zip(keys, values):
            if k in self._store:
                raise MXNetError(f"key {k} already initialized")
            v = _nd(vlist[0])
            self._store[k] = NDArray(v.data.detach().clone(), v._ctx)

    # -- push / pull --------------------------------------------------------

    @torch.no_grad()
    def push(self, key, value, priority=0):
        """Sum the values of each key over its contexts (ref: CommDevice
        reduce), and over the processes for ``dist_*``; then run the
        optimizer on the sum (``set_optimizer``) or keep it."""
        keys, values = _normalize(key, value)
        for k, vlist in zip(keys, values):
            if k not in self._store:
                raise MXNetError(f"key {k} has not been initialized")
            vlist = [_nd(v) for v in vlist]
            if self._compression is not None:
                vlist = [self._compression.compress(k, slot, v)
                         for slot, v in enumerate(vlist)]
            store = self._store[k]
            reduced = _reduce_sum(vlist, store.context)
            if self._is_dist():
                reduced = self._dist_allreduce(k, reduced)
            if self._updater is not None:
                # server-side optimizer (update_on_kvstore=True), in place
                # on the store's copy
                self._updater(_key_index(k), reduced, store)
            else:
                _write(store, reduced.data)

    @torch.no_grad()
    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Copy each key's stored value into its outs, in place."""
        keys, outs = _normalize(key, out)
        for k, olist in zip(keys, outs):
            if k not in self._store:
                raise MXNetError(f"key {k} has not been initialized")
            src = self._store[k]
            for o in olist:
                o = _nd(o)
                _write(o, _to(src.data, src.context, o.context))

    @torch.no_grad()
    def pushpull(self, key, value, out=None, priority=0):
        """push+pull in one call.  The multi-key form takes the fused
        path: dense same-dtype values are packed into size-capped flat
        buckets (``MXTPU_KVSTORE_BUCKET_MB``, default 32), each bucket is
        reduced (and all-reduced under ``dist_*``) as ONE flat buffer, and
        the results are copied into the outs: one collective per bucket
        instead of one per key.  Bit-identical to the per-key path: the
        pairwise order over slots is the same and every other op is a
        copy.  Gradient compression and ``set_optimizer`` take the
        per-key path.  The multi-key form returns ``{"buckets",
        "dispatches"}``, counted as the JAX package counts them."""
        if isinstance(key, (list, tuple)) and len(key) > 1 \
                and self._fusion_eligible():
            keys, values = _normalize(key, value)
            outs = _normalize(key, out)[1] if out is not None else values
            fused, rest = self._split_fusable(keys, values, outs)
            stats = {"buckets": 0, "dispatches": 0}
            if fused:
                self._pushpull_fused(fused, stats)
            for k, vlist, olist in rest:
                self.push(k, vlist, priority)
                self.pull(k, olist, priority)
                stats["dispatches"] += 2 * len(vlist)
            return stats
        self.push(key, value, priority)
        self.pull(key, out if out is not None else value, priority)
        return None

    def _fusion_eligible(self):
        # compression quantizes per (key, slot) with error feedback;
        # update_on_kvstore applies the optimizer inside push: neither
        # composes with packing
        return self._updater is None and self._compression is None

    def _split_fusable(self, keys, values, outs):
        fused, rest = [], []
        for k, vlist, olist in zip(keys, values, outs):
            vlist = [_nd(v) for v in vlist]
            olist = [_nd(o) for o in olist]
            ok = (k in self._store and len(vlist) == len(olist) > 0
                  and len({v.data.dtype for v in vlist}) == 1)
            (fused if ok else rest).append((k, vlist, olist))
        return fused, rest

    def _pushpull_fused(self, items, stats):
        cap = max(int(getenv("KVSTORE_BUCKET_MB", 32.0, float) * (1 << 20)),
                  1)
        if not self._is_dist():
            # one slot and no cross-process sum: nothing to add, so the
            # value goes to the store and the outs as push+pull would put
            # it, with no packing
            multi = []
            for k, vlist, olist in items:
                if len(vlist) > 1:
                    multi.append((k, vlist, olist))
                    continue
                store = self._store[k]
                v = vlist[0]
                _write(store, _to(v.data, v.context, store.context, stats))
                for o in olist:
                    _write(o, _to(store.data, store.context, o.context,
                                  stats))
            items = multi
            if not items:
                return
        # one bucket stream per (dtype, slot count, slot contexts): the
        # values of slot s of every member are packed into one buffer
        groups = {}
        for item in items:
            vlist = item[1]
            fp = (vlist[0].data.dtype, len(vlist),
                  tuple(v.context for v in vlist))
            groups.setdefault(fp, []).append(item)
        for members in groups.values():
            bucket, size = [], 0
            for item in members:
                v0 = item[1][0].data
                nbytes = v0.numel() * v0.element_size()
                if bucket and size + nbytes > cap:
                    self._reduce_bucket(bucket, stats)
                    bucket, size = [], 0
                bucket.append(item)
                size += nbytes
            if bucket:
                self._reduce_bucket(bucket, stats)

    def _reduce_bucket(self, bucket, stats):
        """ONE flat reduce (and all-reduce) for every key in ``bucket``;
        the results land in the store and every out."""
        ks = [b[0] for b in bucket]
        shapes = [tuple(b[1][0].shape) for b in bucket]
        n_slots = len(bucket[0][1])
        single = len(bucket) == 1
        ctxs = [v.context for v in bucket[0][1]]
        if single:
            # a lone key (one tensor past the cap, say) gains nothing from
            # packing: reduce it as it is
            flats = [bucket[0][1][s].data for s in range(n_slots)]
        else:
            flats = [torch.cat([b[1][s].data.reshape(-1) for b in bucket])
                     for s in range(n_slots)]
            stats["dispatches"] += n_slots
        reduced, rctx = _pairwise_tree_reduce(list(zip(flats, ctxs)), stats)
        target = self._store[ks[0]].context
        reduced = _to(reduced, rctx, target, stats)
        if self._is_dist():
            from .parallel import dist

            reduced = dist.allreduce(reduced)
            stats["dispatches"] += 1
        per_ctx = {}

        def pieces_for(ctx):
            got = per_ctx.get(ctx)
            if got is None:
                flat = _to(reduced, target, ctx, stats)
                if single:
                    got = [flat]
                else:
                    got = [piece.view(shape) for piece, shape in zip(
                        torch.split(flat, [_numel(s) for s in shapes]),
                        shapes)]
                    stats["dispatches"] += 1
                per_ctx[ctx] = got
            return got

        for i, (k, _vlist, olist) in enumerate(bucket):
            # each key's stored copy stays on its own context (keys of
            # one bucket may live on different ones)
            store = self._store[k]
            _write(store, pieces_for(store.context)[i])
            for o in olist:
                _write(o, pieces_for(o.context)[i])
        stats["buckets"] += 1

    # -- what later slices bring --------------------------------------------

    def traced_pushpull(self, g_raws, axis_name):
        raise _later("traced_pushpull (the gradient sum traced into a "
                     "captured step)", _PART2)

    def zero_reduce_scatter(self, vlists, padded, devices, stats):
        raise _later("zero_reduce_scatter (ZeRO)", _PART2)

    def zero_allgather(self, shard_raws, shapes, devices, stats):
        raise _later("zero_allgather (ZeRO)", _PART2)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        raise _later("row_sparse_pull", _SPARSE)

    # -- broadcast ----------------------------------------------------------

    def broadcast(self, key, value, out, priority=0):
        self.init(key, value)
        self.pull(key, out=out, priority=priority)

    # -- optimizer ----------------------------------------------------------

    def set_optimizer(self, optimizer):
        """Run ``optimizer`` on the summed pushed gradients (ref:
        kvstore_dist_server.h set_optimizer)."""
        self._optimizer = optimizer
        self._updater = _opt.get_updater(optimizer)

    def set_gradient_compression(self, compression_params):
        """2-bit gradient compression with error feedback (ref:
        src/kvstore/gradient_compression.cc Quantize2BitImpl)."""
        params = dict(compression_params or {})
        ctype = params.get("type", "2bit")
        if ctype == "none":
            self._compression = None
            return
        if ctype != "2bit":
            raise MXNetError(f"unsupported compression type {ctype!r}")
        self._compression = GradientCompression(
            threshold=float(params.get("threshold", 0.5)))

    # -- dist ---------------------------------------------------------------

    def _is_dist(self):
        return self._type.startswith("dist")

    def _dist_allreduce(self, key, value):
        from .parallel import dist

        return dist.allreduce(value)

    def barrier(self):
        if self._is_dist():
            from .parallel import dist

            dist.barrier()

    def save_optimizer_states(self, fname, dump_optimizer=False):
        """Write the updater's states (a pickle of numpy arrays, which the
        JAX package's ``load_optimizer_states`` reads too)."""
        if self._updater is None:
            raise MXNetError("no optimizer set on kvstore")
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("no optimizer set on kvstore")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())


def _numel(shape):
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _pairwise_tree_reduce(parts, stats):
    """Pairwise tree reduce over ``(tensor, context)`` slots IN SLOT
    ORDER: the ONE definition of the reduction order.  The per-key path
    (:func:`_reduce_sum`) and the fused bucket reduce add the same pairs,
    so their sums are bit-identical.  The right operand moves to the left
    one's context; every move and add is counted in ``stats``.  Returns
    ``(sum, its context)``."""
    while len(parts) > 1:
        nxt = []
        for i in range(0, len(parts) - 1, 2):
            (a, ca), (b, cb) = parts[i], parts[i + 1]
            b = _to(b, cb, ca, stats)
            nxt.append((a + b, ca))
            stats["dispatches"] += 1
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    return parts[0]


def _key_index(k):
    try:
        return int(k)
    except (TypeError, ValueError):
        return k


def _normalize(key, value):
    if isinstance(key, (list, tuple)):
        out_v = []
        for v in value:
            out_v.append(list(v) if isinstance(v, (list, tuple)) else [v])
        return list(key), out_v
    return [key], [list(value) if isinstance(value, (list, tuple))
                   else [value]]


def _reduce_sum(vlist, target_ctx):
    """Sum NDArrays on (possibly) different contexts: the pairwise tree of
    :func:`_pairwise_tree_reduce`, then the sum on ``target_ctx``."""
    target_ctx = Context(target_ctx)
    if len(vlist) == 1:
        v = vlist[0]
        return NDArray(_to(v.data, v.context, target_ctx), target_ctx)
    total, ctx = _pairwise_tree_reduce([(v.data, v.context) for v in vlist],
                                       {"dispatches": 0})
    return NDArray(_to(total, ctx, target_ctx), target_ctx)


_VALID = ("local", "device", "nccl", "dist", "dist_sync", "dist_async",
          "dist_device_sync", "dist_device_async", "horovod", "teststore")
_ASYNC = ("dist_async", "dist_device_async")


def create(name="local"):
    """Ref: mx.kv.create.  The ``dist_*`` types join the process group
    (``parallel.dist.init``: a no-op without the launcher's env)."""
    if isinstance(name, KVStore):
        return name
    if name not in _VALID:
        raise MXNetError(f"unknown kvstore type {name!r}; valid: {_VALID}")
    if name in _ASYNC:
        raise _later(f"kvstore {name!r} (asynchronous updates on a "
                     "parameter server)", _PART3)
    if name.startswith("dist"):
        from .parallel import dist

        dist.init()
    return KVStore(name)


def traced_bucket_allreduce(g_raws, axis_name):
    raise _later("traced_bucket_allreduce", _PART2)


def traced_bucket_reduce_scatter(g_raws, axis_name, world):
    raise _later("traced_bucket_reduce_scatter (ZeRO)", _PART2)


def traced_bucket_allgather(shards, metas, axis_name):
    raise _later("traced_bucket_allgather (ZeRO)", _PART2)


# ---------------------------------------------------------------------------
# 2-bit gradient compression (ref: src/kvstore/gradient_compression.{cc,h})


class GradientCompression:
    """Threshold quantization to {-t, 0, +t} with an error-feedback
    residual per (key, slot) (ref: GradientCompression::Quantize2BitImpl
    with its dequantize): the JAX package's ops, in the same order."""

    def __init__(self, threshold=0.5):
        if threshold <= 0:
            raise MXNetError("compression threshold must be positive")
        self.threshold = threshold
        self._residuals = {}  # (key, slot) -> residual tensor

    def get_params(self):
        return {"type": "2bit", "threshold": self.threshold}

    def compress(self, key, slot, grad):
        grad = _nd(grad)
        g = grad.data
        t = torch.tensor(self.threshold, dtype=g.dtype, device=g.device)
        resid = self._residuals.get((key, slot))
        if resid is not None:
            g = g + resid
        q = torch.where(g >= t, t, torch.where(g <= -t, -t,
                                               torch.zeros_like(g)))
        self._residuals[(key, slot)] = g - q
        return NDArray(q, grad._ctx)
