"""Pipeline stage graph — composable, checkpointable input stages (ref:
``mxnet_tpu/pipeline/stages.py``).

A :class:`Pipeline` is a chain of stateful iterator stages over a
``Dataset``/``DataIter``/iterable source.  Its logical core is
synchronous and pull-based (every stage knows exactly how far the
consumer has advanced); asynchrony lives where it pays:

- :class:`MapStage` runs its fn on the engine's host workers, keeping a
  bounded window of ordered futures in flight;
- :class:`PrefetchToDeviceStage` pulls whole upstream batches on the
  engine's per-context ``h2d`` lane and lands each on the device through
  ONE ``engine.batched_put``, ``depth`` batches ahead, so host build and
  transfer overlap the consumer's previous step.

Host stages keep their arrays on ``cpu()``: ``default_batchify`` stacks
on the host (the JAX package stacks on its default device), and a batch
reaches the card through ``prefetch_to_device`` or the trainer.  A
batch prefetched to a CUDA device was copied on a side stream; the
consumer's stream waits for that copy's event when the batch is handed
over (``engine.StagedBatch.wait``).

Every stage carries explicit iterator state (``state_dict()`` /
``load_state_dict()``): source cursor, shuffle ring and RNG, batch
rollover remainder and, for the async stages, the in-flight items
themselves, drained to host arrays.  Restoring that state into a freshly
built identical pipeline replays the remaining batch sequence
bit-identically.  The shuffle's ring fill is a tracer span
(``pipeline.shuffle.fill``) and each map call a profiler scope
(``pipeline.map``), both in the ``dataPipeline`` category, as in the JAX
package.
"""
from __future__ import annotations

import collections
import concurrent.futures
import time

import numpy as np
import torch

from .. import engine, profiler
from ..base import MXNetError, getenv
from ..context import Context, cpu, current_context
from ..ndarray import ndarray as _nd
from ..ndarray.ndarray import NDArray
from ..telemetry import tracer as _tracer
from . import stats as _stats

# sentinel a prefetch pull-job returns instead of raising StopIteration
# across the future boundary
_EOS = object()


def _done_future(value):
    f = concurrent.futures.Future()
    f.set_result(value)
    return f


def _host_array(arr, dtype=None):
    """An NDArray on ``cpu()`` holding a copy of the numpy ``arr``."""
    return _nd.array(arr, ctx=cpu(), dtype=dtype)


def default_batchify(data):
    """Stack samples into a batch (ref: default_batchify_fn; this is the
    canonical copy, ``gluon.data.dataloader`` re-exports it).  NDArray or
    tensor samples are stacked where they live (``cpu()`` for the
    datasets); numpy and Python samples become an NDArray on ``cpu()``,
    float64 as float32."""
    first = data[0]
    if isinstance(first, NDArray):
        return NDArray(torch.stack([d.data for d in data]), first.context)
    if isinstance(first, torch.Tensor):
        return NDArray(torch.stack(list(data)))
    if isinstance(first, tuple):
        return tuple(default_batchify(list(x)) for x in zip(*data))
    arr = np.asarray(data)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return _host_array(arr)


# ---------------------------------------------------------------------------
# state packing: in-flight items (map results, prefetched device batches,
# shuffle-ring elements) are saved as host trees, so a checkpoint is
# device-free and a restore can stage them onto any device.


def _pack(obj):
    """Tree -> host-serializable tree (NDArray/tensor leaves -> numpy)."""
    if isinstance(obj, NDArray):
        return {"__kind__": "ndarray", "v": obj.asnumpy()}
    if isinstance(obj, torch.Tensor):
        return {"__kind__": "ndarray", "v": NDArray(obj).asnumpy()}
    from ..io.io import DataBatch

    if isinstance(obj, DataBatch):
        return {"__kind__": "databatch",
                "data": _pack(obj.data), "label": _pack(obj.label),
                "pad": obj.pad, "index": obj.index}
    if isinstance(obj, dict):
        return {"__kind__": "dict",
                "v": {k: _pack(v) for k, v in obj.items()}}
    if isinstance(obj, (list, tuple)):
        return {"__kind__": type(obj).__name__,
                "v": [_pack(v) for v in obj]}
    return obj


def _unpack(obj):
    """Inverse of :func:`_pack`; arrays come back as NDArrays on ``cpu()``."""
    if isinstance(obj, dict) and "__kind__" in obj:
        kind = obj["__kind__"]
        if kind == "ndarray":
            return _host_array(obj["v"], dtype=obj["v"].dtype)
        if kind == "databatch":
            from ..io.io import DataBatch

            return DataBatch(_unpack(obj["data"]), _unpack(obj["label"]),
                             pad=obj["pad"], index=obj["index"])
        if kind == "dict":
            return {k: _unpack(v) for k, v in obj["v"].items()}
        seq = [_unpack(v) for v in obj["v"]]
        return tuple(seq) if kind == "tuple" else seq
    return obj


def _flatten(obj, leaves):
    """Split a batch tree into transferable leaves and a rebuild spec, so
    one ``engine.batched_put`` moves EVERY array of the batch."""
    if isinstance(obj, NDArray):
        leaves.append(obj.data)
        return ("leaf", len(leaves) - 1)
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        leaves.append(obj)
        return ("leaf", len(leaves) - 1)
    if isinstance(obj, (list, tuple)):
        return ("seq", type(obj) is tuple,
                [_flatten(v, leaves) for v in obj])
    if isinstance(obj, dict):
        return ("dict", [(k, _flatten(v, leaves)) for k, v in obj.items()])
    return ("raw", obj)


def _rebuild(spec, outs, ctx):
    tag = spec[0]
    if tag == "leaf":
        return NDArray(outs[spec[1]], ctx)
    if tag == "seq":
        seq = [_rebuild(s, outs, ctx) for s in spec[2]]
        return tuple(seq) if spec[1] else seq
    if tag == "dict":
        return {k: _rebuild(s, outs, ctx) for k, s in spec[1]}
    return spec[1]


# ---------------------------------------------------------------------------
# stages


class Stage:
    """One stateful iterator node; ``_up`` is the upstream stage."""

    def __init__(self, up=None):
        self._up = up

    def __iter__(self):
        return self

    def __next__(self):
        raise NotImplementedError

    def reset(self):
        if self._up is not None:
            self._up.reset()

    def state_dict(self):
        return {}

    def load_state_dict(self, state):
        pass


class DatasetSource(Stage):
    """Random-access source over a ``Dataset`` (or anything with
    ``__getitem__``/``__len__``); its state is the cursor."""

    def __init__(self, dataset):
        super().__init__()
        self._dataset = dataset
        self._cursor = 0

    def __next__(self):
        if self._cursor >= len(self._dataset):
            raise StopIteration
        item = self._dataset[self._cursor]
        self._cursor += 1
        return item

    def reset(self):
        self._cursor = 0

    def state_dict(self):
        return {"cursor": self._cursor}

    def load_state_dict(self, state):
        self._cursor = int(state["cursor"])


class IterableSource(Stage):
    """Forward-only source over any iterable (``DataIter`` included).

    A source with its own ``state_dict``/``load_state_dict`` (e.g.
    ``io.NDArrayIter``) resumes exactly through them; otherwise resume is
    replay-based (``reset()`` and skip ``count`` items), bit-exact only
    for deterministic sources."""

    def __init__(self, src):
        super().__init__()
        self._src = src
        self._it = None
        self._count = 0

    def _iter(self):
        if self._it is None:
            self._it = iter(self._src)
        return self._it

    def __next__(self):
        item = next(self._iter())
        self._count += 1
        return item

    def reset(self):
        if hasattr(self._src, "reset"):
            self._src.reset()
        self._it = None
        self._count = 0

    def state_dict(self):
        st = {"count": self._count}
        if hasattr(self._src, "state_dict"):
            st["src"] = self._src.state_dict()
        return st

    def load_state_dict(self, state):
        if state.get("src") is not None and hasattr(self._src,
                                                    "load_state_dict"):
            # exact resume, no reset() first: a reset may draw from the
            # RNG (NDArrayIter's reshuffle) and desync the restored stream
            self._src.load_state_dict(state["src"])
            self._it = None
            self._count = int(state["count"])
            return
        self.reset()
        for _ in range(int(state["count"])):  # replay-skip
            next(self)


class ShuffleStage(Stage):
    """Seeded ring-buffer shuffle.  The ring holds ``buffer_size`` upstream
    items; each draw swap-pops a seeded-random slot.  ``reset()`` does NOT
    reseed: the RNG stream continues, so every epoch shuffles differently
    yet the whole multi-epoch sequence is a pure function of the seed."""

    def __init__(self, up, buffer_size, seed=0):
        super().__init__(up)
        if buffer_size < 1:
            raise MXNetError(f"shuffle buffer_size must be >= 1, "
                             f"got {buffer_size}")
        self._size = int(buffer_size)
        self._rng = np.random.RandomState(seed)
        self._ring = []
        self._exhausted = False

    def __next__(self):
        _tracer.span_begin("pipeline.shuffle.fill", "dataPipeline")
        try:
            while not self._exhausted and len(self._ring) < self._size:
                try:
                    self._ring.append(next(self._up))
                except StopIteration:
                    self._exhausted = True
        finally:
            _tracer.span_end("pipeline.shuffle.fill", "dataPipeline",
                             ring=len(self._ring))
        if not self._ring:
            raise StopIteration
        j = int(self._rng.randint(len(self._ring)))
        item = self._ring[j]
        self._ring[j] = self._ring[-1]
        self._ring.pop()
        return item

    def reset(self):
        super().reset()
        self._ring = []
        self._exhausted = False

    def state_dict(self):
        return {"ring": [_pack(v) for v in self._ring],
                "rng": self._rng.get_state(),
                "exhausted": self._exhausted}

    def load_state_dict(self, state):
        self._ring = [_unpack(v) for v in state["ring"]]
        self._rng.set_state(state["rng"])
        self._exhausted = bool(state["exhausted"])


class MapStage(Stage):
    """Ordered async map on the engine's host workers, ``inflight`` items
    ahead.  Its state is the in-flight results themselves (as host
    arrays), so the upstream state, which already reflects the pulls,
    stays consistent and a restore replays them first.  An exception of
    the fn reaches the consumer at that item."""

    def __init__(self, up, fn, inflight=None, timeout=None, sync=False):
        super().__init__(up)
        self._fn = fn
        self._inflight = max(1, int(
            inflight if inflight is not None
            else getenv("PIPELINE_MAP_INFLIGHT", 4, int)))
        # 0 and None both disable the bound (the DataLoader convention)
        self._timeout = timeout if timeout else None
        self._sync = sync
        self._pending = collections.deque()
        self._replay = collections.deque()
        self._delivered = 0
        self._exhausted = False

    def _run(self, item):
        t0 = time.perf_counter()
        with profiler.op_scope("pipeline.map", cat="dataPipeline"):
            engine.fault_point("pipeline.map")
            out = self._fn(item)
        _stats.add("host_build_ms", (time.perf_counter() - t0) * 1e3)
        return out

    def _fill(self):
        while not self._exhausted and len(self._pending) < self._inflight:
            try:
                item = next(self._up)
            except StopIteration:
                self._exhausted = True
                break
            if self._sync:
                self._pending.append(_done_future(self._run(item)))
            else:
                self._pending.append(engine.push_host(self._run, item))

    def __next__(self):
        if self._replay:
            out = self._replay.popleft()
            self._delivered += 1
            self._fill()
            return out
        self._fill()
        if not self._pending:
            raise StopIteration
        fut = self._pending.popleft()
        try:
            out = fut.result(self._timeout)
        except concurrent.futures.TimeoutError:
            raise MXNetError(
                f"pipeline map timed out after {self._timeout}s waiting "
                f"for batch {self._delivered}: the map fn (dataset "
                "__getitem__ / batchify) is stuck or too slow — raise "
                "timeout=, or inspect that batch's samples") from None
        self._delivered += 1
        self._fill()
        return out

    def reset(self):
        for f in self._pending:  # drain: fns may touch shared state
            try:
                f.result()
            except Exception:
                pass
        super().reset()
        self._pending.clear()
        self._replay.clear()
        self._delivered = 0
        self._exhausted = False

    def state_dict(self):
        # in-flight waits honour the stage timeout: a stuck map fn must
        # fail a checkpoint loudly, not hang it
        try:
            drained = [f.result(self._timeout) for f in self._pending]
        except concurrent.futures.TimeoutError:
            raise MXNetError(
                f"pipeline state capture timed out after {self._timeout}s "
                "waiting for an in-flight map item: the map fn (dataset "
                "__getitem__ / batchify) is stuck — the checkpoint was "
                "NOT taken") from None
        buffered = list(self._replay) + drained
        return {"buffer": [_pack(v) for v in buffered],
                "delivered": self._delivered,
                "exhausted": self._exhausted}

    def load_state_dict(self, state):
        self._pending.clear()
        self._replay = collections.deque(
            _unpack(v) for v in state["buffer"])
        self._delivered = int(state["delivered"])
        self._exhausted = bool(state["exhausted"])


class BatchStage(Stage):
    """Group elements into batches.  With a ``bucket_spec`` (a
    ``serve.BucketSpec``) each batch is padded into the spec's closed shape
    grid, so a captured step sees one input signature a bucket (one CUDA
    graph each) over mixed-length data.

    ``last_batch``: 'keep' yields the partial tail, 'discard' drops it,
    'rollover' carries it into the next epoch (state: the remainder)."""

    def __init__(self, up, batch_size, last_batch="keep", batchify_fn=None,
                 bucket_spec=None):
        super().__init__(up)
        if last_batch not in ("keep", "discard", "rollover"):
            raise MXNetError(f"unknown last_batch {last_batch!r}")
        self._bs = int(batch_size)
        self._last = last_batch
        self._fn = batchify_fn or default_batchify
        self._spec = bucket_spec
        self._rollover = []

    def __next__(self):
        batch, self._rollover = self._rollover, []
        while len(batch) < self._bs:
            try:
                batch.append(next(self._up))
            except StopIteration:
                break
        if not batch:
            raise StopIteration
        if len(batch) < self._bs:
            if self._last == "discard":
                raise StopIteration
            if self._last == "rollover":
                self._rollover = batch
                raise StopIteration
        t0 = time.perf_counter()
        out = self._build(batch)
        _stats.add("host_build_ms", (time.perf_counter() - t0) * 1e3)
        return out

    def _build(self, batch):
        if self._spec is None:
            return self._fn(batch)
        # bucket padding: the FIRST component is the variable-shape array
        # the spec covers; the others ride along padded to the same
        # batch-bucket rows (dead rows hold zeros)
        first = [b[0] if isinstance(b, tuple) else b for b in batch]
        lengths = [self._spec.validate(_np(x)) for x in first]
        b, l = self._spec.pick(
            len(batch), max(lengths) if lengths[0] is not None else None)
        if b < len(batch):
            raise MXNetError(
                f"batch_size {len(batch)} exceeds the largest bucket "
                f"batch {self._spec.max_batch}; add a bucket entry")
        data = _host_array(self._spec.pad_batch(
            [_np(x) for x in first], b, l))
        if not isinstance(batch[0], tuple):
            return data
        rest = []
        for i in range(1, len(batch[0])):
            col = np.asarray([_np(x[i]) for x in batch])
            if col.dtype == np.float64:
                col = col.astype(np.float32)
            pad = np.zeros((b - col.shape[0],) + col.shape[1:], col.dtype)
            rest.append(_host_array(np.concatenate([col, pad])
                                    if b > col.shape[0] else col))
        return (data,) + tuple(rest)

    def reset(self):
        # rollover survives reset, matching gluon BatchSampler semantics
        super().reset()

    def state_dict(self):
        return {"rollover": [_pack(v) for v in self._rollover]}

    def load_state_dict(self, state):
        self._rollover = [_unpack(v) for v in state["rollover"]]


def _np(v):
    """numpy of an NDArray, tensor or array-like."""
    if isinstance(v, NDArray):
        return v.asnumpy()
    if isinstance(v, torch.Tensor):
        return NDArray(v).asnumpy()
    return np.asarray(v)


class RebatchStage(Stage):
    """Re-chunk incoming BATCHES (arrays / tuples of arrays / DataBatch)
    to a new leading-dim size: how ``DataIter`` sources with a baked-in
    batch size adapt to a pipeline's geometry.  Host-side: leaves are
    buffered as numpy rows; the state is the rollover remainder."""

    def __init__(self, up, batch_size, last_batch="keep"):
        super().__init__(up)
        if last_batch not in ("keep", "discard"):
            raise MXNetError(
                f"rebatch last_batch must be 'keep' or 'discard', "
                f"got {last_batch!r}")
        self._bs = int(batch_size)
        self._last = last_batch
        self._buf = None   # a list per leaf: numpy chunks
        self._rows = 0
        self._exhausted = False

    @staticmethod
    def _leaves(item):
        from ..io.io import DataBatch

        pad = 0
        if isinstance(item, DataBatch):
            pad = int(item.pad or 0)  # wrap-around rows are NOT samples
            item = tuple(item.data) + tuple(item.label or ())
        if not isinstance(item, (list, tuple)):
            item = (item,)
        out = [_np(v) for v in item]
        if pad:
            out = [v[:-pad] for v in out]
        return out

    def __next__(self):
        while self._rows < self._bs and not self._exhausted:
            try:
                leaves = self._leaves(next(self._up))
            except StopIteration:
                self._exhausted = True
                break
            if self._buf is None:
                self._buf = [[] for _ in leaves]
            if len(leaves) != len(self._buf):
                raise MXNetError(
                    f"rebatch saw {len(leaves)} leaves after "
                    f"{len(self._buf)}: upstream batches must share one "
                    "structure")
            for col, leaf in zip(self._buf, leaves):
                col.append(leaf)
            self._rows += leaves[0].shape[0]
        if self._rows == 0:
            raise StopIteration
        if self._rows < self._bs and self._last == "discard":
            self._rows = 0
            self._buf = None
            raise StopIteration
        n = min(self._bs, self._rows)
        outs, remain = [], []
        for col in self._buf:
            flat = np.concatenate(col) if len(col) > 1 else col[0]
            outs.append(_host_array(flat[:n], dtype=flat.dtype))
            remain.append([flat[n:]] if flat.shape[0] > n else [])
        self._buf = remain if any(r for r in remain) else None
        self._rows -= n
        out = tuple(outs)
        return out[0] if len(out) == 1 else out

    def reset(self):
        super().reset()
        self._buf = None
        self._rows = 0
        self._exhausted = False

    def state_dict(self):
        buf = None
        if self._buf is not None:
            buf = [[np.concatenate(c) if len(c) > 1 else c[0]]
                   if c else [] for c in self._buf]
        return {"buf": buf, "rows": self._rows,
                "exhausted": self._exhausted}

    def load_state_dict(self, state):
        self._buf = state["buf"]
        self._rows = int(state["rows"])
        self._exhausted = bool(state["exhausted"])


class ShardStage(Stage):
    """Per-replica partition of the element stream.

    Every rank pulls identical groups of ``num_replicas`` consecutive
    elements from its own (identically seeded) upstream and keeps element
    ``rank``.  The uneven-tail contract is deterministic and
    rank-symmetric: ``tail='drop'`` discards the partial group on EVERY
    rank (all ranks yield the same count); ``tail='pad'`` has each rank
    take element ``rank % len(partial)``, so all ranks still yield the
    same count, with tail elements reused."""

    def __init__(self, up, num_replicas, rank, tail="drop"):
        super().__init__(up)
        if num_replicas < 1 or not 0 <= rank < num_replicas:
            raise MXNetError(
                f"need 0 <= rank < num_replicas, got rank={rank} "
                f"num_replicas={num_replicas}")
        if tail not in ("drop", "pad"):
            raise MXNetError(f"shard tail must be 'drop' or 'pad', "
                             f"got {tail!r}")
        self._n = int(num_replicas)
        self._rank = int(rank)
        self._tail = tail

    def __next__(self):
        group = []
        for _ in range(self._n):
            try:
                group.append(next(self._up))
            except StopIteration:
                break
        if not group:
            raise StopIteration
        if len(group) < self._n:
            if self._tail == "drop":
                raise StopIteration
            return group[self._rank % len(group)]
        return group[self._rank]


class PrefetchToDeviceStage(Stage):
    """Device double-buffering: ``depth`` whole batches are pulled from
    upstream AND staged onto ``ctx`` ahead of the consumer.

    Each prefetch job runs on the engine's per-context ``h2d`` lane (one
    FIFO lane: upstream is only ever advanced there, serially), does the
    upstream pull, so host batch building also runs off the consumer
    thread, and lands every array of the batch through ONE
    ``engine.batched_put``: pinned staging, ``non_blocking`` copies on a
    copy stream and one event.  The consumer's current stream waits for
    that event when :meth:`__next__` hands the batch over, before anything
    reads it.  A CUDA ``ctx`` without a CUDA device raises at
    construction.

    The state is the prefetched-but-unconsumed batches, drained back to
    host; a restore stages them again through the same transfer path."""

    def __init__(self, up, ctx=None, depth=None, sync=False):
        super().__init__(up)
        self._ctx = ctx if isinstance(ctx, Context) else \
            (Context(ctx) if isinstance(ctx, str) else
             ctx or current_context())
        self._device = self._ctx.torch_device()  # raises without it
        self._depth = max(1, int(
            depth if depth is not None
            else getenv("PIPELINE_PREFETCH", 2, int)))
        self._sync = sync
        self._stream = engine.h2d_stream(self._ctx)
        self._pending = collections.deque()
        self._exhausted = False

    def _transfer(self, item):
        t0 = time.perf_counter()
        leaves = []
        spec = _flatten(item, leaves)
        staged = engine.batched_put(leaves, self._device, wait=False)
        out = _rebuild(spec, staged, self._ctx)
        _stats.add("h2d_ms", (time.perf_counter() - t0) * 1e3)
        return out, staged

    def _job(self):
        try:
            item = next(self._up)
        except StopIteration:
            return _EOS
        return self._transfer(item)

    def _fill(self):
        while not self._exhausted and len(self._pending) < self._depth:
            if self._sync:
                self._pending.append(_done_future(self._job()))
                if self._pending[-1].result() is _EOS:
                    break
            else:
                self._pending.append(self._stream.push(self._job))

    def __next__(self):
        self._fill()
        while self._pending:
            fut = self._pending.popleft()
            ready = fut.done()
            got = fut.result()
            if got is _EOS:
                self._exhausted = True
                continue  # a sentinel, not a batch: keep the hit ratio honest
            _stats.add("prefetch_hits" if ready else "prefetch_misses", 1)
            out, staged = got
            staged.wait()
            self._fill()
            return out
        raise StopIteration

    def reset(self):
        self._drain()
        super().reset()
        self._pending.clear()
        self._exhausted = False

    def _drain(self):
        for f in self._pending:
            try:
                got = f.result()
                if got is not _EOS:
                    got[1].wait()
            except Exception:
                pass

    def state_dict(self):
        # in-flight jobs advance upstream on the lane; waiting them out
        # quiesces it, so upstream state is stable to read
        buffered = []
        for f in self._pending:
            got = f.result()
            if got is not _EOS:
                got[1].wait()
                buffered.append(got[0])
        return {"buffer": [_pack(v) for v in buffered],
                "exhausted": self._exhausted}

    def load_state_dict(self, state):
        self._pending.clear()
        self._exhausted = bool(state["exhausted"])
        for v in state["buffer"]:  # staged again through the transfer path
            item = _unpack(v)
            if self._sync:
                self._pending.append(_done_future(self._transfer(item)))
            else:
                self._pending.append(self._stream.push(self._transfer,
                                                       item))


# ---------------------------------------------------------------------------
# the user-facing graph


class Pipeline:
    """Composable input pipeline over a Dataset / DataIter / iterable.

    ::

        pipe = (pipeline.Pipeline(dataset)
                .shuffle(1024, seed=7)
                .map(augment)
                .batch(32, bucket_spec=spec)
                .shard(num_replicas, rank)
                .prefetch_to_device(mx.gpu(0), depth=2))
        for data, label in pipe:      # one epoch; pipe.reset() for next
            ...

    A Pipeline is a single-pass stateful iterator: iterating continues
    from the current position (which is what makes a restored pipeline
    resume mid-epoch); :meth:`reset` starts a new epoch.
    ``state_dict()``/``load_state_dict()`` snapshot and restore every
    stage; ``checkpoint.CheckpointManager.save(..., pipeline=pipe)``
    persists it atomically beside parameters and trainer states.

    ``sync=True`` (or ``MXTPU_PIPELINE_SYNC=1``) makes every stage
    synchronous, the NaiveEngine-style debugging escape hatch.
    """

    def __init__(self, source, sync=None):
        self._sync = getenv("PIPELINE_SYNC", False, bool) \
            if sync is None else bool(sync)
        if isinstance(source, Stage):
            self._stages = [source]
        elif hasattr(source, "__getitem__") and hasattr(source, "__len__"):
            self._stages = [DatasetSource(source)]
        elif hasattr(source, "__iter__") or hasattr(source, "next"):
            self._stages = [IterableSource(source)]
        else:
            raise MXNetError(
                f"cannot build a pipeline from {type(source).__name__}: "
                "need a Dataset (__getitem__/__len__), a DataIter, or "
                "an iterable")

    @property
    def _tail(self):
        return self._stages[-1]

    def _add(self, stage):
        self._stages.append(stage)
        return self

    # -- stage builders ------------------------------------------------------

    def map(self, fn, inflight=None, timeout=None):
        """Apply ``fn`` per element on the host workers (ordered,
        ``inflight`` items ahead).  ``timeout`` (seconds) bounds the wait
        per element, raising an error naming the stuck index."""
        return self._add(MapStage(self._tail, fn, inflight=inflight,
                                  timeout=timeout, sync=self._sync))

    def shuffle(self, buffer_size, seed=0):
        """Seeded ring-buffer shuffle of ``buffer_size`` elements."""
        return self._add(ShuffleStage(self._tail, buffer_size, seed=seed))

    def batch(self, batch_size, last_batch="keep", batchify_fn=None,
              bucket_spec=None):
        """Group elements into batches; ``bucket_spec`` (a
        ``serve.BucketSpec``) pads into its closed shape grid."""
        return self._add(BatchStage(self._tail, batch_size,
                                    last_batch=last_batch,
                                    batchify_fn=batchify_fn,
                                    bucket_spec=bucket_spec))

    def rebatch(self, batch_size, last_batch="keep"):
        """Re-chunk incoming batches (e.g. a DataIter's) to a new
        leading-dim size, carrying remainders across inputs."""
        return self._add(RebatchStage(self._tail, batch_size,
                                      last_batch=last_batch))

    def shard(self, num_replicas, rank, tail="drop"):
        """Keep this replica's 1/num_replicas of the element stream
        (deterministic drop/pad contract for uneven tails)."""
        return self._add(ShardStage(self._tail, num_replicas, rank,
                                    tail=tail))

    def prefetch_to_device(self, ctx=None, depth=None):
        """Stage ``depth`` batches ahead onto ``ctx`` through one
        ``engine.batched_put`` each, on the context's h2d lane."""
        return self._add(PrefetchToDeviceStage(self._tail, ctx=ctx,
                                               depth=depth,
                                               sync=self._sync))

    # -- iteration -----------------------------------------------------------

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        item = next(self._tail)
        _stats.add("wait_ms", (time.perf_counter() - t0) * 1e3)
        _stats.add("batches", 1)
        return item

    def reset(self):
        """Rewind every stage for a new epoch (rollover remainders and the
        shuffle RNG stream carry over, by design)."""
        self._tail.reset()

    # -- state ---------------------------------------------------------------

    def state_dict(self):
        """Snapshot every stage's iterator state (source position, shuffle
        ring and RNG, rollover remainders, in-flight batches drained to
        host).  Capture runs tail first, so the async lanes are quiesced
        before upstream positions are read."""
        tail_first = [(type(s).__name__, s.state_dict())
                      for s in reversed(self._stages)]
        return {"version": 1,
                "stages": [{"type": t, "state": st}
                           for t, st in reversed(tail_first)]}

    def load_state_dict(self, state):
        """Restore into a freshly built, identically composed pipeline; the
        remaining stream replays bit-identically."""
        stages = state.get("stages")
        if state.get("version") != 1 or stages is None:
            raise MXNetError(
                f"unrecognized pipeline state (version="
                f"{state.get('version')!r}); was it saved by a newer "
                "build?")
        if len(stages) != len(self._stages) or any(
                s["type"] != type(mine).__name__
                for s, mine in zip(stages, self._stages)):
            raise MXNetError(
                "pipeline state does not match this pipeline's stages: "
                f"saved [{', '.join(s['type'] for s in stages)}] vs "
                f"built [{', '.join(type(s).__name__ for s in self._stages)}]"
                " — rebuild the pipeline with the same composition")
        for s, mine in zip(stages, self._stages):
            mine.load_state_dict(s["state"])
