"""Data iterators (ref: ``mxnet_tpu/io/io.py``; src/io/ and
python/mxnet/io/io.py).

The DataIter/DataBatch API is kept exactly.  An iterator's batches are
NDArrays on the context that was current where it was built (the
innermost ``with mx.cpu():`` or ``with mx.gpu(i):``, else ``gpu(0)``),
as the JAX package puts them on its default device; the port's default
context is per thread, so a batch pulled on a worker thread
(``PrefetchingIter``, a pipeline's lanes) lands on the context the
iterator was built in.  The arrays the iterators read from stay in host
memory.  ``DataIter.as_pipeline`` adapts any iterator into the pipeline
tier.  ``ImageRecordIter`` decodes JPEG records on the host, through the
native C++ pipeline or PIL, into pinned staging blocks, and copies each
batch to its device on a copy stream.
"""
from __future__ import annotations

import logging
import os
import struct

import numpy as np

from .. import engine
from ..base import MXNetError
from ..ndarray import ndarray as _nd
from ..ndarray.ndarray import NDArray


class DataDesc:
    def __init__(self, name, shape, dtype=np.float32, layout="NCHW"):
        self.name = name
        self.shape = tuple(shape)
        self.dtype = dtype
        self.layout = layout

    def __repr__(self):
        return f"DataDesc[{self.name},{self.shape},{self.dtype}]"


class DataBatch:
    """One batch (ref: mx.io.DataBatch)."""

    def __init__(self, data, label=None, pad=0, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


def _built_ctx():
    """The innermost ``with`` context of the calling thread, or None (the
    default context, resolved when a batch is made)."""
    from .. import context

    stack = getattr(context._default, "stack", None)
    return stack[-1] if stack else None


class DataIter:
    """Base iterator (ref: mx.io.DataIter)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size
        self._ctx = _built_ctx()

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(self.getdata(), self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        return 0

    def as_pipeline(self):
        """Adapt this iterator into the pipeline tier
        (``mxnet_tpu_torch.pipeline``): downstream stages — ``rebatch`` to a
        new batch geometry, ``shard``, ``prefetch_to_device`` — compose
        over the emitted DataBatch stream.  Iterators exposing
        ``state_dict``/``load_state_dict`` (``NDArrayIter``) resume
        exactly from a checkpoint; others replay (reset + skip)."""
        from ..pipeline import Pipeline

        return Pipeline(self)


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays (ref: mx.io.NDArrayIter)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, False, data_name)
        self.label = _init_data(label, True, label_name)
        self.num_data = self.data[0][1].shape[0] if self.data else 0
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.cursor = -batch_size
        self._order = np.arange(self.num_data)
        if shuffle:
            # draw from the framework's seeded RNG, not numpy's global
            # stream: mx.random.seed() makes shuffled epochs reproducible
            # and get_state/set_state (the checkpoint RNG snapshot)
            # captures the permutation source
            from .. import random as _random

            _random.np_rng().shuffle(self._order)
        if last_batch_handle == "discard":
            self.num_batches = self.num_data // batch_size
        else:
            self.num_batches = (self.num_data + batch_size - 1) // batch_size

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        self.cursor = -self.batch_size
        if self.shuffle:
            from .. import random as _random

            _random.np_rng().shuffle(self._order)

    def state_dict(self):
        """Exact mid-epoch iterator state: cursor + the epoch's (possibly
        shuffled) permutation — a pipeline ``IterableSource`` delegates
        here so a checkpoint-restored stream replays bit-identically
        without replay-skipping or touching the global RNG."""
        return {"cursor": int(self.cursor), "order": self._order.copy()}

    def load_state_dict(self, state):
        self.cursor = int(state["cursor"])
        self._order = np.asarray(state["order"])

    def iter_next(self):
        self.cursor += self.batch_size
        if self.last_batch_handle == "discard":
            return self.cursor + self.batch_size <= self.num_data
        return self.cursor < self.num_data

    def _take(self, arrays):
        end = self.cursor + self.batch_size
        idx = self._order[self.cursor:min(end, self.num_data)]
        if end > self.num_data and self.last_batch_handle == "pad":
            pad = end - self.num_data
            idx = np.concatenate([idx, self._order[:pad]])
        out = []
        for _, v in arrays:
            out.append(_nd.array(v[idx], ctx=self._ctx))
        return out

    def getdata(self):
        return self._take(self.data)

    def getlabel(self):
        return self._take(self.label)

    def getpad(self):
        end = self.cursor + self.batch_size
        if self.last_batch_handle == "pad" and end > self.num_data:
            return end - self.num_data
        return 0


def _init_data(data, allow_empty, default_name):
    if data is None:
        return []
    if isinstance(data, (np.ndarray, NDArray)):
        data = {default_name: data}
    if isinstance(data, (list, tuple)):
        data = {f"{default_name}_{i}" if i else default_name: d
                for i, d in enumerate(data)}
    out = []
    for k, v in data.items():
        if isinstance(v, NDArray):
            v = v.asnumpy()
        out.append((k, np.asarray(v)))
    return out


def _check_partition(num_parts, part_index):
    """Validate the dist-worker sharding pair (ref: every C++ iter's
    num_parts/part_index params)."""
    if num_parts < 1 or not (0 <= part_index < num_parts):
        raise MXNetError(
            f"need 0 <= part_index < num_parts, got part_index="
            f"{part_index} num_parts={num_parts}")


def _partition_range(n, num_parts, part_index):
    """Contiguous [start, end) record range for this worker, matching the
    reference's proportional split (ref: iter_mnist.cc GetPart — start =
    n/num_parts*part_index, end = n/num_parts*(part_index+1)).  Computed
    in exact integer arithmetic rather than the reference's double cast:
    float rounding can drop the final row entirely (e.g. n=15, parts=11:
    int(15/11*11) == 14), and no worker owning a record is worse than a
    one-off boundary shift."""
    start = n * part_index // num_parts
    end = n * (part_index + 1) // num_parts
    return start, end


class MNISTIter(DataIter):
    """Reads the classic idx-ubyte MNIST files (ref: src/io/iter_mnist.cc)."""

    def __init__(self, image, label, batch_size=128, shuffle=True,
                 flat=False, seed=0, silent=False, data_name="data",
                 label_name="softmax_label", num_parts=1, part_index=0,
                 **kwargs):
        super().__init__(batch_size)
        _check_partition(num_parts, part_index)
        self._images = _read_idx_images(image)
        self._labels = _read_idx_labels(label)
        if self._images.shape[0] != self._labels.shape[0]:
            raise MXNetError("MNIST image/label count mismatch")
        if num_parts > 1:
            # dist-worker shard: contiguous range, matching the reference's
            # proportional split (ref: iter_mnist.cc GetPart)
            s, e = _partition_range(self._images.shape[0], num_parts,
                                    part_index)
            self._images = self._images[s:e]
            self._labels = self._labels[s:e]
        if flat:
            self._images = self._images.reshape(self._images.shape[0], -1)
        else:
            self._images = self._images[:, None, :, :]  # NCHW
        self._images = self._images.astype(np.float32) / 255.0
        self._iter = NDArrayIter(
            {data_name: self._images}, {label_name: self._labels},
            batch_size=batch_size, shuffle=shuffle,
            last_batch_handle="discard")

    @property
    def provide_data(self):
        return self._iter.provide_data

    @property
    def provide_label(self):
        return self._iter.provide_label

    def reset(self):
        self._iter.reset()

    def next(self):
        return self._iter.next()

    def iter_next(self):
        return self._iter.iter_next()


def _read_idx_images(path):
    import gzip

    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise MXNetError(f"{path}: bad MNIST image magic {magic}")
        # a writable copy: torch refuses to wrap read-only memory
        return np.frombuffer(f.read(n * rows * cols),
                             dtype=np.uint8).reshape(n, rows, cols).copy()


def _read_idx_labels(path):
    import gzip

    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise MXNetError(f"{path}: bad MNIST label magic {magic}")
        return np.frombuffer(f.read(n), dtype=np.uint8).astype(np.float32)


class CSVIter(DataIter):
    """Ref: src/io/iter_csv.cc."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, num_parts=1, part_index=0,
                 **kwargs):
        super().__init__(batch_size)
        _check_partition(num_parts, part_index)
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32,
                          ndmin=2)
        data = data.reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32,
                               ndmin=2).reshape((-1,) + tuple(label_shape))
        else:
            label = np.zeros((data.shape[0], 1), np.float32)
        if num_parts > 1:
            # dist-worker shard: contiguous range like the reference C++
            # iterator (ref: iter_csv.cc InputSplit partitioning)
            s, e = _partition_range(data.shape[0], num_parts, part_index)
            data = data[s:e]
            label = label[s:e]
        self._iter = NDArrayIter(data, label, batch_size=batch_size,
                                 last_batch_handle="pad" if round_batch
                                 else "discard")

    @property
    def provide_data(self):
        return self._iter.provide_data

    @property
    def provide_label(self):
        return self._iter.provide_label

    def reset(self):
        self._iter.reset()

    def next(self):
        return self._iter.next()


class LibSVMIter(DataIter):
    """Sparse batches from libsvm-format text (ref: src/io/iter_libsvm.cc).

    Each batch's data is a ``ndarray.sparse.CSRNDArray`` on
    ``current_context()``."""

    def __init__(self, data_libsvm, data_shape, label_libsvm=None,
                 label_shape=None, batch_size=1, round_batch=True,
                 num_parts=1, part_index=0, **kwargs):
        super().__init__(batch_size)
        _check_partition(num_parts, part_index)
        self._num_features = int(
            data_shape[0] if isinstance(data_shape, (tuple, list))
            else data_shape)
        self._label_shape = (tuple(label_shape)
                             if label_shape is not None else ())
        vals, cols, indptr, labels = [], [], [0], []
        with open(data_libsvm) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                labels.append(self._parse_labels(parts))
                for tok in parts[len(labels[-1]):]:
                    i, v = tok.split(":")
                    cols.append(int(i))
                    vals.append(float(v))
                indptr.append(len(vals))
        self._vals = np.asarray(vals, np.float32)
        self._cols = np.asarray(cols, np.int64)
        self._indptr = np.asarray(indptr, np.int64)
        if label_libsvm is not None:
            labels = [self._parse_labels(line.split())
                      for line in open(label_libsvm) if line.split()]
        self._labels = np.asarray(labels, np.float32)
        if self._label_shape:
            self._labels = self._labels.reshape(
                (-1,) + self._label_shape)
        else:
            self._labels = self._labels.reshape(-1)
        self._n = len(self._labels)
        if self._n != len(self._indptr) - 1:
            raise MXNetError(
                f"libsvm label/data row mismatch: {self._n} labels vs "
                f"{len(self._indptr) - 1} data rows")
        if num_parts > 1:
            # dist-worker shard: contiguous CSR row range like the
            # reference (ref: iter_libsvm.cc InputSplit partitioning)
            _s, _e = _partition_range(self._n, num_parts, part_index)
            keep = np.arange(self._n)[_s:_e]
            starts, ends = self._indptr[keep], self._indptr[keep + 1]
            lens = ends - starts
            # vectorized per-row index expansion (no python-level loop)
            take = (np.repeat(starts - np.concatenate(
                [[0], np.cumsum(lens[:-1])]), lens)
                    + np.arange(lens.sum())) if len(keep) \
                else np.empty((0,), np.int64)
            self._vals = self._vals[take]
            self._cols = self._cols[take]
            self._indptr = np.concatenate(
                [[0], np.cumsum(lens)]).astype(np.int64)
            self._labels = self._labels[keep]
            self._n = len(keep)
        self._round_batch = round_batch
        self._cursor = 0

    def _parse_labels(self, parts):
        """Leading ':'-free tokens are label components (libsvm multi-label
        extension; ref: iter_libsvm.cc label_width)."""
        want = int(np.prod(self._label_shape)) if self._label_shape else 1
        out = []
        for tok in parts:
            if ":" in tok or len(out) >= want:
                break
            out.append(float(tok))
        if len(out) != want:
            raise MXNetError(
                f"libsvm line has {len(out)} label values, "
                f"label_shape {self._label_shape or (1,)} wants {want}")
        return out

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size, self._num_features))]

    @property
    def provide_label(self):
        return [DataDesc("label",
                         (self.batch_size,) + self._label_shape)]

    def reset(self):
        self._cursor = 0

    def next(self):
        from ..ndarray import sparse

        if self._cursor >= self._n:
            raise StopIteration
        start = self._cursor
        stop = min(start + self.batch_size, self._n)
        self._cursor += self.batch_size
        idx = np.arange(start, stop)
        if stop - start < self.batch_size:
            if not self._round_batch:
                raise StopIteration
            # wrap around (ref: round_batch pads from the beginning);
            # modulo keeps pad valid even when batch_size > dataset size
            idx = np.concatenate(
                [idx,
                 np.arange(self.batch_size - (stop - start)) % self._n])
        # slice csr rows
        vals, cols, indptr = [], [], [0]
        for r in idx:
            lo, hi = self._indptr[r], self._indptr[r + 1]
            vals.append(self._vals[lo:hi])
            cols.append(self._cols[lo:hi])
            indptr.append(indptr[-1] + (hi - lo))
        data = sparse.csr_matrix(
            (np.concatenate(vals) if vals else np.zeros(0, np.float32),
             np.concatenate(cols) if cols else np.zeros(0, np.int64),
             np.asarray(indptr)),
            shape=(self.batch_size, self._num_features),
            ctx=self._ctx)
        label = _nd.array(self._labels[idx], ctx=self._ctx)
        pad = self.batch_size - (stop - start)
        return DataBatch(data=[data], label=[label], pad=pad)


class ImageRecordIter(DataIter):
    """ImageNet-style packed-record pipeline (ref: ``mxnet_tpu/io/io.py``;
    iter_image_recordio_2.cc).  Batches are NCHW float32 NDArrays on the
    context the iterator was built in (else ``gpu(0)``; a CUDA context
    without a CUDA device raises here).

    Two decode lanes, decided once at construction (``lane``, with the
    reason in ``lane_reason``, logged):

    - ``"native"``: the C++ pipeline of ``lib/libmxtpu_io.so``
      (``utils.native``), taken when the library loads, the records are
      indexed and JPEG, and ``use_native`` is not False.  Its own
      ``preprocess_threads`` workers decode whole batches.
    - ``"python"``: PIL and numpy on the host pool, a batch a job, each
      batch drawing its augmentation seed from the iterator's
      ``RandomState(seed)`` when it is enqueued, so a batch is the same
      whatever thread decodes it.  A record whose header or image is
      corrupt gives zeros (the native lane's rule); any other exception
      reaches the consumer.

    ``use_native=True`` raises when the native lane is not taken.  Both
    lanes decode into one staging block of ``storage.Storage`` (pinned for
    a CUDA context) holding the batch and its labels; the block is copied
    to the device on ``engine.copy_stream`` and goes back to the pool only
    once the copy's event has completed; the consumer's stream waits for
    that event before it reads the batch.  ``prefetch_buffer`` batches are
    in flight, which bounds the staging memory."""

    def __init__(self, path_imgrec, data_shape, batch_size=1,
                 path_imgidx=None, shuffle=False, rand_crop=False,
                 rand_mirror=False, mean_r=0.0, mean_g=0.0, mean_b=0.0,
                 std_r=1.0, std_g=1.0, std_b=1.0, resize=-1,
                 label_width=1, preprocess_threads=4, prefetch_buffer=2,
                 round_batch=True, seed=0, use_native=None,
                 random_resized_crop=False, min_random_area=1.0,
                 max_random_area=1.0, min_aspect_ratio=1.0,
                 max_aspect_ratio=1.0, brightness=0.0, contrast=0.0,
                 saturation=0.0, random_h=0.0, inter_method=1,
                 num_parts=1, part_index=0, **kwargs):
        from .. import context
        from . import recordio as rio

        super().__init__(batch_size)
        _check_partition(num_parts, part_index)
        self._ctx = self._ctx or context.current_context()
        self._device = self._ctx.torch_device()
        self._num_parts, self._part_index = num_parts, part_index
        # augmentation tier (ref: image_aug_default.cc —
        # max_random_area/max_aspect_ratio sampled crops, HSL jitter,
        # inter_method choices)
        self.aug = dict(
            random_resized_crop=bool(random_resized_crop),
            min_random_area=float(min_random_area),
            max_random_area=float(max_random_area),
            min_aspect_ratio=float(min_aspect_ratio),
            max_aspect_ratio=float(max_aspect_ratio),
            brightness=float(brightness), contrast=float(contrast),
            saturation=float(saturation), random_h=float(random_h),
            inter_method=int(inter_method))
        self.data_shape = tuple(data_shape)
        idx_path = path_imgidx or os.path.splitext(path_imgrec)[0] + ".idx"
        if os.path.exists(idx_path):
            self._rec = rio.MXIndexedRecordIO(idx_path, path_imgrec, "r")
            # dist-worker shard: every num_parts-th record (ref:
            # iter_image_recordio_2.cc num_parts/part_index)
            self._keys = list(self._rec.keys)[part_index::num_parts]
        else:
            self._rec = rio.MXRecordIO(path_imgrec, "r")
            self._keys = None
            self._stream_count = 0
        self.shuffle = shuffle
        self.rand_crop = rand_crop
        self.rand_mirror = rand_mirror
        self.resize = resize
        self.mean = np.array([mean_r, mean_g, mean_b], np.float32)
        self.std = np.array([std_r, std_g, std_b], np.float32)
        self._rng = np.random.RandomState(seed)
        self._order = None
        self._pos = 0
        self._prefetch = []
        self._prefetch_depth = max(1, prefetch_buffer)
        self._native = None
        self.lane, self.lane_reason = "python", self._python_reason(
            use_native)
        if self.lane_reason is None:
            from ..utils import native as native_mod

            offsets = [self._rec.idx[k] for k in self._keys]
            self._native = native_mod.NativeImagePipeline(
                path_imgrec, offsets, self.data_shape, batch_size,
                num_threads=preprocess_threads, shuffle=shuffle,
                rand_crop=rand_crop, rand_mirror=rand_mirror,
                resize_short=resize, mean=self.mean, std=self.std,
                seed=seed, **self.aug)
            self._lane = engine.stream_manager().get(self._ctx, "io")
            self.lane = "native"
            self.lane_reason = "libmxtpu_io.so loaded; indexed JPEG records"
        elif use_native is True:
            raise MXNetError(f"ImageRecordIter: native pipeline requested "
                             f"but unavailable: {self.lane_reason}")
        logging.getLogger(__name__).info(
            "ImageRecordIter(%s): the %s decode lane (%s)", path_imgrec,
            self.lane, self.lane_reason)
        self.reset()

    def _python_reason(self, use_native):
        """Why the Python lane must run, or None when the native one can."""
        if use_native is False:
            return "use_native=False"
        if self._keys is None:
            return "no .idx index beside the records"
        from ..utils import native as native_mod

        if native_mod.load() is None:
            return f"native IO library unavailable: {native_mod.load_error()}"
        if not self._records_are_jpeg():
            return "the records are not JPEG"
        return None

    def _records_are_jpeg(self):
        from . import recordio as rio

        try:
            rec = self._rec.read_idx(self._keys[0])
            _, payload = rio.unpack(rec)
            return payload[:2] == b"\xff\xd8"
        except Exception:
            return False

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        return [DataDesc("softmax_label", (self.batch_size,))]

    def _drain_prefetch(self):
        """Wait out in-flight batches (epoch reset / del); each job frees
        its staging block itself."""
        for fut in self._prefetch:
            if fut is None:
                continue
            try:
                fut.result()
            except Exception:
                pass
        self._prefetch = []

    def reset(self):
        self._drain_prefetch()
        if self._native is not None:
            self._native.reset()
        else:
            self._pos = 0
            if self._keys is not None:
                self._order = list(self._keys)
                if self.shuffle:
                    self._rng.shuffle(self._order)
            else:
                self._rec.reset()
                self._stream_count = 0
        for _ in range(self._prefetch_depth):
            self._enqueue()

    def __del__(self):
        try:
            self._drain_prefetch()
        except Exception:
            pass

    def _read_raw(self):
        if self._keys is not None:
            if self._pos >= len(self._order):
                return None
            rec = self._rec.read_idx(self._order[self._pos])
        else:
            # streaming (no .idx): modulo-skip to this worker's shard
            while True:
                rec = self._rec.read()
                if rec is None:
                    return None
                mine = (self._stream_count % self._num_parts
                        == self._part_index)
                self._stream_count += 1
                if mine:
                    break
        self._pos += 1
        return rec

    def _enqueue(self):
        if self._native is not None:
            # one lane: the C++ pipeline hands its batches out in order
            self._prefetch.append(self._lane.push(self._native_batch))
            return
        recs = []
        for _ in range(self.batch_size):
            r = self._read_raw()
            if r is None:
                break
            recs.append(r)
        if len(recs) < self.batch_size:
            self._prefetch.append(None)
            return
        self._prefetch.append(engine.push_host(
            self._python_batch, recs, self._rng.randint(1 << 30)))

    def _block(self, n):
        """A staging block for ``n`` images and their labels, and float32
        numpy views of both."""
        from ..storage import Storage

        c, h, w = self.data_shape
        handle = Storage.get().alloc(n * (c * h * w + 1) * 4, ctx=self._ctx)
        flat = handle.as_numpy(np.float32)
        return handle, flat[:n * c * h * w].reshape(n, c, h, w), \
            flat[n * c * h * w:]

    def _python_batch(self, recs, seed):
        return self._upload(self._decode_batch(recs, seed), len(recs))

    def _native_batch(self):
        from ..storage import Storage

        handle, data, labels = self._block(self.batch_size)
        try:
            n = self._native.next_into(data.ctypes.data, labels.ctypes.data)
        except BaseException:
            Storage.get().free(handle)
            raise
        if n == 0:
            Storage.get().free(handle)
            return None
        return self._upload(handle, self.batch_size)

    def _decode_batch(self, recs, seed):
        """Decode and augment ``recs`` into a staging block; returns the
        handle (the batch, then its labels)."""
        import io as _io

        from PIL import Image

        from ..storage import Storage
        from . import recordio as rio

        rng = np.random.RandomState(seed)
        c = self.data_shape[0]
        handle, data, labels = self._block(len(recs))
        try:
            for i, rec in enumerate(recs):
                # two-stage parse mirroring native DecodeOne: a label
                # that survives header parsing is kept even when the
                # image bytes are corrupt; only header corruption zeroes
                # the label too
                try:
                    header, payload = rio.unpack(rec)
                    if (header.flag > 0
                            and np.size(header.label) != header.flag):
                        # truncated label vector: native DecodeOne's
                        # skip>rec.size() check zeroes both — match it
                        raise ValueError("truncated label vector")
                    labels[i] = header.label if np.isscalar(header.label) \
                        else header.label[0]
                except Exception:
                    labels[i] = 0.0
                    data[i] = 0.0
                    continue
                try:
                    img = Image.open(_io.BytesIO(payload))
                    img = np.asarray(img.convert("RGB" if c == 3
                                                 else "L"))
                except Exception:
                    data[i] = 0.0
                    continue
                img = self._augment(img, rng)
                if img.ndim == 2:
                    img = img[:, :, None]
                chw = img.transpose(2, 0, 1).astype(np.float32)
                chw -= self.mean[:c, None, None]
                chw /= self.std[:c, None, None]
                data[i] = chw
        except BaseException:
            Storage.get().free(handle)
            raise
        return handle

    def _upload(self, handle, n):
        """The staged batch on the iterator's device: copied on the
        device's copy stream with an event recorded after it (the block
        returns to the pool once the event has completed), or copied out
        of the block on the CPU.  Returns a ``StagedBatch`` (data,
        labels)."""
        import torch

        from ..storage import Storage

        c, h, w = self.data_shape
        flat = handle.tensor(torch.float32, (n * (c * h * w + 1),))
        views = (flat[:n * c * h * w].view(n, c, h, w), flat[n * c * h * w:])
        out = engine.StagedBatch()
        out.device = self._device
        store = Storage.get()
        if self._device.type != "cuda":
            out.extend(v.clone() for v in views)
            store.free(handle)
            return out
        stream = engine.copy_stream(self._device)
        try:
            with torch.cuda.stream(stream):
                for v in views:
                    dst = torch.empty(v.shape, dtype=v.dtype,
                                      device=self._device)
                    dst.copy_(v, non_blocking=True)
                    out.append(dst)
                ev = torch.cuda.Event()
                ev.record(stream)
        except BaseException:
            stream.synchronize()
            store.free(handle)
            raise
        out.event = ev
        store.free(handle, after=ev)
        return out

    def _augment(self, img, rng):
        from PIL import Image

        c, h, w = self.data_shape
        aug = self.aug
        interp = Image.NEAREST if self._pick_inter(rng) == 0 \
            else Image.BILINEAR
        if aug["random_resized_crop"]:
            ih, iw = img.shape[:2]
            for _ in range(10):
                area = rng.uniform(aug["min_random_area"],
                                   aug["max_random_area"]) * ih * iw
                ar = np.exp(rng.uniform(
                    np.log(aug["min_aspect_ratio"]),
                    np.log(aug["max_aspect_ratio"])))
                tw = int(round(np.sqrt(area * ar)))
                th = int(round(np.sqrt(area / ar)))
                if 0 < tw <= iw and 0 < th <= ih:
                    x0 = rng.randint(0, iw - tw + 1)
                    y0 = rng.randint(0, ih - th + 1)
                    img = img[y0:y0 + th, x0:x0 + tw]
                    break
            else:
                s = min(ih, iw)
                img = img[(ih - s) // 2:(ih - s) // 2 + s,
                          (iw - s) // 2:(iw - s) // 2 + s]
            img = np.asarray(Image.fromarray(img).resize((w, h), interp))
        else:
            if self.resize > 0:
                pil = Image.fromarray(img)
                short = min(pil.size)
                scale = self.resize / short
                pil = pil.resize((max(w, int(pil.size[0] * scale)),
                                  max(h, int(pil.size[1] * scale))),
                                 interp)
                img = np.asarray(pil)
            ih, iw = img.shape[:2]
            if ih < h or iw < w:
                pil = Image.fromarray(img).resize((max(w, iw), max(h, ih)),
                                                  interp)
                img = np.asarray(pil)
                ih, iw = img.shape[:2]
            if self.rand_crop:
                y0 = rng.randint(0, ih - h + 1)
                x0 = rng.randint(0, iw - w + 1)
            else:
                y0, x0 = (ih - h) // 2, (iw - w) // 2
            img = img[y0:y0 + h, x0:x0 + w]
        if self.rand_mirror and rng.rand() < 0.5:
            img = img[:, ::-1]
        return self._color_jitter(img, rng)

    def _pick_inter(self, rng):
        m = self.aug["inter_method"]
        if m in (9, 10):  # reference: random interpolation choice
            return int(rng.randint(0, 2))
        return m

    def _color_jitter(self, img, rng):
        """brightness -> contrast -> saturation -> hue, matching the
        native pipeline's fused matrix (see src/recordio.cc)."""
        aug = self.aug
        if img.ndim != 3 or img.shape[2] != 3 or not any(
                aug[k] > 0 for k in ("brightness", "contrast",
                                     "saturation", "random_h")):
            return img
        v = img.astype(np.float32)
        gw = np.array([0.299, 0.587, 0.114], np.float32)
        if aug["brightness"] > 0:
            v = v * (1.0 + rng.uniform(-1, 1) * aug["brightness"])
        if aug["contrast"] > 0:
            ac = 1.0 + rng.uniform(-1, 1) * aug["contrast"]
            gray = (v @ gw).mean()
            v = ac * v + (1 - ac) * gray
        if aug["saturation"] > 0:
            asat = 1.0 + rng.uniform(-1, 1) * aug["saturation"]
            gray = (v @ gw)[..., None]
            v = asat * v + (1 - asat) * gray
        if aug["random_h"] > 0:
            theta = rng.uniform(-1, 1) * aug["random_h"] / 180.0 * np.pi
            cs, sn = np.cos(theta), np.sin(theta)
            H = np.array(
                [[0.299 + 0.701 * cs + 0.168 * sn,
                  0.587 - 0.587 * cs + 0.330 * sn,
                  0.114 - 0.114 * cs - 0.497 * sn],
                 [0.299 - 0.299 * cs - 0.328 * sn,
                  0.587 + 0.413 * cs + 0.035 * sn,
                  0.114 - 0.114 * cs + 0.292 * sn],
                 [0.299 - 0.300 * cs + 1.25 * sn,
                  0.587 - 0.588 * cs - 1.05 * sn,
                  0.114 + 0.886 * cs - 0.203 * sn]], np.float32)
            v = v @ H.T
        return np.clip(v, 0, 255).astype(np.uint8)

    def next(self):
        if not self._prefetch:
            raise StopIteration
        fut = self._prefetch.pop(0)
        if fut is None:
            raise StopIteration
        staged = fut.result()
        if staged is None:  # the native lane's end of epoch
            raise StopIteration
        self._enqueue()
        data, labels = staged.wait()
        return DataBatch([NDArray(data, self._ctx)],
                         [NDArray(labels, self._ctx)],
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)

    def iter_next(self):
        if self._native is not None:
            return True  # native queue signals end via next()
        return bool(self._prefetch) and self._prefetch[0] is not None


class PrefetchingIter(DataIter):
    """Wrap an iter with async prefetch (ref: src/io/iter_prefetcher.h)."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        self._iter = iters if isinstance(iters, DataIter) else iters[0]
        super().__init__(self._iter.batch_size)
        self._fut = None
        self._prime()

    @property
    def provide_data(self):
        return self._iter.provide_data

    @property
    def provide_label(self):
        return self._iter.provide_label

    def _prime(self):
        def _pull():
            try:
                return self._iter.next()
            except StopIteration:
                return None

        self._fut = engine.push_host(_pull)

    def reset(self):
        if self._fut is not None:
            self._fut.result()
        self._iter.reset()
        self._prime()

    def next(self):
        batch = self._fut.result()
        if batch is None:
            raise StopIteration
        self._prime()
        return batch


class ResizeIter(DataIter):
    """Cap an iterator at `size` batches (ref: mx.io.ResizeIter)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def next(self):
        if self.cur >= self.size:
            raise StopIteration
        self.cur += 1
        try:
            return self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            return self.data_iter.next()
