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
tier.  ``ImageRecordIter`` and
``ImageDetRecordIter`` decode JPEG records through the image tier and the
native decode pipeline, which come with slice 8, part 2: they raise.
"""
from __future__ import annotations

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


def _image_tier(name):
    return MXNetError(
        f"{name} decodes JPEG records through the image tier (image/) and "
        "the native decode pipeline, which come with slice 8, part 2 of "
        "the port (ROADMAP.md queue 1); read decoded arrays through "
        "gluon.data (ArrayDataset, vision.MNIST/CIFAR10) or NDArrayIter")


class ImageRecordIter(DataIter):
    """Ref: mx.io.ImageRecordIter (src/io/iter_image_recordio_2.cc): comes
    with slice 8, part 2 of the port."""

    def __init__(self, *args, **kwargs):
        raise _image_tier("ImageRecordIter")


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
