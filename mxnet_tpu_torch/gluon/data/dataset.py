"""gluon.data datasets (ref: ``mxnet_tpu/gluon/data/dataset.py``)."""
from __future__ import annotations


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def transform(self, fn, lazy=True):
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        return self.transform(_TransformFirstClosure(fn), lazy)

    def filter(self, fn):
        return SimpleDataset([self[i] for i in range(len(self))
                              if fn(self[i])])

    def take(self, count):
        return SimpleDataset([self[i] for i in range(min(count, len(self)))])


class _TransformFirstClosure:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class SimpleDataset(Dataset):
    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class ArrayDataset(Dataset):
    """Zip of arrays/datasets (ref: gluon.data.ArrayDataset).  An NDArray
    argument is indexed on its own device (``vision.datasets`` keep theirs
    on ``cpu()``)."""

    def __init__(self, *args):
        assert len(args) > 0
        self._data = [_indexable(a) for a in args]
        self._length = len(self._data[0])
        for a in self._data:
            assert len(a) == self._length, "all arrays must be same length"

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)

    def __len__(self):
        return self._length


class _Rows:
    """Row access to an NDArray: ``rows[i]`` is row i as an NDArray on the
    array's context (the port's NDArray has no indexing operator yet)."""

    def __init__(self, arr):
        self._arr = arr

    def __len__(self):
        return self._arr.shape[0]

    def __getitem__(self, idx):
        from ...ndarray.ndarray import NDArray

        return NDArray(self._arr.data[idx], self._arr.context)


def _indexable(a):
    from ...ndarray.ndarray import NDArray

    return _Rows(a) if isinstance(a, NDArray) else a


class RecordFileDataset(Dataset):
    """Dataset over an indexed RecordIO file (ref: RecordFileDataset)."""

    def __init__(self, filename):
        import os

        from ...io import recordio as rio

        idx_file = os.path.splitext(filename)[0] + ".idx"
        self._record = rio.MXIndexedRecordIO(idx_file, filename, "r")

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)
