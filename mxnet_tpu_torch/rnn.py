"""Legacy mx.rnn module (ref: mxnet_tpu/rnn.py, after python/mxnet/rnn/:
io.py, rnn_cell.py).

The legacy cell names are the gluon cells (``gluon/rnn/rnn_cell.py``),
re-exported here; this module adds ``BucketSentenceIter``, the bucketed
data path of the reference's sequence-length scaling (one input
signature, so one captured graph, per bucket).  Its shuffles make the
same calls of Python's ``random`` in the same order as the JAX
package's, so one ``random.seed`` gives the same batches.
"""
from __future__ import annotations

import random as _pyrandom

import numpy as np

from .base import MXNetError
from .io.io import DataBatch, DataDesc, DataIter

# legacy cell names (ref: mx.rnn.LSTMCell etc.)
from .gluon.rnn import (RNNCell, LSTMCell, GRUCell,  # noqa: F401
                        SequentialRNNCell, DropoutCell, ResidualCell,
                        ModifierCell, ZoneoutCell)


class BucketSentenceIter(DataIter):
    """Bucketed iterator over variable-length id sequences
    (ref: python/mxnet/rnn/io.py BucketSentenceIter).

    Sentences are assigned to the smallest bucket that fits, padded to
    the bucket length, and batches are drawn bucket-by-bucket; each
    DataBatch carries ``bucket_key`` + per-bucket provide_data/label.
    Its arrays are NDArrays on :func:`current_context` (``with mx.cpu():``
    for the CPU)."""

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label", dtype="float32",
                 layout="NT"):
        super().__init__(batch_size)
        if not buckets:
            lens = np.bincount([len(s) for s in sentences])
            buckets = [i for i, n in enumerate(lens)
                       if n >= batch_size]
            if not buckets:
                buckets = [max(len(s) for s in sentences)]
        buckets = sorted(buckets)
        self.buckets = buckets
        self.data_name, self.label_name = data_name, label_name
        self.dtype = dtype
        self.invalid_label = invalid_label
        self.layout = layout
        if layout not in ("NT", "TN"):
            raise MXNetError(f"unsupported layout {layout!r}")

        self.data = [[] for _ in buckets]
        ndiscard = 0
        for s in sentences:
            buck = np.searchsorted(buckets, len(s))
            if buck == len(buckets):
                ndiscard += 1
                continue
            buff = np.full((buckets[buck],), invalid_label, dtype=dtype)
            buff[:len(s)] = s
            self.data[buck].append(buff)
        self.data = [np.asarray(x, dtype=dtype) for x in self.data]
        if ndiscard:
            import logging

            logging.warning("discarded %d sentences longer than the "
                            "largest bucket", ndiscard)
        self.major_axis = layout.find("N")
        self.reset()

    @property
    def provide_data(self):
        # largest bucket (ref: default_bucket_key binds the biggest shape)
        return [DataDesc(self.data_name, self._shape(max(self.buckets)),
                         layout=self.layout)]

    @property
    def provide_label(self):
        return [DataDesc(self.label_name, self._shape(max(self.buckets)),
                         layout=self.layout)]

    @property
    def default_bucket_key(self):
        return max(self.buckets)

    def _shape(self, seq_len):
        return ((self.batch_size, seq_len) if self.major_axis == 0
                else (seq_len, self.batch_size))

    def reset(self):
        self.curr_idx = 0
        self._plan = []
        for i, buck in enumerate(self.data):
            if len(buck) == 0:
                continue
            idx = list(range(len(buck)))
            _pyrandom.shuffle(idx)
            for start in range(0, len(idx) - self.batch_size + 1,
                               self.batch_size):
                self._plan.append((i, idx[start:start + self.batch_size]))
        _pyrandom.shuffle(self._plan)

    def next(self):
        from .ndarray.ndarray import array

        if self.curr_idx >= len(self._plan):
            raise StopIteration
        bucket_i, rows = self._plan[self.curr_idx]
        self.curr_idx += 1
        buck = self.data[bucket_i][rows]
        # label = data shifted left by one step (next-token prediction)
        label = np.full_like(buck, self.invalid_label)
        label[:, :-1] = buck[:, 1:]
        if self.major_axis == 1:
            buck, label = buck.T, label.T
        key = self.buckets[bucket_i]
        return DataBatch(
            data=[array(buck)], label=[array(label)], pad=0,
            bucket_key=key,
            provide_data=[DataDesc(self.data_name, self._shape(key),
                                   layout=self.layout)],
            provide_label=[DataDesc(self.label_name, self._shape(key),
                                    layout=self.layout)])
