"""``DataDesc``, ``DataBatch`` and ``DataIter`` (ref:
``mxnet_tpu/io/io.py:23-95``, after ``mx.io``)."""
from __future__ import annotations

import numpy as np

from ..base import MXNetError


class DataDesc:
    """Name, shape, dtype and layout of one input (ref: mx.io.DataDesc)."""

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


class DataIter:
    """Base iterator (ref: mx.io.DataIter)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

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
        """Ref: DataIter.as_pipeline, the pipeline tier's adapter."""
        raise MXNetError("DataIter.as_pipeline needs the pipeline tier "
                         "(pipeline/), which comes with slice 8 of the port "
                         "(ROADMAP.md queue 1)")
