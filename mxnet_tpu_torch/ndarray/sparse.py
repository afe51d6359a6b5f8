"""Compressed-sparse-row arrays, as far as ``io.LibSVMIter`` needs them
(ref: ``mxnet_tpu/ndarray/sparse.py`` ``CSRNDArray``/``csr_matrix``).

A :class:`CSRNDArray` holds its values, column indices and row pointer as
NDArrays on one context, with ``shape``, ``stype`` and ``asnumpy()``.  The sparse operators (``sparse.dot``,
``row_sparse``, sparse gradients) come with slice 9 of the port.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from .ndarray import NDArray, array


class CSRNDArray:
    """2-D compressed-sparse-row array (ref: CSRNDArray)."""

    stype = "csr"

    def __init__(self, values, indices, indptr, shape, ctx=None):
        if len(shape) != 2:
            raise MXNetError("csr storage is 2-D only")
        self.data = array(values, ctx=ctx)
        self.indices = array(np.asarray(indices, np.int64), ctx=ctx)
        self.indptr = array(np.asarray(indptr, np.int64), ctx=ctx)
        self.shape = tuple(int(s) for s in shape)

    def todense(self):
        n, m = self.shape
        indptr = self.indptr.data.cpu()
        rows = torch.repeat_interleave(torch.arange(n), indptr.diff())
        dense = torch.zeros((n, m), dtype=self.data.data.dtype,
                            device=self.data.data.device)
        dense.index_put_((rows.to(dense.device), self.indices.data),
                         self.data.data, accumulate=True)
        return NDArray(dense, self.data.context)

    def asnumpy(self):
        return self.todense().asnumpy()


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A CSRNDArray from ``(data, indices, indptr)`` with ``shape``."""
    if not (isinstance(arg1, tuple) and len(arg1) == 3):
        raise MXNetError("csr_matrix takes (data, indices, indptr) in the "
                         "port; the other forms come with slice 9")
    if shape is None:
        raise MXNetError("shape required for (data, indices, indptr)")
    data, indices, indptr = arg1
    data = np.asarray(data, dtype=dtype or np.float32)
    return CSRNDArray(data, indices, indptr, shape, ctx=ctx)
