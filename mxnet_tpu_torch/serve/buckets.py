"""Shape buckets: the closed set of padded shapes a ModelServer runs
(ref: mxnet_tpu/serve/buckets.py).

Serving arbitrary request shapes means either one graph per shape or
padding every request into a small, closed set of shapes prepared ahead
of time.  A :class:`BucketSpec` names that closed set: a grid of batch
sizes x variable-axis lengths.  ``ModelServer`` warms every bucket at
startup, so steady-state traffic meets no new input signature, which the
server's ``stats()["graph"]["post_warmup_compiles"]`` shows.

Token ids want ``dtype="int32"``: the default is float32.
"""
from __future__ import annotations

import numpy as np

from ..base import MXNetError


class BucketOverflowError(MXNetError):
    """A request is larger than every configured bucket."""


class BucketSpec:
    """The closed set of padded input shapes a server runs.

    Parameters
    ----------
    batch_sizes : sequence of int
        Allowed batch dimensions, e.g. ``(1, 2, 4, 8)``.  A batch of n
        requests pads up to the smallest bucket >= n; the largest entry
        is also the coalescing cap.
    example_shape : tuple
        Per-request shape WITHOUT the batch dim.  At most one axis may
        be ``None`` — the variable (sequence/spatial) axis whose
        concrete sizes come from ``lengths``.
    lengths : sequence of int, optional
        Allowed sizes of the variable axis, e.g. ``(32, 64, 128)``.
        Required iff ``example_shape`` contains a ``None``.
    pad_value : float
        Fill for padded positions and dead batch rows.
    dtype : str
        Input dtype of every bucket.
    """

    def __init__(self, batch_sizes, example_shape, lengths=None,
                 pad_value=0.0, dtype="float32"):
        self.batch_sizes = tuple(sorted(set(int(b) for b in batch_sizes)))
        if not self.batch_sizes or self.batch_sizes[0] < 1:
            raise MXNetError("batch_sizes must be positive ints")
        self.example_shape = tuple(example_shape)
        var_axes = [i for i, s in enumerate(self.example_shape) if s is None]
        if len(var_axes) > 1:
            raise MXNetError(
                f"example_shape {self.example_shape} has more than one "
                "variable (None) axis; buckets support at most one")
        self.var_axis = var_axes[0] if var_axes else None
        if self.var_axis is not None:
            if not lengths:
                raise MXNetError(
                    "example_shape has a variable axis but no lengths= "
                    "bucket list was given")
            self.lengths = tuple(sorted(set(int(l) for l in lengths)))
        else:
            if lengths:
                raise MXNetError(
                    "lengths= given but example_shape has no variable "
                    "(None) axis to apply them to")
            self.lengths = None
        self.pad_value = pad_value
        self.dtype = np.dtype(dtype)

    # -- geometry -----------------------------------------------------------

    @property
    def max_batch(self):
        return self.batch_sizes[-1]

    def bucket_shapes(self):
        """Every (batch, *example) shape the server runs — the warmup
        schedule, smallest first so warmup fails fast on a bad model
        before spending time on the big shapes."""
        out = []
        for b in self.batch_sizes:
            for l in (self.lengths or (None,)):
                out.append((b,) + self._example_shape_for(l))
        return sorted(out, key=lambda s: int(np.prod(s)))

    def _example_shape_for(self, length):
        if self.var_axis is None:
            return self.example_shape
        shape = list(self.example_shape)
        shape[self.var_axis] = length
        return tuple(shape)

    def validate(self, example):
        """Check one request's array against the spec; returns its
        variable-axis length (or None for fixed-shape specs)."""
        shape = tuple(example.shape)
        if len(shape) != len(self.example_shape):
            raise MXNetError(
                f"request shape {shape} has rank {len(shape)}, spec "
                f"expects rank {len(self.example_shape)} "
                f"({self.example_shape}; no batch dim in requests)")
        for axis, (got, want) in enumerate(zip(shape, self.example_shape)):
            if want is None:
                continue
            if got != want:
                raise MXNetError(
                    f"request shape {shape} differs from spec "
                    f"{self.example_shape} at axis {axis}")
        if self.var_axis is None:
            return None
        length = shape[self.var_axis]
        if length > self.lengths[-1]:
            raise BucketOverflowError(
                f"request length {length} exceeds the largest bucket "
                f"{self.lengths[-1]}; add a bucket or truncate upstream")
        if length < 1:
            raise MXNetError(f"request shape {shape} has an empty "
                             "variable axis")
        return length

    def pick(self, n_requests, max_length=None):
        """Smallest (batch_bucket, length_bucket) covering a group."""
        n = min(int(n_requests), self.max_batch)
        batch = next(b for b in self.batch_sizes if b >= n)
        if self.var_axis is None:
            return batch, None
        length = next(l for l in self.lengths if l >= max_length)
        return batch, length

    # -- padding ------------------------------------------------------------

    def pad_batch(self, examples, batch, length):
        """Stack per-request host arrays into one padded bucket batch.

        Returns the (batch, *example_shape_for(length)) numpy array —
        dead rows beyond len(examples) and positions beyond each
        request's own length hold ``pad_value``.
        """
        shape = (batch,) + self._example_shape_for(length)
        out = np.full(shape, self.pad_value, dtype=self.dtype)
        for i, ex in enumerate(examples):
            idx = [i] + [slice(0, s) for s in ex.shape]
            out[tuple(idx)] = ex
        return out

    def key(self, batch, length):
        """Stable string id for a bucket, used in stats dicts."""
        return f"b{batch}" if length is None else f"b{batch}xl{length}"

    def __repr__(self):
        return (f"BucketSpec(batch_sizes={self.batch_sizes}, "
                f"example_shape={self.example_shape}, "
                f"lengths={self.lengths}, dtype={self.dtype.name})")
