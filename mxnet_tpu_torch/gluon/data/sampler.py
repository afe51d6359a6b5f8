"""Samplers (ref: ``mxnet_tpu/gluon/data/sampler.py``).
``RandomSampler`` draws its permutation from numpy's global stream
(``np.random.seed`` makes it reproducible), as in the JAX package."""
from __future__ import annotations

import numpy as np


class Sampler:
    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    def __init__(self, length, start=0):
        self._length = length
        self._start = start

    def __iter__(self):
        return iter(range(self._start, self._start + self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    def __init__(self, length):
        self._length = length

    def __iter__(self):
        indices = np.arange(self._length)
        np.random.shuffle(indices)
        return iter(indices.tolist())

    def __len__(self):
        return self._length


class BatchSampler(Sampler):
    """Group a sampler into batches (ref: BatchSampler; ``last_batch`` in
    'keep'|'discard'|'rollover')."""

    def __init__(self, sampler, batch_size, last_batch="keep"):
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev = []

    def __iter__(self):
        batch, self._prev = self._prev, []
        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == "keep":
                yield batch
            elif self._last_batch == "rollover":
                self._prev = batch
            elif self._last_batch != "discard":
                raise ValueError(self._last_batch)

    def __len__(self):
        if self._last_batch == "keep":
            return (len(self._sampler) + self._batch_size - 1) \
                // self._batch_size
        if self._last_batch == "discard":
            return len(self._sampler) // self._batch_size
        return (len(self._sampler) + len(self._prev)) // self._batch_size


class FilterSampler(Sampler):
    """Indices of the samples for which ``fn(dataset[i])`` is truthy (ref:
    gluon.data.FilterSampler)."""

    def __init__(self, fn, dataset):
        self._indices = [i for i in range(len(dataset))
                         if fn(dataset[i])]

    def __iter__(self):
        return iter(self._indices)

    def __len__(self):
        return len(self._indices)
