"""DataLoader (ref: ``mxnet_tpu/gluon/data/dataloader.py``).

A thin composition over ``mxnet_tpu_torch.pipeline``: batch indices stream
from the sampler into a ``map`` stage that batchifies on the engine's host
workers with a bounded in-flight window.  The workers are threads, never
forked processes: a fork after CUDA is initialised is unsafe (MXNet 1.x
forks its workers before CUDA for that reason).  Batches are built on the
host (``cpu()``); ``as_pipeline().prefetch_to_device(gpu(0))`` or the
training loop moves them to the card.

``timeout`` is honoured per batch: a fetch exceeding it raises an error
naming the stuck batch (``timeout=0`` or ``None`` waits forever).
``pin_memory`` is accepted for MXNet's signature and unused: the pinned
staging belongs to ``prefetch_to_device`` (``engine.batched_put``).
"""
from __future__ import annotations

import collections

from ...pipeline.stages import default_batchify as default_batchify_fn  # noqa: F401 - re-export
from .sampler import BatchSampler, RandomSampler, SequentialSampler


class _EpochBatches:
    """Stateful batch-index source of ``DataLoader.as_pipeline()``.

    Iteration streams lazily from the batch sampler.  Only
    ``state_dict()`` pins the epoch: it drains the REMAINDER of the live
    sampler iterator into a queue (indices only) and saves that, so a
    shuffled epoch's permutation is part of the saved state and is not
    drawn again on restore.  The live source keeps serving from the same
    queue afterwards, so capture never perturbs the stream.  State capture
    therefore needs a finite epoch."""

    def __init__(self, batch_sampler):
        self._batch_sampler = batch_sampler
        self._it = None
        self._queued = collections.deque()
        self._pinned = False  # the queue is the whole remainder

    def __iter__(self):
        return self

    def __next__(self):
        if self._queued:
            return self._queued.popleft()
        if self._pinned:
            raise StopIteration
        if self._it is None:
            self._it = iter(self._batch_sampler)
        return next(self._it)

    def reset(self):
        self._it = None  # the next epoch samples again (a fresh shuffle)
        self._queued.clear()
        self._pinned = False

    def state_dict(self):
        if not self._pinned:
            if self._it is None:
                self._it = iter(self._batch_sampler)
            self._queued.extend(self._it)
            self._pinned = True
        return {"remaining": [list(b) for b in self._queued]}

    def load_state_dict(self, state):
        self._queued = collections.deque(
            list(b) for b in state["remaining"])
        self._pinned = True


class DataLoader:
    """Ref: gluon.data.DataLoader, same signature; ``num_workers`` sizes the
    in-flight window (``prefetch``, default ``2 * num_workers``) of host
    threads building batches."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 thread_pool=False, timeout=120):
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size required without batch_sampler")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle else \
                    SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle mutually exclusive with sampler")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._prefetch_depth = max(
            1, prefetch if prefetch is not None else 2 * max(num_workers, 1))
        self._timeout = timeout

    def as_pipeline(self):
        """One epoch as a ``pipeline.Pipeline``: compose further stages
        (``shard``, ``prefetch_to_device``) or checkpoint it through
        ``CheckpointManager.save(..., pipeline=...)``."""
        from ...pipeline import Pipeline

        return Pipeline(_EpochBatches(self._batch_sampler)).map(
            self._fetch_batch, inflight=self._prefetch_depth,
            timeout=self._timeout)

    def __iter__(self):
        return iter(self.as_pipeline())

    def _fetch_batch(self, idxs):
        return self._batchify_fn([self._dataset[i] for i in idxs])

    def __len__(self):
        return len(self._batch_sampler)
