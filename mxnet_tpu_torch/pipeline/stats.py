"""Input-pipeline counters, the ``dataPipeline`` section (ref:
``mxnet_tpu/pipeline/stats.py``).

The decisive signal is ``wait_ms``: the time the consumer (the training
loop) spent blocked inside ``next(pipeline)``.  A well-overlapped
pipeline keeps it near zero while ``host_build_ms`` and ``h2d_ms`` run in
the background; a ``wait_ms`` that tracks ``host_build_ms`` means the
card is starved and the pipeline needs more workers or deeper prefetch.
``h2d_ms`` is the host's part of a transfer (pinned staging and the
copies' enqueue, as the JAX package counts its asynchronous
``device_put``), not the copy's device time.
"""
from __future__ import annotations

import threading

_lock = threading.Lock()
_stats = {
    "batches": 0,           # batches delivered to the consumer
    "host_build_ms": 0.0,   # map fn + batchify time on host workers
    "h2d_ms": 0.0,          # host-to-device staging time on the h2d lane
    "wait_ms": 0.0,         # consumer time blocked on next()
    "prefetch_hits": 0,     # batch already staged at request
    "prefetch_misses": 0,   # consumer had to wait on the transfer
}


def add(key, value):
    """Accumulate one counter (thread-safe; called from pool workers)."""
    with _lock:
        _stats[key] += value


def pipeline_stats():
    """Snapshot of the dataPipeline counters since the last reset."""
    with _lock:
        s = dict(_stats)
    for k in ("host_build_ms", "h2d_ms", "wait_ms"):
        s[k] = round(s[k], 3)
    return s


def reset_pipeline_stats():
    with _lock:
        for k in _stats:
            _stats[k] = 0.0 if isinstance(_stats[k], float) else 0
