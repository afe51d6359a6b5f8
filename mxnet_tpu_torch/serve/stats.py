"""Serving observability: counters + latency percentiles + histogram
(ref: mxnet_tpu/serve/stats.py).

One :class:`ServerStats` instance rides inside each ``ModelServer``;
every mutation happens under one lock so a snapshot is internally
consistent (the ``served == submitted - rejected - pending`` invariant
would otherwise race).

Latencies land twice:

- a bounded ring (newest ``capacity`` samples) for the percentile
  points — serving percentiles care about the recent window, and an
  unbounded list would grow forever under production traffic;
- cumulative histogram buckets (Prometheus ``le`` convention) for the
  ``/metrics`` endpoint, where the scraper computes quantiles over
  scrape intervals itself.

``reset()`` window-scopes everything, matching the profiler sections'
``dumps(reset=True)`` semantics — ``ModelServer.stats(reset=True)``
reads one window and starts the next, instead of the old
process-lifetime-only accumulation.
"""
from __future__ import annotations

import threading

import numpy as np

#: submit→resolve latency bucket bounds, ms (the port's copy of the JAX
#: package's telemetry.metrics.DEFAULT_BUCKETS_MS)
DEFAULT_BUCKETS_MS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                      500.0, 1000.0, 2500.0, float("inf"))


class LatencyWindow:
    """Fixed-capacity ring of latency samples with percentile readout,
    plus cumulative histogram buckets for the metrics endpoint."""

    def __init__(self, capacity=4096, buckets=DEFAULT_BUCKETS_MS):
        self._buf = np.zeros(int(capacity), dtype=np.float64)
        self._capacity = int(capacity)
        self._n = 0  # total recorded since the last reset
        self._bounds = tuple(float(b) for b in buckets)
        if self._bounds[-1] != float("inf"):
            self._bounds += (float("inf"),)
        self._bucket_counts = [0] * len(self._bounds)
        self._sum = 0.0

    def record(self, value):
        self._buf[self._n % self._capacity] = value
        self._n += 1
        self._sum += float(value)
        for i, le in enumerate(self._bounds):
            if value <= le:
                self._bucket_counts[i] += 1
                break

    def reset(self):
        self._n = 0
        self._sum = 0.0
        self._bucket_counts = [0] * len(self._bounds)

    def snapshot(self):
        n = min(self._n, self._capacity)
        # histogram buckets are emitted CUMULATIVE (count of samples
        # <= le), the Prometheus exposition convention
        cum, acc = [], 0
        for le, c in zip(self._bounds, self._bucket_counts):
            acc += c
            cum.append([le, acc])
        hist = {"buckets": cum, "sum_ms": round(self._sum, 3),
                "count": self._n}
        if n == 0:
            return {"count": 0, "p50_ms": None, "p95_ms": None,
                    "p99_ms": None, "mean_ms": None, "max_ms": None,
                    "histogram": hist}
        window = self._buf[:n]
        p50, p95, p99 = np.percentile(window, (50, 95, 99))
        return {
            "count": self._n,
            "p50_ms": round(float(p50), 3),
            "p95_ms": round(float(p95), 3),
            "p99_ms": round(float(p99), 3),
            "mean_ms": round(float(window.mean()), 3),
            "max_ms": round(float(window.max()), 3),
            "histogram": hist,
        }


#: the ModelServer counter set
DEFAULT_COUNTERS = ("submitted", "served", "rejected_overload",
                    "expired_deadline", "failed", "cancelled", "batches",
                    "warmup_batches")


class ServerStats:
    """All ModelServer counters behind one lock."""

    def __init__(self, latency_capacity=4096):
        self._lock = threading.Lock()
        self.latency = LatencyWindow(latency_capacity)
        self._c = {k: 0 for k in DEFAULT_COUNTERS}
        # batch-fill ratio = real requests / padded batch rows, the
        # throughput-per-compile-surface figure of merit
        self._fill_real = 0
        self._fill_rows = 0
        # padded elements / real elements along the variable axis
        self._pad_real = 0
        self._pad_padded = 0
        self._bucket_hits = {}
        # per-bucket splits of the two aggregates above
        self._bucket_fill = {}   # key -> [real requests, padded rows]
        self._bucket_pad = {}    # key -> [real elems, padded elems]
        # raw traffic shape: variable-axis length of every submitted
        # request and real size of every executed group
        self._len_hist = {}      # length -> submissions
        self._group_hist = {}    # group size -> batches

    # -- mutation -----------------------------------------------------------

    def incr(self, name, n=1):
        with self._lock:
            self._c[name] += n

    def record_request_shape(self, length):
        """Tally one submitted request's variable-axis length (no-op
        for fixed-shape specs, where length is None)."""
        if length is None:
            return
        with self._lock:
            self._len_hist[int(length)] = \
                self._len_hist.get(int(length), 0) + 1

    def record_batch(self, bucket_key, n_real, n_rows, real_elems,
                     padded_elems):
        with self._lock:
            self._c["batches"] += 1
            self._fill_real += n_real
            self._fill_rows += n_rows
            self._pad_real += real_elems
            self._pad_padded += padded_elems
            self._bucket_hits[bucket_key] = \
                self._bucket_hits.get(bucket_key, 0) + 1
            fill = self._bucket_fill.setdefault(bucket_key, [0, 0])
            fill[0] += n_real
            fill[1] += n_rows
            pad = self._bucket_pad.setdefault(bucket_key, [0, 0])
            pad[0] += real_elems
            pad[1] += padded_elems
            self._group_hist[n_real] = \
                self._group_hist.get(n_real, 0) + 1

    def record_latency(self, ms):
        with self._lock:
            self.latency.record(ms)

    def _reset_locked(self):
        for k in self._c:
            self._c[k] = 0
        self._fill_real = self._fill_rows = 0
        self._pad_real = self._pad_padded = 0
        self._bucket_hits = {}
        self._bucket_fill = {}
        self._bucket_pad = {}
        self._len_hist = {}
        self._group_hist = {}
        self.latency.reset()

    def reset(self):
        """Start a new accounting window: zero every counter, fill/pad
        accumulator, bucket-hit map, and the latency ring/histogram —
        the same semantics as ``profiler.dumps(reset=True)``.  Gauges
        (queue depth, in-flight) are read live and unaffected."""
        with self._lock:
            self._reset_locked()

    # -- readout ------------------------------------------------------------

    def snapshot(self, queue_depth=0, in_flight=0, extra=None,
                 reset=False):
        with self._lock:
            snap = dict(self._c)
            snap["queue_depth"] = int(queue_depth)
            snap["in_flight"] = int(in_flight)
            snap["batch_fill_ratio"] = (
                round(self._fill_real / self._fill_rows, 4)
                if self._fill_rows else None)
            snap["padding_overhead"] = (
                round(self._pad_padded / self._pad_real - 1.0, 4)
                if self._pad_real else None)
            snap["bucket_hits"] = dict(self._bucket_hits)
            snap["bucket_fill_ratio"] = {
                k: round(real / rows, 4)
                for k, (real, rows) in self._bucket_fill.items() if rows}
            snap["bucket_padding_overhead"] = {
                k: round(padded / real - 1.0, 4)
                for k, (real, padded) in self._bucket_pad.items() if real}
            snap["request_lengths"] = dict(self._len_hist)
            snap["group_sizes"] = dict(self._group_hist)
            snap["latency"] = self.latency.snapshot()
            if reset:
                # read-and-rewind is atomic: a sample landing between
                # the snapshot and the zeroing can't vanish from both
                # windows
                self._reset_locked()
        if extra:
            snap.update(extra)
        return snap
