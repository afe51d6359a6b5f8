"""ModelServer: dynamic-batching inference serving for hybridized blocks
(ref: mxnet_tpu/serve/server.py).

Request path::

    submit(example) -> bounded queue -> batcher thread coalesces
    -> pad into a (batch, length) bucket -> ONE forward on the device
    -> split + unpad -> per-request Future resolves with numpy output

Every bucket of the :class:`~.buckets.BucketSpec` grid runs at
``start()`` (warmup), twice on the card: the hybridized block's first
call of a bucket runs eagerly and its second captures the bucket's
forward as a CUDA graph (``gluon.block.CachedOp``), so every batch after ``start()``
is one replay, and the block's input-signature counters show no new
signature under mixed traffic:
``stats()["graph"]["post_warmup_compiles"] == 0``.  A replay writes its
outputs into the graph's own buffers; ``CachedOp`` returns copies, and
each batch's rows are read back to the host before the next batch runs.

- **backpressure**: the queue is bounded; ``submit()`` on a full queue
  raises :class:`ServerOverloadedError` at once.
- **deadlines**: ``submit(..., deadline_ms=)``; a request whose deadline
  passes while queued fails with :class:`DeadlineExceededError` and
  never reaches the device.
- **graceful drain**: ``shutdown(drain=True)`` stops admissions,
  finishes every queued request, and leaves no in-flight work.

The JAX package's tracer spans, profiler scopes, int8 batch hook,
metrics-endpoint export and ``reload_weights()`` are not ported yet;
``block.load_parameters`` on the served block copies new weights in
place, and the next replay reads them.
The batcher thread launches the kernels on its own current CUDA stream.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutureTimeout

import numpy as np

from ..base import MXNetError, getenv
from ..ndarray.ndarray import NDArray, array as _nd_array
from .batcher import (Batcher, DeadlineExceededError, _Request,
                      ServerClosedError, ServerOverloadedError)
from .buckets import BucketSpec
from .stats import ServerStats

#: compute + readback allowance added to a deadline-derived predict()
#: wait: the deadline bounds QUEUE time (checked at dequeue), so an
#: admitted batch still needs room to execute
PREDICT_GRACE_S = 5.0


class ModelServer:
    """Serve a gluon block behind an async dynamically-batched queue.

    Parameters
    ----------
    block : gluon.HybridBlock
        The model, initialized.  It is hybridized at ``start()``.
    spec : BucketSpec
        The closed set of padded shapes to serve.
    max_queue : int
        Bound on queued requests before submit() fails fast.
    linger_ms : float, optional
        How long the batcher waits for concurrent submitters to coalesce
        once the first request of a batch arrives.  Defaults to
        ``MXTPU_SERVE_LINGER_MS`` (2.0).
    ctx : Context, optional
        Device for the padded input batches (default: the current
        context, ``gpu(0)``).
    """

    def __init__(self, block, spec, max_queue=256, linger_ms=None,
                 ctx=None):
        if not isinstance(spec, BucketSpec):
            raise MXNetError("spec must be a serve.BucketSpec")
        if linger_ms is None:
            linger_ms = getenv("SERVE_LINGER_MS", 2.0, float)
        self._net = block
        self._spec = spec
        self._ctx = ctx
        self._batcher = Batcher(max_queue=max_queue, linger_ms=linger_ms)
        self._stats = ServerStats()
        self._if_lock = threading.Lock()
        self._in_flight = 0
        self._started = False
        self._closing = False
        self._abort = False
        self._worker = None
        self._warmup_compiles = 0

    # -- lifecycle ----------------------------------------------------------

    def start(self, warmup=True):
        """Hybridize, warm every bucket up, start the batcher thread.

        A drained server can be start()ed again: the queue reopens and
        the bucket signatures seen the first time are reused."""
        if self._started:
            raise MXNetError("ModelServer already started")
        self._abort = False
        self._batcher.reopen()
        if hasattr(self._net, "hybridize") and \
                not getattr(self._net, "_active", False):
            self._net.hybridize()
        if warmup:
            self._warmup()
        self._warmup_compiles = self._graph_stats().get("compiles", 0)
        self._started = True
        self._closing = False
        self._worker = threading.Thread(target=self._worker_loop,
                                        name="mxtt-serve-batcher",
                                        daemon=True)
        self._worker.start()
        return self

    def _warmup(self):
        """Run a dummy batch per bucket, smallest shape first; on the card
        a second one, which captures the bucket's graph."""
        for shape in self._spec.bucket_shapes():
            x = _nd_array(np.full(shape, self._spec.pad_value,
                                  dtype=self._spec.dtype), ctx=self._ctx)
            for _ in range(2 if x.data.is_cuda else 1):
                out = self._net(x)
                for o in (out if isinstance(out, (list, tuple)) else [out]):
                    if isinstance(o, NDArray):
                        o.wait_to_read()
            self._stats.incr("warmup_batches")

    def __enter__(self):
        if not self._started:
            self.start()
        return self

    def __exit__(self, *exc):
        self.shutdown(drain=exc == (None, None, None))
        return False

    def drain(self, timeout=None):
        """Stop admissions and block until every accepted request has
        resolved; the server ends with zero queued/in-flight work."""
        self._closing = True
        self._batcher.close()
        if self._worker is not None:
            self._worker.join(timeout)
            if self._worker.is_alive():
                raise MXNetError("drain timed out with work still queued")
            self._worker = None
        self._started = False

    def shutdown(self, drain=True, timeout=None):
        if not self._started and self._worker is None:
            return
        if drain:
            self.drain(timeout)
            return
        # abrupt: fail whatever is still queued
        self._closing = True
        self._abort = True
        self._batcher.close()
        if self._worker is not None:
            self._worker.join(timeout)
            self._worker = None
        self._started = False
        while True:
            group, expired = self._batcher.next_group(
                self._spec.max_batch, timeout=0)
            if not group and not expired:
                break
            for req in group + expired:
                if req.future.set_running_or_notify_cancel():
                    req.future.set_exception(
                        ServerClosedError("server shut down"))
                self._stats.incr("cancelled")

    # -- request path -------------------------------------------------------

    def submit(self, example, deadline_ms=None):
        """Queue one request (shape = spec.example_shape, no batch dim);
        returns a Future resolving to the request's numpy output(s)."""
        if not self._started or self._closing:
            raise ServerClosedError(
                "ModelServer is not accepting requests (not started, "
                "draining, or shut down)")
        if isinstance(example, NDArray):
            example = example.asnumpy()
        example = np.asarray(example, dtype=self._spec.dtype)
        length = self._spec.validate(example)
        self._stats.record_request_shape(length)
        req = _Request(example, length, Future(), deadline_ms=deadline_ms)
        # count before put(): once queued, the batcher may serve the
        # request immediately, and "submitted" must never trail "served"
        self._stats.incr("submitted")
        try:
            self._batcher.put(req)
        except MXNetError as e:
            self._stats.incr("submitted", -1)
            if isinstance(e, ServerOverloadedError):
                self._stats.incr("rejected_overload")
            raise
        return req.future

    def predict(self, example, deadline_ms=None, timeout=None):
        """Synchronous submit().  A caller-side ``timeout`` expiry cancels
        the queued request; with only ``deadline_ms`` the wait is bounded
        by ``deadline_ms/1e3 + PREDICT_GRACE_S``."""
        fut = self.submit(example, deadline_ms=deadline_ms)
        if timeout is None and deadline_ms is not None:
            timeout = deadline_ms / 1e3 + PREDICT_GRACE_S
        try:
            return fut.result(timeout)
        except _FutureTimeout:
            fut.cancel()
            raise

    # -- batcher thread -----------------------------------------------------

    def _worker_loop(self):
        while not self._abort:
            group, expired = self._batcher.next_group(
                self._spec.max_batch, timeout=0.05,
                on_pop=self._take_in_flight)
            for req in expired:
                self._stats.incr("expired_deadline")
                if req.future.set_running_or_notify_cancel():
                    req.future.set_exception(DeadlineExceededError(
                        "deadline passed while queued"))
            if group:
                # requests whose caller already cancelled must not take a
                # batch row
                live = []
                for req in group:
                    if req.future.cancelled():
                        self._finish(req)
                        self._stats.incr("cancelled")
                    else:
                        live.append(req)
                group = live
            if group:
                self._run_batch(group)
            elif group is None and self._batcher.drained():
                return

    def _take_in_flight(self, n):
        # runs under the batcher's queue lock: a request leaves
        # queue_depth and enters in_flight in one critical section
        with self._if_lock:
            self._in_flight += n

    def _run_batch(self, group):
        spec = self._spec
        pending = list(group)   # not yet resolved, for the failure path
        try:
            max_len = max((r.length for r in group), default=None) \
                if spec.var_axis is not None else None
            batch, length = spec.pick(len(group), max_len)
            key = spec.key(batch, length)
            padded = spec.pad_batch([r.example for r in group], batch,
                                    length)
            out = self._net(_nd_array(padded, ctx=self._ctx))
            outs = list(out) if isinstance(out, (list, tuple)) else [out]
            # one synchronous readback per output: latency includes it
            host = [o.asnumpy() if isinstance(o, NDArray) else
                    np.asarray(o) for o in outs]
            self._stats.record_batch(
                key, n_real=len(group), n_rows=batch,
                real_elems=sum(int(np.prod(r.example.shape))
                               for r in group),
                padded_elems=batch * int(np.prod(padded.shape[1:])))
            now = time.monotonic()
            for i, req in enumerate(group):
                res = [self._unpad_row(o[i], length, req.length)
                       for o in host]
                pending.remove(req)
                self._finish(req)
                self._stats.incr("served")
                self._stats.record_latency((now - req.enqueued_at) * 1e3)
                if req.future.set_running_or_notify_cancel():
                    req.future.set_result(res[0] if len(res) == 1
                                          else tuple(res))
        except Exception as e:  # noqa: BLE001 — every failure goes to
            # the affected callers; the batcher thread must survive (a
            # dead worker strands all queued futures forever)
            for req in pending:
                self._finish(req)
                self._stats.incr("failed")
                if req.future.set_running_or_notify_cancel():
                    req.future.set_exception(e)

    def _unpad_row(self, row, padded_len, orig_len):
        """Strip length padding when the output kept the variable axis
        (same axis index, same padded size); reductions that consumed
        the axis pass through untouched."""
        ax = self._spec.var_axis
        if (ax is None or orig_len is None or row.ndim <= ax
                or row.shape[ax] != padded_len or orig_len == padded_len):
            return row
        return row[(slice(None),) * ax + (slice(0, orig_len),)]

    def _finish(self, req):
        with self._if_lock:
            self._in_flight -= 1

    # -- observability ------------------------------------------------------

    def _graph_stats(self):
        op = getattr(self._net, "_cached_op", None)
        if op is not None:
            return dict(op.stats)
        return {}

    def stats(self, reset=False):
        """Snapshot of every serving counter.

        Invariants::

            submitted == served + expired_deadline + failed + cancelled
                         + queue_depth + in_flight
            graph.post_warmup_compiles == 0   # on a warmed server

        The identity is exact whenever the server is quiescent.
        ``reset=True`` atomically starts a new accounting window."""
        g = self._graph_stats()
        graph = {
            "compiles": g.get("compiles", 0),
            "reuses": g.get("reuses", 0),
            "post_warmup_compiles":
                g.get("compiles", 0) - self._warmup_compiles,
        }
        return self._stats.snapshot(
            queue_depth=len(self._batcher), in_flight=self._in_flight,
            reset=reset,
            extra={"graph": graph, "buckets": repr(self._spec)})
