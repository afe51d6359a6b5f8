"""Request queue + dynamic batch coalescing (ref: mxnet_tpu/serve/batcher.py).

The batcher is the server's admission controller and shape planner in
one: ``put()`` is the bounded fail-fast edge (overload shows up as an
immediate ``ServerOverloadedError`` at the caller, never as silent
queue bloat), and ``next_group()`` is the coalescing loop — take the
FIFO head, linger briefly for followers, stop at the largest batch
bucket, and drop anything whose deadline already passed.

Grouping is FIFO, not length-sorted: a length-sorted queue would give
better fill ratios but unbounded tail latency for rare lengths.  The
bucket grid bounds padding waste instead.
"""
from __future__ import annotations

import collections
import threading
import time

from ..base import MXNetError


class ServerOverloadedError(MXNetError):
    """The bounded request queue is full — shed load upstream."""


class ServerClosedError(MXNetError):
    """submit() after shutdown/drain began."""


class DeadlineExceededError(MXNetError):
    """The request's deadline passed before a batch picked it up."""


class _Request:
    __slots__ = ("example", "length", "future", "deadline", "enqueued_at",
                 "trace_id")

    def __init__(self, example, length, future, deadline_ms=None):
        self.trace_id = None          # the tracer's request span, if armed
        self.example = example
        self.length = length          # variable-axis size (None if fixed)
        self.future = future
        self.enqueued_at = time.monotonic()
        self.deadline = (self.enqueued_at + deadline_ms / 1e3
                         if deadline_ms is not None else None)

    def expired(self, now=None):
        return (self.deadline is not None
                and (now or time.monotonic()) > self.deadline)


class Batcher:
    """Bounded FIFO of :class:`_Request` with batch coalescing."""

    def __init__(self, max_queue=256, linger_ms=2.0):
        if max_queue < 1:
            raise MXNetError("max_queue must be >= 1")
        self._max_queue = int(max_queue)
        self._linger_s = float(linger_ms) / 1e3
        self._q = collections.deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._closed = False

    def __len__(self):
        with self._lock:
            return len(self._q)

    def put(self, request):
        """Admit a request or fail fast.  Never blocks: backpressure is
        the caller's signal to shed or retry with jitter."""
        with self._lock:
            if self._closed:
                raise ServerClosedError("request queue is closed")
            if len(self._q) >= self._max_queue:
                raise ServerOverloadedError(
                    f"request queue full ({self._max_queue}); retry with "
                    "backoff or raise max_queue")
            self._q.append(request)
            self._not_empty.notify()

    def close(self):
        """Reject further put()s and wake any blocked next_group() call;
        already-queued requests remain collectable (drain semantics)."""
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()

    def reopen(self):
        """Accept put()s again (server restart after drain/shutdown).
        The queue must be empty — both drain and abrupt shutdown leave
        it so; anything else is a lifecycle bug worth failing on."""
        with self._lock:
            if self._q:
                raise MXNetError("cannot reopen a batcher with queued work")
            self._closed = False

    def drained(self):
        """True once closed with nothing left to collect — the batcher
        thread's authoritative exit condition (checked under the queue
        lock so a request admitted before close() is never orphaned)."""
        with self._lock:
            return self._closed and not self._q

    def next_group(self, max_batch, timeout=0.1, on_pop=None):
        """Collect up to ``max_batch`` live requests.

        Blocks (up to ``timeout``) for the first request, then lingers
        ``linger_ms`` so concurrent submitters coalesce into one padded
        batch instead of max_batch singleton batches.  Expired requests
        are failed here — the only dequeue point — and never reach the
        device.  Returns ([], expired) when only expired work was found
        and (None, []) on timeout with an empty queue.

        ``on_pop(n_live)`` runs under the queue lock before the group is
        returned, so a caller's in-flight gauge can pick the requests up
        in the same critical section that removes them from the queue.
        """
        with self._not_empty:
            if not self._q and not self._closed:
                self._not_empty.wait(timeout)
            if not self._q:
                return None, []
        if self._linger_s > 0:
            deadline = time.monotonic() + self._linger_s
            while time.monotonic() < deadline:
                with self._lock:
                    # once closed no new submitter can arrive — lingering
                    # would only slow the drain/shutdown sweep down
                    if len(self._q) >= max_batch or self._closed:
                        break
                time.sleep(self._linger_s / 8)
        group, expired = [], []
        now = time.monotonic()
        with self._lock:
            while self._q and len(group) < max_batch:
                req = self._q.popleft()
                (expired if req.expired(now) else group).append(req)
            if group and on_pop is not None:
                on_pop(len(group))
        return group, expired
