"""Fault-tolerant serving: a routed replica pool with health-based
eviction, hedged retries and zero-downtime rolling reload (ref:
``mxnet_tpu/serve/router.py``).

A :class:`Router` fronts N server replicas (:class:`~.server.ModelServer`
or :class:`~.decode.DecodeServer`):

- **least-loaded dispatch**: each request goes to the replica with the
  lowest live load score, (queued + in-flight requests) weighted by the
  replica's EWMA service time.
- **deadline budget propagation**: the replica sees the REMAINING
  milliseconds of the caller's deadline, not the original figure, so the
  pool never computes an answer whose caller has already given up.
- **classified retries**: a dispatch failure runs through
  ``resilience.classify``: ``transient`` and ``network`` (and a replica
  shut down mid-eviction) re-dispatch on a DIFFERENT replica under the
  seeded :class:`~..resilience.retry.RetryPolicy`; ``overloaded`` spills
  to the next-least-loaded replica without burning retry budget and
  rejects when every replica is full; ``deadline`` fails the request at
  once; anything fatal is forwarded unchanged.
- **tail-latency hedging**: a request dispatched with less than
  ``hedge_ms`` of budget remaining is sent to the TWO least-loaded
  replicas; the first result wins and the loser is cancelled.
- **health-based eviction**: a background prober sends one tiny request
  per replica per ``health_sec``; ``evict_after`` consecutive failures
  (probe or traffic) trip the circuit breaker: the replica leaves
  rotation, its queued and in-flight work fails over to survivors, and a
  warm spare from the factory joins only after its full bucket warm-up
  (on the card, each bucket captured), so an eviction causes no capture
  in traffic on the survivors.
- **per-tenant quota**: ``submit(tenant=)`` bounds each tenant's
  outstanding requests in front of the pool's bounded queues.
- **rolling reload**: ``rolling_reload()`` takes one replica at a time
  out of rotation, drains it, swaps its weights in place through the
  server's ``reload_weights()`` and rejoins it: a rollout drops no
  request and captures nothing, and each request is served entirely by
  the old or the new weights.

On the card the replicas of one process share the device, the kernels'
launch counters and the capture machinery: a warm spare captures its
buckets on the router's own thread while its peers replay theirs, which
``ops/kernels/build.py`` (launches booked per capturing thread) and
``gluon/whole_step.py`` (a counted collector guard, thread-local capture
errors) allow.

Chaos rides two catalogued fault points, ``serve.replica.submit`` (per
dispatch attempt) and ``serve.replica.health`` (per probe), through
:class:`~..resilience.faults.FaultPlan`.

Knobs: ``MXTPU_ROUTER_HEALTH_SEC``, ``MXTPU_ROUTER_EVICT_AFTER``,
``MXTPU_ROUTER_HEDGE_MS``, ``MXTPU_ROUTER_TENANT_QUOTA``.
"""
from __future__ import annotations

import itertools
import queue as _queue_mod
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutureTimeout

from .. import engine
from ..base import MXNetError, getenv
from ..log import get_logger
from ..resilience.retry import RetryPolicy
from ..resilience.supervisor import classify
from ..telemetry import tracer as _tracer
from .batcher import (DeadlineExceededError, ServerClosedError,
                      ServerOverloadedError)
from .stats import ServerStats

logger = get_logger("mxnet_tpu_torch.serve.router")


class TenantQuotaExceededError(ServerOverloadedError):
    """The tenant's outstanding-request quota is exhausted — shed load
    for THIS tenant; other tenants are unaffected."""


class NoHealthyReplicaError(ServerOverloadedError):
    """Every replica is out of rotation or full — shed load upstream
    (classified ``overloaded``, same as a full single-server queue)."""


#: the Router counter set (rides the same ServerStats machinery the
#: servers use; exported as mxtpu_router_* by telemetry.metrics)
ROUTER_COUNTERS = ("submitted", "served", "failed", "cancelled",
                   "rejected_quota", "rejected_overload",
                   "expired_deadline", "dispatched", "retries", "hedges",
                   "hedge_wins", "evictions", "replacements", "probes",
                   "probe_failures", "reloads")

# replica rotation states
HEALTHY = "healthy"        # in rotation
RELOADING = "reloading"    # out of rotation for a rolling reload leg
EVICTED = "evicted"        # circuit breaker tripped; being replaced


# ---------------------------------------------------------------------------
# window-scoped module counters: the profiler's `router` section
# (provider: profiler._router_counters; exported to /metrics as
# mxtpu_router_* gauges by the section collector)

_sec_lock = threading.Lock()
_sec = {"dispatched": 0, "retries": 0, "hedges": 0, "hedge_wins": 0,
        "evictions": 0, "replacements": 0, "probes": 0,
        "probe_failures": 0, "reloads": 0}


def _sec_bump(**deltas):
    with _sec_lock:
        for k, n in deltas.items():
            _sec[k] += n


def router_stats():
    """Window snapshot of the pool-level routing counters (aggregated
    across every Router in the process)."""
    with _sec_lock:
        return dict(_sec)


def reset_router_stats():
    with _sec_lock:
        for k in _sec:
            _sec[k] = 0


# ---------------------------------------------------------------------------


class Replica:
    """One pool member: a server plus its rotation state, circuit-
    breaker counter, and live load attribution."""

    def __init__(self, rid, server):
        self.id = int(rid)
        self.server = server
        self.state = HEALTHY
        self.consecutive_failures = 0
        self.dispatched = 0
        self.served = 0
        self.failed = 0
        self.ewma_ms = 0.0          # per-request service time estimate
        self.outstanding = {}       # inner future -> _PoolRequest

    def score(self):
        """Live load: pending work weighted by expected service time.
        A replica that is both deep-queued and slow scores worst."""
        return (self.server.pending() + 1) * max(self.ewma_ms, 0.1)

    def info(self):
        return {"state": self.state,
                "consecutive_failures": self.consecutive_failures,
                "dispatched": self.dispatched, "served": self.served,
                "failed": self.failed,
                "pending": self.server.pending(),
                "ewma_ms": round(self.ewma_ms, 3)}


class _PoolRequest:
    """Router-side request state: the caller-facing future, the
    absolute deadline the per-dispatch budgets derive from, and the
    resolve-exactly-once flag hedged/retried dispatches race on."""

    __slots__ = ("example", "kwargs", "tenant", "future", "deadline",
                 "deadline_ms", "submit_t", "attempts", "retries",
                 "lock", "resolved", "inners", "trace_id", "sink")

    def __init__(self, example, tenant, deadline_ms, kwargs):
        self.example = example
        self.kwargs = kwargs
        self.tenant = tenant
        self.future = Future()
        self.submit_t = time.monotonic()
        self.deadline_ms = deadline_ms
        self.deadline = (self.submit_t + deadline_ms / 1e3
                         if deadline_ms is not None else None)
        self.attempts = 0
        self.retries = 0
        self.lock = threading.Lock()
        self.resolved = False
        self.inners = []
        self.trace_id = None
        self.sink = None    # PooledStreamHandle for submit_stream()

    def remaining_ms(self, now=None):
        """The budget a dispatch RIGHT NOW would propagate (None when
        the caller gave no deadline)."""
        if self.deadline is None:
            return None
        return (self.deadline - (now or time.monotonic())) * 1e3


_POOL_STREAM_DONE = object()   # attach-queue sentinel: outer resolved


class PooledStreamHandle:
    """The :meth:`Router.submit_stream` handle: a decode token iterator
    that fans through the pool.

    Iteration yields token ids the moment they land on whichever
    replica CURRENTLY owns the request.  When a replica dies mid-stream
    the router's classified-retry path re-dispatches the request and
    the next attach resumes the walk, skipping the prefix already
    yielded — greedy decode is deterministic across same-weight
    replicas, so the re-generated prefix is identical and the caller
    sees one gapless, duplicate-free token sequence.  :attr:`future`
    resolves with the full sequence exactly like ``DecodeHandle``'s.

    Each pooled stream reads only its OWN per-request queue (in-process
    handles) or demux lane (remote replicas), so a slow consumer never
    head-of-line-blocks other requests' tokens.
    """

    def __init__(self, future):
        self.future = future
        self._attached = _queue_mod.Queue()   # inner handles, in
        # dispatch order; _POOL_STREAM_DONE once the outer resolved
        self._inner = None
        self._skip = 0
        self._yielded = 0
        self._tail = None   # leftovers recovered from future.result()

    # router-internal -------------------------------------------------------

    def _attach(self, inner, replica_id):
        self._attached.put(inner)

    def _finalize(self, fut):
        self._attached.put(_POOL_STREAM_DONE)

    # iterator --------------------------------------------------------------

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            if self._tail is not None:
                if self._tail:
                    self._yielded += 1
                    return self._tail.pop(0)
                raise StopIteration
            if self._inner is None:
                nxt = self._attached.get()
                if nxt is _POOL_STREAM_DONE:
                    # repeat-consumable, like DecodeHandle's sentinel
                    self._attached.put(_POOL_STREAM_DONE)
                    # future.result() re-raises the terminal error
                    # (incl. CancelledError) when the request failed;
                    # on success any tokens the inner walks missed
                    # (hedge winner raced us, connection died between
                    # the result and the last frame) drain as the tail
                    seq = self.future.result(timeout=0)
                    self._tail = [int(t) for t in seq[self._yielded:]]
                    continue
                self._inner = iter(nxt)
                self._skip = self._yielded
                continue
            try:
                tok = next(self._inner)
            except StopIteration:
                # clean inner finish: the outer future resolves off its
                # done-callback; loop to the sentinel/tail path
                self._inner = None
                continue
            except BaseException:  # noqa: BLE001 — the router already
                # classified it: a retryable failure re-dispatches (a
                # new attach arrives), a terminal one resolves the
                # outer future (the sentinel arrives); either way the
                # loop blocks on the attach queue, never on a dead
                # stream
                self._inner = None
                continue
            if self._skip > 0:
                self._skip -= 1
                continue
            self._yielded += 1
            return tok

    def result(self, timeout=None):
        """The full generated token sequence (np.int32 array)."""
        return self.future.result(timeout)

    def cancel(self):
        self.future.cancel()


class Router:
    """A replica pool fronting N servers behind one ``submit()`` edge.

    Parameters
    ----------
    factory : callable, optional
        ``factory(replica_id) -> server`` building one UNSTARTED
        replica (its own block instance + spec).  Used for the initial
        pool (with ``n_replicas``) and for warm spares after an
        eviction; without a factory an evicted replica is not replaced.
    n_replicas : int, optional
        Initial pool size built from ``factory``.
    servers : sequence, optional
        Pre-built (unstarted) servers instead of / in addition to the
        factory-built pool.
    retry : RetryPolicy, optional
        Seeded policy bounding per-request re-dispatches (default:
        ``RetryPolicy(max_retries=2, base_delay=0.01, max_delay=0.25)``).
    evict_after : int
        Consecutive failures (traffic or probe) that trip the circuit
        breaker (``MXTPU_ROUTER_EVICT_AFTER``, default 3).
    health_sec : float
        Probe period; 0 disables probing
        (``MXTPU_ROUTER_HEALTH_SEC``, default 5).
    hedge_ms : float
        Hedge a dispatch whose remaining deadline budget is below this
        (``MXTPU_ROUTER_HEDGE_MS``, default 0 = off).
    tenant_quota : int
        Max outstanding requests per tenant; 0 disables
        (``MXTPU_ROUTER_TENANT_QUOTA``, default 0).
    probe_example / probe_kwargs :
        Health-probe payload; by default derived from the first
        replica's smallest bucket (``server.probe_example()``), with
        ``max_new_tokens=1`` added for decode replicas.
    """

    def __init__(self, factory=None, n_replicas=None, *, servers=None,
                 retry=None, evict_after=None, health_sec=None,
                 hedge_ms=None, tenant_quota=None, probe_example=None,
                 probe_kwargs=None):
        if factory is None and not servers:
            raise MXNetError(
                "Router needs replicas: pass factory= + n_replicas=, "
                "or servers=[...]")
        if factory is not None and n_replicas is None and not servers:
            raise MXNetError("factory= without n_replicas=: how many "
                             "replicas should the initial pool hold?")
        self._factory = factory
        self._retry = retry if retry is not None else RetryPolicy(
            max_retries=2, base_delay=0.01, max_delay=0.25)
        self._evict_after = int(getenv("ROUTER_EVICT_AFTER", 3, int)
                                if evict_after is None else evict_after)
        self._health_sec = float(getenv("ROUTER_HEALTH_SEC", 5.0, float)
                                 if health_sec is None else health_sec)
        self._hedge_ms = float(getenv("ROUTER_HEDGE_MS", 0.0, float)
                               if hedge_ms is None else hedge_ms)
        self._tenant_quota = int(getenv("ROUTER_TENANT_QUOTA", 0, int)
                                 if tenant_quota is None else tenant_quota)
        if self._evict_after < 1:
            raise MXNetError(
                f"evict_after must be >= 1, got {self._evict_after}")
        self._ids = itertools.count(0)   # per-router: replica ids (and
        # therefore fault-plan match={"replica": N} targeting) are
        # deterministic regardless of other routers in the process
        self._lock = threading.RLock()   # pool membership + states +
        # tenant counts; OUTERMOST — never acquired from code running
        # under a server/batcher/stats lock
        self._pool = []
        for srv in (servers or ()):
            self._pool.append(Replica(next(self._ids), srv))
        missing = int(n_replicas or 0) - len(self._pool)
        if missing > 0 and factory is None:
            raise MXNetError(
                f"n_replicas={n_replicas} but only {len(self._pool)} "
                "server(s) were given and there is no factory= to "
                "build the rest")
        for _ in range(max(missing, 0)):
            rid = next(self._ids)
            self._pool.append(Replica(rid, factory(rid)))
        self._stats = ServerStats(counters=ROUTER_COUNTERS)
        self._tenants = {}
        self._outstanding = set()
        self._started = False
        self._closing = False    # no NEW submits (drain or shutdown)
        self._aborting = False   # abrupt shutdown: stop re-dispatching
        self._health_stop = None
        self._health_thread = None
        self._metrics_collector = None
        self._probe_example = probe_example
        self._probe_kwargs = dict(probe_kwargs or {})
        self.last_recovery_ms = None    # evict -> warm spare admitted

    # -- lifecycle ----------------------------------------------------------

    def start(self):
        """Start (and AOT-warm) every replica, then the health prober.
        Each replica's full bucket grid compiles during ITS start(), so
        steady pool traffic — including traffic during a later
        eviction/replacement cycle — never compiles."""
        if self._started:
            raise MXNetError("Router already started")
        self._closing = False
        self._aborting = False
        for rep in self._pool:
            rep.server.start()
        if self._probe_example is None and self._pool:
            self._probe_example = self._pool[0].server.probe_example()
        if not self._probe_kwargs and self._pool and \
                hasattr(self._pool[0].server, "generate"):
            # decode replicas: one token proves the whole loop is live
            self._probe_kwargs = {"max_new_tokens": 1}
        self._started = True
        if self._metrics_collector is None:
            from ..telemetry import metrics as _metrics

            self._metrics_collector = _metrics.register_router(self)
        if self._health_sec > 0:
            self._health_stop = threading.Event()
            self._health_thread = threading.Thread(
                target=self._health_loop, args=(self._health_stop,),
                name="mxtpu-router-health", daemon=True)
            self._health_thread.start()
        return self

    def __enter__(self):
        if not self._started:
            self.start()
        return self

    def __exit__(self, *exc):
        self.shutdown(drain=exc == (None, None, None))
        return False

    def _stop_health(self):
        if self._health_stop is not None:
            self._health_stop.set()
            self._health_thread.join(timeout=2 * max(self._health_sec, 1))
            self._health_stop = self._health_thread = None

    def drain(self, timeout=None):
        """Stop admissions, wait for every outstanding request to
        resolve (re-dispatches included), then drain each replica —
        ``timeout`` bounds the WHOLE drain (the replica drains get the
        remaining budget, not the original figure again)."""
        self._closing = True
        self._stop_health()
        deadline = (time.monotonic() + timeout) if timeout else None
        while self._outstanding:
            if deadline is not None and time.monotonic() > deadline:
                raise MXNetError(
                    f"router drain timed out with "
                    f"{len(self._outstanding)} request(s) outstanding")
            time.sleep(0.005)
        with self._lock:
            reps = [r for r in self._pool if r.state != EVICTED]
        for rep in reps:
            rep.server.drain(
                max(deadline - time.monotonic(), 0.001)
                if deadline is not None else None)
        self._started = False

    def shutdown(self, drain=True, timeout=None):
        if not self._started:
            return
        if drain:
            self.drain(timeout)
            return
        self._closing = True
        self._aborting = True
        self._stop_health()
        with self._lock:
            reps = [r for r in self._pool if r.state != EVICTED]
        for rep in reps:
            try:
                rep.server.shutdown(drain=False, timeout=timeout or 2.0)
            except Exception as e:  # noqa: BLE001 — best-effort teardown
                logger.warning("replica %d shutdown failed: %s",
                               rep.id, e)
        # anything still unresolved (e.g. callbacks raced the close)
        for rreq in list(self._outstanding):
            self._resolve_exc(rreq, ServerClosedError(
                "router shut down"), "failed", outcome="cancelled")
        self._started = False

    # -- request path -------------------------------------------------------

    def submit(self, example, deadline_ms=None, tenant=None, **kwargs):
        """Admit one request into the pool; returns a Future.

        Raises :class:`TenantQuotaExceededError` when ``tenant``'s
        outstanding quota is exhausted (admission control in FRONT of
        the replicas' bounded queues).  Every dispatch-level failure —
        replica full, replica dead, budget exhausted — resolves the
        FUTURE with a classified error instead; an admitted request is
        never silently lost.  Extra kwargs (e.g. ``max_new_tokens`` for
        decode pools) pass through to the replica's ``submit()``.
        """
        return self._admit(example, deadline_ms, tenant, kwargs).future

    def submit_stream(self, example, deadline_ms=None, tenant=None,
                      **kwargs):
        """Pooled streaming decode: like :meth:`submit` against a
        decode-replica pool, but returns a :class:`PooledStreamHandle`
        whose iterator yields tokens as they land — multiplexed
        per-request, surviving mid-stream replica loss via the same
        classified re-dispatch path (the re-attached stream skips the
        already-yielded prefix).  Admission control (quota, closing)
        is identical to ``submit``."""
        rreq = self._admit(example, deadline_ms, tenant, kwargs,
                           stream=True)
        return rreq.sink

    def _admit(self, example, deadline_ms, tenant, kwargs,
               stream=False):
        if not self._started or self._closing:
            raise ServerClosedError(
                "Router is not accepting requests (not started, "
                "draining, or shut down)")
        if self._tenant_quota > 0 and tenant is not None:
            with self._lock:
                n = self._tenants.get(tenant, 0)
                if n >= self._tenant_quota:
                    self._stats.incr("rejected_quota")
                    raise TenantQuotaExceededError(
                        f"tenant {tenant!r} has {n} outstanding "
                        f"request(s), at its quota of "
                        f"{self._tenant_quota}; retry after one "
                        "resolves or raise MXTPU_ROUTER_TENANT_QUOTA")
                self._tenants[tenant] = n + 1
        rreq = _PoolRequest(example, tenant, deadline_ms, kwargs)
        if stream:
            rreq.sink = PooledStreamHandle(rreq.future)
            rreq.future.add_done_callback(rreq.sink._finalize)
        rreq.trace_id = _tracer.request_begin(
            "serve.router.request", cat="serve",
            deadline_ms=deadline_ms if deadline_ms is not None else -1,
            tenant=str(tenant) if tenant is not None else "")
        self._stats.incr("submitted")
        self._outstanding.add(rreq)
        rreq.future.add_done_callback(
            lambda f, r=rreq: self._on_outer_done(r, f))
        self._dispatch(rreq, exclude=frozenset())
        return rreq

    def predict(self, example, deadline_ms=None, timeout=None,
                tenant=None, **kwargs):
        """Synchronous wrapper; like ``ModelServer.predict`` the
        caller-side wait derives its default bound from the deadline
        and an expiry cancels the pooled request."""
        from .server import PREDICT_GRACE_S

        fut = self.submit(example, deadline_ms=deadline_ms,
                          tenant=tenant, **kwargs)
        if timeout is None and deadline_ms is not None:
            timeout = deadline_ms / 1e3 + PREDICT_GRACE_S
        try:
            return fut.result(timeout)
        except _FutureTimeout:
            fut.cancel()
            raise

    # -- dispatch -----------------------------------------------------------

    def _pick(self, skip):
        """Least-loaded healthy replica not in ``skip`` (ties go to the
        least-dispatched, so an idle pool round-robins)."""
        with self._lock:
            cands = [r for r in self._pool
                     if r.state == HEALTHY and r.id not in skip]
        if not cands:
            return None
        # scores read the servers' live queue gauges OUTSIDE the pool
        # lock (one-directional router->batcher lock order)
        return min(cands, key=lambda r: (r.score(), r.dispatched, r.id))

    def _dispatch(self, rreq, exclude):
        """Place ``rreq`` on a replica; spills across replicas on
        overload and resolves the request with a classified error when
        no placement is possible."""
        skip = set(exclude)
        while True:
            if rreq.resolved:
                return
            if self._aborting:
                # abrupt shutdown only — a graceful drain() keeps
                # re-dispatching so every outstanding request resolves
                self._resolve_exc(rreq, ServerClosedError(
                    "router shut down while the request was being "
                    "re-dispatched"), "failed", outcome="cancelled")
                return
            remaining = rreq.remaining_ms()
            if remaining is not None and remaining <= 0:
                self._resolve_exc(rreq, DeadlineExceededError(
                    f"deadline budget exhausted after {rreq.attempts} "
                    f"dispatch attempt(s) ({rreq.retries} retries) — "
                    f"original deadline_ms={rreq.deadline_ms}"),
                    "expired_deadline", outcome="expired")
                return
            replica = self._pick(skip)
            if replica is None:
                self._resolve_exc(rreq, NoHealthyReplicaError(
                    f"no healthy replica can take the request "
                    f"(pool={len(self._pool)}, tried "
                    f"{sorted(skip) if skip else 'none'}); shed load "
                    "upstream or grow the pool"),
                    "rejected_overload", outcome="rejected")
                return
            try:
                self._dispatch_to(rreq, replica, remaining)
            except ServerOverloadedError:
                # this replica's queue is full: spill to the next
                # least-loaded one — admission pressure, not sickness,
                # so no health penalty and no retry-budget burn
                skip.add(replica.id)
                continue
            except Exception as e:  # noqa: BLE001 — classified below
                kind = classify(e)
                if self._retryable(e, kind):
                    self._note_failure(replica)
                    if self._claim_retry(rreq):
                        self._redispatch_later(rreq, {replica.id})
                    else:
                        self._resolve_exc(rreq, MXNetError(
                            f"request failed on {rreq.attempts} "
                            f"replica(s), retry budget exhausted "
                            f"(max_retries="
                            f"{self._retry.max_retries}): {e}"),
                            "failed", outcome="failed")
                    return
                self._resolve_exc(rreq, e, "failed", outcome="failed")
                return
            # hedging: near-deadline requests get a second runner
            if (self._hedge_ms > 0 and remaining is not None
                    and remaining <= self._hedge_ms
                    and not rreq.retries):
                second = self._pick(skip | {replica.id})
                if second is not None:
                    try:
                        self._dispatch_to(rreq, second,
                                          rreq.remaining_ms(),
                                          hedge=True)
                        self._stats.incr("hedges")
                        _sec_bump(hedges=1)
                    except Exception:  # noqa: BLE001 — a failed hedge
                        # never hurts the primary dispatch
                        pass
            return

    def _dispatch_to(self, rreq, replica, remaining_ms, hedge=False):
        rreq.attempts += 1
        attempt = rreq.attempts
        engine.fault_point("serve.replica.submit", replica=replica.id,
                           attempt=attempt)
        t0 = time.monotonic()
        inner = replica.server.submit(rreq.example,
                                      deadline_ms=remaining_ms,
                                      **rreq.kwargs)
        fut = getattr(inner, "future", inner)
        if rreq.sink is not None and inner is not fut:
            # streaming dispatch: hand the (decode) handle to the
            # pooled stream — tokens start flowing before the future
            rreq.sink._attach(inner, replica.id)
        with self._lock:
            replica.outstanding[fut] = rreq
            replica.dispatched += 1
        with rreq.lock:
            rreq.inners.append(fut)
        self._stats.incr("dispatched")
        _sec_bump(dispatched=1)
        _tracer.request_instant(
            "serve.router.dispatch", rreq.trace_id, cat="serve",
            replica=replica.id, attempt=attempt, hedge=hedge,
            remaining_ms=round(remaining_ms, 3)
            if remaining_ms is not None else -1)
        fut.add_done_callback(
            lambda f: self._on_inner_done(rreq, replica, f, t0, hedge))

    @staticmethod
    def _retryable(exc, kind):
        # transient = the classifier's call; `network` (a dropped RPC
        # connection to a cross-process replica) re-dispatches for the
        # same reason, and a replica closing under a concurrent
        # eviction is equally re-dispatchable.  `overloaded` and
        # `deadline` are deliberately NOT here: overload spills or
        # sheds (no backoff-hammering an overloaded pool), an exhausted
        # budget cannot be retried into existence.
        return (kind in ("transient", "network")
                or isinstance(exc, ServerClosedError))

    def _claim_retry(self, rreq):
        with rreq.lock:
            if rreq.resolved:
                return False
            rreq.retries += 1
            n = rreq.retries
        ok = self._retry.should_retry(n)
        if ok:
            # booked only when the re-dispatch will actually happen —
            # the claim that EXHAUSTS the budget is not a retry
            self._stats.incr("retries")
            _sec_bump(retries=1)
        return ok

    def _redispatch_later(self, rreq, exclude):
        delay = self._retry.delay_for(rreq.retries)
        if delay < 1e-3:
            self._dispatch(rreq, exclude)
            return
        t = threading.Timer(delay, self._dispatch, args=(rreq, exclude))
        t.daemon = True
        t.start()

    # -- inner-future resolution --------------------------------------------

    def _on_inner_done(self, rreq, replica, fut, t0, hedge):
        with self._lock:
            replica.outstanding.pop(fut, None)
        if fut.cancelled():
            return   # hedge loser / eviction failover — already handled
        exc = fut.exception()
        if exc is None:
            self._note_success(replica, (time.monotonic() - t0) * 1e3)
            self._resolve_result(rreq, fut.result(), replica, hedge)
            return
        kind = classify(exc)
        if kind == "deadline":
            # the propagated budget expired at the replica == the
            # caller's budget is gone; no replica can still help
            self._resolve_exc(rreq, exc, "expired_deadline",
                              outcome="expired")
        elif self._retryable(exc, kind):
            self._note_failure(replica)
            if self._aborting:
                self._resolve_exc(rreq, ServerClosedError(
                    "router shut down while the request was queued on "
                    f"replica {replica.id}"), "failed",
                    outcome="cancelled")
            elif self._claim_retry(rreq):
                self._redispatch_later(rreq, {replica.id})
            else:
                self._resolve_exc(rreq, MXNetError(
                    f"request failed on {rreq.attempts} replica(s), "
                    f"retry budget exhausted (max_retries="
                    f"{self._retry.max_retries}): {exc}"),
                    "failed", outcome="failed")
        else:
            # fatal (model bug, bad request): every replica would fail
            # identically — forward unchanged, no health penalty
            self._resolve_exc(rreq, exc, "failed", outcome="failed")

    def _claim_resolution(self, rreq):
        with rreq.lock:
            if rreq.resolved:
                return False
            rreq.resolved = True
            return True

    def _cancel_losers(self, rreq, winner=None):
        with rreq.lock:
            inners = list(rreq.inners)
        for f in inners:
            if f is not winner and not f.done():
                f.cancel()

    def _resolve_result(self, rreq, result, replica, hedge):
        if not self._claim_resolution(rreq):
            return
        self._cancel_losers(rreq, winner=None)
        delivered = rreq.future.set_running_or_notify_cancel()
        if delivered:
            rreq.future.set_result(result)
            self._stats.incr("served")
            self._stats.record_latency(
                (time.monotonic() - rreq.submit_t) * 1e3)
            if hedge:
                self._stats.incr("hedge_wins")
                _sec_bump(hedge_wins=1)
        else:
            # the caller cancelled between our claim and the delivery:
            # book it here — _on_outer_done lost the claim race
            self._stats.incr("cancelled")
        _tracer.request_end(
            "serve.router.request", rreq.trace_id, cat="serve",
            outcome="served" if delivered else "cancelled",
            replica=replica.id, attempts=rreq.attempts,
            retries=rreq.retries, hedged=hedge)

    def _resolve_exc(self, rreq, exc, counter, outcome):
        if not self._claim_resolution(rreq):
            return
        self._cancel_losers(rreq)
        if rreq.future.set_running_or_notify_cancel():
            rreq.future.set_exception(exc)
            self._stats.incr(counter)
        else:
            self._stats.incr("cancelled")
        _tracer.request_end(
            "serve.router.request", rreq.trace_id, cat="serve",
            outcome=outcome, attempts=rreq.attempts,
            retries=rreq.retries, error=str(exc)[:160])

    def _on_outer_done(self, rreq, fut):
        self._outstanding.discard(rreq)
        if rreq.tenant is not None and self._tenant_quota > 0:
            with self._lock:
                n = self._tenants.get(rreq.tenant, 0)
                if n <= 1:
                    self._tenants.pop(rreq.tenant, None)
                else:
                    self._tenants[rreq.tenant] = n - 1
        if fut.cancelled():
            # the CALLER gave up (predict timeout / explicit cancel):
            # stop the replicas computing a dead answer
            claimed = self._claim_resolution(rreq)
            self._cancel_losers(rreq)
            if claimed:
                self._stats.incr("cancelled")
                _tracer.request_end("serve.router.request",
                                    rreq.trace_id, cat="serve",
                                    outcome="cancelled",
                                    attempts=rreq.attempts,
                                    retries=rreq.retries)

    # -- health + eviction --------------------------------------------------

    def _note_success(self, replica, ms):
        with self._lock:
            replica.consecutive_failures = 0
            replica.served += 1
            if ms is not None:
                replica.ewma_ms = (0.8 * replica.ewma_ms + 0.2 * ms
                                   if replica.ewma_ms else ms)

    def _note_failure(self, replica):
        with self._lock:
            replica.consecutive_failures += 1
            replica.failed += 1
            trip = (replica.state == HEALTHY
                    and replica.consecutive_failures >= self._evict_after)
        if trip:
            self.evict(replica)

    def evict(self, replica):
        """Trip the circuit breaker: remove the replica from rotation,
        fail its queued/in-flight work over to survivors, and (with a
        factory) warm a spare that joins only after its full AOT
        warmup.  Idempotent per replica."""
        with self._lock:
            if replica.state == EVICTED:
                return
            replica.state = EVICTED
        self._stats.incr("evictions")
        _sec_bump(evictions=1)
        _tracer.instant("serve.router.evict", cat="serve",
                        replica=replica.id,
                        consecutive_failures=replica.consecutive_failures)
        logger.warning(
            "evicting replica %d after %d consecutive failure(s); "
            "queued work fails over to survivors%s", replica.id,
            replica.consecutive_failures,
            "" if self._factory is None
            else "; warming a replacement")
        # the replacement cycle runs off-thread: evict() may be called
        # from the sick replica's own worker thread (a future callback),
        # and shutting that server down joins the very thread
        threading.Thread(target=self._replace,
                         args=(replica, time.monotonic()),
                         name=f"mxtpu-router-replace-{replica.id}",
                         daemon=True).start()

    def _replace(self, old, t0):
        try:
            old.server.shutdown(drain=False, timeout=2.0)
        except Exception as e:  # noqa: BLE001 — a wedged server must
            # not block the replacement
            logger.warning("evicted replica %d shutdown failed: %s",
                           old.id, e)
        # failover: shutdown failed the QUEUED requests (their callbacks
        # re-dispatch); anything still outstanding is wedged in-flight —
        # claim and re-dispatch it here, racing the (possibly never
        # arriving) late completion via the resolve-once flag
        with self._lock:
            stuck = list(old.outstanding.items())
        for fut, rreq in stuck:
            fut.cancel()
            with self._lock:
                old.outstanding.pop(fut, None)
            if rreq.resolved:
                continue
            if self._claim_retry(rreq):
                self._redispatch_later(rreq, {old.id})
            else:
                self._resolve_exc(rreq, MXNetError(
                    f"replica {old.id} was evicted with the request "
                    f"in flight and the retry budget is exhausted "
                    f"(max_retries={self._retry.max_retries})"),
                    "failed", outcome="failed")
        if self._factory is None or self._closing:
            return
        rid = next(self._ids)
        try:
            srv = self._factory(rid)
            srv.start()   # FULL BucketSpec AOT warmup before admission
        except Exception as e:  # noqa: BLE001 — pool keeps serving at
            # reduced size; the operator sees it in healthy/pool_size
            logger.error("replacement replica %d failed to start: %s",
                         rid, e)
            return
        rep = Replica(rid, srv)
        with self._lock:
            if self._closing:
                admit = False
            else:
                self._pool.append(rep)
                admit = True
        if not admit:
            srv.shutdown(drain=False, timeout=2.0)
            return
        self.last_recovery_ms = round((time.monotonic() - t0) * 1e3, 3)
        self._stats.incr("replacements")
        _sec_bump(replacements=1)
        _tracer.instant("serve.router.admit", cat="serve", replica=rid,
                        recovery_ms=self.last_recovery_ms)
        logger.warning("replacement replica %d warmed and admitted "
                       "(%.0f ms after eviction)", rid,
                       self.last_recovery_ms)

    def _health_loop(self, stop):
        while not stop.wait(self._health_sec):
            with self._lock:
                reps = [r for r in self._pool if r.state == HEALTHY]
            for rep in reps:
                if stop.is_set() or self._closing:
                    return
                self._probe(rep)

    def _probe(self, replica):
        """One end-to-end health probe: a real (tiny) request through
        the replica's full submit->batch->compute->resolve path, so a
        wedged batcher or a dead device fails it, not just a dead
        process."""
        self._stats.incr("probes")
        _sec_bump(probes=1)
        budget_ms = max(self._health_sec, 0.25) * 1e3
        try:
            engine.fault_point("serve.replica.health", replica=replica.id)
            inner = replica.server.submit(self._probe_example,
                                          deadline_ms=budget_ms,
                                          **self._probe_kwargs)
            fut = getattr(inner, "future", inner)
            fut.result(timeout=budget_ms / 1e3)
            self._note_success(replica, None)
        except Exception as e:  # noqa: BLE001 — every probe failure is
            # a health datapoint, whatever its type
            self._stats.incr("probe_failures")
            _sec_bump(probe_failures=1)
            logger.warning("health probe failed on replica %d: %s",
                           replica.id, e)
            self._note_failure(replica)

    # -- pool scaling (the control plane's actuation primitives) ------------

    def admit(self, server=None):
        """Warm-admit ONE new replica into rotation — the scale-UP
        actuation path.  The replica is built from the factory when
        ``server`` is not given, and its full AOT-warming ``start()``
        runs BEFORE it joins the pool, so scaling up never serves a
        cold compile in traffic (same admission contract as the
        eviction path's warm spare).  Returns the new :class:`Replica`.
        """
        if not self._started:
            raise MXNetError("admit() needs a started Router")
        rid = next(self._ids)
        if server is None:
            if self._factory is None:
                raise MXNetError(
                    "admit() without server= needs a factory")
            server = self._factory(rid)
        server.start()
        rep = Replica(rid, server)
        with self._lock:
            ok = not self._closing
            if ok:
                self._pool.append(rep)
        if not ok:
            server.shutdown(drain=False, timeout=2.0)
            raise ServerClosedError(
                "router is draining/shut down; the admitted replica "
                "was discarded")
        _tracer.instant("serve.router.admit", cat="serve", replica=rid)
        logger.info("replica %d warmed and admitted (pool grows to %d)",
                    rid, len(self._pool))
        return rep

    def retire(self, replica=None, timeout=60.0):
        """Gracefully remove ONE replica from the pool — the scale-DOWN
        actuation path, riding the ``rolling_reload`` drain machinery:
        the replica (least-loaded healthy one by default) leaves
        rotation, its queued and in-flight work drains to completion,
        then it shuts down and drops from the pool.  Zero requests
        dropped; refuses to retire the last healthy replica.  Returns
        the retired replica's id."""
        with self._lock:
            cands = [r for r in self._pool if r.state == HEALTHY]
            if replica is not None:
                cands = [r for r in cands if r is replica
                         or r.id == replica]
        if not cands:
            raise MXNetError("retire(): no matching healthy replica")
        # score() reads the servers' live queue gauges OUTSIDE the pool
        # lock (one-directional router->batcher lock order, like _pick)
        rep = min(cands, key=lambda r: (r.score(), -r.id))
        with self._lock:
            healthy = sum(1 for r in self._pool if r.state == HEALTHY)
            if healthy <= 1:
                raise MXNetError(
                    "refusing to retire the last healthy replica — "
                    "shut the router down instead")
            if rep.state != HEALTHY:
                raise MXNetError(
                    f"replica {rep.id} left rotation while being "
                    "selected for retirement; retry")
            rep.state = RELOADING   # out of _pick, like a reload leg
        deadline = time.monotonic() + timeout
        try:
            while rep.server.pending() > 0 or rep.outstanding:
                if time.monotonic() > deadline:
                    raise MXNetError(
                        f"retire: replica {rep.id} did not drain "
                        f"within {timeout}s "
                        f"({rep.server.pending()} pending)")
                time.sleep(0.005)
        except Exception:
            with self._lock:   # put it back in rotation on failure
                if rep.state == RELOADING:
                    rep.state = HEALTHY
            raise
        try:
            rep.server.shutdown(
                drain=True,
                timeout=max(deadline - time.monotonic(), 1.0))
        except Exception as e:  # noqa: BLE001 — it is out of rotation
            # and drained; a noisy teardown must not undo the retire
            logger.warning("retired replica %d shutdown failed: %s",
                           rep.id, e)
        with self._lock:
            if rep in self._pool:
                self._pool.remove(rep)
        logger.info("replica %d drained and retired (pool shrinks "
                    "to %d)", rep.id, len(self._pool))
        return rep.id

    # -- rolling reload -----------------------------------------------------

    def rolling_reload(self, step=None, timeout=60.0):
        """Hot weight rollout with zero dropped requests: one replica
        at a time leaves rotation, drains its already-dispatched work,
        ``reload_weights(step)``s, and rejoins — the rest of the pool
        keeps serving throughout, and every request is served entirely
        by pre- or post-reload weights (a request never sees a mix:
        it runs on exactly one replica, whose reload is serialized
        against batch execution).  A single-replica pool reloads in
        place (the server's exec lock already guarantees no drops).
        Returns the per-replica reload metadata."""
        out = []
        with self._lock:
            targets = [r for r in self._pool if r.state == HEALTHY]
        for rep in targets:
            with self._lock:
                if rep.state != HEALTHY:
                    continue   # evicted while we were reloading others
                others = any(r is not rep and r.state == HEALTHY
                             for r in self._pool)
                if others:
                    rep.state = RELOADING
            try:
                if others:
                    deadline = time.monotonic() + timeout
                    while rep.server.pending() > 0 or rep.outstanding:
                        if time.monotonic() > deadline:
                            raise MXNetError(
                                f"rolling reload: replica {rep.id} did "
                                f"not drain within {timeout}s "
                                f"({rep.server.pending()} pending)")
                        time.sleep(0.005)
                meta = rep.server.reload_weights(step)
            finally:
                with self._lock:
                    if rep.state == RELOADING:
                        rep.state = HEALTHY
            self._stats.incr("reloads")
            _sec_bump(reloads=1)
            _tracer.instant("serve.router.reload", cat="serve",
                            replica=rep.id, step=meta.get("step", -1))
            out.append(dict(meta, replica=rep.id))
        return out

    # -- observability ------------------------------------------------------

    def stats(self, reset=False):
        """Pool snapshot: routing counters, router-level latency
        percentiles, per-replica health/attribution, and the
        ``requests_lost`` audit (submitted minus every accounted
        outcome minus still-outstanding — 0 unless a request fell
        through an unhandled hole; exact when quiescent, like
        ``ModelServer.stats``).  ``reset=True`` window-scopes the
        counters exactly like the servers' ``stats(reset=True)``."""
        with self._lock:
            pool = [(r, r.state) for r in self._pool]
        # the replicas' gauges are read OUTSIDE the pool lock: a remote
        # replica's pending() is a round trip, and the lock must not wait
        # on one (dispatch and admission take it; the JAX package holds it)
        replicas = {r.id: dict(r.info(), state=st) for r, st in pool}
        healthy = sum(1 for _, st in pool if st == HEALTHY)
        pool_size = sum(1 for _, st in pool if st != EVICTED)
        pending = sum(replicas[r.id]["pending"] for r, st in pool
                      if st != EVICTED)
        outstanding = len(self._outstanding)
        snap = self._stats.snapshot(queue_depth=pending,
                                    in_flight=outstanding, reset=reset)
        snap["requests_lost"] = (
            snap["submitted"] - snap["served"] - snap["failed"]
            - snap["rejected_overload"] - snap["expired_deadline"]
            - snap["cancelled"] - outstanding)
        snap["pool_size"] = pool_size
        snap["healthy"] = healthy
        snap["last_recovery_ms"] = self.last_recovery_ms
        snap["replicas"] = replicas
        return snap

    @property
    def replicas(self):
        """Current pool members (evicted ones drop out)."""
        with self._lock:
            return [r for r in self._pool if r.state != EVICTED]


#: the pool-management reading of the same object
ReplicaPool = Router
