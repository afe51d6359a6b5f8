"""Span tracer: event-level timelines for the production subsystems
(ref: ``mxnet_tpu/telemetry/tracer.py``).

The profiler's counter sections answer "how much, in aggregate"; the
tracer answers "where did step 412 go" — nested, thread-lane-aware
spans with key/value attrs, recorded into a lock-cheap per-thread
buffer and exported as Chrome trace-event JSON (load the file straight
into Perfetto / chrome://tracing).

Disabled-by-default cost follows the ``engine.fault_point`` pattern:
every hook below (``span_begin``/``span_end``/``instant``/
``request_begin``/``request_instant``/``request_end``) is a rebindable
module global whose disarmed binding IS :func:`_noop` — one call,
zero branches taken, measured in ~ns and asserted by
the tests.  Arming (``start_trace`` /
``telemetry.trace(path)`` / ``MXTPU_TRACE=<path>`` / the flight
recorder) rebinds them to the recording implementations; callers
resolve the CURRENT binding through the module attribute
(``tracer.span_begin(...)``), exactly like ``engine.fault_point``.

Span model:

- **scope spans** — ``span_begin(name, cat)`` / ``span_end(name,
  cat, **attrs)`` pairs on one thread, exported as complete ``"X"``
  events (ts + dur).  ``profiler.op_scope`` emits these automatically
  while tracing is armed, so every existing op scope (trainer
  allreduce/fused_update, pipeline stages, serve batches, checkpoint
  phases) is a span for free.
- **instants** — ``instant(name, cat, **attrs)``: a point event
  (``"i"``, thread scope) for things with no duration (a supervisor
  retry, a watchdog fire).
- **request spans** — ``rid = request_begin(name, cat, **attrs)`` /
  ``request_instant`` / ``request_end``: Chrome *async* events
  (``"b"``/``"n"``/``"e"`` sharing an id) that follow one logical
  request across threads — how a serve request is traced
  submit→queue→dispatch→resolve.

Per-thread buffers: a thread's spans append to its own list (no lock
on the hot path); the global registry of lanes is only locked on
first-touch and at export.  Each lane is capped (``_LANE_CAP``) so a
runaway trace degrades by dropping (counted) instead of eating the
heap.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time

from ..base import MXNetError

_PID = os.getpid()
_LANE_CAP = 200_000          # events per thread lane before dropping

_lock = threading.Lock()     # lanes registry + arm/disarm + counters
_lanes = []                  # [{"tid", "name", "events": []}]
_state = threading.local()   # .events (this thread's lane), .stack
_trace_on = False
_trace_path = None
_flight_ring = None          # collections.deque(maxlen=...) when armed
_rid_counter = itertools.count(1)
# arming generation: bumped on every arm/disarm transition so a span
# begun in one session can never close (with a garbage duration) in a
# later one — begin/end must see the same epoch to emit
_epoch = 0

# window-scoped telemetry counters (the profiler's "telemetry" section)
_counters = {
    "spans": 0,              # completed scope spans recorded
    "instants": 0,           # point events recorded
    "requests": 0,           # async request spans opened
    "dropped": 0,            # events lost to the per-lane cap
    "flight_dumps": 0,       # flight-recorder files written
    "scrapes": 0,            # /metrics renders served
    "aggregations": 0,       # telemetry.aggregate() calls
}


def _noop(*_args, **_kwargs):
    """Disarmed telemetry hook: nothing beyond the call is evaluated
    (and ``request_begin`` callers get ``None`` for the request id, so
    the matching ``request_end(None)`` is a no-op too)."""
    return None


# -- recording implementations ----------------------------------------------


def _now_us():
    return time.perf_counter() * 1e6


def _lane_events():
    ev = getattr(_state, "events", None)
    if ev is None:
        ev = _state.events = []
        _state.stack = []
        th = threading.current_thread()
        with _lock:
            _lanes.append({"tid": th.ident % 100000, "name": th.name,
                           "events": ev})
    return ev


def _emit(ev):
    if _flight_ring is not None:
        _flight_ring.append(ev)     # deque.append is atomic
    if _trace_on:
        events = _lane_events()
        if len(events) >= _LANE_CAP:
            with _lock:
                _counters["dropped"] += 1
            return
        events.append(ev)


def _clean_attrs(attrs):
    return {k: (v if isinstance(v, (int, float, str, bool)) else str(v))
            for k, v in attrs.items()}


def _span_begin(name, cat="op"):
    _lane_events()                   # ensure .stack exists
    _state.stack.append((name, _now_us(), _epoch))


def _span_end(name, cat="op", **attrs):
    stack = getattr(_state, "stack", None)
    if not stack or stack[-1][0] != name:
        return                       # armed mid-span: nothing to close
    _nm, t0, epoch = stack.pop()
    if epoch != _epoch:
        return    # begun under a previous arming session: the t0 is
        # from another trace — emitting would fabricate a phantom span
    t1 = _now_us()
    ev = {"name": name, "ph": "X", "ts": t0,
          "dur": max(t1 - t0, 0.01), "pid": _PID,
          "tid": threading.get_ident() % 100000, "cat": cat}
    if attrs:
        ev["args"] = _clean_attrs(attrs)
    with _lock:
        _counters["spans"] += 1
    _emit(ev)


def _instant(name, cat="op", **attrs):
    ev = {"name": name, "ph": "i", "ts": _now_us(), "pid": _PID,
          "tid": threading.get_ident() % 100000, "cat": cat, "s": "t"}
    if attrs:
        ev["args"] = _clean_attrs(attrs)
    with _lock:
        _counters["instants"] += 1
    _emit(ev)


def _request_begin(name, cat="request", **attrs):
    rid = next(_rid_counter)
    ev = {"name": name, "ph": "b", "ts": _now_us(), "pid": _PID,
          "tid": threading.get_ident() % 100000, "cat": cat, "id": rid}
    if attrs:
        ev["args"] = _clean_attrs(attrs)
    with _lock:
        _counters["requests"] += 1
    _emit(ev)
    return rid


def _request_instant(name, rid, cat="request", **attrs):
    if rid is None:
        return
    ev = {"name": name, "ph": "n", "ts": _now_us(), "pid": _PID,
          "tid": threading.get_ident() % 100000, "cat": cat, "id": rid}
    if attrs:
        ev["args"] = _clean_attrs(attrs)
    _emit(ev)


def _request_end(name, rid, cat="request", **attrs):
    if rid is None:
        return
    ev = {"name": name, "ph": "e", "ts": _now_us(), "pid": _PID,
          "tid": threading.get_ident() % 100000, "cat": cat, "id": rid}
    if attrs:
        ev["args"] = _clean_attrs(attrs)
    _emit(ev)


# -- the rebindable hook surface (disarmed = _noop) --------------------------

span_begin = _noop
span_end = _noop
instant = _noop
request_begin = _noop
request_instant = _noop
request_end = _noop

_HOOKS = {
    "span_begin": _span_begin,
    "span_end": _span_end,
    "instant": _instant,
    "request_begin": _request_begin,
    "request_instant": _request_instant,
    "request_end": _request_end,
}


def _rebind():
    """Point the hook surface at the recording impls iff any consumer
    (trace export, flight ring) is armed; else back to the no-op.
    Every transition bumps the epoch, invalidating any span stack
    entries left dangling by a mid-span arm/disarm."""
    global _epoch
    _epoch += 1
    active = _trace_on or _flight_ring is not None
    g = globals()
    for name, impl in _HOOKS.items():
        g[name] = impl if active else _noop


def armed():
    """True when any hook is recording (tracing or flight ring)."""
    return span_begin is not _noop


def tracing():
    """True while a trace export is armed (``start_trace`` .. ``stop_trace``)."""
    return _trace_on


# -- arming ------------------------------------------------------------------


def start_trace(path):
    """Arm span recording; ``stop_trace()`` exports to ``path``."""
    global _trace_on, _trace_path
    if not path:
        raise MXNetError("start_trace needs an output path")
    with _lock:
        if _trace_on:
            raise MXNetError(
                f"tracing is already armed (exporting to {_trace_path});"
                " stop_trace() first")
        for lane in _lanes:
            del lane["events"][:]    # in place: thread-locals alias it
        _trace_path = str(path)
        _trace_on = True
    _rebind()


def stop_trace():
    """Disarm and export the collected spans as Chrome trace-event
    JSON; returns the path written (None when tracing was not armed)."""
    global _trace_on, _trace_path
    with _lock:
        if not _trace_on:
            return None
        _trace_on = False
        path = _trace_path
        _trace_path = None
        data = export_events()
        # release the buffered events now, not at the next arm: a
        # one-shot trace of a heavy window would otherwise pin up to
        # _LANE_CAP event dicts per thread for the process lifetime
        # (in place — thread-locals alias these lists)
        for lane in _lanes:
            del lane["events"][:]
    _rebind()
    with open(path, "w") as f:
        json.dump({"traceEvents": data, "displayTimeUnit": "ms"}, f)
    return path


def export_events():
    """The current event list (thread-name metadata first, then every
    lane's events) — what ``stop_trace`` writes under ``traceEvents``."""
    out = [{"name": "process_name", "ph": "M", "pid": _PID, "tid": 0,
            "args": {"name": "mxnet_tpu_torch"}}]
    for lane in _lanes:
        out.append({"name": "thread_name", "ph": "M", "pid": _PID,
                    "tid": lane["tid"], "args": {"name": lane["name"]}})
        out.extend(list(lane["events"]))
    out.sort(key=lambda ev: ev.get("ts", 0))
    return out


def set_flight_ring(ring):
    """Attach/detach the flight recorder's bounded ring (a deque with
    maxlen, or None); arming it turns span recording on even when no
    trace export is armed."""
    global _flight_ring
    with _lock:
        _flight_ring = ring
    _rebind()


def flight_ring():
    return _flight_ring


def bump(counter, n=1):
    """Count one telemetry-internal event (flight dump, scrape, ...)
    into the window-scoped ``telemetry`` profiler section."""
    with _lock:
        _counters[counter] += n


def telemetry_stats():
    """Snapshot of the telemetry counters since the last reset."""
    with _lock:
        return dict(_counters)


def reset_telemetry_stats():
    with _lock:
        for k in _counters:
            _counters[k] = 0
