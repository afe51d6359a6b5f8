"""Resilience telemetry — the ``resilience`` profiler section (ref:
``mxnet_tpu/resilience/stats.py``).

Recovery must be OBSERVABLE to be trusted: after a chaos rehearsal (or
a real preemption) these counters answer "what did the supervisor
actually do" — how many times ``train_fn`` was re-invoked, which fault
classes forced a retry, whether a corrupt checkpoint silently fell back
to an older step, how often the progress watchdog fired, and how much
wall time recovery cost.

Window-scoped like the cachedGraph/trainerStep/dataPipeline sections:
``profiler.dumps(reset=True)`` resets them with the event buffer.
"""
from __future__ import annotations

import threading

_lock = threading.Lock()
_stats = {
    "restarts": 0,          # train_fn re-invocations (any fault class)
    "retries": {},          # fault class -> recovery count
    "fallback_restores": 0,  # restore() fell back past a corrupt newest
    "watchdog_fires": 0,    # progress watchdog expiries
    "time_lost_ms": 0.0,    # failure -> re-invocation wall time
    "resizes": 0,           # elastic world shrinks (peer death -> M)
    "ranks_lost": 0,        # ranks dropped across those resizes
    "reshard_ms": 0.0,      # checkpoint repartition wall time
}


def add(key, value=1):
    """Accumulate one scalar counter (thread-safe)."""
    with _lock:
        _stats[key] += value


def add_retry(fault_class, value=1):
    """Count one recovery under its fault class (thread-safe)."""
    with _lock:
        _stats["retries"][fault_class] = \
            _stats["retries"].get(fault_class, 0) + value


def resilience_stats():
    """Snapshot of the resilience counters since the last reset."""
    with _lock:
        s = dict(_stats)
        s["retries"] = dict(_stats["retries"])
    s["time_lost_ms"] = round(s["time_lost_ms"], 3)
    s["reshard_ms"] = round(s["reshard_ms"], 3)
    return s


def reset_resilience_stats():
    with _lock:
        for k in _stats:
            if k == "retries":
                _stats[k] = {}
            else:
                _stats[k] = 0.0 if isinstance(_stats[k], float) else 0
