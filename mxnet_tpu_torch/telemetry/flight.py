"""Flight recorder: the last seconds of a crashing job, on disk (ref:
``mxnet_tpu/telemetry/flight.py``).

A bounded ring (``collections.deque(maxlen=ring_size)``) of the most
recent telemetry events rides in :mod:`.tracer`; on a watchdog fire, a
fatal supervisor failure, or SIGTERM the ring plus a counters snapshot
is dumped to ``flight-<rank>-<ts>.json`` — a loadable Chrome-trace
timeline of what the process was doing when it died, with the
profiler's counter sections and currently-OPEN op scopes attached for
post-mortem context.

Arming:

- ``MXTPU_FLIGHT_RECORDER=<ring size>`` arms it process-wide at
  telemetry import (``0``/``off`` forces it off everywhere);
- ``resilience.Supervisor.run`` auto-arms it for the duration of the
  supervised job (default ring 512, dumps land next to the
  checkpoints) unless the env var said ``off``;
- ``enable(size, directory)`` / ``disable()`` for manual control.

Disarmed there is no ring and the tracer hooks stay bound to the
no-op — the same zero-cost contract as ``engine.fault_point``.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time

from ..base import getenv
from . import tracer

DEFAULT_RING = 512

_lock = threading.Lock()
_directory = "."
_auto_depth = 0          # nested Supervisor auto-enables


def _env_setting():
    """``MXTPU_FLIGHT_RECORDER``: None (unset), 0 (explicit off), or a
    ring size."""
    raw = getenv("FLIGHT_RECORDER")
    if raw is None:
        return None
    if str(raw).strip().lower() in ("0", "off", "false", "no"):
        return 0
    try:
        return max(1, int(raw))
    except ValueError:
        return DEFAULT_RING


def enabled():
    return tracer.flight_ring() is not None


def enable(size=None, directory=None):
    """Arm the ring (idempotent; a second call only resizes/re-aims).
    ``size`` defaults to ``MXTPU_FLIGHT_RECORDER`` or 512."""
    global _directory
    if size is None:
        size = _env_setting() or DEFAULT_RING
    size = max(1, int(size))
    with _lock:
        if directory is not None:
            _directory = str(directory)
        ring = tracer.flight_ring()
        if ring is not None and ring.maxlen == size:
            return
        old = list(ring) if ring is not None else []
        tracer.set_flight_ring(
            collections.deque(old[-size:], maxlen=size))


def disable():
    tracer.set_flight_ring(None)


def auto_enable(directory=None):
    """Supervisor entry hook: arm with defaults unless the env var
    explicitly said off.  A ring armed BEFORE the supervised run
    (manual ``enable()`` or the env var) is left exactly as configured
    — size, directory and post-run lifetime all belong to whoever
    armed it.  Nested/repeated supervised runs refcount, so the
    outermost exit disarms only what this hook armed."""
    global _auto_depth
    if _env_setting() == 0:
        return None
    if enabled():
        return "riding"        # pre-armed: don't resize, don't disarm
    enable(directory=directory)
    with _lock:
        _auto_depth += 1
    return "armed"


def auto_disable(token):
    """Supervisor exit hook; pass ``auto_enable``'s return value."""
    global _auto_depth
    if token != "armed":
        return
    with _lock:
        _auto_depth = max(0, _auto_depth - 1)
        keep = _auto_depth > 0
    if not keep:
        disable()


def dump(reason, directory=None, extra=None):
    """Write the ring + counters snapshot; returns the file path.

    The file is itself valid Chrome trace-event JSON (``traceEvents``
    at top level) so Perfetto loads the crash timeline directly; the
    ``counters`` (profiler sections), ``activeScopes`` (open op scopes,
    when the watchdog armed tracking), and ``extra`` keys carry the
    post-mortem context.
    """
    ring = tracer.flight_ring()
    events = list(ring) if ring is not None else []
    from .. import profiler

    data = {
        "reason": str(reason),
        "rank": _rank(),
        "time_unix": time.time(),
        "ring_size": ring.maxlen if ring is not None else 0,
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "counters": profiler.sections(),
        "activeScopes": {str(k): v for k, v in
                         profiler.active_scopes().items()},
    }
    if extra:
        data["extra"] = dict(extra)
    d = str(directory) if directory is not None else _directory
    os.makedirs(d, exist_ok=True)
    path = os.path.join(
        d, f"flight-{data['rank']}-{int(data['time_unix'] * 1e3)}.json")
    n = 0
    while os.path.exists(path):    # same-ms dumps: never overwrite
        n += 1
        path = path[:path.rindex(".json")].split("~")[0] + f"~{n}.json"
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f)
    os.replace(tmp, path)          # atomic: SIGKILL window safe
    tracer.bump("flight_dumps")
    return path


def dump_if_enabled(reason, directory=None, extra=None):
    """Best-effort dump for signal handlers / crash paths: no-op when
    the ring is disarmed, and never raises."""
    if not enabled():
        return None
    try:
        return dump(reason, directory=directory, extra=extra)
    except Exception:  # noqa: BLE001 — a dump must not mask the crash
        return None


def _rank():
    try:
        from ..parallel import dist

        return int(dist.rank())
    except Exception:  # noqa: BLE001 — pre-init: rank 0
        return 0
