"""End-to-end observability: span tracing, flight recorder, metrics
(ref: ``mxnet_tpu/telemetry/__init__.py``).

Three tiers:

- :mod:`.tracer` — nested, thread-lane-aware spans exported as Chrome
  trace-event JSON (Perfetto-loadable).  ``with telemetry.trace(path):``
  or ``MXTPU_TRACE=<path>`` arms it; the existing ``profiler.op_scope``
  sites (trainer step, pipeline stages, serve batches, checkpoint
  phases) emit spans automatically, and the serve request lifecycle is
  followed across threads with async request spans.
- :mod:`.flight` — a bounded ring of the most recent spans dumped to
  ``flight-<rank>-<ts>.json`` on watchdog fire, fatal supervisor
  failure, and SIGTERM, so every crash leaves a loadable timeline.
- :mod:`.metrics` + :mod:`.httpd` — one counter/gauge/histogram
  registry unifying the profiler sections and ``serve.stats()``,
  served as Prometheus text from ``/metrics`` (+``/healthz``) on
  ``MXTPU_METRICS_PORT``.

Everything is off by default at ``engine.fault_point`` cost: the span
hooks are rebindable module globals bound to a no-op until armed.
"""
from __future__ import annotations

import atexit
import contextlib
import json

from ..base import getenv
from . import flight, health, httpd, metrics, tracer  # noqa: F401
from .health import HealthMonitor, SLORule, active_monitor  # noqa: F401
from .httpd import (MetricsServer, metrics_server,  # noqa: F401
                    start_metrics_server, stop_metrics_server)
from .metrics import Registry, default_registry, register_server  # noqa: F401
from .tracer import armed, start_trace, stop_trace  # noqa: F401

__all__ = [
    "trace", "start_trace", "stop_trace", "armed", "tracing",
    "sections", "aggregate", "tracer", "flight", "health", "metrics",
    "httpd", "HealthMonitor", "SLORule", "active_monitor",
    "MetricsServer", "Registry", "default_registry", "register_server",
    "metrics_server", "start_metrics_server", "stop_metrics_server",
]


def tracing():
    """True while a trace export is armed."""
    return tracer.tracing()


@contextlib.contextmanager
def trace(path):
    """Arm span tracing for the block; on exit the collected spans are
    exported to ``path`` as Chrome trace-event JSON::

        with telemetry.trace("step.trace.json"):
            train_some_steps()
        # load step.trace.json in Perfetto / chrome://tracing
    """
    start_trace(path)
    try:
        yield
    finally:
        stop_trace()


def sections(reset=False):
    """This rank's profiler counter sections (the same dict
    ``profiler.dumps()`` embeds)."""
    from .. import profiler

    return profiler.sections(reset)


def aggregate(reset=False):
    """Allgather every rank's counter sections.

    Returns ``{"world_size": P, "rank": r, "ranks": [sections_rank0,
    ..., sections_rankP-1]}`` on every rank (the exchange is an
    allgather over ``parallel.dist``'s world mesh, so rank 0's monitor
    and every peer see the same thing).  Single-process: world_size 1.
    """
    from ..parallel import dist

    snap = sections(reset)
    payloads = dist.allgather_bytes(
        json.dumps(snap, sort_keys=True).encode())
    tracer.bump("aggregations")
    return {"world_size": len(payloads), "rank": dist.rank(),
            "ranks": [json.loads(p.decode()) for p in payloads]}


# -- env bootstrap -----------------------------------------------------------


def _arm_from_env():
    """Arm whatever the environment asked for (idempotent; called at
    import — ``mxnet_tpu_torch/__init__`` imports this package eagerly when
    any telemetry env var is set)."""
    path = getenv("TRACE")
    if path and not tracer.tracing():
        start_trace(path)
        atexit.register(stop_trace)
    if flight._env_setting():
        flight.enable()
    port = getenv("METRICS_PORT", None, int)
    if port is not None and metrics_server() is None:
        start_metrics_server(port)


_arm_from_env()
