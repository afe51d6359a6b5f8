"""The serving control plane: the process boundary of the serving stack
(ref: ``mxnet_tpu/serve/control_plane/``).

The :class:`~..router.Router` fronts replicas in its own process; this
package lets it front replicas in OTHER processes, with the router's
failure matrix unchanged:

- :mod:`.rpc`: the socket wire, the JAX package's byte for byte.  A
  replica process wraps its started ``ModelServer``/``DecodeServer`` in a
  :class:`~.rpc.ReplicaEndpoint` (length-prefixed frames over a threaded
  stdlib ``socketserver``; payloads in the ``utils/serialization.py``
  container) and registers itself in a shared lease directory
  (``parallel.dist.LeaseDir``).  A :class:`~.rpc.RemoteReplica` client
  speaks the ``submit()/pending()/probe_example()/reload_weights()/
  drain()`` surface the Router scores and evicts.
- :mod:`.pool`: :class:`~.pool.ReplicaProcess` (spawn of a fresh
  interpreter, and the registration wait: workers warm up BEFORE they
  register, so admission is always warm) and :class:`~.pool.ControlPlane`
  (a spawn-backed Router factory and ``scale_up()/scale_down()``).
- :mod:`.autoscale`: :class:`~.autoscale.Autoscaler`, a ticker with
  hysteresis, bounds and a cooldown over the pool's occupancy and a
  health monitor's verdict, acting through the warm admission and the
  drain paths.

This module's window counters are the profiler's ``ctrl`` section
(``mxtpu_ctrl_*`` on /metrics); scaling decisions emit
``serve.ctrl.scale`` instants and every endpoint request runs under a
``serve.rpc.request`` span.
"""
from __future__ import annotations

import threading

# ---------------------------------------------------------------------------
# window-scoped module counters: the profiler's `ctrl` section
# (provider: profiler._ctrl_counters; exported to /metrics as
# mxtpu_ctrl_* gauges by the section collector)

_sec_lock = threading.Lock()
_sec = {"ticks": 0, "scale_ups": 0, "scale_downs": 0,
        "blocked_cooldown": 0, "blocked_bounds": 0,
        "spawns": 0, "spawn_failures": 0, "retired": 0,
        "rpc_requests": 0, "rpc_streams": 0, "rpc_errors": 0,
        "stale_leases_rejected": 0,
        "replicas": 0, "load": 0.0}


def _sec_bump(replicas=None, load=None, **deltas):
    with _sec_lock:
        for k, n in deltas.items():
            _sec[k] += n
        if replicas is not None:
            # level gauges, not counters: the latest tick's pool size
            # and load signal
            _sec["replicas"] = int(replicas)
        if load is not None:
            _sec["load"] = round(float(load), 4)


def ctrl_stats():
    """Window snapshot of the control-plane counters (RPC traffic,
    spawn/retire churn, autoscaler decisions and the blocked-action
    tallies that explain a pool that is NOT moving)."""
    with _sec_lock:
        return dict(_sec)


def reset_ctrl_stats():
    with _sec_lock:
        for k in _sec:
            _sec[k] = 0.0 if k == "load" else 0


from .autoscale import Autoscaler                          # noqa: E402
from .pool import (ControlPlane, ReplicaProcess,           # noqa: E402
                   ReplicaSpawnError)
from .rpc import (RPCConnectionError, RemoteReplica,       # noqa: E402
                  ReplicaEndpoint, WIRE_VERSION, discover_replicas,
                  recv_frame, send_frame, serve_replica)

__all__ = [
    "Autoscaler", "ControlPlane", "RPCConnectionError",
    "RemoteReplica", "ReplicaEndpoint", "ReplicaProcess",
    "ReplicaSpawnError", "WIRE_VERSION", "ctrl_stats",
    "discover_replicas", "recv_frame", "reset_ctrl_stats",
    "send_frame", "serve_replica",
]
