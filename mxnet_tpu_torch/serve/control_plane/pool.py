"""Process management for the control plane: spawn replica worker
processes, wait for their warm registration, and front them with the
Router as a cross-process pool (ref: ``mxnet_tpu/serve/control_plane/
pool.py``).

:class:`ReplicaProcess` owns ONE worker subprocess: ``spawn()`` starts a
fresh interpreter (``subprocess.Popen``, never a fork of a process that
holds CUDA state) behind the ``serve.replica.spawn`` fault point, and
``wait_registered()`` blocks until the worker's lease appears in the
shared registry directory.  Workers register only AFTER their server's
warm-up, so a registered replica is a WARM replica.  :class:`ControlPlane`
makes that a Router ``factory``: the router's eviction and warm-spare
machinery replaces whole processes, and ``scale_up()/scale_down()`` are
the admit/retire actions the :class:`~.autoscale.Autoscaler` drives.
"""
from __future__ import annotations

import subprocess
import time

from ... import engine
from ...base import MXNetError, getenv
from ...log import get_logger
from ..router import HEALTHY, Router
from . import _sec_bump
from .rpc import RemoteReplica, _registry

logger = get_logger("mxnet_tpu_torch.serve.control_plane.pool")


class ReplicaSpawnError(MXNetError):
    """A replica worker process could not be spawned or never
    registered.  Worded as a transient condition on purpose: the
    supervisor/router retry machinery treats spawn hiccups as
    retry-with-pacing, not fatal."""

    def __init__(self, msg):
        super().__init__(
            f"replica process spawn failed (temporarily "
            f"unavailable): {msg}")


class ReplicaProcess:
    """One replica worker subprocess plus its registration handshake.

    The worker's stdout/stderr land in ``replica-<id>.log`` next to the
    registry markers, and the tail of that log is quoted in the
    :class:`ReplicaSpawnError` when the worker dies before registering
    — the difference between "spawn failed" and "spawn failed: port
    already in use" at 3am.
    """

    def __init__(self, argv, registry_dir, replica_id, *, env=None,
                 start_timeout=None, lease_sec=None):
        self.argv = list(argv)
        self.registry_dir = registry_dir
        self.replica_id = replica_id
        self._env = env          # None = inherit the parent environment
        self._start_timeout = float(
            getenv("CTRL_SPAWN_TIMEOUT_SEC", 120.0, float)
            if start_timeout is None else start_timeout)
        self._leases = _registry(registry_dir, lease_sec)
        self._log_path = self._leases.path_for(replica_id)[:-5] + ".log"
        self._proc = None

    def spawn(self):
        """Start the worker, a fresh interpreter (fault point
        ``serve.replica.spawn``)."""
        engine.fault_point("serve.replica.spawn",
                           replica=self.replica_id)
        try:
            with open(self._log_path, "ab") as log:
                self._proc = subprocess.Popen(
                    self.argv, stdout=log, stderr=subprocess.STDOUT,
                    env=self._env)
        except OSError as e:
            raise ReplicaSpawnError(
                f"exec {self.argv[0]!r} for replica "
                f"{self.replica_id}: {e}") from e
        logger.info("replica %s spawned as pid %d",
                    self.replica_id, self._proc.pid)
        return self

    def wait_registered(self, timeout=None):
        """Block until the worker's lease shows up (it warmed and is
        serving); returns the registration payload ``{"host", "port",
        "pid", "kind"}``."""
        if self._proc is None:
            raise MXNetError("wait_registered() before spawn()")
        deadline = time.monotonic() + (self._start_timeout
                                       if timeout is None else timeout)
        key = str(self.replica_id)
        while True:
            payload = self._leases.fresh().get(key)
            if payload is not None and payload.get("pid") == \
                    self._proc.pid:
                return payload
            if self._proc.poll() is not None:
                raise ReplicaSpawnError(
                    f"replica {self.replica_id} worker (pid "
                    f"{self._proc.pid}) exited with code "
                    f"{self._proc.returncode} before registering:"
                    f"\n{self._log_tail()}")
            if time.monotonic() > deadline:
                raise ReplicaSpawnError(
                    f"replica {self.replica_id} worker (pid "
                    f"{self._proc.pid}) did not register within "
                    f"{self._start_timeout}s:\n{self._log_tail()}")
            time.sleep(0.05)

    def _log_tail(self, n=2000):
        try:
            with open(self._log_path, "rb") as f:
                f.seek(0, 2)
                f.seek(max(f.tell() - n, 0))
                return f.read().decode(errors="replace")
        except OSError:
            return "<no worker log>"

    @property
    def pid(self):
        return self._proc.pid if self._proc is not None else None

    def alive(self):
        return self._proc is not None and self._proc.poll() is None

    def stop(self, timeout=10.0):
        """Terminate the worker (escalating to SIGKILL) and retire its
        lease so routers stop discovering a corpse."""
        if self._proc is not None and self._proc.poll() is None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait(5.0)
        self._leases.retire(str(self.replica_id))

    def kill(self):
        """SIGKILL, no grace — the chaos path."""
        if self._proc is not None and self._proc.poll() is None:
            self._proc.kill()
            self._proc.wait(5.0)


class ControlPlane:
    """A Router whose replicas are worker PROCESSES.

    ``worker_argv_fn(replica_id) -> argv`` describes how to launch one
    worker (typically ``python -m mxnet_tpu_torch.serve.control_plane.worker
    --registry DIR --id N --seed S ...``; every worker gets the SAME
    seed so replicas are bit-identical and failover is invisible).
    The control plane wires that through a Router factory: spawn →
    wait for the warm registration → :class:`~.rpc.RemoteReplica` —
    so health eviction replaces dead processes with freshly spawned
    warm ones, and ``scale_up()/scale_down()`` grow and drain the pool
    through the router's admit/retire paths (never a cold compile, and
    never a dropped request, in traffic).
    """

    def __init__(self, worker_argv_fn, registry_dir, n_replicas, *,
                 capacity_hint=8, spawn_timeout=None, lease_sec=None,
                 spawn_env=None, **router_kwargs):
        self._argv_fn = worker_argv_fn
        self._registry_dir = registry_dir
        self._lease_sec = lease_sec
        self._spawn_timeout = spawn_timeout
        self._spawn_env = spawn_env
        self._capacity_hint = max(int(capacity_hint), 1)
        self._replicas = {}     # rid -> RemoteReplica (live members)
        self.router = Router(factory=self._spawn_replica,
                             n_replicas=int(n_replicas),
                             **router_kwargs)

    # -- the Router factory (also the eviction warm-spare path) -------------

    def _spawn_replica(self, rid):
        _sec_bump(spawns=1)
        proc = ReplicaProcess(self._argv_fn(rid), self._registry_dir,
                              rid, env=self._spawn_env,
                              start_timeout=self._spawn_timeout,
                              lease_sec=self._lease_sec)
        try:
            proc.spawn()
            payload = proc.wait_registered()
        except Exception:
            _sec_bump(spawn_failures=1)
            try:
                proc.stop(timeout=2.0)
            except Exception:  # noqa: BLE001 — the spawn error wins
                pass
            raise
        replica = RemoteReplica(payload["host"], payload["port"],
                                rid=rid, process=proc)
        self._replicas[rid] = replica
        return replica

    # -- lifecycle + the serving edge (delegates to the Router) -------------

    def start(self):
        self.router.start()
        _sec_bump(replicas=self.healthy_count())
        return self

    def shutdown(self, drain=True, timeout=None):
        try:
            self.router.shutdown(drain=drain, timeout=timeout)
        finally:
            for replica in list(self._replicas.values()):
                if replica.process is not None:
                    try:
                        replica.process.stop(timeout=5.0)
                    except Exception:  # noqa: BLE001 — teardown sweep
                        pass
            self._replicas.clear()
            _sec_bump(replicas=0)

    def submit(self, example, deadline_ms=None, tenant=None, **kw):
        return self.router.submit(example, deadline_ms=deadline_ms,
                                  tenant=tenant, **kw)

    def submit_stream(self, example, deadline_ms=None, tenant=None,
                      **kw):
        return self.router.submit_stream(example,
                                         deadline_ms=deadline_ms,
                                         tenant=tenant, **kw)

    def predict(self, example, deadline_ms=None, timeout=None,
                tenant=None, **kw):
        return self.router.predict(example, deadline_ms=deadline_ms,
                                   timeout=timeout, tenant=tenant, **kw)

    def stats(self, reset=False):
        return self.router.stats(reset=reset)

    def rolling_reload(self, step=None, timeout=60.0):
        return self.router.rolling_reload(step=step, timeout=timeout)

    # -- the autoscaler's actuation + sensing surface -----------------------

    def healthy_count(self):
        with self.router._lock:
            return sum(1 for r in self.router._pool
                       if r.state == HEALTHY)

    def replica_count(self):
        with self.router._lock:
            return len(self.router._pool)

    def load(self):
        """Mean replica occupancy in [0, ~1.5]: live queue depth over
        the per-replica ``capacity_hint``.  An unreachable replica
        reports a huge ``pending()`` (the router's scoring convention)
        and is clamped, so one dead worker reads as pressure, not as
        infinity."""
        with self.router._lock:
            reps = [r for r in self.router._pool
                    if r.state == HEALTHY]
        if not reps:
            return 0.0
        occ = [min(r.server.pending() / self._capacity_hint, 1.5)
               for r in reps]
        return sum(occ) / len(occ)

    def scale_up(self):
        """Admit one freshly spawned, warm replica; returns its id."""
        rep = self.router.admit()
        _sec_bump(replicas=self.replica_count())
        return rep.id

    def scale_down(self, timeout=60.0):
        """Drain and retire the least-loaded replica (the router
        refuses to take the last one); returns the retired id."""
        rid = self.router.retire(timeout=timeout)
        self._replicas.pop(rid, None)
        _sec_bump(retired=1, replicas=self.replica_count())
        return rid
