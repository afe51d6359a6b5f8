"""Autoscaling of the control plane's replica pool (ref:
``mxnet_tpu/serve/control_plane/autoscale.py``).

The :class:`Autoscaler` is a ticker: each tick it reads one occupancy
sample (the pool's mean queue depth over capacity, or a caller's
``load_fn``) and, when armed, a
:class:`~...telemetry.health.HealthMonitor`'s verdict, feeds both through
hysteresis (K consecutive breaching ticks, a cooldown after every action,
hard min/max bounds), and acts through ``ControlPlane.scale_up()/
scale_down()``, the router's warm admission and drain-retire paths: a
scaling decision never serves a cold warm-up and never drops a request.

The thresholds are the restart-free ``tune`` knobs
``ctrl_scale_up_occupancy``, ``ctrl_scale_down_occupancy`` and
``ctrl_cooldown_sec``, re-read from the environment every tick, so the
tuner or an operator can move them on a live pool.

Every decision is booked in the ``ctrl`` profiler section (with the
``blocked_cooldown``/``blocked_bounds`` tallies that explain a pool that
does not move) and emitted as a ``serve.ctrl.scale`` trace instant.
"""
from __future__ import annotations

import threading
import time

from ...base import MXNetError, getenv
from ...log import get_logger
from ...telemetry import tracer as _tracer
from . import _sec_bump

logger = get_logger("mxnet_tpu_torch.serve.control_plane.autoscale")


class Autoscaler:
    """Hysteresis ticker driving a pool's replica count.

    Parameters
    ----------
    pool : ControlPlane (or anything with ``load()``,
        ``healthy_count()``, ``replica_count()``, ``scale_up()``,
        ``scale_down()``)
    monitor : HealthMonitor, optional
        When given, a ``status() != "ok"`` window counts as scale-up
        pressure even at low occupancy (latency SLOs fire before
        queues look deep).
    min_replicas / max_replicas :
        Hard pool bounds (``MXTPU_CTRL_MIN_REPLICAS`` default 1,
        ``MXTPU_CTRL_MAX_REPLICAS`` default 8).
    up_ticks / down_ticks :
        Consecutive breaching ticks before acting (default 2 up /
        3 down — scaling down is the cheaper mistake to delay).
    tick_sec :
        Ticker period for :meth:`start`
        (``MXTPU_CTRL_TICK_SEC``, default 5); :meth:`tick` can always
        be called manually (tests, external schedulers).
    load_fn : callable, optional
        Replaces ``pool.load()`` as the occupancy signal.

    The occupancy thresholds and the cooldown are read per tick from
    the knob env (``MXTPU_CTRL_SCALE_UP_OCCUPANCY`` /
    ``MXTPU_CTRL_SCALE_DOWN_OCCUPANCY`` / ``MXTPU_CTRL_COOLDOWN_SEC``).
    """

    def __init__(self, pool, *, monitor=None, min_replicas=None,
                 max_replicas=None, up_ticks=2, down_ticks=3,
                 tick_sec=None, load_fn=None):
        self.pool = pool
        self.monitor = monitor
        self.min_replicas = int(getenv("CTRL_MIN_REPLICAS", 1, int)
                                if min_replicas is None
                                else min_replicas)
        self.max_replicas = int(getenv("CTRL_MAX_REPLICAS", 8, int)
                                if max_replicas is None
                                else max_replicas)
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise MXNetError(
                f"autoscaler bounds must satisfy 1 <= min <= max, got "
                f"min={self.min_replicas} max={self.max_replicas}")
        self.up_ticks = int(up_ticks)
        self.down_ticks = int(down_ticks)
        self.tick_sec = float(getenv("CTRL_TICK_SEC", 5.0, float)
                              if tick_sec is None else tick_sec)
        self._load_fn = load_fn
        self._up_streak = 0
        self._down_streak = 0
        self._last_action_t = -float("inf")
        self._stop = None
        self._thread = None
        self._lock = threading.Lock()

    # -- one decision -------------------------------------------------------

    def tick(self, now=None):
        """Take one sample, update the hysteresis streaks, maybe act.
        Returns the decision record ``{"load", "replicas", "slo",
        "action", "reason"}`` (``action`` in ``up/down/hold``)."""
        with self._lock:
            return self._tick_locked(time.monotonic()
                                     if now is None else now)

    def _tick_locked(self, now):
        # restart-free knobs: re-read every tick so the autotuner (or
        # an operator) can steer a LIVE pool
        up_thr = float(getenv("CTRL_SCALE_UP_OCCUPANCY", 0.75, float))
        down_thr = float(getenv("CTRL_SCALE_DOWN_OCCUPANCY", 0.25,
                                float))
        cooldown = float(getenv("CTRL_COOLDOWN_SEC", 30.0, float))
        load = float((self._load_fn or self.pool.load)())
        n = self.pool.replica_count()
        slo = "ok"
        if self.monitor is not None:
            slo = self.monitor.status()[0]
        pressure = load >= up_thr or slo != "ok"
        idle = load <= down_thr and slo == "ok"
        self._up_streak = self._up_streak + 1 if pressure else 0
        self._down_streak = self._down_streak + 1 if idle else 0
        action, reason = "hold", "within band"
        if self._up_streak >= self.up_ticks:
            action, reason = self._try_scale(
                now, cooldown, up=True, n=n,
                why=(f"slo {slo}" if slo != "ok"
                     else f"occupancy {load:.2f} >= {up_thr}"))
        elif self._down_streak >= self.down_ticks:
            action, reason = self._try_scale(
                now, cooldown, up=False, n=n,
                why=f"occupancy {load:.2f} <= {down_thr}")
        _sec_bump(ticks=1, replicas=self.pool.replica_count(),
                  load=load)
        return {"load": load, "replicas": self.pool.replica_count(),
                "slo": slo, "action": action, "reason": reason}

    def _try_scale(self, now, cooldown, *, up, n, why):
        word = "up" if up else "down"
        if now - self._last_action_t < cooldown:
            _sec_bump(blocked_cooldown=1)
            return "hold", (f"scale-{word} ({why}) blocked by "
                            f"cooldown ({cooldown}s)")
        if up and n >= self.max_replicas:
            _sec_bump(blocked_bounds=1)
            return "hold", (f"scale-up ({why}) blocked at "
                            f"max_replicas={self.max_replicas}")
        if not up and n <= self.min_replicas:
            _sec_bump(blocked_bounds=1)
            return "hold", (f"scale-down ({why}) blocked at "
                            f"min_replicas={self.min_replicas}")
        try:
            rid = (self.pool.scale_up() if up
                   else self.pool.scale_down())
        except Exception as e:  # noqa: BLE001 — a failed actuation
            # (spawn hiccup, drain timeout) must not kill the ticker;
            # the streak persists and the next tick retries
            logger.warning("scale-%s failed (%s): %s", word, why, e)
            return "hold", f"scale-{word} failed: {e}"
        self._last_action_t = now
        self._up_streak = self._down_streak = 0
        _sec_bump(**{f"scale_{word}s": 1})
        _tracer.instant("serve.ctrl.scale", cat="serve",
                        direction=word, replica=rid, reason=why,
                        replicas=self.pool.replica_count())
        logger.info("scaled %s (%s): pool now %d replica(s)", word,
                    why, self.pool.replica_count())
        return word, why

    # -- the ticker thread --------------------------------------------------

    def start(self):
        if self._thread is not None:
            raise MXNetError("Autoscaler already started")
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="mxtpu-ctrl-autoscaler",
            daemon=True)
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.tick_sec):
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 — a bad sample must
                # not end autoscaling for the rest of the job
                logger.warning("autoscaler tick failed: %s", e)

    def stop(self):
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=self.tick_sec + 5.0)
        self._thread = None
