"""Health monitor: the interpretation layer over the measured signal
(ref: ``mxnet_tpu/telemetry/health.py``).

The rest of :mod:`mxnet_tpu_torch.telemetry` answers "what happened" (spans,
counters, scrapes); this module answers the operator questions — *what
fraction of wall time was productive?* (goodput), *how close to the
hardware is the step?* (MFU), *which phase is eating my step?* (the
per-step phase breakdown), *which rank is the straggler?* (cross-rank
aggregation), and *is the job healthy right now?* (a declarative SLO
rule set evaluated on a ticker thread).

Three data paths feed one :class:`HealthMonitor`:

- **scope sink** — ``profiler.op_scope`` exits call the rebindable
  :func:`scope_end` hook (``engine.fault_point`` pattern: the disarmed
  binding IS :func:`_noop`, ~ns, asserted by tests + the smoke), which
  folds trainer/checkpoint scope durations into per-phase counters:
  ``trainer.step``/``whole_step`` close a STEP, ``allreduce``/
  ``reduce_scatter``/``allgather``/``broadcast`` book collective time,
  ``fused_update`` books optimizer time, ``cat="checkpoint"`` scopes
  book checkpoint stalls, ``cached_op.compile.*`` books compile time.
- **sections** — the window deltas of the ``dataPipeline`` section
  (``wait_ms`` = input starvation, ``h2d_ms``) and the ``resilience``
  section (``time_lost_ms`` + ``reshard_ms`` = the goodput debits for
  restarts / resizes / watchdog recoveries).
- **FLOP hooks** — ``Trainer.whole_step`` notes batch/param geometry,
  from which the monitor counts ``6 * params * batch`` FLOPs a step
  (``flops_source`` ``"analytic"``).  ``MFU = flops_per_step /
  step_seconds / peak_flops`` with the per-device peak table below
  (``MXTPU_HEALTH_PEAK_FLOPS`` overrides it).  The JAX package reads
  the count from the lowered step's cost analysis; a CUDA graph has no
  such analysis, and a ``FlopCounterMode`` count would miss the
  hand-written kernels (ctypes calls), so ``note_whole_step_compiled``
  fires at each capture and changes no count.

The step time is the interval the step scopes measure on the host.  A
captured step's replay returns once its work is enqueued, so a
``whole_step`` scope closes before the device finishes: under a steady
loop the scopes' sum still tracks the device, which paces the host
through the allocator and the loss's readback, but one step's scope is
not its device time.

Everything the monitor derives lands in the window-scoped ``health``
profiler section (-> ``mxtpu_health_*`` gauges on ``/metrics``, rank
snapshots in ``telemetry.aggregate()``), SLO breaches emit
``telemetry.alert`` instant spans and optionally a flight-recorder
dump, and ``/healthz`` reports ``ok``/``degraded`` while a monitor is
armed (plain liveness otherwise).  The ticker thread reads host
counters only: it makes no CUDA call, so it can run beside a capture.
"""
from __future__ import annotations

import collections
import statistics
import threading
import time

from ..base import MXNetError, getenv
from . import flight as _flight
from . import tracer as _tracer

__all__ = ["HealthMonitor", "SLORule", "active_monitor", "healthz",
           "health_stats", "reset_health_stats",
           "describe_for_diagnostic"]

_lock = threading.Lock()

# the window-scoped ``health`` profiler section.  Accumulating keys
# grow under the scope sink / tick; gauge keys hold the LAST computed
# window value (goodput, mfu, p95).  All numeric, so the /metrics
# section collector exports every one as an mxtpu_health_* gauge.
_counters = {
    "steps": 0,              # step scopes closed (trainer.step | whole_step)
    "step_ms": 0.0,          # total time inside those step scopes
    "input_wait_ms": 0.0,    # dataPipeline wait_ms folded in at tick
    "h2d_ms": 0.0,           # dataPipeline h2d_ms folded in at tick
    "compute_ms": 0.0,       # step_ms minus collective+optimizer (tick)
    "collective_ms": 0.0,    # allreduce/reduce_scatter/allgather/broadcast
    "optimizer_ms": 0.0,     # fused_update scopes
    "checkpoint_ms": 0.0,    # cat="checkpoint" scopes (save/restore stalls)
    "compile_ms": 0.0,       # cached_op.compile.* scopes
    "lost_ms": 0.0,          # resilience debits folded in at tick
    "ticks": 0,              # monitor windows evaluated
    "alerts": 0,             # SLO rule fire transitions
    "stragglers": 0,         # straggler flag transitions
    "rules_firing": 0,       # gauge: rules firing after the last tick
    "goodput": 0.0,          # gauge: last window productive/wall
    "mfu": 0.0,              # gauge: last window model FLOP utilization
    "flops_per_step": 0.0,   # gauge: whole-step executable FLOP count
    "step_p95_ms": 0.0,      # gauge: p95 over the recent step ring
}

_STEP_RING_CAP = 512
_step_ring = collections.deque(maxlen=_STEP_RING_CAP)
_ever_armed = False           # section appears only once health is used
_param_elems = {}             # id(trainer) -> total param elements
_flops_state = {"source": None, "batch_size": 0}

# scope name -> phase counter (cat == "trainer")
_SCOPE_PHASE = {
    "allreduce": "collective_ms",
    "reduce_scatter": "collective_ms",
    "allgather": "collective_ms",
    "broadcast": "collective_ms",
    "fused_update": "optimizer_ms",
}
_STEP_SCOPES = ("trainer.step", "whole_step")

# peak dense FLOP/s by a substring of torch.cuda.get_device_name()
# (lower case; first match wins, so the PCIe and NVL parts come before
# "h100").  These are NVIDIA's datasheet figures for dense BF16 on the
# tensor cores (half the "with sparsity" figures), not measurements.  The
# CPU gets a NOMINAL figure so MFU stays comparable across runs on a dev
# box; MXTPU_HEALTH_PEAK_FLOPS overrides the table.
_PEAK_FLOPS_TABLE = (
    ("h100 pcie", 756e12),
    ("h100 nvl", 835e12),
    ("h100", 989e12),
)
_CPU_NOMINAL_PEAK = 1e11


def _noop(*_args, **_kwargs):
    """Disarmed health hook: nothing beyond the call is evaluated."""
    return None


# -- recording implementations (bound while a monitor is armed) --------------


def _scope_end(name, cat, t0_us, t1_us):
    dur_ms = (t1_us - t0_us) / 1000.0
    if cat == "trainer":
        phase = _SCOPE_PHASE.get(name)
        with _lock:
            if phase is not None:
                _counters[phase] += dur_ms
            elif name in _STEP_SCOPES:
                _counters["steps"] += 1
                _counters["step_ms"] += dur_ms
                _step_ring.append(dur_ms)
    elif cat == "checkpoint":
        with _lock:
            _counters["checkpoint_ms"] += dur_ms
    elif name.startswith("cached_op.compile"):
        with _lock:
            _counters["compile_ms"] += dur_ms


def _note_whole_step(trainer, batch_size):
    """Per-step geometry from ``Trainer.whole_step`` — feeds the
    analytic dense FLOP count (6 * param elements * batch: fwd 2PB +
    bwd 4PB)."""
    try:
        elems = _param_elems.get(id(trainer))
        if elems is None:
            elems = 0
            for p in trainer._params:
                n = 1
                for d in (p.shape or ()):
                    n *= int(d)
                elems += n
            if len(_param_elems) > 64:   # id() reuse bound
                _param_elems.clear()
            _param_elems[id(trainer)] = elems
        with _lock:
            _flops_state["batch_size"] = int(batch_size)
            _flops_state["source"] = "analytic"
            _counters["flops_per_step"] = float(6 * elems * int(batch_size))
    except Exception:  # noqa: BLE001 — health must never break a step
        pass


def _note_whole_step_compiled(graph, args):
    """A whole step was captured (``gluon/whole_step.py``).  The JAX
    package reads the step's FLOP count from the lowered HLO here; a
    CUDA graph carries no cost analysis, so the analytic count stands and
    the capture changes no count."""
    return None


# -- the rebindable hook surface (disarmed = _noop) --------------------------

scope_end = _noop
note_whole_step = _noop
note_whole_step_compiled = _noop

_HOOKS = {
    "scope_end": _scope_end,
    "note_whole_step": _note_whole_step,
    "note_whole_step_compiled": _note_whole_step_compiled,
}


def _rebind(active):
    g = globals()
    for name, impl in _HOOKS.items():
        g[name] = impl if active else _noop


def armed():
    """True while a HealthMonitor's hooks are recording."""
    return scope_end is not _noop


# -- the health profiler section --------------------------------------------


def health_stats():
    """Snapshot of the ``health`` section counters since the last
    reset — None until a monitor has ever been armed (the section only
    appears once the subsystem is actually in use)."""
    if not _ever_armed:
        return None
    with _lock:
        s = dict(_counters)
    for k, v in s.items():
        if isinstance(v, float):
            # ms accumulators read fine at 3 decimals; ratio gauges
            # (mfu on a CPU dev box is ~1e-6 of nominal peak, goodput
            # under a fast tick can be tiny) must not round to zero
            s[k] = round(v, 3 if k.endswith("_ms") else 9)
    return s


def reset_health_stats():
    with _lock:
        flops = _counters["flops_per_step"]
        for k in _counters:
            _counters[k] = 0.0 if isinstance(_counters[k], float) else 0
        # the FLOP count is a LEARNED gauge, not a window counter: it
        # describes the model, so a window reset keeps it
        _counters["flops_per_step"] = flops
        _step_ring.clear()


def _reset_learned_flops():
    """Forget the learned FLOP count AND its source (tests / a new
    model in the same process)."""
    with _lock:
        _counters["flops_per_step"] = 0.0
        _flops_state["source"] = None


# -- SLO rules ---------------------------------------------------------------


class SLORule:
    """One declarative SLO bound on a health signal.

    name      : rule name (appears in alerts, /healthz, diagnostics)
    signal    : window signal ("step_p95_ms", "goodput",
                "input_starvation", "mfu", ...) or a dotted path into a
                watched source's stats ("router.requests_lost",
                "serve.latency.p99_ms", "decode.slots.occupancy" —
                see :meth:`HealthMonitor.watch`)
    above     : fire while value > above
    below     : fire while value < below
    for_ticks : consecutive breaching windows before the rule fires
                (debounce; default 1 = fire on the first breach)

    A signal that resolves to None (source not loaded, no steps this
    window) SKIPS the rule for that tick — absence of signal is not a
    breach.
    """

    def __init__(self, name, signal, above=None, below=None, for_ticks=1):
        if above is None and below is None:
            raise MXNetError(
                f"SLO rule {name!r} needs a bound: above= and/or below=")
        self.name = str(name)
        self.signal = str(signal)
        self.above = None if above is None else float(above)
        self.below = None if below is None else float(below)
        self.for_ticks = max(1, int(for_ticks))

    def breached(self, value):
        if value is None:
            return False
        if self.above is not None and value > self.above:
            return True
        if self.below is not None and value < self.below:
            return True
        return False

    def threshold(self):
        return self.above if self.above is not None else self.below

    def __repr__(self):
        bound = (f"> {self.above}" if self.above is not None
                 else f"< {self.below}")
        return (f"SLORule({self.name}: {self.signal} {bound} "
                f"for {self.for_ticks} tick(s))")


def _resolve_peak_flops(override=None):
    if override is not None:
        return float(override)
    env = getenv("HEALTH_PEAK_FLOPS", None, float)
    if env:
        return float(env)
    kind = ""
    try:
        import torch

        if torch.cuda.is_available():
            kind = torch.cuda.get_device_name(0).lower()
    except Exception:  # noqa: BLE001 — no device: nominal CPU
        pass
    for sub, peak in _PEAK_FLOPS_TABLE:
        if sub in kind:
            return peak
    return _CPU_NOMINAL_PEAK


# -- the monitor -------------------------------------------------------------


_active = None                  # the armed monitor (at most one)


def active_monitor():
    """The armed :class:`HealthMonitor`, or None."""
    return _active


class HealthMonitor:
    """Derives decision-grade health facts from the measured signal.

    tick_sec        : ticker-thread window, seconds; 0 = no thread,
                      call :meth:`tick` yourself
                      (``MXTPU_HEALTH_TICK_SEC``, default 5)
    straggler_ratio : flag a rank whose per-step step/collective time
                      exceeds the pool median by this factor
                      (``MXTPU_HEALTH_STRAGGLER_RATIO``, default 1.5)
    straggler_ticks : consecutive breaching windows (K) before the
                      rank is named
                      (``MXTPU_HEALTH_STRAGGLER_TICKS``, default 2)
    goodput_floor   : > 0 installs the built-in goodput SLO rule
                      (``MXTPU_HEALTH_GOODPUT_FLOOR``, default 0 = off)
    peak_flops      : per-chip peak FLOP/s for MFU; default resolved
                      from the device kind table
                      (``MXTPU_HEALTH_PEAK_FLOPS`` overrides)
    rules           : extra :class:`SLORule` list
    aggregate_fn    : () -> ``telemetry.aggregate()``-shaped dict for
                      straggler detection (virtual-rank rehearsals,
                      tests, or a pre-gathered snapshot feed)
    cross_rank      : opt IN to calling the REAL (collective)
                      ``telemetry.aggregate()`` each tick in a
                      multi-process job.  Off by default because the
                      allgather must line up across ranks: enable it
                      only with ``tick_sec=0`` and a ``tick()`` call
                      at the same point of every rank's training loop
                      — a free-running ticker thread would interleave
                      its allgather with the training step's gradient
                      collectives in a different order per rank, which
                      deadlocks real multi-host backends.  With
                      neither ``aggregate_fn`` nor ``cross_rank`` the
                      straggler check is skipped (a pool of one has no
                      straggler).
    flight_on_breach: dump the flight-recorder ring (when armed) on a
                      rule fire / straggler flag transition
    """

    def __init__(self, tick_sec=None, straggler_ratio=None,
                 straggler_ticks=None, goodput_floor=None,
                 peak_flops=None, rules=None, aggregate_fn=None,
                 cross_rank=False, flight_on_breach=True):
        self.tick_sec = float(getenv("HEALTH_TICK_SEC", 5.0, float)
                              if tick_sec is None else tick_sec)
        self.straggler_ratio = float(
            getenv("HEALTH_STRAGGLER_RATIO", 1.5, float)
            if straggler_ratio is None else straggler_ratio)
        self.straggler_ticks = max(1, int(
            getenv("HEALTH_STRAGGLER_TICKS", 2, int)
            if straggler_ticks is None else straggler_ticks))
        floor = float(getenv("HEALTH_GOODPUT_FLOOR", 0.0, float)
                      if goodput_floor is None else goodput_floor)
        self.peak_flops = _resolve_peak_flops(peak_flops)
        self.flight_on_breach = bool(flight_on_breach)
        self.rules = list(rules or [])
        if floor > 0.0:
            self.rules.append(SLORule("goodput_floor", "goodput",
                                      below=floor))
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise MXNetError(f"duplicate SLO rule names: {names}")
        self._aggregate_fn = aggregate_fn
        self.cross_rank = bool(cross_rank)
        self._sources = {}
        self._thread = None
        self._stop = None
        # one window closes at a time: the ticker thread and a manual
        # tick() (tests, smoke, an operator poke) must not interleave
        # their delta baselines
        self._tick_lock = threading.Lock()
        self._last_tick = None
        self._prev = {}
        self._prev_pipeline = {}
        self._prev_resilience = {}
        self._rank_prev = {}
        self._rank_rate = {}
        self._rank_streak = {}
        self._rule_streak = {r.name: 0 for r in self.rules}
        self._firing = {}        # rule name -> {"value", "threshold"}
        self._stragglers = []    # [{"rank", "phase", "ratio"}]
        self._snapshot = None    # last tick's window snapshot

    # -- sources -------------------------------------------------------------

    def watch(self, prefix, source):
        """Attach an SLO signal source: ``source`` is an object with
        ``.stats()`` (ModelServer / DecodeServer / Router) or a
        zero-arg callable returning a stats dict.  Rules then address
        it by dotted path: ``watch("router", router)`` makes
        ``"router.requests_lost"`` and ``"router.latency.p99_ms"``
        resolvable signals.  Returns self (chainable)."""
        self._sources[str(prefix)] = source
        return self

    # -- lifecycle -----------------------------------------------------------

    def arm(self):
        """Install the hooks, register as THE process monitor, start
        the ticker thread (tick_sec > 0).  Returns self."""
        global _active, _ever_armed
        with _lock:
            if _active is not None:
                raise MXNetError(
                    "a HealthMonitor is already armed; disarm() it "
                    "first (one monitor owns the process hooks)")
            _active = self
            _ever_armed = True
        self._last_tick = time.monotonic()
        self._seed_baselines()
        _rebind(True)
        if self.tick_sec > 0:
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="mxtpu-health")
            self._thread.start()
        return self

    def disarm(self):
        """Stop the ticker and unbind the hooks; the accumulated
        ``health`` section keeps its window (a reset dump rewinds it
        like every other section)."""
        global _active
        if _active is not self:
            return
        if self._stop is not None:
            self._stop.set()
            self._thread.join(timeout=2.0)
            self._stop = self._thread = None
        _rebind(False)
        with _lock:
            _active = None

    def __enter__(self):
        return self.arm()

    def __exit__(self, *a):
        self.disarm()

    def _run(self):
        stop = self._stop       # local ref: disarm() nulls the attr
        while not stop.wait(self.tick_sec):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the ticker must survive
                pass

    def _seed_baselines(self):
        with _lock:
            self._prev = dict(_counters)
        self._prev_pipeline = self._read_section(".pipeline.stats",
                                                 "pipeline_stats")
        self._prev_resilience = self._read_section(".resilience.stats",
                                                   "resilience_stats")

    # -- the tick ------------------------------------------------------------

    @staticmethod
    def _read_section(suffix, fn_name):
        import sys

        root = __package__.rsplit(".", 1)[0]
        mod = sys.modules.get(root + suffix)
        if mod is None:
            return {}
        try:
            return getattr(mod, fn_name)()
        except Exception:  # noqa: BLE001 — a stats read never breaks a tick
            return {}

    @staticmethod
    def _delta(cur, prev):
        """Per-key non-negative delta; an externally reset source
        (dumps(reset=True)) restarts the baseline instead of going
        negative."""
        out = {}
        for k, v in cur.items():
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                continue
            p = prev.get(k, 0)
            out[k] = v - p if v >= p else v
        return out

    def tick(self):
        """Close one window: phase breakdown, goodput, MFU, straggler
        check, SLO evaluation.  Returns the window snapshot dict (also
        available as :meth:`snapshot`)."""
        with self._tick_lock:
            return self._tick()

    def _tick(self):
        now = time.monotonic()
        wall_ms = max((now - (self._last_tick or now)) * 1e3, 1e-6)
        self._last_tick = now

        with _lock:
            cur = dict(_counters)
            ring = list(_step_ring)
        d = self._delta(cur, self._prev)
        self._prev = cur

        pipe = self._read_section(".pipeline.stats", "pipeline_stats")
        dp = self._delta(pipe, self._prev_pipeline)
        self._prev_pipeline = pipe
        res = self._read_section(".resilience.stats", "resilience_stats")
        dr = self._delta(res, self._prev_resilience)
        self._prev_resilience = res

        steps = d.get("steps", 0)
        step_ms = d.get("step_ms", 0.0)
        collective = d.get("collective_ms", 0.0)
        optimizer = d.get("optimizer_ms", 0.0)
        checkpoint = d.get("checkpoint_ms", 0.0)
        compile_ms = d.get("compile_ms", 0.0)
        compute = max(step_ms - collective - optimizer, 0.0)
        input_wait = dp.get("wait_ms", 0.0)
        h2d = dp.get("h2d_ms", 0.0)
        lost = dr.get("time_lost_ms", 0.0) + dr.get("reshard_ms", 0.0)

        step_p95 = (statistics.quantiles(ring, n=20)[-1]
                    if len(ring) >= 2 else (ring[0] if ring else 0.0))
        loop_ms = step_ms + input_wait
        starvation = input_wait / loop_ms if loop_ms > 0 else None
        # goodput: productive step time over wall time — restart /
        # resize / recompile / watchdog time (the debits) eats wall
        # without producing steps, so it lands as the gap
        goodput = min(step_ms / wall_ms, 1.0) if steps else None
        with _lock:
            flops = _counters["flops_per_step"]
            flops_source = _flops_state["source"]
        mfu = None
        if steps and flops > 0 and step_ms > 0:
            mean_step_s = (step_ms / steps) / 1e3
            mfu = flops / mean_step_s / self.peak_flops

        window = {
            "wall_ms": round(wall_ms, 3),
            "steps": steps,
            "step_ms": round(step_ms, 3),
            "step_ms_mean": round(step_ms / steps, 3) if steps else 0.0,
            "step_p95_ms": round(step_p95, 3),
            "phases": {
                "input_wait_ms": round(input_wait, 3),
                "h2d_ms": round(h2d, 3),
                "compute_ms": round(compute, 3),
                "collective_ms": round(collective, 3),
                "optimizer_ms": round(optimizer, 3),
                "checkpoint_ms": round(checkpoint, 3),
            },
            "compile_ms": round(compile_ms, 3),
            "input_starvation": (round(starvation, 4)
                                 if starvation is not None else None),
            "goodput": round(goodput, 4) if goodput is not None else None,
            "lost_ms": round(lost + compile_ms, 3),
            "mfu": round(mfu, 9) if mfu is not None else None,
            "flops_per_step": flops,
            "flops_source": flops_source,
        }

        stragglers = self._check_stragglers()
        window["stragglers"] = stragglers
        firing = self._evaluate_rules(window)
        window["firing"] = {n: dict(v) for n, v in firing.items()}
        window["status"] = ("degraded" if firing or stragglers
                            else "ok")
        self._snapshot = window

        with _lock:
            _counters["ticks"] += 1
            _counters["input_wait_ms"] += input_wait
            _counters["h2d_ms"] += h2d
            _counters["compute_ms"] += compute
            _counters["lost_ms"] += lost + compile_ms
            _counters["rules_firing"] = len(firing) + len(stragglers)
            _counters["step_p95_ms"] = round(step_p95, 3)
            if goodput is not None:
                _counters["goodput"] = round(goodput, 4)
            if mfu is not None:
                _counters["mfu"] = round(mfu, 9)
        return window

    # -- straggler detection -------------------------------------------------

    def _aggregate(self):
        if self._aggregate_fn is not None:
            try:
                return self._aggregate_fn()
            except Exception:  # noqa: BLE001 — a bad feed skips the check
                return None
        if not self.cross_rank:
            return None         # collective aggregation is opt-in
        try:
            from ..parallel import dist

            if not dist.is_multiprocess():
                return None
            from . import aggregate

            return aggregate()
        except Exception:  # noqa: BLE001 — no backend / collective failed
            return None

    def _check_stragglers(self):
        """Flag ranks whose per-step step or collective time exceeds
        the pool median by ``straggler_ratio`` for ``straggler_ticks``
        consecutive windows, naming the dominant phase."""
        agg = self._aggregate()
        if not agg or agg.get("world_size", 1) <= 1:
            self._rank_streak.clear()
            self._stragglers = []
            return []
        ranks = agg.get("ranks") or []
        for r, secs in enumerate(ranks):
            h = (secs or {}).get("health") or {}
            p = (secs or {}).get("dataPipeline") or {}
            cur = {f"h.{k}": v for k, v in h.items()
                   if isinstance(v, (int, float))}
            cur.update({f"p.{k}": v for k, v in p.items()
                        if isinstance(v, (int, float))})
            prev = self._rank_prev.get(r, {})
            dd = self._delta(cur, prev)
            self._rank_prev[r] = cur
            steps = dd.get("h.steps", 0)
            if steps > 0:
                self._rank_rate[r] = {
                    "step": dd.get("h.step_ms", 0.0) / steps,
                    "collective": dd.get("h.collective_ms", 0.0) / steps,
                    "optimizer": dd.get("h.optimizer_ms", 0.0) / steps,
                    "checkpoint": dd.get("h.checkpoint_ms", 0.0) / steps,
                    "input_wait": dd.get("p.wait_ms", 0.0) / steps,
                    "h2d": dd.get("p.h2d_ms", 0.0) / steps,
                }
            # a rank with no new steps keeps its previous rate: a rank
            # stalled HARD enough to finish zero steps must not become
            # invisible to the very check that should name it
        rates = {r: self._rank_rate[r] for r in range(len(ranks))
                 if r in self._rank_rate}
        if len(rates) < 2:
            self._stragglers = []
            return []
        med_step = statistics.median(v["step"] for v in rates.values())
        med_coll = statistics.median(v["collective"]
                                     for v in rates.values())
        flagged = []
        for r, rate in rates.items():
            ratios = []
            if med_step > 1e-9:
                ratios.append(rate["step"] / med_step)
            if med_coll > 1e-9:
                ratios.append(rate["collective"] / med_coll)
            worst = max(ratios) if ratios else 0.0
            if worst > self.straggler_ratio:
                self._rank_streak[r] = self._rank_streak.get(r, 0) + 1
            else:
                self._rank_streak[r] = 0
                continue
            if self._rank_streak[r] < self.straggler_ticks:
                continue
            phases = {
                "compute": max(rate["step"] - rate["collective"]
                               - rate["optimizer"], 0.0),
                "collective": rate["collective"],
                "optimizer": rate["optimizer"],
                "checkpoint": rate["checkpoint"],
                "input_wait": rate["input_wait"],
                "h2d": rate["h2d"],
            }
            dominant = max(phases, key=phases.get)
            flagged.append({"rank": r, "phase": dominant,
                            "ratio": round(worst, 2)})
            if self._rank_streak[r] == self.straggler_ticks:
                # transition: alert once, not every following window
                with _lock:
                    _counters["stragglers"] += 1
                _tracer.instant(
                    "telemetry.alert", cat="health", rule="straggler",
                    state="firing", rank=r, phase=dominant,
                    ratio=round(worst, 2))
                if self.flight_on_breach:
                    _flight.dump_if_enabled(
                        "slo", extra={"rule": "straggler", "rank": r,
                                      "phase": dominant})
        self._stragglers = flagged
        return flagged

    # -- SLO evaluation ------------------------------------------------------

    def _signal(self, name, window):
        if name in window:
            return window[name]
        if name in window["phases"]:
            return window["phases"][name]
        prefix, _, rest = name.partition(".")
        src = self._sources.get(prefix)
        if src is None or not rest:
            return None
        try:
            snap = src() if callable(src) else src.stats()
            for part in rest.split("."):
                if not isinstance(snap, dict):
                    return None
                snap = snap.get(part)
            if isinstance(snap, (int, float)) and \
                    not isinstance(snap, bool):
                return float(snap)
        except Exception:  # noqa: BLE001 — a dead source is no signal
            return None
        return None

    def _evaluate_rules(self, window):
        firing = {}
        for rule in self.rules:
            value = self._signal(rule.signal, window)
            if rule.breached(value):
                self._rule_streak[rule.name] += 1
            else:
                if self._firing.pop(rule.name, None) is not None:
                    _tracer.instant(
                        "telemetry.alert", cat="health", rule=rule.name,
                        state="cleared", signal=rule.signal)
                self._rule_streak[rule.name] = 0
                continue
            if self._rule_streak[rule.name] < rule.for_ticks:
                continue
            info = {"signal": rule.signal, "value": value,
                    "threshold": rule.threshold()}
            if rule.name not in self._firing:
                with _lock:
                    _counters["alerts"] += 1
                _tracer.instant(
                    "telemetry.alert", cat="health", rule=rule.name,
                    state="firing", signal=rule.signal,
                    value=value, threshold=rule.threshold())
                if self.flight_on_breach:
                    _flight.dump_if_enabled(
                        "slo", extra={"rule": rule.name, "value": value,
                                      "threshold": rule.threshold()})
            self._firing[rule.name] = info
            firing[rule.name] = info
        return firing

    # -- readouts ------------------------------------------------------------

    def snapshot(self):
        """The last tick's window snapshot (None before the first
        tick): phase breakdown, goodput, MFU, stragglers, firing
        rules, status."""
        return self._snapshot

    def status(self):
        """``("ok" | "degraded", [firing rule names])`` — degraded
        while any SLO rule fires or a straggler is flagged."""
        names = sorted(self._firing)
        names += [f"straggler(rank {s['rank']}, {s['phase']})"
                  for s in self._stragglers]
        return ("degraded" if names else "ok", names)

    def stragglers(self):
        """Currently flagged stragglers:
        ``[{"rank", "phase", "ratio"}]``."""
        return list(self._stragglers)


# -- module-level readouts (httpd / supervisor consumers) --------------------


def healthz():
    """The armed monitor's /healthz payload, or None (no monitor ->
    the endpoint stays a plain liveness probe)."""
    mon = _active
    if mon is None:
        return None
    state, names = mon.status()
    payload = {"status": state, "rules": names}
    snap = mon.snapshot()
    if snap is not None:
        payload["goodput"] = snap.get("goodput")
        payload["mfu"] = snap.get("mfu")
        payload["step_p95_ms"] = snap.get("step_p95_ms")
    return payload


def describe_for_diagnostic():
    """One line for the supervisor's watchdog diagnostic: the last
    health window's phase breakdown + firing rules ('' when no monitor
    is armed or it has not ticked) — so a stuck-phase report says what
    was SLOW before the hang, not just which scope was open."""
    mon = _active
    snap = mon.snapshot() if mon is not None else None
    if snap is None:
        return ""
    phases = ", ".join(f"{k.replace('_ms', '')}={v:.0f}ms"
                       for k, v in snap["phases"].items() if v)
    state, names = mon.status()
    rules = ("; firing SLO rules: " + ", ".join(names)) if names else ""
    gp = snap.get("goodput")
    gp_s = f", goodput={gp:.2f}" if gp is not None else ""
    return (f" Last health window ({snap['steps']} step(s){gp_s}): "
            f"{phases or 'no instrumented phase time'}{rules}.")
