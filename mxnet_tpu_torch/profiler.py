"""Profiler (ref: ``mxnet_tpu/profiler.py``; src/profiler/profiler.{h,cc}
+ python/mxnet/profiler.py).

Two tiers:
1. Op-level chrome://tracing JSON — every imperative invoke is bracketed
   (dispatch + optional sync timing), dumped via ``dumps()``/``dump()``
   exactly like the reference's MXDumpProfile.
2. Device-level — ``set_config(xla_trace_dir=DIR)`` makes ``start()``
   open a ``torch.profiler`` session (CPU and CUDA activities; the JAX
   package opens a jax.profiler trace there) and ``stop()`` writes its
   Chrome trace into ``DIR``.

Besides, the counter sections of every loaded tier (``sections()``,
embedded by ``dumps()``, exported on ``/metrics``) and the op scopes
(``op_scope``) that feed the tracer and the health monitor.
"""
from __future__ import annotations

import json
import os
import threading
import time

from .base import getenv
from .telemetry import health as _health
from .telemetry import tracer as _tracer

_state = threading.local()
_config = {
    "profile_all": False,
    "profile_imperative": True,
    "profile_memory": False,  # per-op device memory/pool counter events
    "filename": "profile.json",
    "aggregate_stats": False,
    "xla_trace_dir": None,
    "sync": False,  # block per op for accurate durations
}
_events = []
_events_lock = threading.Lock()
_running = False
_device_prof = None       # the torch.profiler session start() opened
# running peaks across the profiled window (ref: the reference's
# profiler records memory-pool events per device — profiler.cc
# DeviceStats); sampled from the CUDA caching allocator + the native
# staging pool.  Ops on several threads sample at once, so the peaks are
# updated under their own lock.
_mem_peak = {"device_bytes_in_use": 0, "pool_used_bytes": 0}
_mem_lock = threading.Lock()


def set_config(**kwargs):
    """Ref: mx.profiler.set_config(profile_all=True, filename=...)."""
    for k, v in kwargs.items():
        if k in ("profile_symbolic", "profile_api", "continuous_dump"):
            continue  # accepted for parity
        _config[k] = v


def set_state(state="stop", profile_process="worker"):
    if state == "run":
        start()
    else:
        stop()


def start():
    global _running, _device_prof
    _running = True
    if _config.get("xla_trace_dir") and _device_prof is None:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        _device_prof = torch.profiler.profile(activities=acts)
        _device_prof.__enter__()


def stop():
    global _running, _device_prof
    _running = False
    if _device_prof is not None:
        prof, _device_prof = _device_prof, None
        prof.__exit__(None, None, None)
        d = _config["xla_trace_dir"]
        os.makedirs(d, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            d, f"device-{os.getpid()}-{int(time.time() * 1e3)}.json"))


def is_running():
    return _running


def _memory_sample():
    """Current device memory + host staging-pool occupancy, in bytes.

    Device side: the CUDA caching allocator's counters for the current
    device (``torch.cuda.memory_stats``: host bookkeeping, no device
    synchronisation, so safe beside a capture), read only once CUDA is
    initialised.  Host side: the native storage pool's counters
    (src/storage.cc), once a pool exists.
    """
    import torch

    sample = {}
    try:
        if torch.cuda.is_initialized():
            stats = torch.cuda.memory_stats()
            sample["device_bytes_in_use"] = int(
                stats.get("allocated_bytes.all.current", 0))
            sample["device_peak_bytes_in_use"] = int(
                stats.get("allocated_bytes.all.peak", 0))
    except Exception:  # noqa: BLE001 — a sample never breaks an op
        pass
    try:
        from .storage import Storage

        if Storage._instance is not None:
            st = Storage._instance.stats()
            sample["pool_used_bytes"] = int(st.get("used_bytes", 0))
            if "pool_bytes" in st:
                sample["pool_reserved_bytes"] = int(st["pool_bytes"])
    except Exception:  # noqa: BLE001
        pass
    with _mem_lock:
        for k in _mem_peak:
            if sample.get(k, 0) > _mem_peak[k]:
                _mem_peak[k] = sample[k]
    return sample


def record_op(name, begin_us, end_us, shapes=None, cat="operator"):
    if not _running:
        return
    mem = _memory_sample() if _config.get("profile_memory") else None
    with _events_lock:
        _events.append({
            "name": name, "ph": "X", "ts": begin_us,
            "dur": max(end_us - begin_us, 0.01),
            "pid": os.getpid(), "tid": threading.get_ident() % 100000,
            "cat": cat,
            "args": {"shapes": str(shapes)} if shapes else {},
        })
        if mem:
            # chrome counter track: stacked view of HBM + staging pool
            _events.append({
                "name": "memory", "ph": "C", "ts": end_us,
                "pid": os.getpid(), "cat": "memory", "args": mem,
            })


# Open-scope registry: while armed (the supervisor's watchdog turns it
# on via track_scopes), every entered-but-not-exited op scope is
# visible per thread — how a stalled job names its stuck PHASE (a
# completed-events trace can only name what finished).  One global
# boolean check per scope when disarmed.
_scope_track = False
_scope_lock = threading.Lock()
_open_scopes = {}  # thread ident -> [scope names, innermost last]


def track_scopes(on=True):
    """Arm/disarm open-scope tracking (watchdog diagnostics)."""
    global _scope_track
    _scope_track = bool(on)
    if not on:
        with _scope_lock:
            _open_scopes.clear()


def active_scopes():
    """Snapshot of currently OPEN op scopes per thread; populated only
    while ``track_scopes(True)``."""
    with _scope_lock:
        return {tid: list(stack) for tid, stack in _open_scopes.items()
                if stack}


class _OpScope:
    __slots__ = ("name", "cat", "t0")

    def __init__(self, name, cat="operator"):
        self.name = name
        self.cat = cat

    def __enter__(self):
        if _scope_track:
            with _scope_lock:
                _open_scopes.setdefault(threading.get_ident(),
                                        []).append(self.name)
        # telemetry span hook: the disarmed binding is a ~ns no-op
        # (engine.fault_point pattern); armed, every op scope is a
        # span in the exported trace / flight-recorder ring
        _tracer.span_begin(self.name, self.cat)
        self.t0 = time.perf_counter() * 1e6
        return self

    def __exit__(self, exc_type, *a):
        t1 = time.perf_counter() * 1e6
        record_op(self.name, self.t0, t1, cat=self.cat)
        _tracer.span_end(self.name, self.cat)
        if exc_type is None:
            # health-monitor phase sink (telemetry.health): disarmed
            # it IS the module no-op, same ~ns contract as the tracer
            # hook above; a scope aborted by an exception books no
            # phase time (a failed step is not a completed step)
            _health.scope_end(self.name, self.cat, self.t0, t1)
        if _scope_track:
            with _scope_lock:
                stack = _open_scopes.get(threading.get_ident())
                # entered before arming: nothing of ours to pop
                if stack and stack[-1] == self.name:
                    stack.pop()


def op_scope(name, cat="operator"):
    """Trace bracket; `cat` groups rows in chrome://tracing (checkpoint
    save/restore phases are tagged cat="checkpoint")."""
    return _OpScope(name, cat)


def _graph_cache_counters(reset=False):
    """Compiled-graph cache compile/reuse split (gluon CachedOp) — only
    when the gluon tier is actually loaded; importing it from here would
    drag the whole frontend in for a profiler dump."""
    import sys

    block = sys.modules.get(__package__ + ".gluon.block")
    if block is None:
        return None
    stats = block.cached_graph_stats()
    if reset:
        # a reset dump must scope EVERY section to the window, not mix
        # per-window events with forever-cumulative compile counts
        block.reset_cached_graph_stats()
    return stats


def _trainer_step_counters(reset=False):
    """Step-fusion counters from gluon.Trainer (params_fused,
    buckets_built, dispatches_per_step) — window-scoped under reset=True
    exactly like cachedGraph; only present when the gluon tier is
    loaded."""
    import sys

    trainer = sys.modules.get(__package__ + ".gluon.trainer")
    if trainer is None:
        return None
    stats = trainer.trainer_step_stats()
    if reset:
        trainer.reset_trainer_step_stats()
    return stats


def _data_pipeline_counters(reset=False):
    """Input-pipeline counters (batches, host-build/h2d/wait ms,
    prefetch hit/miss) — window-scoped under reset=True exactly like
    cachedGraph/trainerStep; only present when the pipeline tier is
    loaded."""
    import sys

    pstats = sys.modules.get(__package__ + ".pipeline.stats")
    if pstats is None:
        return None
    stats = pstats.pipeline_stats()
    if reset:
        pstats.reset_pipeline_stats()
    return stats


def _resilience_counters(reset=False):
    """Supervisor/fault-recovery counters (restarts, retries by fault
    class, fallback_restores, watchdog_fires, time_lost_ms, and the
    elastic-resize trio resizes/ranks_lost/reshard_ms) — window-scoped
    under reset=True exactly like cachedGraph/trainerStep/
    dataPipeline; only present when the resilience tier is loaded."""
    import sys

    rstats = sys.modules.get(__package__ + ".resilience.stats")
    if rstats is None:
        return None
    stats = rstats.resilience_stats()
    if reset:
        rstats.reset_resilience_stats()
    return stats


def _decode_serve_counters(reset=False):
    """Continuous-batching decode counters (token steps, tokens,
    prefill batches, admissions, finishes, deadline expiries, slot
    occupancy) — window-scoped under reset=True exactly like every
    other section; only present when the decode serving tier is
    loaded."""
    import sys

    dec = sys.modules.get(__package__ + ".serve.decode")
    if dec is None:
        return None
    stats = dec.decode_serve_stats()
    if reset:
        dec.reset_decode_serve_stats()
    return stats


def _router_counters(reset=False):
    """Serve-router replica-pool counters (dispatches, retries, hedges,
    evictions/replacements, health probes, rolling reloads) —
    window-scoped under reset=True exactly like every other section;
    only present when the routing tier is loaded."""
    import sys

    rt = sys.modules.get(__package__ + ".serve.router")
    if rt is None:
        return None
    stats = rt.router_stats()
    if reset:
        rt.reset_router_stats()
    return stats


def _ctrl_counters(reset=False):
    """Serving control-plane counters (RPC traffic, replica spawn and
    retire churn, autoscaler decisions and the blocked-action tallies)
    — window-scoped under reset=True like every other section; only
    present when the control plane is loaded."""
    import sys

    cp = sys.modules.get(__package__ + ".serve.control_plane")
    if cp is None:
        return None
    stats = cp.ctrl_stats()
    if reset:
        cp.reset_ctrl_stats()
    return stats


def _quantize_counters(reset=False):
    """INT8 quantization counters (layers quantized, calibration
    batches + wall time, requantize folds, compiled int8 serve
    batches) — window-scoped under reset=True exactly like every other
    section; only present when the quantization tier is loaded."""
    import sys

    qz = sys.modules.get(__package__ + ".contrib.quantization")
    if qz is None:
        return None
    stats = qz.quantize_stats()
    if reset:
        qz.reset_quantize_stats()
    return stats


def _health_counters(reset=False):
    """Health-monitor counters (per-step phase breakdown ms, goodput/
    MFU gauges, SLO alerts, straggler flags) — window-scoped under
    reset=True exactly like every other section; only present once a
    HealthMonitor has been armed (telemetry.health)."""
    stats = _health.health_stats()
    if stats is None:
        return None
    if reset:
        _health.reset_health_stats()
    return stats


def _tune_counters(reset=False):
    """Autotuner counters (trials run, recompiles spent, blocked
    restart-class moves, best/baseline ratio) — window-scoped under
    reset=True exactly like every other section; only present when the
    tune subsystem is loaded."""
    import sys

    tune = sys.modules.get(__package__ + ".tune")
    if tune is None:
        return None
    stats = tune.tune_stats()
    if reset:
        tune.reset_tune_stats()
    return stats


def _telemetry_counters(reset=False):
    """Telemetry-subsystem counters (spans/instants/requests recorded,
    drops, flight dumps, scrapes, aggregations) — window-scoped under
    reset=True exactly like every other section."""
    stats = _tracer.telemetry_stats()
    if reset:
        _tracer.reset_telemetry_stats()
    return stats


# ---------------------------------------------------------------------------
# Section registry: every counter section a subsystem contributes to
# dumps()/the aggregate table is one (provider, table renderer) entry
# here; both output paths iterate it, so each forwards ``reset`` the
# same way.  A provider looks its tier up in sys.modules and returns
# None while that tier is not loaded.


_sections = []   # [(name, provider, table_fn)] in registration order


def register_section(name, provider, table=None):
    """Register a counter section.

    ``provider(reset=False)`` returns the section's stats dict (or
    None while its subsystem is not loaded) and MUST zero its counters
    under ``reset=True`` — every section is window-scoped, so a reset
    dump never mixes per-window events with forever-cumulative counts.
    ``table(stats)`` (optional) returns the section's lines for
    ``dumps(format="table")``.  Re-registering a name replaces it.
    """
    for i, (n, _p, _t) in enumerate(_sections):
        if n == name:
            _sections[i] = (name, provider, table)
            return
    _sections.append((name, provider, table))


def unregister_section(name):
    """Drop a registered section (tests / unloading subsystems)."""
    _sections[:] = [s for s in _sections if s[0] != name]


def section_names():
    return [n for n, _p, _t in _sections]


def sections(reset=False):
    """Public snapshot of every loaded section: ``{name: stats}`` —
    the dict ``dumps()`` embeds and the /metrics collector exports."""
    return _section_data(reset)


def _section_data(reset=False):
    out = {}
    for name, provider, _table in list(_sections):
        stats = provider(reset)
        if stats is not None:
            out[name] = stats
    return out


def _section_tables(reset=False):
    lines = []
    for _name, provider, table in list(_sections):
        stats = provider(reset)
        if stats is None or table is None:
            continue
        lines.append("")
        lines.extend(table(stats))
    return lines


def _rows_table(title, rows):
    """Standard section renderer: a title plus label/value rows."""
    def render(stats):
        out = [title + ":"]
        for label, key in rows:
            out.append(f"{label:<40}{stats[key]:>12}")
        return out
    return render


def _resilience_table(stats):
    out = ["Resilience (supervisor):"]
    for label, key in (("restarts", "restarts"),
                       ("fallback restores", "fallback_restores"),
                       ("watchdog fires", "watchdog_fires"),
                       ("time lost (ms)", "time_lost_ms"),
                       ("elastic resizes", "resizes"),
                       ("ranks lost", "ranks_lost"),
                       ("reshard (ms)", "reshard_ms")):
        out.append(f"{label:<40}{stats[key]:>12}")
    for cls in sorted(stats["retries"]):
        out.append(f"{'retries[' + cls + ']':<40}"
                   f"{stats['retries'][cls]:>12}")
    return out


register_section("cachedGraph", _graph_cache_counters, _rows_table(
    "Compiled-Graph Cache (CachedOp)",
    (("graph compiles (new signature)", "compiles"),
     ("graph reuses (cache hit)", "reuses"))))
register_section("trainerStep", _trainer_step_counters, _rows_table(
    "Trainer Step Fusion",
    (("steps", "steps"),
     ("params fused", "params_fused"),
     ("allreduce buckets built", "buckets_built"),
     ("dispatches per step", "dispatches_per_step"),
     ("whole-step compiled steps", "whole_step_steps"),
     ("whole-step compiles", "whole_step_compiles"),
     ("whole-step fallbacks", "whole_step_fallbacks"),
     ("zero-sharded steps", "zero_steps"),
     ("zero-shard fallbacks", "zero_fallbacks"),
     ("spmd mesh steps", "spmd_steps"))))
register_section("dataPipeline", _data_pipeline_counters, _rows_table(
    "Data Pipeline",
    (("batches delivered", "batches"),
     ("host build (ms)", "host_build_ms"),
     ("h2d staging (ms)", "h2d_ms"),
     ("step wait-on-input (ms)", "wait_ms"),
     ("prefetch hits", "prefetch_hits"),
     ("prefetch misses", "prefetch_misses"))))
register_section("resilience", _resilience_counters, _resilience_table)
register_section("decodeServe", _decode_serve_counters, _rows_table(
    "Decode Serving (continuous batching)",
    (("decode steps", "steps"),
     ("tokens generated", "tokens"),
     ("prefill batches", "prefill_batches"),
     ("requests admitted", "admitted"),
     ("requests finished", "finished"),
     ("deadline expiries", "expired_deadlines"),
     ("slot occupancy (mean live/max)", "slot_occupancy"),
     ("pages in flight", "pages_in_flight"),
     ("copy-on-write page copies", "cow_copies"),
     ("prefix pages shared (hits)", "prefix_hit_pages"),
     ("draft proposal steps", "draft_steps"),
     ("draft tokens proposed", "spec_proposed"),
     ("draft tokens accepted", "spec_accepted"))))
register_section("router", _router_counters, _rows_table(
    "Serve Router (replica pool)",
    (("requests dispatched", "dispatched"),
     ("re-dispatches (retries)", "retries"),
     ("hedged dispatches", "hedges"),
     ("hedge wins", "hedge_wins"),
     ("replica evictions", "evictions"),
     ("warm replacements admitted", "replacements"),
     ("health probes", "probes"),
     ("health probe failures", "probe_failures"),
     ("rolling-reload legs", "reloads"))))
register_section("ctrl", _ctrl_counters, _rows_table(
    "Serving Control Plane",
    (("autoscaler ticks", "ticks"),
     ("scale-ups", "scale_ups"),
     ("scale-downs", "scale_downs"),
     ("actions blocked by cooldown", "blocked_cooldown"),
     ("actions blocked by bounds", "blocked_bounds"),
     ("replica processes spawned", "spawns"),
     ("replica spawn failures", "spawn_failures"),
     ("replicas drained and retired", "retired"),
     ("rpc requests served", "rpc_requests"),
     ("rpc streams opened", "rpc_streams"),
     ("rpc errors", "rpc_errors"),
     ("stale leases rejected", "stale_leases_rejected"),
     ("pool size (last tick)", "replicas"),
     ("mean occupancy (last tick)", "load"))))
register_section("quantize", _quantize_counters, _rows_table(
    "INT8 Quantization",
    (("layers quantized", "layers_quantized"),
     ("calibration batches", "calib_batches"),
     ("calibration time (ms)", "calib_ms"),
     ("requantize folds", "requant_folds"),
     ("int8 serve batches", "int8_serve_batches"))))
register_section("health", _health_counters, _rows_table(
    "Health Monitor",
    (("steps observed", "steps"),
     ("step time (ms)", "step_ms"),
     ("input wait (ms)", "input_wait_ms"),
     ("h2d staging (ms)", "h2d_ms"),
     ("compute (ms)", "compute_ms"),
     ("collective (ms)", "collective_ms"),
     ("optimizer (ms)", "optimizer_ms"),
     ("checkpoint stall (ms)", "checkpoint_ms"),
     ("compile (ms)", "compile_ms"),
     ("lost to recovery (ms)", "lost_ms"),
     ("monitor ticks", "ticks"),
     ("SLO alerts fired", "alerts"),
     ("stragglers flagged", "stragglers"),
     ("rules firing now", "rules_firing"),
     ("goodput (last window)", "goodput"),
     ("MFU (last window)", "mfu"),
     ("FLOPs per step", "flops_per_step"),
     ("step p95 (ms)", "step_p95_ms"))))
register_section("tune", _tune_counters, _rows_table(
    "Autotuner",
    (("trials run", "trials"),
     ("measurement windows", "measurements"),
     ("recompiles spent", "recompiles_spent"),
     ("candidates cost-model ranked", "candidates_ranked"),
     ("restart-class moves blocked", "blocked_moves"),
     ("knobs moved", "knobs_moved"),
     ("baseline score", "baseline_score"),
     ("best score", "best_score"),
     ("best/baseline ratio", "best_over_baseline"))))
register_section("telemetry", _telemetry_counters, _rows_table(
    "Telemetry (tracer / flight recorder / metrics)",
    (("spans recorded", "spans"),
     ("instant events", "instants"),
     ("request spans opened", "requests"),
     ("events dropped (lane cap)", "dropped"),
     ("flight-recorder dumps", "flight_dumps"),
     ("/metrics scrapes", "scrapes"),
     ("aggregate() calls", "aggregations"))))


def dumps(reset=False, format="json"):
    """Return the trace (ref: mx.profiler.dumps).

    format="json": chrome://tracing event JSON (the default).
    format="table": per-op aggregate summary — name, count, total/min/
    max/avg ms — requires set_config(aggregate_stats=True) like the
    reference's MXAggregateProfileStatsPrint (ref:
    src/profiler/aggregate_stats.cc)."""
    if format == "table":
        if not _config.get("aggregate_stats"):
            raise RuntimeError(
                "aggregate stats not enabled: call "
                "profiler.set_config(aggregate_stats=True) before "
                "profiling (ref: MXAggregateProfileStatsPrint)")
        return _aggregate_table(reset)
    with _events_lock:
        data = {"traceEvents": list(_events),
                "displayTimeUnit": "ms"}
        if _config.get("profile_memory"):
            with _mem_lock:
                data["memoryPeaks"] = dict(_mem_peak)
        if reset:
            _events.clear()
    # every registered counter section, reset forwarded so a reset
    # dump window-scopes ALL of them
    data.update(_section_data(reset))
    return json.dumps(data)


def _aggregate_table(reset=False):
    """Per-op totals across recorded events, formatted like the
    reference's aggregate stats table (ref: aggregate_stats.cc
    DumpTable: Name / Total Count / Time columns, sorted by total)."""
    with _events_lock:
        events = list(_events)
        if reset:
            _events.clear()
    stats = {}
    for ev in events:
        if "dur" not in ev:  # counter (memory) events have no duration
            continue
        s = stats.setdefault(ev["name"], [0, 0.0, float("inf"), 0.0])
        dur_ms = ev["dur"] / 1000.0
        s[0] += 1
        s[1] += dur_ms
        s[2] = min(s[2], dur_ms)
        s[3] = max(s[3], dur_ms)
    header = (f"{'Name':<40}{'Total Count':>12}{'Total (ms)':>14}"
              f"{'Min (ms)':>12}{'Max (ms)':>12}{'Avg (ms)':>12}")
    lines = ["Profile Statistics:", header, "-" * len(header)]
    for name, (cnt, tot, mn, mx) in sorted(
            stats.items(), key=lambda kv: -kv[1][1]):
        lines.append(f"{name:<40}{cnt:>12}{tot:>14.4f}"
                     f"{mn:>12.4f}{mx:>12.4f}{tot / cnt:>12.4f}")
    if _config.get("profile_memory"):
        # memory-pool section (ref: profiler.cc DeviceStats / the
        # reference table's Memory: Device columns)
        lines.append("")
        lines.append("Memory Statistics (peak over profiled window):")
        with _mem_lock:
            peaks = dict(_mem_peak)
        for key, val in peaks.items():
            lines.append(f"{key:<40}{val / 1e6:>14.3f} MB")
    # counter sections are window-scoped under reset=True exactly like
    # the event table above (and like the JSON format path)
    lines.extend(_section_tables(reset))
    return "\n".join(lines)


def dump(finished=True, profile_process="worker"):
    """Write the trace file (ref: mx.profiler.dump)."""
    with open(_config["filename"], "w") as f:
        f.write(dumps())


def reset():
    with _events_lock:
        _events.clear()
    with _mem_lock:
        for k in _mem_peak:
            _mem_peak[k] = 0


def pause(profile_process="worker"):
    global _running
    _running = False


def resume(profile_process="worker"):
    global _running
    _running = True


# env autostart (ref: MXNET_PROFILER_AUTOSTART)
if getenv("PROFILER_AUTOSTART", False, bool):
    _config["profile_all"] = True
    start()
