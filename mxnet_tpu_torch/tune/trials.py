"""Measured A/B trials: apply a candidate config, run a window, book it
(ref: mxnet_tpu/tune/trials.py).

One :class:`TrialRunner` owns the measurement protocol the whole tuner
trusts:

1. apply the candidate ``{knob: value}`` through the registry,
2. snapshot the compile counters (graph-cache compiles + whole-step
   compiles — the two places a shape-surface move shows up),
3. run the caller's ``measure(config)`` callable, which drives a real
   training/serving window and returns a metrics dict (goodput,
   step_p95_ms, tokens_per_s, fill ratio — whatever the objective
   reads),
4. debit the recompiles the move triggered against the measured score,
5. append a bit-replayable JSONL record (``BENCH_HISTORY.jsonl`` style,
   readable by ``tools/bench_diff.py --file``).

Records carry no wallclock and every float is written as repr'd JSON
with sorted keys, so re-running the same seed over the same surface
produces byte-identical lines — that is what makes a tuning run
reviewable evidence rather than an anecdote.

The module-level counters back the window-scoped ``tune`` profiler
section (→ ``mxtpu_tune_*`` gauges via the section registry).
"""
from __future__ import annotations

import json

from ..base import MXNetError, getenv

__all__ = ["TrialRunner", "default_objective", "profiler_compiles",
           "tune_stats", "reset_tune_stats"]


# ---------------------------------------------------------------------------
# tune section counters (window-scoped; profiler._tune_counters proxies
# here, the /metrics section collector exports them as mxtpu_tune_*)


def _zero():
    return {
        "trials": 0,              # measured trials run (incl. baseline)
        "measurements": 0,        # measure() windows driven
        "recompiles_spent": 0,    # compile debits across all trials
        "candidates_ranked": 0,   # configs scored by the cost model
        "blocked_moves": 0,       # restart-class moves refused mid-burst
        "knobs_moved": 0,         # knobs whose adopted value != baseline
        "baseline_score": 0.0,    # objective at the starting config
        "best_score": 0.0,        # objective at the best trial so far
        "best_over_baseline": 1.0,  # best/baseline ratio (>=1 == win)
    }


_counters = _zero()


def tune_stats():
    """Snapshot of the ``tune`` section counters."""
    return dict(_counters)


def reset_tune_stats():
    """Zero the ``tune`` section (window scoping under
    ``profiler.dumps(reset=True)``)."""
    _counters.update(_zero())


def _note_scores(baseline, best):
    _counters["baseline_score"] = float(baseline)
    _counters["best_score"] = float(best)
    if baseline > 0:
        _counters["best_over_baseline"] = float(best) / float(baseline)


# ---------------------------------------------------------------------------
# compile accounting


def profiler_compiles():
    """Total captures' signatures visible to the profiler right now: the
    graph-cache compiles (new ``CachedOp`` and ``CachedStepOp``
    signatures, ``gluon.block.cached_graph_stats``) plus the whole-step
    compiles (new whole-step signatures).  The trial runner diffs this around each measurement
    window to debit what a knob move actually cost."""
    from .. import profiler

    total = 0
    data = profiler.sections(reset=False)
    graph = data.get("cachedGraph")
    if graph:
        total += int(graph.get("compiles", 0))
    trainer = data.get("trainerStep")
    if trainer:
        total += int(trainer.get("whole_step_compiles", 0))
    return total


def default_objective(metrics):
    """Score a metrics dict, higher better.  Prefers explicit
    throughput-style keys; falls back to inverse step time.  Trial
    records always store the raw metrics too, so a custom objective
    can re-score history offline."""
    for key in ("score", "goodput", "tokens_per_s", "throughput_rps",
                "samples_per_s"):
        if key in metrics:
            return float(metrics[key])
    if "step_ms" in metrics and metrics["step_ms"] > 0:
        return 1000.0 / float(metrics["step_ms"])
    if "step_p95_ms" in metrics and metrics["step_p95_ms"] > 0:
        return 1000.0 / float(metrics["step_p95_ms"])
    raise MXNetError(
        f"no scoreable key in metrics {sorted(metrics)} — pass an "
        f"explicit objective= to TrialRunner")


class TrialRunner:
    """Seeded measured-trial executor over a knob registry.

    Parameters
    ----------
    registry : KnobRegistry
        The knobs ``run()`` applies candidate configs through.
    measure : callable
        ``measure(config) -> metrics dict`` — drives one real
        measurement window (a training burst through HealthMonitor, a
        serving burst through ServerStats) and returns the numbers.
    objective : callable, optional
        ``objective(metrics) -> float`` (higher better); defaults to
        :func:`default_objective`.
    history : str or None
        JSONL path trial records append to.  Defaults to
        ``MXTPU_TUNE_HISTORY`` (``TUNE_HISTORY.jsonl``); pass ``""``
        to disable booking (unit tests that only want scores).
    seed : int
        Recorded into every trial line; the tuner threads its search
        seed through here so records say which sequence produced them.
    recompile_penalty : float, optional
        Score debited per recompile triggered inside a trial window.
        Defaults to ``MXTPU_TUNE_RECOMPILE_PENALTY`` (0.0 — record but
        don't punish; smokes keep it 0 so tiny windows aren't swamped
        by warmup).
    compile_counter : callable, optional
        Override for :func:`profiler_compiles` (tests inject a fake).
    """

    def __init__(self, registry, measure, objective=None, history=None,
                 seed=0, recompile_penalty=None, compile_counter=None):
        self.registry = registry
        self.measure = measure
        self.objective = objective or default_objective
        if history is None:
            history = getenv("TUNE_HISTORY", "TUNE_HISTORY.jsonl")
        self.history = history or None
        self.seed = int(seed)
        if recompile_penalty is None:
            recompile_penalty = getenv("TUNE_RECOMPILE_PENALTY", 0.0,
                                       float)
        self.recompile_penalty = float(recompile_penalty)
        self._compiles = compile_counter or profiler_compiles
        self._trial_no = 0
        self.records = []          # in-memory evidence trail

    # -- the protocol --------------------------------------------------------

    def run(self, config, label="", baseline=False, knob=None,
            allow_restart=True):
        """Run one measured trial of ``config``; returns the record
        dict (score already recompile-debited)."""
        applied = self.registry.apply(config,
                                      allow_restart=allow_restart)
        before = self._compiles()
        metrics = self.measure(dict(applied))
        recompiles = max(0, self._compiles() - before)
        raw = self.objective(metrics)
        score = raw - self.recompile_penalty * recompiles

        self._trial_no += 1
        record = {
            "kind": "tune_trial",
            "trial": self._trial_no,
            "seed": self.seed,
            "label": label or ("baseline" if baseline
                               else f"trial{self._trial_no}"),
            "baseline": bool(baseline),
            "knob": knob,
            "config": dict(applied),
            "metrics": {k: metrics[k] for k in sorted(metrics)},
            "recompiles": recompiles,
            "score": score,
        }
        self.records.append(record)
        self._book(record)

        _counters["trials"] += 1
        _counters["measurements"] += 1
        _counters["recompiles_spent"] += recompiles
        return record

    def _book(self, record):
        if not self.history:
            return
        line = json.dumps(record, sort_keys=True)
        with open(self.history, "a") as f:
            f.write(line + "\n")

    # -- evidence ------------------------------------------------------------

    def best(self):
        """Highest-scoring record so far (baseline included)."""
        if not self.records:
            raise MXNetError("no trials run yet")
        return max(self.records, key=lambda r: r["score"])

    def evidence(self):
        """The full in-memory trail, trial order preserved."""
        return list(self.records)
