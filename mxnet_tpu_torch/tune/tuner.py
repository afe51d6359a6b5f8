"""The closed loop: measured coordinate descent over the knob registry
(ref: mxnet_tpu/tune/tuner.py).

``Tuner.recommend()`` is the whole protocol end to end:

1. measure the **baseline** (the config currently applied),
2. walk the knobs in seeded order; for each knob build the candidate
   configs its domain allows, let the :class:`~.cost_model.CostModel`
   rank them, and run only the top few as real measured trials
   (:class:`~.trials.TrialRunner` windows, recompiles debited),
3. adopt a move only when it beats the incumbent by ``min_gain``,
4. measure any **reference configs** (the shipped defaults, by
   default) as first-class trials, so the final recommendation is
   ≥ hand-tuned defaults *by construction* — if the defaults win on
   this box, the tuner recommends the defaults,
5. emit a :class:`Recommendation` carrying the winning config AND the
   full evidence trail (every trial record that justified it).

Restart-cost discipline: while ``busy_fn()`` reports a live serving
burst, knobs whose restart class is not ``free`` are never moved —
the trial is skipped and counted as a ``blocked_move`` (visible in the
``tune`` section), not silently dropped.  Training-knob moves happen
between measurement windows, i.e. at step boundaries, because a trial
window *is* a run of whole steps.
"""
from __future__ import annotations

import numpy as np

from ..base import MXNetError, getenv
from .cost_model import CostModel
from .trials import TrialRunner, _counters, _note_scores

__all__ = ["Tuner", "Recommendation"]


class Recommendation:
    """A recommended config plus the evidence that earned it."""

    def __init__(self, config, baseline, best, trials, seed,
                 blocked_moves=0):
        self.config = dict(config)
        self.baseline = baseline          # baseline trial record
        self.best = best                  # winning trial record
        self.trials = list(trials)        # full evidence trail
        self.seed = int(seed)
        self.blocked_moves = int(blocked_moves)

    @property
    def ratio(self):
        """best/baseline objective ratio (>= 1.0 means the loop won;
        == 1.0 means the starting config was already the best)."""
        if self.baseline["score"] <= 0:
            return float("inf") if self.best["score"] > 0 else 1.0
        return self.best["score"] / self.baseline["score"]

    def moved(self):
        """``{knob: (from, to)}`` for every knob the recommendation
        actually changes."""
        out = {}
        for name, to in self.config.items():
            frm = self.baseline["config"].get(name)
            if frm != to:
                out[name] = (frm, to)
        return out

    def summary(self):
        lines = [f"tune: {len(self.trials)} trials (seed "
                 f"{self.seed}), best/baseline = {self.ratio:.3f}"]
        for name, (frm, to) in sorted(self.moved().items()):
            lines.append(f"  {name}: {frm} -> {to}")
        if self.blocked_moves:
            lines.append(f"  ({self.blocked_moves} restart-class "
                         f"moves blocked mid-burst)")
        for rec in self.trials:
            lines.append(f"  [{rec['label']}] score={rec['score']:.4g}"
                         f" recompiles={rec['recompiles']}")
        return "\n".join(lines)

    def __repr__(self):
        return (f"Recommendation({len(self.moved())} moves, "
                f"ratio={self.ratio:.3f}, "
                f"{len(self.trials)} trials)")


class Tuner:
    """Coordinate-descent knob search with cost-model trial filtering.

    Parameters
    ----------
    registry : KnobRegistry
    measure : callable
        ``measure(config) -> metrics dict`` — one real measurement
        window (forwarded to the :class:`TrialRunner` unless a
        pre-built ``runner`` is given).
    runner : TrialRunner, optional
        Pre-configured runner (custom objective/history/penalty).
    cost_model : CostModel, optional
        Candidate ranker; built fresh over the registry when omitted.
    knobs : sequence of str, optional
        Restrict the search to these knobs (default: whole registry).
    seed : int, optional
        Drives the knob-walk order and candidate exploration order —
        same seed, same surface ⇒ same trial sequence, byte-identical
        records.  Defaults to ``MXTPU_TUNE_SEED`` (0).
    busy_fn : callable, optional
        Returns True while a serving burst is live; non-``free`` knobs
        are not moved while it does.
    top_k : int
        Measured trials per knob (the cost model ranks the rest out).
    min_gain : float
        Relative improvement a move must show to be adopted
        (0.02 = 2%); guards against noise-chasing on small windows.
    reference_configs : dict of {label: config}, optional
        Configs always measured as trials.  Default: the registry's
        shipped defaults as ``"defaults"`` — the "autotuned ≥
        hand-tuned" gate.  Pass ``{}`` to disable.
    passes : int
        Coordinate-descent sweeps over the knob list.
    """

    def __init__(self, registry, measure=None, runner=None,
                 cost_model=None, knobs=None, seed=None, busy_fn=None,
                 top_k=2, min_gain=0.0, reference_configs=None,
                 passes=1):
        self.registry = registry
        if seed is None:
            seed = getenv("TUNE_SEED", 0, int)
        if runner is None:
            if measure is None:
                raise MXNetError("Tuner needs measure= or runner=")
            runner = TrialRunner(registry, measure, seed=seed)
        self.runner = runner
        self.cost_model = cost_model or CostModel(registry)
        self.knobs = list(knobs or registry.names())
        for n in self.knobs:
            registry.get(n)          # loud on unknown names
        self.seed = int(seed)
        self.busy_fn = busy_fn or (lambda: False)
        self.top_k = max(1, int(top_k))
        self.min_gain = float(min_gain)
        if reference_configs is None:
            reference_configs = {
                "defaults": {n: registry.get(n).default
                             for n in self.knobs
                             if registry.get(n).default is not None}}
        self.reference_configs = dict(reference_configs)
        self.passes = max(1, int(passes))

    # -- search --------------------------------------------------------------

    def recommend(self):
        """Run the search; returns a :class:`Recommendation` (nothing
        is left applied — ``run()`` applies the winner)."""
        rng = np.random.RandomState(self.seed)
        blocked = 0

        incumbent = self.registry.current(self.knobs)
        base = self.runner.run(dict(incumbent), label="baseline",
                               baseline=True)
        self.cost_model.observe(base["config"], base["score"])
        best = base
        incumbent = dict(base["config"])

        for sweep in range(self.passes):
            order = list(self.knobs)
            rng.shuffle(order)
            for name in order:
                knob = self.registry.get(name)
                if knob.restart != "free" and self.busy_fn():
                    blocked += 1
                    _counters["blocked_moves"] += 1
                    continue
                cands = [v for v in knob.candidates()
                         if v != incumbent.get(name)]
                if not cands:
                    continue
                rng.shuffle(cands)
                configs = [dict(incumbent, **{name: v}) for v in cands]
                ranked = self.cost_model.rank(configs)[:self.top_k]
                for cfg in ranked:
                    rec = self.runner.run(
                        cfg, label=f"s{sweep}:{name}={cfg[name]}",
                        knob=name)
                    self.cost_model.observe(rec["config"],
                                            rec["score"])
                    if rec["score"] > best["score"] * \
                            (1.0 + self.min_gain):
                        best = rec
                        incumbent = dict(rec["config"])

        for label, cfg in sorted(self.reference_configs.items()):
            full = dict(incumbent)
            full.update(cfg)
            if knob_blocked := [n for n in cfg
                                if self.registry.get(n).restart
                                != "free" and self.busy_fn()]:
                blocked += len(knob_blocked)
                _counters["blocked_moves"] += len(knob_blocked)
                continue
            rec = self.runner.run(full, label=f"ref:{label}")
            self.cost_model.observe(rec["config"], rec["score"])
            if rec["score"] > best["score"]:
                best = rec

        # leave the winner applied — trials end on whatever ran last,
        # and the recommendation must describe the live state run()
        # promises (re-apply is cheap and idempotent)
        if best is not base or self.reference_configs:
            self._apply(best["config"])

        out = Recommendation(best["config"], base, best,
                             self.runner.evidence(), self.seed,
                             blocked_moves=blocked)
        _counters["knobs_moved"] += len(out.moved())
        _note_scores(base["score"], best["score"])
        return out

    def _apply(self, config):
        free = {n: v for n, v in config.items()
                if self.registry.get(n).restart == "free"}
        rest = {n: v for n, v in config.items() if n not in free}
        self.registry.apply(free)
        if rest and not self.busy_fn():
            self.registry.apply(rest)

    def run(self):
        """``recommend()`` + apply the winning config (restart-class
        knobs only when not mid-burst); returns the
        :class:`Recommendation`."""
        rec = self.recommend()
        self._apply(rec.config)
        return rec
