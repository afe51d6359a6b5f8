"""Fitted candidate-ranking model: spend real trials only where it counts
(ref: mxnet_tpu/tune/cost_model.py).

Live trials are the ground truth but each one costs a measurement
window (and possibly recompiles).  The cost model is the cheap filter
in front of them, in the spirit of the learned TPU performance model
(arXiv 2008.01040) scaled down to a knob surface: featurize a
candidate config, predict its score, and let the tuner measure only
the top few.

Two information sources, combined:

* **Analytic seed** — the step's FLOP count (surfaced by HealthMonitor
  as ``flops_per_step``; the port's is the analytic ``6 x parameters x
  batch_size``)
  plus the measured phase breakdown (input wait vs compute vs
  collective vs optimizer ms).  Before any trial has run, the seed
  gives a direction: dispatch-overhead knobs (bucket size, fused-group
  size) matter when the optimizer/collective phases dominate; pipeline
  knobs matter when input wait dominates.
* **Measured fit** — every observed ``(config, score)`` pair refits a
  ridge regression over log-scaled knob features (value, value²,
  reciprocal, pairwise cross terms).  The reciprocal term is what lets
  a quadratic-ish model capture 1/v-shaped dispatch-overhead knobs;
  cross terms capture bucket-size × group-size style interaction.

With fewer observations than features the fit is ridge-regularised
toward the analytic prior's direction, so ranking degrades gracefully
to "the seed's guess" instead of to noise.
"""
from __future__ import annotations

import numpy as np

from ..base import MXNetError

__all__ = ["CostModel", "check_monotonic_agreement"]


class CostModel:
    """Rank candidate configs; measure only the winners.

    Parameters
    ----------
    registry : KnobRegistry
        Defines the feature space (one block per numeric knob, one
        index feature per choice knob).
    phase_hint : dict, optional
        A HealthMonitor window (``mon.tick()`` dict or the ``health``
        section): ``flops_per_step`` + phase ``*_ms`` keys seed the
        prior.
    ridge : float
        L2 regularisation strength for the fit.
    """

    def __init__(self, registry, phase_hint=None, ridge=1e-3):
        self.registry = registry
        self.ridge = float(ridge)
        self._X = []      # feature rows
        self._y = []      # observed scores
        self._w = None    # fitted weights (lazily refit)
        self._names = list(registry.names())
        self._prior = self._seed_prior(phase_hint or {})

    # -- featurization -------------------------------------------------------

    def _unit(self, knob, value):
        """Map one knob value to [0, 1] on a log scale (linear for
        choice/bool), so every feature block is comparable."""
        if knob.kind == "choice":
            dom = list(knob.domain)
            return dom.index(value) / max(1, len(dom) - 1)
        if knob.kind == "bool":
            return 1.0 if value else 0.0
        lo, hi = knob.bounds
        lo, hi = max(lo, 1e-9), max(hi, 1e-9)
        v = min(max(float(value), lo), hi)
        if hi / lo < 4.0:          # narrow range: linear is fine
            return (v - lo) / (hi - lo) if hi > lo else 0.0
        return float(np.log(v / lo) / np.log(hi / lo))

    def features(self, config):
        """Feature vector for one full config: per knob ``[u, u²,
        1/(u+eps)]`` plus pairwise ``u_i·u_j`` cross terms and a bias
        term."""
        us = []
        for name in self._names:
            knob = self.registry.get(name)
            value = config.get(name, knob.default)
            us.append(self._unit(knob, value))
        feats = [1.0]
        for u in us:
            feats.extend((u, u * u, 1.0 / (u + 0.25)))
        for i in range(len(us)):
            for j in range(i + 1, len(us)):
                feats.append(us[i] * us[j])
        return np.asarray(feats, dtype=np.float64)

    # -- analytic seed -------------------------------------------------------

    def _seed_prior(self, hint):
        """Per-knob direction weights from the phase breakdown: which
        phase a knob attacks decides how much headroom moving it up
        its range plausibly buys.  Returned as a weight vector over
        the linear feature slots (everything else zero)."""
        phase_of = {
            "kvstore_bucket_mb": "collective_ms",
            "aggregate_num": "optimizer_ms",
            "zero_shard": "optimizer_ms",
            "pipeline_prefetch": "input_wait_ms",
            "pipeline_map_inflight": "input_wait_ms",
        }
        total = sum(float(hint.get(k, 0.0)) for k in
                    ("input_wait_ms", "h2d_ms", "compute_ms",
                     "collective_ms", "optimizer_ms", "compile_ms"))
        n = len(self._names)
        dim = 1 + 3 * n + n * (n - 1) // 2
        w = np.zeros(dim, dtype=np.float64)
        if total <= 0:
            return w
        for i, name in enumerate(self._names):
            phase = phase_of.get(name)
            if phase is None:
                continue
            share = float(hint.get(phase, 0.0)) / total
            # linear slot of knob i: deeper prefetch / bigger buckets
            # help in proportion to the phase they hide
            w[1 + 3 * i] = share
        return w

    # -- fitting -------------------------------------------------------------

    def observe(self, config, score):
        """Feed one measured ``(config, score)`` pair (the tuner calls
        this for every real trial, baseline included)."""
        self._X.append(self.features(config))
        self._y.append(float(score))
        self._w = None      # refit lazily on next predict

    def _fit(self):
        X = np.vstack(self._X)
        y = np.asarray(self._y, dtype=np.float64)
        # center scores so the ridge pull-to-zero acts on deltas, and
        # anchor the solution toward the analytic prior direction
        mean = y.mean()
        A = X.T @ X + self.ridge * np.eye(X.shape[1])
        b = X.T @ (y - mean) + self.ridge * self._prior
        w = np.linalg.solve(A, b)
        return w, mean

    def predict(self, config):
        """Predicted score (same units as the objective once ≥2 trials
        are observed; before that, prior-direction pseudo-score)."""
        f = self.features(config)
        if len(self._X) >= 2:
            if self._w is None:
                self._w = self._fit()
            w, mean = self._w
            return float(f @ w + mean)
        return float(f @ self._prior)

    def rank(self, candidates):
        """Sort candidate configs best-predicted-first.  Ties break by
        original order, so with zero signal the ranking is the
        caller's ordering (deterministic)."""
        if not candidates:
            return []
        scored = [(self.predict(c), -i, c)
                  for i, c in enumerate(candidates)]
        scored.sort(key=lambda t: (t[0], t[1]), reverse=True)
        from . import trials as _trials
        _trials._counters["candidates_ranked"] += len(candidates)
        return [c for _s, _i, c in scored]

    def n_observed(self):
        return len(self._y)

    def __repr__(self):
        return (f"CostModel({len(self._names)} knobs, "
                f"{len(self._y)} observations)")


def check_monotonic_agreement(model, configs, scores):
    """Test helper: fraction of candidate pairs whose predicted order
    matches the measured order (1.0 = perfect rank agreement)."""
    if len(configs) != len(scores) or len(configs) < 2:
        raise MXNetError("need >=2 (config, score) pairs")
    preds = [model.predict(c) for c in configs]
    agree = total = 0
    for i in range(len(configs)):
        for j in range(i + 1, len(configs)):
            if scores[i] == scores[j]:
                continue
            total += 1
            if (preds[i] - preds[j]) * (scores[i] - scores[j]) > 0:
                agree += 1
    return agree / max(1, total)
