"""GluonTS-style probabilistic-forecasting data pipeline for DeepAR: the
port's own copy of ``mxnet_tpu/data/timeseries.py`` (numpy only; the same
seeds give the same arrays).

Ref (behavioral parity): GluonTS ListDataset + InstanceSplitter +
time_features + mean scaling — the feature machinery the DeepAR
BASELINE config trains with.  Covers: the dataset container, age
feature, time features by frequency, mean-|target| scaling, training
instance sampling (context+prediction windows), and the train/predict
split.
"""
from __future__ import annotations

import json

import numpy as np

from ..base import MXNetError

# steps per larger period, by pandas-style freq string
_FREQ_PERIODS = {
    "H": (24, 168),    # hour of day, hour of week
    "D": (7, 30),      # day of week, day of month
    "W": (52, 52),
    "M": (12, 12),
    "B": (5, 20),
    "min": (60, 1440),
}


class ListDataset:
    """GluonTS's in-memory dataset: entries {'target': [...],
    'start': int_offset, 'item_id': ...} at one frequency."""

    def __init__(self, entries, freq="H"):
        if freq not in _FREQ_PERIODS:
            raise MXNetError(
                f"unsupported freq {freq!r}; one of "
                f"{sorted(_FREQ_PERIODS)}")
        self.freq = freq
        self.entries = []
        for i, e in enumerate(entries):
            tgt = np.asarray(e["target"], np.float32)
            if tgt.ndim != 1 or not len(tgt):
                raise MXNetError(f"entry {i}: target must be a "
                                 "non-empty 1D series")
            self.entries.append({
                "target": tgt,
                "start": int(e.get("start", 0)),
                "item_id": e.get("item_id", i),
            })

    def __len__(self):
        return len(self.entries)

    def __iter__(self):
        return iter(self.entries)

    @classmethod
    def from_jsonl(cls, path, freq="H"):
        """One JSON object per line — the GluonTS file convention."""
        with open(path) as f:
            return cls([json.loads(line) for line in f if line.strip()],
                       freq=freq)


def time_features(freq, start, length):
    """(length, 2) cyclic position features in [-0.5, 0.5] — GluonTS
    time_features role, computed from the integer offset (no calendar
    dependency; a caller with real datetimes maps them to offsets)."""
    p1, p2 = _FREQ_PERIODS[freq]
    t = np.arange(start, start + length, dtype=np.float32)
    return np.stack([(t % p1) / p1 - 0.5, (t % p2) / p2 - 0.5], axis=-1)


def age_feature(length):
    """log10(2 + t): the GluonTS 'age' covariate."""
    return np.log10(2.0 + np.arange(length, dtype=np.float32))


def mean_scale(context, eps=1e-10):
    """GluonTS mean scaling: mean of |target| over the context, floored
    so all-zero series don't divide by zero."""
    return max(float(np.mean(np.abs(context))), eps) if len(context) \
        else 1.0


class InstanceSplitter:
    """Sample (past_target, future_target, covariates) training windows
    and build the aligned prediction-time inputs."""

    def __init__(self, context_length, prediction_length, freq="H",
                 seed=0):
        self.C = int(context_length)
        self.P = int(prediction_length)
        self.freq = freq
        self.rng = np.random.RandomState(seed)

    def _features(self, entry, t0, length):
        # calendar features use the absolute offset; age is position
        # WITHIN the series (GluonTS semantics — 'start' must not
        # shift it)
        tf = time_features(self.freq, entry["start"] + t0, length)
        age = age_feature(t0 + length)[-length:]
        return np.concatenate([tf, age[:, None]], axis=-1)

    def training_instances(self, dataset, num_instances):
        """-> dict of stacked arrays: target (n, C+P) scaled,
        covariates (n, C+P, 3), scale (n,).  The model trains on
        one-step-ahead NLL over the whole window (DeepARNetwork
        contract: target (b, T), covariates (b, T, C))."""
        T = self.C + self.P
        eligible = [e for e in dataset if len(e["target"]) >= T]
        if not eligible:
            raise MXNetError(
                f"no series long enough for context+prediction = {T}")
        tgts, covs, scales = [], [], []
        for _ in range(num_instances):
            e = eligible[self.rng.randint(len(eligible))]
            t0 = self.rng.randint(len(e["target"]) - T + 1)
            window = e["target"][t0:t0 + T]
            scale = mean_scale(window[:self.C])
            tgts.append(window / scale)
            covs.append(self._features(e, t0, T))
            scales.append(scale)
        return {"target": np.stack(tgts).astype(np.float32),
                "covariates": np.stack(covs).astype(np.float32),
                "scale": np.asarray(scales, np.float32)}

    def prediction_instances(self, dataset):
        """Last context window of every series + the covariates known
        over the prediction range: target (n, C), covariates
        (n, C+P, 3), scale (n,)."""
        tgts, covs, scales = [], [], []
        for e in dataset:
            if len(e["target"]) < self.C:
                raise MXNetError(
                    f"series {e['item_id']} shorter than context "
                    f"{self.C}")
            t0 = len(e["target"]) - self.C
            ctx = e["target"][t0:]
            scale = mean_scale(ctx)
            tgts.append(ctx / scale)
            covs.append(self._features(e, t0, self.C + self.P))
            scales.append(scale)
        return {"target": np.stack(tgts).astype(np.float32),
                "covariates": np.stack(covs).astype(np.float32),
                "scale": np.asarray(scales, np.float32)}


def train_test_split(dataset, prediction_length):
    """GluonTS convention: train = every series minus the last
    prediction_length points; test = the full series (the held-out
    tail is the forecast target)."""
    train_entries = []
    for e in dataset:
        if len(e["target"]) <= prediction_length:
            raise MXNetError(
                f"series {e['item_id']} too short to hold out "
                f"{prediction_length} points")
        train_entries.append({
            "target": e["target"][:-prediction_length],
            "start": e["start"], "item_id": e["item_id"]})
    return ListDataset(train_entries, dataset.freq), dataset


def quantile_loss(target, forecast_samples, quantiles=(0.1, 0.5, 0.9)):
    """GluonTS Evaluator role: weighted quantile loss per quantile plus
    the mean.  ``target``: (n, P) held-out future; ``forecast_samples``:
    (n, num_samples, P) from ``DeepARNetwork.predict``.  Returns a dict
    {'wQL[q]': float, ..., 'mean_wQL': float}."""
    target = np.asarray(target, np.float32)
    samples = np.asarray(forecast_samples, np.float32)
    if samples.ndim != 3 or target.ndim != 2 or \
            samples.shape[0] != target.shape[0] or \
            samples.shape[2] != target.shape[1]:
        raise MXNetError(
            f"quantile_loss: samples must be (n, num_samples, P) "
            f"aligned with target (n, P); got {samples.shape} vs "
            f"{target.shape}")
    denom = np.abs(target).sum()
    out = {}
    for q in quantiles:
        pred = np.quantile(samples, q, axis=1)
        diff = target - pred
        ql = 2.0 * np.sum(np.maximum(q * diff, (q - 1.0) * diff))
        out[f"wQL[{q}]"] = float(ql / max(denom, 1e-10))
    out["mean_wQL"] = float(np.mean(list(out.values())))
    return out


def synthetic_dataset(rng, n_series=16, length=200, freq="H"):
    """Seasonal+level synthetic series in GluonTS entry form."""
    entries = []
    for i in range(n_series):
        t = np.arange(length, dtype=np.float32)
        level = 1.0 + 2.0 * rng.rand()
        season = np.sin(2 * np.pi * t / 24.0)
        noise = rng.randn(length).astype(np.float32) * 0.1
        entries.append({
            "target": (level * (1.0 + 0.5 * season) + noise).tolist(),
            "start": int(rng.randint(0, 1000)), "item_id": i})
    return ListDataset(entries, freq=freq)
