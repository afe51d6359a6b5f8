"""Evaluation metrics (ref: ``mxnet_tpu/metric.py``, after
python/mxnet/metric.py).  Labels and predictions are read back to numpy
and every metric is computed on the host.

Thread safety: the serving tier (``serve``) updates accuracy
metrics from worker threads, so every metric instance carries an RLock
and all state-touching entry points (``update``/``get``/``reset``,
including subclass overrides — wrapped automatically via
``__init_subclass__``) run under it.  Without this, the read-modify-
write on ``sum_metric``/``num_inst`` drops updates under concurrency.
"""
from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from .base import MXNetError


class Registry:
    """Name -> class registry, case-insensitive (ref: the JAX package's
    ``base.Registry``; the port keeps its own copy)."""

    def __init__(self, kind):
        self.kind = kind
        self._entries = {}
        self._lock = threading.Lock()

    def register(self, name=None, override=False):
        def _reg(obj):
            key = (name or getattr(obj, "__name__", None) or str(obj)).lower()
            with self._lock:
                if key in self._entries and not override:
                    raise MXNetError(
                        f"{self.kind} '{key}' already registered")
                self._entries[key] = obj
            return obj

        return _reg

    def get(self, name):
        key = str(name).lower()
        if key not in self._entries:
            raise MXNetError(
                f"unknown {self.kind} '{name}'; known: {sorted(self._entries)}")
        return self._entries[key]

    def __contains__(self, name):
        return str(name).lower() in self._entries

    def list(self):
        return sorted(self._entries)


_registry = Registry("metric")
register = _registry.register


def _locked(method):
    """Run a metric method under the instance lock (idempotent)."""
    if getattr(method, "_metric_locked", False):
        return method

    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        lock = getattr(self, "_lock", None)
        if lock is None:  # during __init__, before the lock exists
            return method(self, *args, **kwargs)
        with lock:
            return method(self, *args, **kwargs)

    wrapper._metric_locked = True
    return wrapper


def _as_np(x):
    """numpy of an NDArray or tensor (read back from the device), or of an
    array-like."""
    from .ndarray.ndarray import NDArray

    if isinstance(x, torch.Tensor):
        x = NDArray(x)
    if isinstance(x, NDArray):
        return x.asnumpy()
    return np.asarray(x)


def _to_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


class EvalMetric:
    """Base metric (ref: mx.metric.EvalMetric).  Safe for concurrent
    ``update``/``get`` callers (see module docstring)."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        for name in ("update", "get", "reset"):
            fn = cls.__dict__.get(name)
            if callable(fn):
                setattr(cls, name, _locked(fn))

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self._lock = threading.RLock()  # RLock: get() may call super().get()
        self.name = name
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("_lock", None)  # locks don't pickle
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.RLock()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        raise NotImplementedError

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, self.sum_metric / self.num_inst

    def get_name_value(self):
        name, value = self.get()
        name = _to_list(name)
        value = _to_list(value)
        return list(zip(name, value))

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"


# __init_subclass__ only sees subclasses — lock the base entry points
# too, since most metrics inherit get()/reset() unchanged
for _name in ("update", "get", "reset"):
    setattr(EvalMetric, _name, _locked(EvalMetric.__dict__[_name]))
del _name


@register("acc")
@register("accuracy")
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", **kwargs):
        super().__init__(name, **kwargs)
        self.axis = axis

    def update(self, labels, preds):
        for label, pred in zip(_to_list(labels), _to_list(preds)):
            label = _as_np(label)
            pred = _as_np(pred)
            # argmax whenever shapes differ (ref compares shapes, not ndim:
            # handles (N,1) labels vs (N,C) predictions)
            if pred.shape != label.shape:
                pred = pred.argmax(axis=self.axis)
            pred = pred.astype(np.int64).ravel()
            label = label.astype(np.int64).ravel()
            self.sum_metric += (pred == label).sum()
            self.num_inst += len(label)


@register("top_k_accuracy")
@register("top_k_acc")
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", **kwargs):
        super().__init__(name, **kwargs)
        self.top_k = top_k
        self.name = f"top_k_accuracy_{top_k}"

    def update(self, labels, preds):
        for label, pred in zip(_to_list(labels), _to_list(preds)):
            label = _as_np(label).astype(np.int64).ravel()
            pred = _as_np(pred)
            topk = np.argsort(-pred, axis=-1)[:, :self.top_k]
            self.sum_metric += sum(l in t for l, t in zip(label, topk))
            self.num_inst += len(label)


@register("f1")
class F1(EvalMetric):
    def __init__(self, name="f1", average="macro", **kwargs):
        super().__init__(name, **kwargs)
        self.average = average
        self.reset()

    def reset(self):
        super().reset()
        self._tp = self._fp = self._fn = 0.0

    def update(self, labels, preds):
        for label, pred in zip(_to_list(labels), _to_list(preds)):
            label = _as_np(label).ravel().astype(np.int64)
            pred = _as_np(pred)
            if pred.ndim > 1:
                pred = pred.argmax(axis=-1)
            pred = pred.ravel().astype(np.int64)
            self._tp += ((pred == 1) & (label == 1)).sum()
            self._fp += ((pred == 1) & (label == 0)).sum()
            self._fn += ((pred == 0) & (label == 1)).sum()
            self.num_inst += 1

    def get(self):
        prec = self._tp / max(self._tp + self._fp, 1e-12)
        rec = self._tp / max(self._tp + self._fn, 1e-12)
        f1 = 2 * prec * rec / max(prec + rec, 1e-12)
        return self.name, f1


@register("mcc")
class MCC(EvalMetric):
    """Matthews correlation coefficient, binary (ref: mx.metric.MCC)."""

    def __init__(self, name="mcc", **kwargs):
        super().__init__(name, **kwargs)
        self.reset()

    def reset(self):
        super().reset()
        self._tp = self._fp = self._fn = self._tn = 0.0

    def update(self, labels, preds):
        for label, pred in zip(_to_list(labels), _to_list(preds)):
            label = _as_np(label).ravel().astype(np.int64)
            pred = _as_np(pred)
            if pred.ndim > 1:
                pred = pred.argmax(axis=-1)
            pred = pred.ravel().astype(np.int64)
            self._tp += ((pred == 1) & (label == 1)).sum()
            self._fp += ((pred == 1) & (label == 0)).sum()
            self._fn += ((pred == 0) & (label == 1)).sum()
            self._tn += ((pred == 0) & (label == 0)).sum()
            self.num_inst += 1

    def get(self):
        tp, fp, fn, tn = self._tp, self._fp, self._fn, self._tn
        denom = np.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
        mcc = (tp * tn - fp * fn) / denom if denom > 0 else 0.0
        return self.name, float(mcc)


@register("mae")
class MAE(EvalMetric):
    def __init__(self, name="mae", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_to_list(labels), _to_list(preds)):
            label, pred = _as_np(label), _as_np(pred)
            self.sum_metric += np.abs(label.reshape(pred.shape)
                                      - pred).mean()
            self.num_inst += 1


@register("mse")
class MSE(EvalMetric):
    def __init__(self, name="mse", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_to_list(labels), _to_list(preds)):
            label, pred = _as_np(label), _as_np(pred)
            self.sum_metric += ((label.reshape(pred.shape) - pred) ** 2).mean()
            self.num_inst += 1


@register("rmse")
class RMSE(MSE):
    def __init__(self, name="rmse", **kwargs):
        super().__init__(name=name, **kwargs)

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, float(np.sqrt(self.sum_metric / self.num_inst))


@register("ce")
@register("cross-entropy")
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", **kwargs):
        super().__init__(name, **kwargs)
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in zip(_to_list(labels), _to_list(preds)):
            label = _as_np(label).ravel().astype(np.int64)
            pred = _as_np(pred)
            prob = pred[np.arange(label.shape[0]), label]
            self.sum_metric += (-np.log(prob + self.eps)).sum()
            self.num_inst += label.shape[0]


@register("nll_loss")
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", **kwargs):
        super().__init__(eps=eps, name=name, **kwargs)


@register("perplexity")
class Perplexity(CrossEntropy):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 **kwargs):
        super().__init__(name=name, **kwargs)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        for label, pred in zip(_to_list(labels), _to_list(preds)):
            label = _as_np(label).ravel().astype(np.int64)
            pred = _as_np(pred).reshape(-1, _as_np(pred).shape[-1])
            mask = np.ones_like(label, dtype=bool)
            if self.ignore_label is not None:
                mask = label != self.ignore_label
            prob = pred[np.arange(label.shape[0]), label]
            self.sum_metric += (-np.log(prob[mask] + self.eps)).sum()
            self.num_inst += mask.sum()

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, float(np.exp(self.sum_metric / self.num_inst))


@register("pearsonr")
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", **kwargs):
        super().__init__(name, **kwargs)
        self._labels, self._preds = [], []

    def reset(self):
        super().reset()
        self._labels, self._preds = [], []

    def update(self, labels, preds):
        for label, pred in zip(_to_list(labels), _to_list(preds)):
            self._labels.append(_as_np(label).ravel())
            self._preds.append(_as_np(pred).ravel())
            self.num_inst += 1

    def get(self):
        if not self._labels:
            return self.name, float("nan")
        ls = np.concatenate(self._labels)
        ps = np.concatenate(self._preds)
        return self.name, float(np.corrcoef(ls, ps)[0, 1])


@register("loss")
class Loss(EvalMetric):
    """Average of a scalar loss output (ref: mx.metric.Loss)."""

    def __init__(self, name="loss", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, _, preds):
        for pred in _to_list(preds):
            pred = _as_np(pred)
            self.sum_metric += pred.sum()
            self.num_inst += pred.size


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", **kwargs):
        super().__init__(name, **kwargs)
        self.metrics = [create(m) if isinstance(m, str) else m
                        for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric) if isinstance(metric, str)
                            else metric)

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.extend(_to_list(n))
            values.extend(_to_list(v))
        return names, values


class CustomMetric(EvalMetric):
    def __init__(self, feval, name="custom", allow_extra_outputs=False,
                 **kwargs):
        super().__init__(f"custom({name})", **kwargs)
        self._feval = feval

    def update(self, labels, preds):
        for label, pred in zip(_to_list(labels), _to_list(preds)):
            v = self._feval(_as_np(label), _as_np(pred))
            if isinstance(v, tuple):
                s, n = v
                self.sum_metric += s
                self.num_inst += n
            else:
                self.sum_metric += v
                self.num_inst += 1


def np_metric(numpy_feval, name=None, allow_extra_outputs=False):
    return CustomMetric(numpy_feval, name or numpy_feval.__name__,
                        allow_extra_outputs)


def create(metric, *args, **kwargs):
    """Ref: mx.metric.create."""
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        c = CompositeEvalMetric()
        for m in metric:
            c.add(create(m, *args, **kwargs))
        return c
    if callable(metric):
        return CustomMetric(metric)
    return _registry.get(metric)(*args, **kwargs)
