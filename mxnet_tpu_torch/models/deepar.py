"""DeepAR probabilistic forecaster (ref: ``mxnet_tpu/models/deepar.py``;
structure after GluonTS's DeepAREstimator: an autoregressive LSTM over
lagged targets and covariates, a Student-t or Gaussian output head, NLL
training, ancestral-sampling prediction).

The LSTM is ``gluon.rnn.LSTM``, so on the card its recurrence runs in the
LSTM kernels (``ops/kernels/rnn.py``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..base import MXNetError
from ..gluon import nn, rnn
from ..gluon.block import HybridBlock
from ..ndarray.ndarray import as_tensor


def _host(x):
    """An NDArray, tensor or array-like as a float32 numpy array."""
    x = as_tensor(x)
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


class GaussianOutput(HybridBlock):
    """Projects the hidden state to (mu, sigma); sigma through softplus."""

    def __init__(self, in_units=0, **kwargs):
        super().__init__(**kwargs)
        self.proj = nn.Dense(2, flatten=False)

    def hybrid_forward(self, F, h):
        out = self.proj(h)
        mu = F.slice_axis(out, -1, 0, 1)
        sigma = F.Activation(F.slice_axis(out, -1, 1, 2), act_type="softrelu")
        return F.squeeze(mu, axis=-1), F.squeeze(sigma, axis=-1) + 1e-4

    @staticmethod
    def nll(F, target, mu, sigma):
        return (F.log(sigma) + 0.5 * math.log(2 * math.pi)
                + 0.5 * F.square((target - mu) / sigma))


class StudentTOutput(HybridBlock):
    """(mu, sigma, nu) head, GluonTS's default for DeepAR."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.proj = nn.Dense(3, flatten=False)

    def hybrid_forward(self, F, h):
        out = self.proj(h)
        mu = F.squeeze(F.slice_axis(out, -1, 0, 1), axis=-1)
        sigma = F.squeeze(F.Activation(F.slice_axis(out, -1, 1, 2),
                                       act_type="softrelu"), axis=-1) + 1e-4
        nu = 2.0 + F.squeeze(F.Activation(F.slice_axis(out, -1, 2, 3),
                                          act_type="softrelu"), axis=-1)
        return mu, sigma, nu

    @staticmethod
    def nll(F, target, mu, sigma, nu):
        z = (target - mu) / sigma
        return -(F.gammaln((nu + 1) / 2) - F.gammaln(nu / 2)
                 - 0.5 * F.log(3.141592653589793 * nu) - F.log(sigma)
                 - (nu + 1) / 2 * F.log(1 + F.square(z) / nu))


class DeepARNetwork(HybridBlock):
    """Training network: the LSTM unrolled over the context and prediction
    range; the forward returns the mean one-step-ahead NLL."""

    def __init__(self, num_cells=40, num_layers=2, dropout=0.1,
                 distr="student_t", num_lags=3, **kwargs):
        super().__init__(**kwargs)
        self._num_lags = num_lags
        self.lstm = rnn.LSTM(num_cells, num_layers, layout="NTC",
                             dropout=dropout)
        self.distr_output = StudentTOutput() if distr == "student_t" \
            else GaussianOutput()
        self._distr = distr

    def _lag_features(self, F, target):
        """``target (batch, T)`` -> lags 1..num_lags ``(batch, T, L)``."""
        lags = []
        for lag in range(1, self._num_lags + 1):
            padded = F.squeeze(F.pad(F.expand_dims(target, axis=1),
                                     mode="constant",
                                     pad_width=(0, 0, 0, 0, lag, 0),
                                     constant_value=0.0), axis=1)
            lags.append(F.slice_axis(padded, 1, 0, target.shape[1]))
        return F.stack(*lags, axis=-1)

    def hybrid_forward(self, F, target, covariates=None):
        """``target (batch, T)``; ``covariates (batch, T, C)`` or None.
        Returns the mean NLL of the one-step-ahead predictions."""
        feats = self._lag_features(F, target)
        if covariates is not None:
            feats = F.concat(feats, covariates, dim=2)
        out = self.lstm(feats)
        params = self.distr_output(out)
        if self._distr == "student_t":
            nll = StudentTOutput.nll(F, target, *params)
        else:
            nll = GaussianOutput.nll(F, target, *params)
        return F.mean(nll)

    def _device(self):
        return next(iter(self.collect_params().values())).data().device

    def next_params(self, paths, covariates=None):
        """The head's parameters for the value after each path: ``paths
        (rows, L)`` on the host, ``covariates`` the rows' known features
        ``(rows, >= L+1, C)`` (a tensor on the network's device) or None.
        Position t's input is lag1 = target[t-1] (+ covariates[t]) and its
        output parameterizes target[t], so the path is extended by a dummy
        value (never read by position L's lags) and run through the
        network on its device; returns ``[mu, sigma(, nu)]``, each a
        ``(rows,)`` numpy array."""
        from .. import ndarray as F

        device = self._device()
        L = paths.shape[1]
        ext = np.concatenate(
            [paths, np.zeros((paths.shape[0], 1), paths.dtype)], axis=1)
        feats = self._lag_features(
            F, torch.from_numpy(ext.astype(np.float32)).to(device))
        if covariates is not None:
            feats = F.concat(feats, covariates[:, :L + 1], dim=2)
        params = self.distr_output(self.lstm(feats))
        return [p[:, -1].detach().cpu().numpy() for p in params]

    def predict(self, context, prediction_length=24, num_samples=100,
                covariates=None, seed=0):
        """Ancestral sampling: ``(batch, num_samples, prediction_length)``
        numpy samples.  Each step runs the network over the whole path on
        the device of its parameters (:meth:`next_params`) and draws the
        next values on the host from ``np.random.RandomState(seed)``
        (``standard_t(nu)*sigma + mu`` or ``normal(mu, sigma)``), as the JAX
        package does, so the same weights and seed give the same paths.

        ``covariates``: ``(batch, context+prediction, C)`` known-future
        features aligned with training's covariate layout, required when
        the network was trained with covariates."""
        rng = np.random.RandomState(seed)
        ctx_np = _host(context)
        b, t0 = ctx_np.shape[:2]
        paths = np.repeat(ctx_np, num_samples, axis=0)
        cov_rep = None
        if covariates is not None:
            cov_np = _host(covariates)
            if cov_np.shape[:2] != (b, t0 + prediction_length):
                raise MXNetError(
                    f"predict covariates must be (batch, context+"
                    f"prediction, C) = ({b}, {t0 + prediction_length}, "
                    f"C); got {cov_np.shape}")
            cov_rep = torch.from_numpy(np.repeat(cov_np, num_samples,
                                                 axis=0)).to(self._device())
        for _ in range(prediction_length):
            last = self.next_params(paths, cov_rep)
            if self._distr == "student_t":
                mu, sigma, nu = last
                z = rng.standard_t(nu) * sigma + mu
            else:
                mu, sigma = last
                z = rng.normal(mu, sigma)
            paths = np.concatenate([paths, z[:, None]], axis=1)
        return paths[:, t0:].reshape(b, num_samples, prediction_length)

def deepar(num_cells=40, num_layers=2, **kwargs):
    """The BASELINE DeepAR config (GluonTS defaults: 2x40 LSTM)."""
    return DeepARNetwork(num_cells, num_layers, **kwargs)
