"""Contrib neural-network blocks (ref: ``mxnet_tpu/gluon/contrib/nn.py``;
python/mxnet/gluon/contrib/nn/basic_layers.py): ``Concurrent``,
``HybridConcurrent``, ``Identity`` and ``SyncBatchNorm``.  ``MoEFFN``
comes with part 3 of the distributed slice and ``SparseEmbedding`` with
slice 9 (sparse arrays); both raise naming them.
"""
from __future__ import annotations

from ... import autograd
from ...base import MXNetError
from .. import nn as _nn
from ..block import HybridBlock, commit_aux


class Concurrent(HybridBlock):
    """Run the children on the same input and concatenate their outputs
    along ``axis`` (ref: contrib.nn.Concurrent)."""

    def __init__(self, axis=-1, **kwargs):
        super().__init__(**kwargs)
        self.axis = axis
        self._layers = []

    def add(self, *blocks):
        for b in blocks:
            self.register_child(b, f"c{len(self._layers)}")
            self._layers.append(b)

    def hybrid_forward(self, F, x):
        return F.concat(*[b(x) for b in self._layers], dim=self.axis)


class HybridConcurrent(Concurrent):
    """Ref: contrib.nn.HybridConcurrent."""


class Identity(HybridBlock):
    """The input itself (ref: contrib.nn.Identity)."""

    def hybrid_forward(self, F, x):
        return x


class SyncBatchNorm(_nn.BatchNorm):
    """Cross-device BatchNorm (ref: contrib.nn.SyncBatchNorm,
    src/operator/contrib/sync_batch_norm.cc) on channel axis 1.

    Inside a ``DataParallelTrainer`` step on a mesh of more than one rank
    its statistics are those of the whole global batch, as every
    BatchNorm's there (the data axes' ranks sum them).  ``axis_name``
    names one mesh axis to sum them over instead.  ``num_devices`` is
    taken for the API and changes nothing."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, center=True, scale=True,
                 use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", axis_name=None,
                 **kwargs):
        super().__init__(axis=1, momentum=momentum, epsilon=epsilon,
                         center=center, scale=scale,
                         use_global_stats=use_global_stats,
                         beta_initializer=beta_initializer,
                         gamma_initializer=gamma_initializer,
                         running_mean_initializer=running_mean_initializer,
                         running_variance_initializer=(
                             running_variance_initializer),
                         in_channels=in_channels, **kwargs)
        self._kwargs = {"eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats,
                        "ndev": num_devices or 1}
        if axis_name is not None:
            self._kwargs["axis_name"] = axis_name

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        train = autograd.is_training()
        out, new_mm, new_mv = F.contrib.SyncBatchNorm(
            x, gamma, beta, running_mean, running_var, _train=train,
            **self._kwargs)
        if train and not self._kwargs["use_global_stats"]:
            commit_aux(running_mean, new_mm)
            commit_aux(running_var, new_mv)
        return out


class MoEFFN(HybridBlock):
    def __init__(self, *args, **kwargs):
        raise MXNetError("gluon.contrib.nn.MoEFFN is not ported yet; it comes "
                         "with part 3 of the distributed slice (slice 7, part "
                         "3: moe; ROADMAP.md queue 1)")


class SparseEmbedding(HybridBlock):
    def __init__(self, *args, **kwargs):
        raise MXNetError("gluon.contrib.nn.SparseEmbedding is not ported yet; "
                         "it comes with slice 9 (sparse arrays; ROADMAP.md "
                         "queue 1)")
