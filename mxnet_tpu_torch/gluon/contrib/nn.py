"""Contrib neural-network blocks (ref: ``mxnet_tpu/gluon/contrib/nn.py``;
python/mxnet/gluon/contrib/nn/basic_layers.py): ``Concurrent``,
``HybridConcurrent``, ``Identity``, ``SyncBatchNorm``, ``MoEFFN`` and
``PixelShuffle1D/2D/3D``.
``SparseEmbedding`` comes with slice 9 (sparse arrays) and raises naming
it.
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
    """Mixture-of-Experts feed-forward (ref: contrib.nn.MoEFFN; Switch
    top-1 or GShard top-2 routing by ``top_k``, static capacity, GShard's
    einsum dispatch: ``parallel.moe``).

    Input (..., d_model) -> (output shaped like it, aux_loss (1,)).  Add
    ``aux_weight * aux_loss`` to the objective for load balancing.  Under
    ``DataParallelTrainer(param_spec_fn=parallel.moe.
    gluon_moe_param_spec_fn(mesh))`` on a mesh with an ``ep`` axis a rank
    holds and computes E/ep experts (``parallel.moe``)."""

    def __init__(self, num_experts, d_model, d_hidden,
                 capacity_factor=1.25, top_k=1, weight_initializer=None,
                 **kwargs):
        super().__init__(**kwargs)
        if num_experts < 2:
            raise ValueError("MoEFFN needs >= 2 experts")
        self._cf = float(capacity_factor)
        self._top_k = int(top_k)
        self.router_weight = self.params.get(
            "router_weight", shape=(d_model, num_experts),
            init=weight_initializer)
        self.w1 = self.params.get(
            "w1", shape=(num_experts, d_model, d_hidden),
            init=weight_initializer)
        self.b1 = self.params.get("b1", shape=(num_experts, d_hidden),
                                  init="zeros")
        self.w2 = self.params.get(
            "w2", shape=(num_experts, d_hidden, d_model),
            init=weight_initializer)
        self.b2 = self.params.get("b2", shape=(num_experts, d_model),
                                  init="zeros")

    def hybrid_forward(self, F, x, router_weight, w1, b1, w2, b2):
        return F._contrib_MoEFFN(x, router_weight, w1, b1, w2, b2,
                                 capacity_factor=self._cf,
                                 top_k=self._top_k)


class SparseEmbedding(HybridBlock):
    def __init__(self, *args, **kwargs):
        raise MXNetError("gluon.contrib.nn.SparseEmbedding is not ported yet; "
                         "it comes with slice 9 (sparse arrays; ROADMAP.md "
                         "queue 1)")


class PixelShuffle1D(HybridBlock):
    """Upsample by moving channels into length (ref: contrib.nn.
    PixelShuffle1D): ``(N, C*f, W) -> (N, C, W*f)``."""

    def __init__(self, factor, **kwargs):
        super().__init__(**kwargs)
        self._factor = int(factor)

    def hybrid_forward(self, F, x):
        f = self._factor
        x = F.reshape(x, shape=(0, -4, -1, f, 0))      # (N, C, f, W)
        x = F.transpose(x, axes=(0, 1, 3, 2))          # (N, C, W, f)
        return F.reshape(x, shape=(0, 0, -3))          # (N, C, W*f)

    def __repr__(self):
        return f"PixelShuffle1D({self._factor})"


class PixelShuffle2D(HybridBlock):
    """``(N, C*f1*f2, H, W) -> (N, C, H*f1, W*f2)`` (ref: contrib.nn.
    PixelShuffle2D); ``factor`` one int or a pair."""

    def __init__(self, factor, **kwargs):
        super().__init__(**kwargs)
        try:
            f1, f2 = factor
        except TypeError:
            f1 = f2 = factor
        self._factors = (int(f1), int(f2))

    def hybrid_forward(self, F, x):
        f1, f2 = self._factors
        # (N, C, f1, f2, H, W) -> (N, C, H, f1, W, f2) -> merge
        x = F.reshape(x, shape=(0, -4, -1, f1 * f2, 0, 0))
        x = F.reshape(x, shape=(0, 0, -4, f1, f2, 0, 0))
        x = F.transpose(x, axes=(0, 1, 4, 2, 5, 3))
        return F.reshape(x, shape=(0, 0, -3, -3))

    def __repr__(self):
        return f"PixelShuffle2D({self._factors})"


class PixelShuffle3D(HybridBlock):
    """``(N, C*f1*f2*f3, D, H, W) -> (N, C, D*f1, H*f2, W*f3)`` (ref:
    contrib.nn.PixelShuffle3D); ``factor`` one int or a triple."""

    def __init__(self, factor, **kwargs):
        super().__init__(**kwargs)
        try:
            f1, f2, f3 = factor
        except TypeError:
            f1 = f2 = f3 = factor
        self._factors = (int(f1), int(f2), int(f3))

    def hybrid_forward(self, F, x):
        f1, f2, f3 = self._factors
        x = F.reshape(x, shape=(0, -4, -1, f1 * f2 * f3, 0, 0, 0))
        x = F.reshape(x, shape=(0, 0, -4, f1, f2 * f3, 0, 0, 0))
        x = F.reshape(x, shape=(0, 0, 0, -4, f2, f3, 0, 0, 0))
        x = F.transpose(x, axes=(0, 1, 5, 2, 6, 3, 7, 4))
        return F.reshape(x, shape=(0, 0, -3, -3, -3))

    def __repr__(self):
        return f"PixelShuffle3D({self._factors})"
