"""Basic Gluon layers (ref: python/mxnet/gluon/nn/basic_layers.py): the
ones BERT and ResNet use."""
from __future__ import annotations

import math

from ... import autograd
from ..block import HybridBlock, commit_aux


class HybridSequential(HybridBlock):
    """Hybridizable Sequential (ref: nn.HybridSequential); children are
    named "0", "1", ... in the structural parameter names."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._layers = []

    def add(self, *blocks):
        for b in blocks:
            self.register_child(b, str(len(self._layers)))
            self._layers.append(b)

    def hybrid_forward(self, F, x):
        for b in self._layers:
            x = b(x)
        return x

    def __iter__(self):
        return iter(self._layers)

    def __getitem__(self, i):
        return self._layers[i]


class Dense(HybridBlock):
    """Fully-connected layer (ref: nn.Dense -> FullyConnected op).  Without
    ``in_units`` the weight's input size is inferred at the first call."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._flatten = flatten
        self._activation = activation
        self.weight = self.params.get(
            "weight", shape=(units, in_units), dtype=dtype,
            init=weight_initializer, allow_deferred_init=True)
        self.bias = self.params.get(
            "bias", shape=(units,), dtype=dtype, init=bias_initializer,
            allow_deferred_init=True) if use_bias else None

    _split_params = ("weight", "bias")

    def infer_shape(self, x, *args):
        in_units = math.prod(x.shape[1:]) if self._flatten else x.shape[-1]
        self.weight.shape = (self._units, in_units)

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                               no_bias=bias is None, flatten=self._flatten)
        if self._activation:
            out = F.Activation(out, act_type=self._activation)
        return out


class Dropout(HybridBlock):
    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = tuple(axes)

    def hybrid_forward(self, F, x):
        return F.Dropout(x, p=self._rate, axes=self._axes)


class Embedding(HybridBlock):
    """Ref: nn.Embedding -> Embedding op."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self.weight = self.params.get(
            "weight", shape=(input_dim, output_dim), dtype=dtype,
            init=weight_initializer)

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim)


class LayerNorm(HybridBlock):
    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._eps = epsilon
        self.gamma = self.params.get("gamma", shape=(in_channels,),
                                     init=gamma_initializer,
                                     allow_deferred_init=True)
        self.beta = self.params.get("beta", shape=(in_channels,),
                                    init=beta_initializer,
                                    allow_deferred_init=True)

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        self.gamma.shape = (c,)
        self.beta.shape = (c,)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis, eps=self._eps)


class Activation(HybridBlock):
    """Ref: nn.Activation -> Activation op."""

    def __init__(self, activation, **kwargs):
        super().__init__(**kwargs)
        self._act = activation

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act)


class Flatten(HybridBlock):
    """Every axis after the first folded into one."""

    def hybrid_forward(self, F, x):
        return F.flatten(x)


class BatchNorm(HybridBlock):
    """Ref: nn.BatchNorm (``gluon/nn/basic_layers.py:191``).  The moving
    statistics are ``grad_req='null'`` parameters; the BatchNorm op
    returns their new values and the layer commits them in place after
    each training forward."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"axis": axis, "eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats}
        self._axis = axis
        self.gamma = self.params.get(
            "gamma", grad_req="write" if scale else "null",
            shape=(in_channels,), init=gamma_initializer,
            allow_deferred_init=True)
        self.beta = self.params.get(
            "beta", grad_req="write" if center else "null",
            shape=(in_channels,), init=beta_initializer,
            allow_deferred_init=True)
        self.running_mean = self.params.get(
            "running_mean", grad_req="null", shape=(in_channels,),
            init=running_mean_initializer, allow_deferred_init=True)
        self.running_var = self.params.get(
            "running_var", grad_req="null", shape=(in_channels,),
            init=running_variance_initializer, allow_deferred_init=True)

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean, self.running_var):
            p.shape = (c,)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        train = autograd.is_training()
        out, new_mm, new_mv = F.BatchNorm(x, gamma, beta, running_mean,
                                          running_var, _train=train,
                                          **self._kwargs)
        if train and not self._kwargs["use_global_stats"]:
            commit_aux(running_mean, new_mm)
            commit_aux(running_var, new_mv)
        return out
