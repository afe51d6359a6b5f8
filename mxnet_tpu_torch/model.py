"""Legacy `mx.model` namespace (ref: python/mxnet/model.py;
``mxnet_tpu/model.py`` of the JAX package).

Provides the checkpoint helpers every MXNet-era script reaches for
(`mx.model.load_checkpoint(prefix, epoch)`), the `BatchEndParam`
callback payload, and a thin `FeedForward` shim (deprecated in the
reference too) that delegates to the Module API.
"""
from __future__ import annotations

from collections import namedtuple

from .module.module import (Module, load_checkpoint,  # noqa: F401
                            save_checkpoint)

BatchEndParam = namedtuple("BatchEndParam",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def _names(descs):
    """Names from a provide_data/provide_label list (DataDesc or tuple)."""
    return tuple(getattr(d, "name", None) or d[0] for d in descs or ())


class FeedForward:
    """Deprecated pre-Module trainer (ref: mx.model.FeedForward).

    Kept as a thin delegate so ancient scripts run; new code should use
    `mx.mod.Module` or Gluon.
    """

    def __init__(self, symbol, ctx=None, num_epoch=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, **kwargs):
        self.symbol = symbol
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.optimizer = optimizer
        self.initializer = initializer
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.optimizer_params = kwargs
        self._module = None

    def _as_iter(self, X, y=None, shuffle=False):
        from .io.io import DataIter, NDArrayIter

        if isinstance(X, DataIter):
            return X
        return NDArrayIter(X, y, batch_size=self.numpy_batch_size,
                           shuffle=shuffle)

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None):
        from .initializer import Uniform

        train = self._as_iter(X, y, shuffle=False)
        self._module = Module(self.symbol,
                              data_names=_names(train.provide_data),
                              label_names=_names(train.provide_label),
                              context=self.ctx)
        self._module.fit(
            train, eval_data=eval_data, eval_metric=eval_metric,
            epoch_end_callback=epoch_end_callback,
            batch_end_callback=batch_end_callback, kvstore=kvstore,
            optimizer=self.optimizer,
            optimizer_params=tuple(self.optimizer_params.items())
            or (("learning_rate", 0.01),),
            initializer=self.initializer or Uniform(0.01),
            arg_params=self.arg_params, aux_params=self.aux_params,
            allow_missing=self.arg_params is not None,
            num_epoch=self.num_epoch)
        self.arg_params, self.aux_params = self._module.get_params()
        return self

    def _ensure_module(self, X):
        """Return a (module, data_iter) pair, lazily binding after load()."""
        from .base import MXNetError

        assert self._module is not None or self.arg_params is not None, \
            "call fit() or load() before predict()/score()"
        data = self._as_iter(X)
        if self._module is not None:
            return self._module, data
        if not data.provide_label:
            import numpy as _np
            from .io.io import DataIter

            if isinstance(X, DataIter):
                raise MXNetError(
                    "this FeedForward was restored via load(); predict/"
                    "score need an iterator that provides labels (loss "
                    "heads carry a label input), or pass raw arrays")
            # loss heads (SoftmaxOutput) carry a label input even at
            # inference; bind it with dummy zeros like the reference
            data = self._as_iter(X, _np.zeros((len(X),), _np.float32))
        self._module = Module(self.symbol,
                              data_names=_names(data.provide_data),
                              label_names=_names(data.provide_label),
                              context=self.ctx)
        self._module.bind(data_shapes=data.provide_data,
                          label_shapes=data.provide_label,
                          for_training=False)
        self._module.set_params(self.arg_params, self.aux_params)
        return self._module, data

    def predict(self, X, num_batch=None):
        module, data = self._ensure_module(X)
        return module.predict(data, num_batch=num_batch).asnumpy()

    def score(self, X, eval_metric="acc", num_batch=None):
        module, data = self._ensure_module(X)
        from . import metric as _metric

        m = (_metric.create(eval_metric)
             if not hasattr(eval_metric, "update") else eval_metric)
        module.score(data, m, num_batch=num_batch)
        return m.get()[1]

    def save(self, prefix, epoch=None):
        epoch = self.num_epoch if epoch is None else epoch
        save_checkpoint(prefix, epoch or 0, self.symbol,
                        self.arg_params or {}, self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, **kwargs)
