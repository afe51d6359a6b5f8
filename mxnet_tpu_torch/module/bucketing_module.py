"""BucketingModule (ref: python/mxnet/module/bucketing_module.py;
``mxnet_tpu/module/bucketing_module.py`` of the JAX package).

Variable-length training: one Module (one bound graph) per bucket key,
made by ``sym_gen(bucket_key)`` at the bucket's first batch.  Switching
buckets copies the current parameters into the next bucket's executor,
and every bucket shares one optimizer and its states.
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from ..initializer import Uniform
from .module import BaseModule, Module


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None,
                 compression_params=None):
        super().__init__(logger)
        assert default_bucket_key is not None
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._fixed_param_names = fixed_param_names
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._bind_args = None

    @property
    def default_bucket_key(self):
        return self._default_bucket_key

    @property
    def symbol(self):
        return self._curr_module.symbol

    def _gen_module(self, bucket_key):
        if bucket_key in self._buckets:
            return self._buckets[bucket_key]
        sym, data_names, label_names = self._sym_gen(bucket_key)
        mod = Module(sym, data_names, label_names, self.logger,
                     self._context,
                     fixed_param_names=self._fixed_param_names)
        self._buckets[bucket_key] = mod
        return mod

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        self._bind_args = dict(for_training=for_training,
                               inputs_need_grad=inputs_need_grad,
                               grad_req=grad_req)
        mod = self._gen_module(self._default_bucket_key)
        mod.bind(data_shapes, label_shapes, for_training, inputs_need_grad,
                 force_rebind, None, grad_req)
        self._curr_module = mod
        self._curr_bucket_key = self._default_bucket_key
        self.binded = True
        self.for_training = for_training

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        self._curr_module.init_params(initializer, arg_params, aux_params,
                                      allow_missing, force_init)
        self.params_initialized = True

    def get_params(self):
        return self._curr_module.get_params()

    def set_params(self, arg_params, aux_params, **kwargs):
        self._curr_module.set_params(arg_params, aux_params, **kwargs)
        self.params_initialized = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self._curr_module.init_optimizer(kvstore, optimizer,
                                         optimizer_params, force_init)
        # all buckets share the updater (shared optimizer state)
        self._shared_updater = self._curr_module._updater
        self._shared_optimizer = self._curr_module._optimizer
        self.optimizer_initialized = True

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Ref: BucketingModule.switch_bucket — bind (or reuse) the bucket's
        executor and share current params."""
        if bucket_key == self._curr_bucket_key:
            return
        params = self._curr_module.get_params() if self.params_initialized \
            else (None, None)
        mod = self._gen_module(bucket_key)
        if not mod.binded:
            mod.bind(data_shapes, label_shapes,
                     self._bind_args["for_training"],
                     self._bind_args["inputs_need_grad"],
                     False, None, self._bind_args["grad_req"])
        if self.params_initialized:
            mod.init_params(arg_params=params[0], aux_params=params[1],
                            allow_missing=False, force_init=True)
        if self.optimizer_initialized:
            mod._updater = self._shared_updater
            mod._optimizer = self._shared_optimizer
            mod.optimizer_initialized = True
        self._curr_module = mod
        self._curr_bucket_key = bucket_key

    def forward(self, data_batch, is_train=None):
        key = getattr(data_batch, "bucket_key", None)
        if key is None:
            key = self._default_bucket_key
        self.switch_bucket(key, data_batch.provide_data,
                           data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads)

    def update(self):
        self._curr_module.update()
        # propagate updated params to other bound buckets lazily at switch

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._curr_module.update_metric(eval_metric, labels)

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs()
