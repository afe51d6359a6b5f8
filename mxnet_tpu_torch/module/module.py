"""Module API: the symbolic trainer (ref: python/mxnet/module/
{base_module,module}.py; ``mxnet_tpu/module/module.py`` of the JAX
package): bind, init_params, init_optimizer, forward, backward, update,
fit, score, predict and checkpoints.

Data parallelism (the reference's DataParallelExecutorGroup) is one
executor per context: the batch is split along axis 0, each replica runs
its slice, ``update`` sums the replicas' gradients with the kvstore's
reduction (``kvstore._reduce_sum``), updates the first replica's
parameters and copies them to the others.  ``update`` runs the updater
over every parameter as one ``fused_update`` (``Updater.update_many``):
the per-parameter updates of the JAX package's Module, bit for bit.
"""
from __future__ import annotations

import logging

import torch

from .. import callback as _callback
from .. import kvstore as _kvstore
from .. import metric as _metric
from .. import optimizer as _opt
from ..base import MXNetError
from ..context import current_context
from ..initializer import InitDesc, Uniform
from ..io.io import DataDesc
from .. import ndarray as _nd
from ..ndarray.ndarray import NDArray
from ..symbol.symbol import _assign


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.params_initialized = False
        self.optimizer_initialized = False

    # -- the training loop (ref: base_module.py fit) --------------------------

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=Uniform(0.01), arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, sparse_row_id_fn=None):
        assert num_epoch is not None, "please specify num_epoch"
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)
        validation_metric = validation_metric or eval_metric

        for epoch in range(begin_epoch, num_epoch):
            eval_metric.reset()
            train_data.reset()
            for nbatch, data_batch in enumerate(train_data):
                self.forward_backward(data_batch)
                self.update()
                self.update_metric(eval_metric, data_batch.label)
                if batch_end_callback is not None:
                    p = _callback.BatchEndParam(epoch, nbatch, eval_metric)
                    for cb in _as_list(batch_end_callback):
                        cb(p)
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            if epoch_end_callback is not None:
                arg_params, aux_params = self.get_params()
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, self.symbol, arg_params, aux_params)
            if eval_data is not None:
                res = self.score(eval_data, validation_metric, epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, reset=True, epoch=0, **kwargs):
        assert self.binded and self.params_initialized
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)
        eval_metric.reset()
        if reset:
            eval_data.reset()
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(batch, is_train=False)
            self.update_metric(eval_metric, batch.label)
        return eval_metric.get_name_value()

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        outputs = []
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(batch, is_train=False)
            outs = [o.copy() for o in self.get_outputs()]
            if batch.pad:
                outs = [_rows(o, 0, o.shape[0] - batch.pad) for o in outs]
            outputs.append(outs)
        if merge_batches:
            merged = [_concat([b[i] for b in outputs])
                      for i in range(len(outputs[0]))]
            if len(merged) == 1 and not always_output_list:
                return merged[0]
            return merged
        return outputs

    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def _as_list(self, x):
        return _as_list(x)


def _as_list(x):
    if isinstance(x, (list, tuple)):
        return x
    return [x]


def _rows(arr, start, stop):
    """Rows ``start:stop`` of an NDArray (a view, on its context)."""
    return NDArray(arr.data[start:stop], arr.context)


def _concat(arrays, ctx=None):
    """NDArrays joined along axis 0, on ``ctx`` (default: the first's)."""
    ctx = ctx or arrays[0].context
    return NDArray(torch.cat([a.as_in_context(ctx).data for a in arrays]),
                   ctx)


class Module(BaseModule):
    """Ref: python/mxnet/module/module.py."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None,
                 compression_params=None):
        super().__init__(logger)
        self._symbol = symbol
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        ctxs = context or current_context()
        self._contexts = list(ctxs) if isinstance(ctxs, (list, tuple)) \
            else [ctxs]
        self._context = self._contexts[0]
        self._fixed_param_names = set(fixed_param_names or [])
        # ref: Module(group2ctxs=...) -> Executor::Bind group2ctx
        if isinstance(group2ctxs, (list, tuple)):
            group2ctxs = group2ctxs[0] if group2ctxs else None
        self._group2ctxs = group2ctxs
        self._exec = None
        self._optimizer = None
        self._data_shapes = None
        self._label_shapes = None

    @property
    def symbol(self):
        return self._symbol

    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._symbol.list_outputs()

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return [(n, o.shape) for n, o in
                zip(self.output_names, self._exec.outputs)]

    # -- bind -----------------------------------------------------------------

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        if self.binded and not force_rebind:
            return
        self._data_shapes = [_as_desc(d) for d in data_shapes]
        self._label_shapes = [_as_desc(d) for d in (label_shapes or [])]
        shape_kwargs = {d.name: d.shape for d in self._data_shapes}
        shape_kwargs.update({d.name: d.shape for d in self._label_shapes})
        K = len(self._contexts)
        if K > 1:
            for d in self._data_shapes + self._label_shapes:
                if d.shape and d.shape[0] % K:
                    raise MXNetError(
                        f"batch dim {d.shape[0]} of {d.name} must divide "
                        f"across {K} contexts")
            shape_kwargs = {
                n: ((sh[0] // K,) + tuple(sh[1:])) if sh else sh
                for n, sh in shape_kwargs.items()}
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**shape_kwargs)
        arg_names = self._symbol.list_arguments()
        aux_names = self._symbol.list_auxiliary_states()
        input_names = set(self._data_names) | set(self._label_names)
        self._execs = []
        for ctx in self._contexts:
            args, grads, req = {}, {}, {}
            for name, shape in zip(arg_names, arg_shapes):
                args[name] = _nd.zeros(shape, ctx=ctx)
                if for_training and name not in input_names \
                        and name not in self._fixed_param_names:
                    grads[name] = _nd.zeros(shape, ctx=ctx)
                    req[name] = grad_req
                else:
                    req[name] = "null"
            aux = {n: _nd.zeros(s, ctx=ctx)
                   for n, s in zip(aux_names, aux_shapes)}
            self._execs.append(self._symbol.bind(
                ctx, args, grads, req, aux, group2ctx=self._group2ctxs))
        self._exec = self._execs[0]
        self.binded = True
        self.for_training = for_training
        if shared_module is not None and shared_module.params_initialized:
            ap, xp = shared_module.get_params()
            self.set_params(ap, xp)

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded
        input_names = set(self._data_names) | set(self._label_names)
        for name, arr in self._exec.arg_dict.items():
            if name in input_names:
                continue
            if arg_params is not None and name in arg_params:
                _assign(arr, arg_params[name], self._context)
            else:
                if arg_params is not None and not allow_missing:
                    raise MXNetError(f"missing arg_param {name}")
                initializer(InitDesc(name), arr.data)
        for name, arr in self._exec.aux_dict.items():
            if aux_params is not None and name in aux_params:
                _assign(arr, aux_params[name], self._context)
            else:
                initializer(InitDesc(name), arr.data)
        self._sync_params_to_replicas()
        self.params_initialized = True

    def _sync_params_to_replicas(self):
        """Copy the first replica's parameters and auxiliary states to the
        others (ref: DataParallelExecutorGroup's broadcast)."""
        input_names = set(self._data_names) | set(self._label_names)
        for ex in self._execs[1:]:
            for name, arr in self._exec.arg_dict.items():
                if name not in input_names:   # batch slices stay per replica
                    _assign(ex.arg_dict[name], arr, ex._ctx)
            for name, arr in self._exec.aux_dict.items():
                _assign(ex.aux_dict[name], arr, ex._ctx)

    def get_params(self):
        input_names = set(self._data_names) | set(self._label_names)
        arg_params = {k: v.copy() for k, v in self._exec.arg_dict.items()
                      if k not in input_names}
        aux_params = {k: v.copy() for k, v in self._exec.aux_dict.items()}
        return arg_params, aux_params

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(None, arg_params, aux_params, allow_missing,
                         force_init)

    # -- optimizer ------------------------------------------------------------

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        if self.optimizer_initialized and not force_init:
            return
        if isinstance(optimizer_params, tuple):
            optimizer_params = dict(optimizer_params)
        # ref Module.init_optimizer: 1/batch goes into rescale_grad when
        # the caller did not set it -- the loss heads' gradients
        # (normalization 'null') are sums over the batch
        batch = self._data_shapes[0].shape[0] if self._data_shapes else 0
        if isinstance(optimizer, _opt.Optimizer):
            if batch and abs(optimizer.rescale_grad * batch - 1.0) > 1e-8:
                logging.warning(
                    "optimizer instance rescale_grad=%g != 1/batch (%g); "
                    "setting it to 1/%d -- pass rescale_grad explicitly "
                    "to silence", optimizer.rescale_grad, 1.0 / batch,
                    batch)
                optimizer.rescale_grad = 1.0 / batch
            self._optimizer = optimizer
        else:
            if "rescale_grad" not in optimizer_params and batch:
                optimizer_params = dict(optimizer_params,
                                        rescale_grad=1.0 / batch)
            self._optimizer = _opt.create(optimizer, **optimizer_params)
        self._updater = _opt.get_updater(self._optimizer)
        self.optimizer_initialized = True

    # -- compute --------------------------------------------------------------

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        K = len(self._execs)

        def _slices(arr):
            if K == 1:
                return [arr]
            if arr.shape[0] % K:
                raise MXNetError(
                    f"batch of {arr.shape[0]} does not divide across "
                    f"{K} contexts")
            n = arr.shape[0] // K
            return [_rows(arr, k * n, (k + 1) * n) for k in range(K)]

        feeds = [{} for _ in range(K)]
        for name, arr in zip(self._data_names, data_batch.data):
            for k, piece in enumerate(_slices(arr)):
                feeds[k][name] = piece
        if data_batch.label is not None:
            for name, arr in zip(self._label_names, data_batch.label):
                for k, piece in enumerate(_slices(arr)):
                    feeds[k][name] = piece
        for ex, feed in zip(self._execs, feeds):
            ex.forward(is_train=is_train, **feed)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        K = len(self._execs)
        if out_grads is None or K == 1:
            for ex in self._execs:
                ex.backward(out_grads)
            return
        # the head gradients sliced per replica (ref:
        # DataParallelExecutorGroup.backward)
        og = out_grads if isinstance(out_grads, (list, tuple)) \
            else [out_grads]
        n = og[0].shape[0] // K
        for k, ex in enumerate(self._execs):
            ex.backward([_rows(g, k * n, (k + 1) * n) for g in og])

    def update(self):
        assert self.optimizer_initialized
        input_names = set(self._data_names) | set(self._label_names)
        multi = len(self._execs) > 1
        indices, grads, weights = [], [], []
        for i, name in enumerate(self._exec._arg_names):
            if name in input_names or name not in self._exec.grad_dict:
                continue
            if multi:
                grad = _kvstore._reduce_sum(
                    [ex.grad_dict[name] for ex in self._execs],
                    self._context)
            else:
                grad = self._exec.grad_dict[name]
            indices.append(i)
            grads.append(grad)
            weights.append(self._exec.arg_dict[name])
        # the per-parameter updater's result, a rule call a group
        self._updater.update_many(indices, grads, weights)
        if multi:
            self._sync_params_to_replicas()

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        eval_metric.update(labels, self.get_outputs())

    def get_outputs(self, merge_multi_context=True):
        if len(self._execs) == 1:
            return self._exec.outputs
        if not merge_multi_context:
            return [[ex.outputs[i] for ex in self._execs]
                    for i in range(len(self._exec.outputs))]
        return [_concat([ex.outputs[i] for ex in self._execs], self._context)
                for i in range(len(self._exec.outputs))]

    def get_input_grads(self, merge_multi_context=True):
        if len(self._execs) == 1:
            return [self._exec.grad_dict.get(n) for n in self._data_names]
        if not merge_multi_context:
            return [[ex.grad_dict.get(n) for ex in self._execs]
                    for n in self._data_names]
        return [_concat([ex.grad_dict[n] for ex in self._execs],
                        self._context)
                if self._exec.grad_dict.get(n) is not None else None
                for n in self._data_names]

    # -- checkpoints (ref: module.py save_checkpoint/load) --------------------

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        save_checkpoint(prefix, epoch, self._symbol, *self.get_params())
        if save_optimizer_states:
            with open(f"{prefix}-{epoch:04d}.states", "wb") as f:
                f.write(self._updater.get_states())

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module over a checkpoint's symbol whose ``bind`` also sets the
        checkpoint's parameters.  ``load_optimizer_states`` is accepted
        and, as in the JAX package, not applied: call
        :meth:`load_optimizer_states` after ``init_optimizer``."""
        sym, arg_params, aux_params = load_checkpoint(prefix, epoch)
        mod = Module(sym, **kwargs)
        orig_bind = mod.bind

        def bind_and_set(*a, **k):
            orig_bind(*a, **k)
            mod.init_params(arg_params=arg_params, aux_params=aux_params,
                            allow_missing=False, force_init=True)

        mod.bind = bind_and_set
        return mod

    def load_optimizer_states(self, fname):
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """``prefix-symbol.json`` and ``prefix-NNNN.params`` (ref:
    mx.model.save_checkpoint), each committed atomically (temp file,
    fsync, rename), so a kill during the save leaves no truncated file
    under the published name."""
    from ..checkpoint import atomic_file

    with atomic_file(f"{prefix}-symbol.json") as tmp:
        symbol.save(tmp)
    payload = {f"arg:{k}": v for k, v in arg_params.items()}
    payload.update({f"aux:{k}": v for k, v in aux_params.items()})
    with atomic_file(f"{prefix}-{epoch:04d}.params") as tmp:
        _nd.save(tmp, payload)


def load_checkpoint(prefix, epoch):
    """``(symbol, arg_params, aux_params)`` of a checkpoint that either
    package wrote; the arrays are NDArrays on the CPU."""
    from ..symbol import symbol as sym_mod

    sym = sym_mod.load(f"{prefix}-symbol.json")
    loaded = _nd.load(f"{prefix}-{epoch:04d}.params")
    arg_params, aux_params = {}, {}
    for k, v in loaded.items():
        if k.startswith("arg:"):
            arg_params[k[4:]] = v
        elif k.startswith("aux:"):
            aux_params[k[4:]] = v
    return sym, arg_params, aux_params


def _as_desc(d):
    if isinstance(d, DataDesc):
        return d
    return DataDesc(d[0], d[1])
