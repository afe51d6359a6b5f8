"""Gluon Block / HybridBlock (ref: python/mxnet/gluon/block.py).

Blocks are ``torch.nn.Module``s: child blocks are registered submodules
and each Gluon :class:`~.parameter.Parameter` held as an attribute puts
its value, a ``torch.nn.Parameter``, in ``_parameters`` under that
attribute's name.  ``hybrid_forward(F, x, ..., **params)`` receives
``F``, the namespace of plain tensor functions (``mx.nd``), tensors for
its inputs and each parameter's value by attribute name.

Calls with NDArray inputs are the public boundary: the tensors are
unwrapped and the outputs wrapped back.  Blocks call each other with
tensors.

``hybridize()`` makes each input signature's forward one CUDA graph
(:class:`CachedOp`, ref: ``gluon/block.py:356`` of the JAX package,
where it is one XLA executable).  On CUDA inputs in predict mode outside
``autograd.record``, the first call of a ``(train, ctx, input
shapes/dtypes)`` signature runs eagerly on a side stream (the warm-up),
the second captures the forward and replays it, and later calls replay
it.  Recording, training mode and CPU inputs run eagerly.  The counters
are the JAX package's: a new signature counts as a "compile", a seen one
as a "reuse", so ``ModelServer.stats()["graph"]["post_warmup_compiles"]``
counts the signatures warm-up did not cover.

``save_parameters``/``load_parameters`` write and read the JAX package's
``.params`` container, keyed by structural name, so a file moves between
the packages; loading copies into the existing values in place, so a
captured graph sees the loaded weights at its next replay.
"""
from __future__ import annotations

import threading

import torch

from .. import autograd
from .._imperative import invoke
from ..base import MXNetError
from ..context import Context, current_context
from .parameter import (DeferredInitializationError, Parameter,
                        ParameterDict)


def _int8_container_mismatch(params, loaded):
    """Detect an fp32 <-> int8 .params container mismatch before the
    generic missing-parameter error hides it (ref:
    ``mxnet_tpu/gluon/block.py:71``)."""
    def has(keys, suffix):
        return any(k == suffix or k.endswith("." + suffix)
                   or k.endswith("_" + suffix) for k in keys)

    net_q, file_q = has(params, "qweight"), has(loaded, "qweight")
    if net_q and not file_q and has(loaded, "weight"):
        return ("file holds fp32 parameters but this network is "
                "INT8-quantized — re-quantize them via contrib."
                "quantization.apply_fp32_params(net, nd.load(file)) "
                "(ModelServer/DecodeServer reload_weights() does this "
                "automatically), or save from the quantized net itself")
    if file_q and not net_q and has(params, "weight"):
        return ("file holds INT8-quantized parameters but this network "
                "is fp32 — rebuild the target with contrib.quantization"
                ".quantize_net (same architecture + calibration config) "
                "before loading, or load the fp32 training checkpoint "
                "instead")
    return None


class _BlockScope:
    """Auto-naming: dense0_, conv1_, ... (ref: _BlockScope in block.py)."""

    _counters = {}
    _lock = threading.Lock()

    @classmethod
    def create_prefix(cls, hint):
        with cls._lock:
            i = cls._counters.get(hint, 0)
            cls._counters[hint] = i + 1
        return f"{hint}{i}_"


class Block(torch.nn.Module):
    """Base container for layers and parameters (ref: gluon.Block)."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        self._prefix = (prefix if prefix is not None
                        else _BlockScope.create_prefix(
                            type(self).__name__.lower()))
        self._params = ParameterDict(self._prefix, shared=params)
        self._reg_params = {}

    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            self._reg_params[name] = value
            object.__setattr__(self, name, value)
            value._attach(self, name)
            return
        super().__setattr__(name, value)

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix

    @property
    def params(self):
        return self._params

    @property
    def _children(self):
        return self._modules

    def _ordered_params(self):
        """``(name, Parameter)`` in a stable order: the order of
        :meth:`collect_params` (ref: ``Block._ordered_params``)."""
        return list(self.collect_params().items())

    def collect_params(self):
        ret = ParameterDict(self._params.prefix)
        ret.update(self._params)
        for child in self._children.values():
            ret.update(child.collect_params())
        return ret

    def register_child(self, block, name=None):
        """Register a child under an explicit structural name."""
        self.add_module(name if name is not None
                        else str(len(self._children)), block)
        return block

    def _collect_params_with_prefix(self, prefix=""):
        """Structural name -> Parameter (ref: Block._collect_params_with_
        prefix): the names ``convert.load_numpy_params`` matches on."""
        if prefix:
            prefix += "."
        ret = {prefix + k: v for k, v in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        self.collect_params().initialize(init=init, ctx=ctx,
                                         force_reinit=force_reinit)

    # -- save / load (ref: gluon/block.py:199-237) ---------------------------

    def save_parameters(self, filename, deduplicate=False):
        """Save the initialized parameters by structural name (ref:
        Block.save_parameters), so an identically built net loads them
        whatever its auto-prefix counters."""
        from .. import ndarray as _nd

        params = self._collect_params_with_prefix()
        _nd.save(filename, {k: v.data() for k, v in params.items()
                            if v._data is not None})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Load a :meth:`save_parameters` file (either package's) by
        structural name, falling back to full-prefix names when none
        matches.  Each value is copied into the parameter in place
        (``Parameter.set_data``), cast to its dtype; a deferred parameter
        takes the file's shape and is initialized first, on ``ctx`` or
        the device its ``initialize()`` named."""
        from .. import ndarray as _nd

        loaded = _nd.load(filename)
        params = self._collect_params_with_prefix()
        if loaded and params and not any(k in params for k in loaded):
            # fall back to full-prefix names (collect_params keys)
            params = dict(self.collect_params().items())
        mismatch = _int8_container_mismatch(params, loaded)
        if mismatch:
            raise MXNetError(f"{filename}: {mismatch}")
        for name, p in params.items():
            if name in loaded:
                p.shape = loaded[name].shape
                if p._data is None:
                    if p._deferred_init is not None:
                        p._finish_deferred_init()
                    else:
                        p.initialize(ctx=ctx or [current_context()])
                p.set_data(loaded[name])
            elif not allow_missing:
                raise MXNetError(f"missing parameter {name} in {filename}")
        if not ignore_extra:
            extra = set(loaded) - set(params)
            if extra:
                raise MXNetError(f"extra parameters in {filename}: {extra}")

    # the names before MXNet 1.4
    save_params = save_parameters

    def load_params(self, filename, ctx=None, **kwargs):
        self.load_parameters(filename, ctx=ctx, **kwargs)


class HybridBlock(Block):
    """Block whose forward is ``hybrid_forward(F, ...)`` (ref: gluon.HybridBlock)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._cached_op = None

    def hybridize(self, active=True, **kwargs):
        """Run each input signature's forward as a captured graph from now
        on (see the module docstring); ``static_alloc``/``static_shape``
        are accepted and unused (a graph's buffers are static)."""
        self._active = active
        self._cached_op = None

    def infer_shape(self, *args):
        """Complete deferred parameter shapes from example inputs; the
        layers with deferred parameters override it."""
        raise DeferredInitializationError(
            f"{type(self).__name__} has deferred-init parameters and no "
            "infer_shape; initialize with explicit in_units/in_channels")

    def forward(self, x, *args):
        return invoke(self._call_tensors, x, *args)

    def _call_tensors(self, x, *args):
        with torch.set_grad_enabled(autograd.is_recording()):
            if self._active:
                if self._cached_op is None:
                    self._cached_op = CachedOp(self)
                return self._cached_op(x, *args)
            return self._eager_forward(x, *args)

    def _eager_forward(self, x, *args):
        from .. import ndarray as F

        try:
            params = {k: p.data() for k, p in self._reg_params.items()}
        except DeferredInitializationError:
            self.infer_shape(x, *args)
            for p in self.collect_params().values():
                p._finish_deferred_init()
            params = {k: p.data() for k, p in self._reg_params.items()}
        return self.hybrid_forward(F, x, *args, **params)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def export(self, path, epoch=0):
        """Ref: HybridBlock.export (model-symbol.json + .params): it needs
        the symbolic API, which the port does not have yet."""
        raise MXNetError("HybridBlock.export needs the symbolic API "
                         "(symbol/), which comes with slice 9 of the port "
                         "(ROADMAP.md queue 1); save_parameters writes "
                         "the .params half")


def commit_aux(value, new_value):
    """Write ``new_value`` into the auxiliary state ``value`` (BatchNorm's
    moving statistics) in place, outside autograd; the ops return the new
    statistics and the layer that owns them commits them."""
    with torch.no_grad():
        value.copy_(new_value)


def _clone_outputs(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, (list, tuple)):
        return type(out)(_clone_outputs(o) for o in out)
    return out


class CachedOp:
    """The forward of a hybridized block, one CUDA graph per input
    signature (ref: CachedOp, ``gluon/block.py:356`` of the JAX package).

    On CUDA inputs, outside ``autograd.record`` and in predict mode: the
    first call of a signature runs the forward eagerly on a side stream
    (the kernels' wrappers make their lazy allocations there), the second
    captures it (``whole_step.CapturedStep``: static inputs, the device's
    generators registered, the launches counted again at each replay) and
    replays it, and later calls copy their inputs into the static ones and
    replay.  A parameter whose value was replaced rather than written in
    place (``initialize(force_reinit=True)``) is seen before the replay
    and the signature is captured again; ``set_data`` and
    ``load_parameters`` write in place, and the next replay reads them.
    The graphs of one block share a memory pool, so a replay may
    overwrite another signature's outputs: each call returns copies of the
    graph's outputs, made before the next replay.  Other calls run the
    forward eagerly.  A capture that fails raises."""

    def __init__(self, block):
        self.block = block
        self._seen_sigs = set()
        self._warm = set()
        # signature -> (CapturedStep, the block's Parameters, their values)
        self._graphs = {}
        self._pool = None
        self._lock = threading.Lock()
        self.stats = {"compiles": 0, "reuses": 0}

    def __call__(self, *inputs):
        ctx = next((Context.from_device(i.device) for i in inputs
                    if isinstance(i, torch.Tensor)), None)
        training = autograd.is_training()
        sig = (training, str(ctx),
               tuple((tuple(i.shape), str(i.dtype))
                     if isinstance(i, torch.Tensor) else repr(i)
                     for i in inputs))
        with self._lock:
            if sig in self._seen_sigs:
                self.stats["reuses"] += 1
            else:
                self._seen_sigs.add(sig)
                self.stats["compiles"] += 1
        tensors = [i for i in inputs if isinstance(i, torch.Tensor)]
        if (training or autograd.is_recording() or not tensors
                or not all(t.is_cuda for t in tensors)
                or torch.cuda.is_current_stream_capturing()):
            return self.block._eager_forward(*inputs)
        with self._lock:
            return self._graph_forward(sig, inputs, tensors[0].device)

    def _graph_forward(self, sig, inputs, device):
        from .whole_step import CapturedStep, side_stream_run

        if sig not in self._warm:
            out = side_stream_run(lambda: self.block._eager_forward(*inputs),
                                  device)
            self._warm.add(sig)
            return out
        pos = [j for j, i in enumerate(inputs) if isinstance(i, torch.Tensor)]
        got = self._graphs.get(sig)
        if got is not None and any(p._replica() is not v
                                   for p, v in zip(got[1], got[2])):
            got = None   # a parameter's value was replaced: capture again
        if got is None:
            args = list(inputs)

            def forward(*tensors):
                for j, t in zip(pos, tensors):
                    args[j] = t
                return self.block._eager_forward(*args)

            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            params = list(self.block.collect_params().values())
            got = self._graphs[sig] = (CapturedStep(
                forward, [inputs[j].clone() for j in pos], device,
                pool=self._pool), params, [p._replica() for p in params])
        return _clone_outputs(got[0].replay([inputs[j] for j in pos]))
