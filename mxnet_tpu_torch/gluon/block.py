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

Forward hooks are MXNet's (ref: ``gluon/block.py:52-68, 241-256`` of the
JAX package), not ``torch.nn.Module``'s: ``register_forward_pre_hook(
hook)`` and ``register_forward_hook(hook)`` return a :class:`HookHandle`
(``detach()``, or use it as a context manager), ``hook(block, args)``
and ``hook(block, args, out)`` run around each call of the block with the
arguments it was called with, and what a hook returns is ignored.  A
hybridized block fires its own hooks on every call, replayed or not; its
children fire theirs only when its forward runs eagerly (warm-up and
capture on the card, every call on the CPU), as a JAX child fires its
hooks only while its parent is traced.

``save_parameters``/``load_parameters`` write and read the JAX package's
``.params`` container, keyed by structural name, so a file moves between
the packages; loading copies into the existing values in place, so a
captured graph sees the loaded weights at its next replay.
"""
from __future__ import annotations

import threading
import weakref

import torch

from .. import autograd, profiler
from .._imperative import invoke
from ..base import MXNetError
from ..context import Context, current_context
from ..symbol.symbol import Symbol
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


class HookHandle:
    """Removable handle for a registered hook (ref: ``gluon.utils.
    HookHandle``; ``mxnet_tpu/gluon/block.py:52``)."""

    def __init__(self, hooks_list, hook):
        self._hooks_list = hooks_list
        self._hook = hook

    def detach(self):
        if self._hook is not None and self._hook in self._hooks_list:
            self._hooks_list.remove(self._hook)
        self._hook = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.detach()


class Block(torch.nn.Module):
    """Base container for layers and parameters (ref: gluon.Block)."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        self._prefix = (prefix if prefix is not None
                        else _BlockScope.create_prefix(
                            type(self).__name__.lower()))
        self._params = ParameterDict(self._prefix, shared=params)
        self._reg_params = {}
        # MXNet's hook lists; torch's own _forward_hooks stay unused
        self._mx_forward_hooks = []
        self._mx_forward_pre_hooks = []

    # -- hooks (ref: gluon/block.py:241-256) ----------------------------------

    def register_forward_hook(self, hook):
        """``hook(block, args, out)`` after each call; returns a
        :class:`HookHandle`.  What the hook returns is ignored."""
        self._mx_forward_hooks.append(hook)
        return HookHandle(self._mx_forward_hooks, hook)

    def register_forward_pre_hook(self, hook):
        """``hook(block, args)`` before each call; returns a
        :class:`HookHandle`.  What the hook returns is ignored."""
        self._mx_forward_pre_hooks.append(hook)
        return HookHandle(self._mx_forward_pre_hooks, hook)

    def __call__(self, *args, **kwargs):
        for hook in self._mx_forward_pre_hooks:
            hook(self, args)
        out = super().__call__(*args, **kwargs)
        for hook in self._mx_forward_hooks:
            hook(self, args, out)
        return out

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

    def cast(self, dtype):
        """Cast this block's parameters and its children's to ``dtype``
        (ref: ``Block.cast``; ``Parameter.cast``)."""
        for child in self._children.values():
            child.cast(dtype)
        for p in self._params.values():
            p.cast(dtype)

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

    def _clear_cache(self):
        """Drop what this block and its hybrid children captured on their
        parameters' tensors (ref: ``HybridBlock._clear_cache``): the
        :class:`CachedOp` with its serve graphs, and the graphs of every
        :class:`CachedStepOp` made over them.  The next call warms up and
        captures again."""
        self._cached_op = None
        for op in list(getattr(self, "_step_ops", ())):
            op._release()
        for child in self._children.values():
            if isinstance(child, HybridBlock):
                child._clear_cache()

    def cast(self, dtype):
        """:meth:`Block.cast`, after :meth:`_clear_cache`: the captured
        graphs hold the old tensors."""
        self._clear_cache()
        super().cast(dtype)

    def infer_shape(self, *args):
        """Complete deferred parameter shapes from example inputs; the
        layers with deferred parameters override it."""
        raise DeferredInitializationError(
            f"{type(self).__name__} has deferred-init parameters and no "
            "infer_shape; initialize with explicit in_units/in_channels")

    def forward(self, x, *args):
        if isinstance(x, Symbol):
            return self._symbolic_forward(x, *args)
        return invoke(self._call_tensors, x, *args)

    def _symbolic_forward(self, x, *args):
        """The forward on Symbol inputs: ``hybrid_forward`` with ``F`` the
        symbol namespace and every parameter a variable of its name (ref:
        ``mxnet_tpu/gluon/block.py:619-630``); the export path."""
        from .. import symbol as sym_ns

        params = {k: (p._traced_value if isinstance(p._traced_value, Symbol)
                      else sym_ns.var(p.name))
                  for k, p in self._reg_params.items()}
        return self.hybrid_forward(sym_ns, x, *args, **params)

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
            params = self._param_values()
        except DeferredInitializationError:
            self.infer_shape(x, *args)
            for p in self.collect_params().values():
                p._finish_deferred_init()
            params = self._param_values()
        return self.hybrid_forward(F, x, *args, **params)

    #: the parameter attributes this block feeds only to products that can
    #: compute on a shard (``FullyConnected``, ``multihead_attention``'s
    #: projections): inside the mesh step they are handed their shard
    #: (``parallel.spmd.products``), every other parameter its full value
    _split_params = ()

    def _param_values(self):
        from ..parallel.spmd import products

        scope = products.current()
        if scope is None:
            return {k: p.data() for k, p in self._reg_params.items()}
        return {k: scope.value(p, k in self._split_params)
                for k, p in self._reg_params.items()}

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def export(self, path, epoch=0):
        """Write ``path-symbol.json`` and ``path-NNNN.params`` (ref:
        HybridBlock.export): the forward traced on one Symbol input named
        ``data``."""
        from ..symbol import export as _export

        return _export.export_block(self, path, epoch)


def commit_aux(value, new_value):
    """Write ``new_value`` into the auxiliary state ``value`` (BatchNorm's
    moving statistics) in place, outside autograd; the ops return the new
    statistics and the layer that owns them commits them."""
    with torch.no_grad():
        value.copy_(new_value)


# Compiled-graph cache counters (ref: gluon/block.py:291): a CachedOp
# call with an unseen input signature counts as a "compile", a seen one
# as a "reuse", per CachedOp (``ModelServer.stats()``) and globally (the
# profiler's ``cachedGraph`` section).
_graph_stats_lock = threading.Lock()
_graph_stats = {"compiles": 0, "reuses": 0}


def cached_graph_stats():
    """Global compiled-graph cache counters across every CachedOp:
    ``{"compiles": new-signature calls, "reuses": cache-hit calls}``."""
    with _graph_stats_lock:
        return dict(_graph_stats)


def reset_cached_graph_stats():
    with _graph_stats_lock:
        for k in _graph_stats:
            _graph_stats[k] = 0


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
            kind = "reuses" if sig in self._seen_sigs else "compiles"
            self._seen_sigs.add(sig)
            self.stats[kind] += 1
        with _graph_stats_lock:
            _graph_stats[kind] += 1
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
            # the capture is this signature's "compile" (ref:
            # gluon/block.py:445 of the JAX package)
            with profiler.op_scope(f"cached_op.compile.{self.block.name}",
                                   cat="cached_op"):
                step = CapturedStep(forward,
                                    [inputs[j].clone() for j in pos],
                                    device, pool=self._pool)
            got = self._graphs[sig] = (step, params,
                                       [p._replica() for p in params])
        return _clone_outputs(got[0].replay([inputs[j] for j in pos]))


def _step_tensor(v):
    """A step input as a tensor: numpy arrays and numbers become CPU
    tensors (sharing a numpy array's memory)."""
    if isinstance(v, torch.Tensor):
        return v
    import numpy as np

    return torch.from_numpy(np.ascontiguousarray(v))


class CachedStepOp:
    """A block's forward as a fixed-shape, state-carrying step: the decode
    tier's per-token path (ref: CachedStepOp, ``gluon/block.py:467`` of
    the JAX package).

    ``op(*inputs)`` runs ``block.forward(*inputs, **static_kwargs)`` on
    tensors (numpy inputs become tensors) and returns the forward's flat
    tuple of output tensors.  The inputs at ``inplace_inputs`` are the
    carried state (the decode arena's cache buffers): the caller passes
    the same tensors at every call and the forward writes their new values
    into them in place.  The JAX package instead donates those buffers and
    receives new ones; here a captured graph reads and writes the arena's
    own memory, so nothing is handed back.

    On CUDA inputs, per input signature: the first call runs the forward
    eagerly on a side stream (the warm-up), the second captures it in a
    CUDA graph (``whole_step.CapturedStep``: the cyclic collector off,
    ``CAPTURE_MODE`` thread-local) and replays it, later calls copy their
    other inputs into the graph's static buffers and replay.  The in-place
    inputs are the graph's static buffers themselves, and a call that
    passes other tensors there, or a parameter whose value was replaced
    rather than written in place, captures again.  Parameters are read
    where they live, so a reload that copies new values in
    (``Parameter.set_data``) needs no new capture.  The outputs of a
    replay are the graph's own buffers, valid until its next replay.  On
    the CPU the forward runs eagerly at every call.

    ``static_kwargs`` are fixed keyword arguments of the forward (the
    speculative verify step's ``k``): a different value is another op.
    Every call books one dispatch (``_imperative.device_dispatch_count``),
    and a new signature counts as a "compile", a seen one as a "reuse",
    here and in :func:`cached_graph_stats`."""

    def __init__(self, block, inplace_inputs=(), static_kwargs=None):
        self.block = block
        self._inplace = frozenset(int(i) for i in inplace_inputs)
        self._static = dict(static_kwargs or {})
        for v in self._static.values():
            hash(v)   # a signature of its own: fail at construction
        self._params = None
        self._seen_sigs = set()
        self._warm = set()
        # signature -> (CapturedStep, parameter values, in-place tensors)
        self._graphs = {}
        self._pool = None
        self._lock = threading.Lock()
        self.stats = {"compiles": 0, "reuses": 0}
        if isinstance(block, HybridBlock):   # HybridBlock.cast drops ours
            if getattr(block, "_step_ops", None) is None:
                block._step_ops = weakref.WeakSet()
            block._step_ops.add(self)

    def _release(self):
        """Drop the captured graphs (the block's parameters were replaced):
        each signature warms up and captures again at its next calls."""
        with self._lock:
            self._params = None
            self._warm = set()
            self._graphs = {}

    def _body(self, *tensors):
        with torch.no_grad():
            out = self.block(*tensors, **self._static)
        outs = tuple(out) if isinstance(out, (list, tuple)) else (out,)
        if not all(isinstance(o, torch.Tensor) for o in outs):
            raise MXNetError("a CachedStepOp forward must return a flat "
                             "tuple of tensors")
        return outs

    def __call__(self, *inputs):
        from .. import _imperative

        tensors = [_step_tensor(v) for v in inputs]
        device = next((t.device for j, t in enumerate(tensors)
                       if j in self._inplace), None) or next(
            (t.device for t in tensors if t.is_cuda), torch.device("cpu"))
        sig = (str(device), tuple((tuple(t.shape), str(t.dtype))
                                  for t in tensors))
        with self._lock:
            kind = "reuses" if sig in self._seen_sigs else "compiles"
            self._seen_sigs.add(sig)
            self.stats[kind] += 1
        with _graph_stats_lock:
            _graph_stats[kind] += 1
        _imperative.count("step_dispatches")
        if device.type != "cuda" or torch.cuda.is_current_stream_capturing():
            return self._body(*[t.to(device) for t in tensors])
        with self._lock:
            return self._graph_step(sig, tensors, device)

    def _graph_step(self, sig, tensors, device):
        from .whole_step import CapturedStep, side_stream_run

        if sig not in self._warm:
            on_dev = [t.to(device) for t in tensors]
            out = side_stream_run(lambda: self._body(*on_dev), device)
            self._warm.add(sig)
            return out
        if self._params is None:
            self._params = list(self.block.collect_params().values())
        got = self._graphs.get(sig)
        if got is not None and (
                any(p._replica() is not v
                    for p, v in zip(self._params, got[1]))
                or any(tensors[j] is not t for j, t in got[2].items())):
            got = None   # a parameter or the carried state was replaced
        if got is None:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            static = [t if j in self._inplace else t.to(device).clone()
                      for j, t in enumerate(tensors)]
            with profiler.op_scope(f"cached_op.compile.{self.block.name}",
                                   cat="cached_op"):
                step = CapturedStep(self._body, static, device,
                                    pool=self._pool)
            got = self._graphs[sig] = (
                step, [p._replica() for p in self._params],
                {j: tensors[j] for j in self._inplace})
        return got[0].replay(tensors)
