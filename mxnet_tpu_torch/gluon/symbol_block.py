"""SymbolBlock: a Symbol graph as a Gluon block (ref: python/mxnet/gluon/
block.py SymbolBlock; ``mxnet_tpu/gluon/symbol_block.py`` of the JAX
package).

``SymbolBlock.imports`` loads what ``HybridBlock.export`` wrote
(``model-symbol.json`` and ``model-0000.params``, from either package)
back into Gluon, and ``SymbolBlock(outputs, inputs)`` wraps any symbol as
a layer of a larger net.  Every variable that is not an input is a
Parameter of the block; the auxiliary states (BatchNorm's moving
statistics) have ``grad_req='null'``.

The forward runs the graph eagerly through the executor's node plan
(``symbol._Plan``) on the input's device, on the parameters' values, so
autograd records it as it records any block; in training the ops' new
auxiliary values are written into the parameters.  Hybridized, or nested
in a hybridized parent, it is captured with the rest of the forward.  On
Symbol inputs it splices its graph into the caller's.
"""
from __future__ import annotations

from .. import autograd
from ..base import MXNetError
from .block import HybridBlock, commit_aux
from .parameter import DeferredInitializationError


def _as_name_list(inputs):
    if not isinstance(inputs, (list, tuple)):
        inputs = [inputs]
    names = []
    for i in inputs:
        if isinstance(i, str):
            names.append(i)
        else:
            if i.list_arguments() != [getattr(i, "name", None)]:
                raise MXNetError(
                    "SymbolBlock inputs must be variable symbols "
                    f"(sym.var), got {i}")
            names.append(i.name)
    return names


class SymbolBlock(HybridBlock):
    """A block of a symbol graph and its input variables (ref:
    gluon.SymbolBlock(outputs, inputs, params=None))."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix="", params=params)
        from ..symbol import symbol as sym_ns

        if isinstance(outputs, (list, tuple)):
            outputs = (outputs[0] if len(outputs) == 1
                       else sym_ns.Group(list(outputs)))
        self._out_sym = outputs
        self._in_names = _as_name_list(inputs)
        arg_names = outputs.list_arguments()
        aux_names = outputs.list_auxiliary_states()
        for name in self._in_names:
            if name not in arg_names and name not in aux_names:
                raise MXNetError(
                    f"input {name!r} is not a variable of the symbol "
                    f"(arguments: {arg_names})")
        self._arg_params = [n for n in arg_names if n not in self._in_names]
        self._aux_params = [n for n in aux_names if n not in self._in_names]
        for name in self._arg_params:
            self.params.get(name, allow_deferred_init=True)
        for name in self._aux_params:
            self.params.get(name, grad_req="null", allow_deferred_init=True)
        self._n_out = sym_ns._n_outputs(outputs._node)
        self._plans = {}

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """Load an exported model (ref: SymbolBlock.imports): the parameters
        go on ``ctx`` (default :func:`current_context`)."""
        from .. import ndarray as nd
        from ..context import current_context
        from ..symbol import symbol as sym_ns

        out = sym_ns.load(symbol_file)
        names = [input_names] if isinstance(input_names, str) \
            else list(input_names)
        block = SymbolBlock(out, [sym_ns.var(n) for n in names])
        if param_file is not None:
            flat = {}
            for k, v in nd.load(param_file).items():
                flat[k.split(":", 1)[1] if k.startswith(("arg:", "aux:"))
                     else k] = v
            ctx_list = [ctx] if ctx is not None and not isinstance(
                ctx, (list, tuple)) else (ctx or [current_context()])
            for name, p in block.collect_params().items():
                if name not in flat:
                    raise MXNetError(
                        f"parameter {name!r} missing from {param_file}")
                p.shape = flat[name].shape
                p.initialize(ctx=ctx_list)
                p.set_data(flat[name])
        return block

    def forward(self, *args):
        from ..symbol.symbol import Symbol

        if args and isinstance(args[0], Symbol):
            return self._compose_symbolic(args)
        if len(args) != len(self._in_names):
            raise MXNetError(
                f"SymbolBlock expects {len(self._in_names)} inputs "
                f"({self._in_names}), got {len(args)}")
        return super().forward(*args)

    def infer_shape(self, *args):
        """The parameters' shapes from the inputs' (the graph's shape
        inference)."""
        arg_shapes, _, aux_shapes = self._out_sym.infer_shape(
            **{n: tuple(a.shape) for n, a in zip(self._in_names, args)})
        shapes = dict(zip(self._out_sym.list_arguments(), arg_shapes))
        shapes.update(zip(self._out_sym.list_auxiliary_states(), aux_shapes))
        for name in self._arg_params + self._aux_params:
            self.params.get(name).shape = shapes[name]

    def _param_tensors(self):
        return {n: self.params.get(n).data()
                for n in self._arg_params + self._aux_params}

    def _eager_forward(self, *args):
        from ..symbol.symbol import _Plan, _run

        try:
            params = self._param_tensors()
        except DeferredInitializationError:
            self.infer_shape(*args)
            for p in self.collect_params().values():
                p._finish_deferred_init()
            params = self._param_tensors()
        feed = dict(zip(self._in_names, args))
        feed.update(params)
        train = autograd.is_training()
        plan = self._plans.get(train)
        if plan is None:
            plan = self._plans[train] = _Plan(self._out_sym._node, train)
        vals, aux_updates = _run(plan, feed)
        for name, new in aux_updates.items():
            old = params.get(name)
            if old is not None and new is not old:
                commit_aux(old, new)
        outs = vals[plan.head][:self._n_out]
        return outs[0] if self._n_out == 1 else list(outs)

    def _compose_symbolic(self, args):
        """Symbol inputs: this block's graph spliced into the caller's (the
        reference composes through Symbol.__call__)."""
        from ..symbol.symbol import Symbol, _Node, _topo_order

        if len(args) != len(self._in_names):
            raise MXNetError(
                f"SymbolBlock expects {len(self._in_names)} inputs "
                f"({self._in_names}), got {len(args)}")
        for a in args:
            if not isinstance(a, Symbol):
                raise MXNetError(
                    "SymbolBlock symbolic compose expects all-Symbol "
                    f"inputs, got {type(a).__name__}")
        sub = dict(zip(self._in_names, [a._node for a in args]))
        memo = {}
        for n in _topo_order([self._out_sym._node]):
            if n.op is None and n.name in sub:
                memo[id(n)] = sub[n.name]
            elif n.op is None:
                memo[id(n)] = n     # a parameter variable, shared
            else:
                memo[id(n)] = _Node(n.op, n.name, dict(n.attrs),
                                    [(memo[id(s)], oi) for s, oi in n.inputs])
        return Symbol(memo[id(self._out_sym._node)], self._out_sym._index)

    def __repr__(self):
        return (f"SymbolBlock(inputs={self._in_names}, "
                f"outputs={self._out_sym.list_outputs()})")
