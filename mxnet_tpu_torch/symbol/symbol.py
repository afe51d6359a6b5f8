"""Symbolic API: lazy graph building and its executor (ref:
python/mxnet/symbol/symbol.py, 3rdparty/nnvm and
src/executor/graph_executor.cc; ``mxnet_tpu/symbol/symbol.py`` of the JAX
package).

The graph is a Python DAG over the op registry that the eager namespace
uses (``ops/registry.py``).  Its JSON keeps the reference's
``nodes``/``arg_nodes``/``heads`` layout and is the JAX package's byte for
byte, so a symbol file written by either package loads in the other.

Shape inference (``infer_shape``) walks the graph node by node: the
parameter variables of the core layers get their shapes from the data
shape and the attributes (``_fill_param_shapes``, the JAX package's rules,
so an NHWC convolution fails the same way), and every node's output
shapes come from running its op on ``meta`` tensors, which hold no data.
``infer_type`` says float32 everywhere, as the JAX package does.

:class:`Executor` runs a bound graph eagerly, node by node through the
registry, on the bound device (or, with ``group2ctx``, on the device of
each node's ``ctx_group``, the inputs copied across).  A training forward
with gradients to take records torch's autograd graph, and ``backward``
takes the gradients of the variables from it; a backward after a
predict forward runs the forward again with recording on, as the JAX
executor's backward recomputes.  Where the JAX executor jits the graph
into one XLA program, this one is eager: a captured executor is later
work (ROADMAP queue 2).
"""
from __future__ import annotations

import ast
import json
import sys as _sys

import numpy as np
import torch

from .. import autograd
from .. import operator as _custom_op_mod  # noqa: F401  (registers Custom)
from ..base import MXNetError
from ..context import Context, current_context
from ..ndarray import ndarray as _nd
from ..ndarray.ndarray import NDArray, _on
from ..ops import registry as _registry


class AttrScope:
    """Attribute scope for symbol construction (ref: mx.AttrScope).

    Attributes set here go on every symbol created inside the ``with``
    block, stored as ``__key__`` node attributes so they never collide
    with op arguments.  ``ctx_group`` places nodes for manual model
    parallelism::

        with mx.AttrScope(ctx_group='stage1'):
            h = mx.sym.FullyConnected(x, num_hidden=128)

    and ``sym.bind(ctx, args, group2ctx={'stage1': mx.gpu(1)})`` runs
    stage1's ops on gpu(1) (ref: Executor::Bind group2ctx)."""

    _stack = [{}]

    def __init__(self, **attrs):
        self._attrs = {f"__{k}__": str(v) for k, v in attrs.items()}

    def __enter__(self):
        merged = dict(AttrScope._stack[-1])
        merged.update(self._attrs)
        AttrScope._stack.append(merged)
        return self

    def __exit__(self, *exc):
        AttrScope._stack.pop()
        return False

    @staticmethod
    def current_attrs():
        return AttrScope._stack[-1]


class _Node:
    __slots__ = ("op", "name", "attrs", "inputs")

    def __init__(self, op, name, attrs, inputs):
        self.op = op          # None for variables
        self.name = name
        self.attrs = attrs    # static attributes
        self.inputs = inputs  # list of (node, output index)


def _auto_name(op):
    from ..name import NameManager

    return NameManager.current().get(None, op.lower())


# aux input slots per op: the variables feeding them are auxiliary states
# (ref: FListAuxiliaryStates)
_AUX_SLOTS = {"BatchNorm": (3, 4)}


class Symbol:
    """A node output in the graph (ref: mx.sym.Symbol)."""

    def __init__(self, node, index=0):
        self._node = node
        self._index = index

    @property
    def name(self):
        return self._node.name

    # -- composition ----------------------------------------------------------

    def __getitem__(self, idx):
        if isinstance(idx, int):
            return Symbol(self._node, idx)
        outputs = self.list_outputs()
        if idx in outputs:
            return Symbol(self._node, outputs.index(idx))
        raise MXNetError(f"no output {idx!r}")

    def __iter__(self):
        n = len(self.list_outputs())
        return iter(Symbol(self._node, i) for i in range(n))

    def get_internals(self):
        syms = [Symbol(n, i) for n in _topo_order([self._node])
                for i in range(_n_outputs(n))]
        return _SymbolList(syms)

    def get_children(self):
        if not self._node.inputs:
            return None
        return _SymbolList([Symbol(n, i) for n, i in self._node.inputs])

    # -- graph queries --------------------------------------------------------

    def list_arguments(self):
        aux = set(self._aux_names())
        return [n.name for n in _topo_order([self._node])
                if n.op is None and n.name not in aux]

    def list_auxiliary_states(self):
        return list(self._aux_names())

    def _aux_names(self):
        aux = []
        for n in _topo_order([self._node]):
            for slot in _AUX_SLOTS.get(n.op, ()):
                if slot < len(n.inputs):
                    src, _ = n.inputs[slot]
                    if src.op is None and src.name not in aux:
                        aux.append(src.name)
        return aux

    def list_outputs(self):
        base = self._node.name
        n = _n_outputs(self._node)
        if n == 1:
            return [base + "_output"]
        return [f"{base}_output{i}" for i in range(n)]

    def list_inputs(self):
        return [n.name for n in _topo_order([self._node]) if n.op is None]

    @property
    def attrs(self):
        return dict(self._node.attrs)

    def attr(self, key):
        a = self._node.attrs
        if key in a:
            return a[key]
        return a.get(f"__{key}__")

    def attr_dict(self):
        out = {}
        for n in _topo_order([self._node]):
            if n.attrs:
                out[n.name] = {k: str(v) for k, v in n.attrs.items()}
        return out

    # -- shape and type inference ---------------------------------------------

    def infer_shape(self, *args, **kwargs):
        try:
            return self._infer_shape_impl(False, *args, **kwargs)
        except Exception as e:
            raise MXNetError(f"infer_shape failed: {e}") from e

    def infer_shape_partial(self, *args, **kwargs):
        return self._infer_shape_impl(True, *args, **kwargs)

    def _infer_shape_impl(self, partial, *args, **kwargs):
        arg_names = self.list_arguments()
        aux_names = self.list_auxiliary_states()
        known = dict(zip(arg_names, args)) if args else dict(kwargs)
        known = {k: tuple(v) for k, v in known.items() if v is not None}
        solved, node_shapes = _solve_param_shapes([self._node], known)
        arg_shapes = [solved.get(n) for n in arg_names]
        aux_shapes = [solved.get(n) for n in aux_names]
        if not partial and any(s is None for s in arg_shapes):
            missing = [n for n, s in zip(arg_names, arg_shapes) if s is None]
            raise MXNetError(f"cannot infer shapes for {missing}")
        out_shapes = None
        if all(s is not None for s in arg_shapes):
            outs = node_shapes.get(id(self._node))
            if outs is None:
                if not partial:
                    raise MXNetError(
                        f"the shapes of {self.name}'s outputs do not follow "
                        "from the arguments' shapes")
            else:
                out_shapes = [tuple(o)
                              for o in outs[:_n_outputs(self._node)]]
        return arg_shapes, out_shapes, aux_shapes

    def infer_type(self, *args, **kwargs):
        dt = np.float32
        return ([dt] * len(self.list_arguments()),
                [dt] * _n_outputs(self._node),
                [dt] * len(self.list_auxiliary_states()))

    # -- serialization (ref: nnvm SaveJSON/LoadJSON) ---------------------------

    def tojson(self):
        nodes = _topo_order([self._node])
        idx = {id(n): i for i, n in enumerate(nodes)}
        out_nodes, arg_nodes = [], []
        for i, n in enumerate(nodes):
            out_nodes.append({
                "op": n.op if n.op else "null",
                "name": n.name,
                "attrs": {k: str(v) for k, v in n.attrs.items()},
                "inputs": [[idx[id(s)], oi, 0] for s, oi in n.inputs],
            })
            if n.op is None:
                arg_nodes.append(i)
        # the JAX package's version tag: the two packages' files are one
        # format
        return json.dumps({
            "nodes": out_nodes,
            "arg_nodes": arg_nodes,
            "heads": [[idx[id(self._node)], self._index, 0]],
            "attrs": {"mxnet_version": ["str", "mxnet_tpu-0.1"]},
        }, indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    # -- evaluation -----------------------------------------------------------

    def eval(self, ctx=None, **kwargs):
        ex = self.bind(ctx or current_context(), kwargs)
        return ex.forward()

    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        return Executor(self, ctx, args, args_grad, grad_req, aux_states,
                        group2ctx=group2ctx)

    def get_backend_symbol(self, backend="TPU"):
        """The graph with the backend's registered fusions applied (ref:
        Symbol.get_backend_symbol)."""
        from ..subgraph import build_subgraph

        return build_subgraph(self, backend)

    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    group2ctx=None, **kwargs):
        """Allocate zero arrays from the inferred shapes and bind (ref:
        Executor::SimpleBind)."""
        ctx = ctx or current_context()
        arg_shapes, _, aux_shapes = self.infer_shape(**kwargs)
        arg_names = self.list_arguments()
        aux_names = self.list_auxiliary_states()
        args = {n: _nd.zeros(s, ctx=ctx)
                for n, s in zip(arg_names, arg_shapes)}
        args_grad = None
        if grad_req != "null":
            args_grad = {n: _nd.zeros(s, ctx=ctx)
                         for n, s in zip(arg_names, arg_shapes)}
        aux = {n: _nd.zeros(s, ctx=ctx)
               for n, s in zip(aux_names, aux_shapes)}
        return Executor(self, ctx, args, args_grad, grad_req, aux,
                        group2ctx=group2ctx)

    # -- arithmetic (mirrors NDArray) -----------------------------------------

    def _bin(self, other, op, scalar_op):
        if isinstance(other, Symbol):
            return _make_op_symbol(op, [self, other], {})
        return _make_op_symbol(scalar_op, [self], {"scalar": other})

    def __add__(self, o):
        return self._bin(o, "broadcast_add", "_plus_scalar")

    def __radd__(self, o):
        return self.__add__(o)

    def __sub__(self, o):
        return self._bin(o, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, o):
        return self._bin(o, "broadcast_sub", "_rminus_scalar") \
            if not isinstance(o, Symbol) else NotImplemented

    def __mul__(self, o):
        return self._bin(o, "broadcast_mul", "_mul_scalar")

    def __rmul__(self, o):
        return self.__mul__(o)

    def __truediv__(self, o):
        return self._bin(o, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, o):
        return self._bin(o, "broadcast_div", "_rdiv_scalar") \
            if not isinstance(o, Symbol) else NotImplemented

    def __pow__(self, o):
        return self._bin(o, "broadcast_power", "_power_scalar")

    def __neg__(self):
        return _make_op_symbol("negative", [self], {})

    def __repr__(self):
        return f"<Symbol {self.name}>"

    def __getattr__(self, name):
        # method-style ops: x.reshape(...) == sym.reshape(x, ...)
        if not name.startswith("_") and _registry.exists(name):
            fn = getattr(_sys.modules[__name__], name)
            return lambda *a, **k: fn(self, *a, **k)
        raise AttributeError(f"Symbol has no attribute {name!r}")


class _SymbolList(list):
    def __getitem__(self, key):
        if isinstance(key, str):
            for s in self:
                if s.list_outputs()[s._index] == key or s.name == key:
                    return s
            raise MXNetError(f"no internal output {key!r}")
        return super().__getitem__(key)


# -- graph utilities -----------------------------------------------------------


def _n_outputs(node):
    if node.op is None:
        return 1
    if node.op == "_group":
        return len(node.inputs)
    entry = _registry.entry(node.op)
    if entry.num_outputs == 1:
        return 1
    if node.op in ("split", "SliceChannel"):
        return int(node.attrs.get("num_outputs", 1))
    if node.op == "RNN":
        return 3 if node.attrs.get("mode", "lstm") == "lstm" else 2
    if node.op == "BatchNorm":
        return 3
    if entry.num_outputs > 1:
        return entry.num_outputs
    return 1


def _topo_order(heads):
    seen, order = set(), []

    def visit(n):
        if id(n) in seen:
            return
        seen.add(id(n))
        for src, _ in n.inputs:
            visit(src)
        order.append(n)

    for h in heads:
        visit(h)
    return order


def _op_attrs(node, train):
    """The attributes an op's function is called with: the node's, less
    the scope attributes (``__key__``), with ``_train`` for the ops that
    take it."""
    entry = _registry.entry(node.op)
    attrs = {k: v for k, v in node.attrs.items() if not k.startswith("__")}
    if entry.takes_train:
        attrs["_train"] = train
    return entry, attrs


def _as_tuple(out):
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _meta_outputs(node, in_shapes):
    """The output shapes of ``node`` on inputs of ``in_shapes``: its op run
    on float32 ``meta`` tensors (shapes only: no data, no device)."""
    entry, attrs = _op_attrs(node, False)
    ins = [torch.empty(tuple(s), dtype=torch.float32, device="meta")
           for s in in_shapes]
    with torch.no_grad(), autograd.predict_mode():
        out = entry.fn(*ins, **attrs)
    return tuple(tuple(o.shape) for o in _as_tuple(out))


def _solve_param_shapes(heads, known):
    """Forward-propagate shapes node by node, filling the shapes of the
    parameter variables as the reference's FInferShape backward-fills them
    (weights from the data shape and the attributes).  Returns the solved
    variable shapes and each node's output shapes (``id(node)`` -> tuple)."""
    solved = dict(known)
    out_shapes = {}

    def in_shapes_of(n):
        shapes = []
        for src, oi in n.inputs:
            if src.op is None and solved.get(src.name) is not None:
                out_shapes[id(src)] = (tuple(solved[src.name]),)
            s = out_shapes.get(id(src))
            shapes.append(s[oi] if s is not None and oi < len(s) else None)
        return shapes

    for n in _topo_order(heads):
        if n.op is None:
            if solved.get(n.name) is not None:
                out_shapes[id(n)] = (tuple(solved[n.name]),)
            continue
        _fill_param_shapes(n, in_shapes_of(n), solved)
        in_shapes = in_shapes_of(n)
        if any(s is None for s in in_shapes):
            continue
        if n.op == "_group":
            out_shapes[id(n)] = tuple(tuple(s) for s in in_shapes)
            continue
        try:
            out_shapes[id(n)] = _meta_outputs(n, in_shapes)
        except Exception:
            continue
    return solved, out_shapes


def _fill_param_shapes(n, in_shapes, solved):
    """Backward-fill the variable shapes of the weight and bias slots of the
    core ops (ref: ``_fill_param_shapes``, mxnet_tpu/symbol/symbol.py:508:
    the same rules, so a channel-last convolution's weight is filled from
    ``x[1]`` here too)."""
    a = n.attrs
    names = [src.name if src.op is None else None for src, _ in n.inputs]

    def setn(i, shape):
        if i < len(names) and names[i] and solved.get(names[i]) is None:
            solved[names[i]] = tuple(int(x) for x in shape)

    x = in_shapes[0] if in_shapes else None
    if x is None:
        return
    if n.op == "FullyConnected":
        flat = a.get("flatten", True)
        in_units = int(np.prod(x[1:])) if flat else x[-1]
        setn(1, (a["num_hidden"], in_units))
        if not a.get("no_bias", False):
            setn(2, (a["num_hidden"],))
    elif n.op == "Convolution":
        k = a["kernel"]
        g = a.get("num_group", 1)
        setn(1, (a["num_filter"], x[1] // g) + tuple(k))
        if not a.get("no_bias", False):
            setn(2, (a["num_filter"],))
    elif n.op == "Deconvolution":
        k = a["kernel"]
        g = a.get("num_group", 1)
        setn(1, (x[1], a["num_filter"] // g) + tuple(k))
        if not a.get("no_bias", True):
            setn(2, (a["num_filter"],))
    elif n.op in ("BatchNorm", "LayerNorm", "InstanceNorm"):
        axis = a.get("axis", 1 if n.op != "LayerNorm" else -1)
        c = x[axis]
        for i in range(1, 5 if n.op == "BatchNorm" else 3):
            setn(i, (c,))
    elif n.op == "Embedding":
        setn(1, (a["input_dim"], a["output_dim"]))
    elif n.op == "SoftmaxOutput":
        # the label: class ids, the data's shape less the class axis (ref:
        # SoftmaxOutputProp::InferShape)
        setn(1, (x[0],) + tuple(x[2:]))
    elif n.op in ("LinearRegressionOutput", "LogisticRegressionOutput",
                  "MAERegressionOutput"):
        setn(1, tuple(x))
    elif n.op == "RNN":
        from ..ops.rnn import rnn_param_size

        psize = rnn_param_size(a["num_layers"], x[-1], a["state_size"],
                               a.get("mode", "lstm"),
                               a.get("bidirectional", False))
        setn(1, (psize,))
        d = 2 if a.get("bidirectional", False) else 1
        setn(2, (a["num_layers"] * d, x[1], a["state_size"]))
        setn(3, (a["num_layers"] * d, x[1], a["state_size"]))


# -- running a graph -----------------------------------------------------------


class _Plan:
    """A graph's nodes in execution order, each op node with its function
    and call attributes resolved once: the executor's per-call work is the
    calls themselves.  ``steps`` holds ``(node, fn, inputs, attrs,
    mutate)``: ``inputs`` are ``(step index, output index)`` pairs."""

    def __init__(self, head, train):
        nodes = _topo_order([head])
        pos = {id(n): i for i, n in enumerate(nodes)}
        self.head = pos[id(head)]
        self.steps = []
        for n in nodes:
            ins = [(pos[id(s)], oi) for s, oi in n.inputs]
            if n.op is None or n.op == "_group":
                self.steps.append((n, None, ins, None, ()))
                continue
            entry, attrs = _op_attrs(n, train)
            mutate = tuple(
                (n.inputs[i][0].name, o) for i, o in entry.mutate_aux or ()
                if i < len(n.inputs) and n.inputs[i][0].op is None)
            self.steps.append((n, entry.fn, ins, attrs, mutate))


def _run(plan, feed, node_device=None):
    """Evaluate ``plan`` on the variable tensors of ``feed``; returns every
    step's outputs and the new values of the auxiliary inputs the ops
    update (``mutate_aux``).  ``node_device(node)``, when given, is the
    device each op runs on: its inputs are copied there."""
    vals = []
    aux_updates = {}
    for node, fn, ins, attrs, mutate in plan.steps:
        if fn is None:
            if node.op is None:
                if node.name not in feed:
                    raise MXNetError(
                        f"missing binding for variable {node.name!r}")
                vals.append((feed[node.name],))
            else:                                   # _group
                vals.append(tuple(vals[i][oi] for i, oi in ins))
            continue
        args = [vals[i][oi] for i, oi in ins]
        if node_device is not None:
            dev = node_device(node)
            args = [a.to(dev) for a in args]
        out = _as_tuple(fn(*args, **attrs))
        vals.append(out)
        for name, o in mutate:
            aux_updates[name] = out[o]
    return vals, aux_updates


def _wrap(t, ctx):
    return NDArray(t, ctx if _on(t, ctx) else None)


class Executor:
    """A bound graph (ref: mx.executor.Executor): ``arg_dict``,
    ``grad_dict`` and ``aux_dict`` of NDArrays, ``forward``, ``backward``
    and ``outputs``.

    ``grad_req`` (one string, or a dict by argument) is ``'write'``
    (``backward`` writes each gradient into its array, in place),
    ``'add'`` (adds to it) or ``'null'`` (no gradient); an argument the
    heads do not depend on gets a zero gradient under ``'write'``.  A
    training forward writes the new values of the auxiliary states the
    ops update (BatchNorm's moving statistics) into ``aux_dict``."""

    def __init__(self, symbol, ctx, args, args_grad=None, grad_req="write",
                 aux_states=None, group2ctx=None):
        self._symbol = symbol
        self._ctx = Context(ctx)
        self._group2ctx = dict(group2ctx) if group2ctx else None
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        if isinstance(args, (list, tuple)):
            args = dict(zip(arg_names, args))
        if isinstance(args_grad, (list, tuple)):
            args_grad = dict(zip(arg_names, args_grad))
        if isinstance(aux_states, (list, tuple)):
            aux_states = dict(zip(aux_names, aux_states))
        self.arg_dict = dict(args)
        self.grad_dict = dict(args_grad) if args_grad else {}
        self.aux_dict = dict(aux_states) if aux_states else {}
        if not self._group2ctx:
            # the graph runs on ctx: arrays bound from elsewhere (a loaded
            # checkpoint's, on the CPU) are copied there once
            for d in (self.arg_dict, self.aux_dict):
                for k, v in d.items():
                    d[k] = _as_nd(v).as_in_context(self._ctx)
        if isinstance(grad_req, str):
            grad_req = {n: grad_req for n in arg_names}
        self._grad_req = grad_req
        self._arg_names = arg_names
        self._aux_names = aux_names
        self._n_out = _n_outputs(symbol._node)
        self._plans = {}
        self.outputs = []
        # the recorded forward: (output tensors, {name: leaf tensor})
        self._graph = None

    def _plan(self, train):
        plan = self._plans.get(train)
        if plan is None:
            plan = self._plans[train] = _Plan(self._symbol._node, train)
        return plan

    def _node_device(self, node):
        grp = node.attrs.get("__ctx_group__")
        ctx = self._group2ctx.get(grp, self._ctx) if grp else self._ctx
        return Context(ctx).torch_device()

    def _wanted(self):
        return [n for n in self._arg_names
                if self._grad_req.get(n, "write") != "null"
                and n in self.grad_dict]

    def forward(self, is_train=False, **kwargs):
        for k, v in kwargs.items():
            # fed inputs are committed to this executor's device (a
            # multi-context Module's replicas receive host slices)
            v = _as_nd(v).as_in_context(self._ctx)
            if k in self.arg_dict:
                self.arg_dict[k].data = v.data
            else:
                self.arg_dict[k] = v
        self._graph = None
        record = bool(is_train) and bool(self._wanted())
        outs = self._forward(bool(is_train), record)
        self.outputs = [_wrap(o.detach(), self._ctx) for o in outs]
        return self.outputs

    def _forward(self, train, record):
        feed = {n: self.arg_dict[n].data for n in self._arg_names}
        feed.update({n: self.aux_dict[n].data for n in self._aux_names})
        leaves = {}
        if record:
            for n in self._wanted():
                leaves[n] = feed[n] = feed[n].detach().requires_grad_(True)
        plan = self._plan(train)
        with autograd._RecordingScope(record, train):
            vals, aux_updates = _run(
                plan, feed, self._node_device if self._group2ctx else None)
        outs = vals[plan.head][:self._n_out]
        if record:
            self._graph = (outs, leaves)
        with torch.no_grad():
            for name, new in aux_updates.items():
                dst = self.aux_dict.get(name)
                if dst is not None and new is not dst.data:
                    dst.data.copy_(new)
        return outs

    def backward(self, out_grads=None):
        """Gradients of the heads (ones, or ``out_grads``) with respect to
        every argument whose ``grad_req`` is not ``'null'``."""
        if not self.outputs and self._graph is None:
            raise MXNetError("backward before forward")
        wanted = self._wanted()
        if not wanted:
            return
        if self._graph is None:
            self._forward(False, True)
        outs, leaves = self._graph
        if out_grads is None:
            cts = [torch.ones_like(o) for o in outs]
        else:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            cts = [_nd.as_tensor(g).to(o.device)
                   for g, o in zip(out_grads, outs)]
        pairs = [(o, c) for o, c in zip(outs, cts) if o.requires_grad]
        names = list(leaves)
        grads = [None] * len(names)
        if pairs:
            grads = torch.autograd.grad(
                [o for o, _ in pairs], [leaves[n] for n in names],
                [c for _, c in pairs], retain_graph=True, allow_unused=True)
        with torch.no_grad():
            for name, g in zip(names, grads):
                dst = self.grad_dict[name]
                req = self._grad_req.get(name, "write")
                if g is None:
                    if req == "write":
                        dst.data.zero_()
                    continue
                g = g.to(dst.data.device)
                if req == "add":
                    dst.data.add_(g)
                elif dst.data.shape == g.shape and dst.data.dtype == g.dtype:
                    dst.data.copy_(g)
                else:
                    dst.data = g

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        for k, v in arg_params.items():
            if k in self.arg_dict:
                _assign(self.arg_dict[k], v, self._ctx)
            elif not allow_extra_params:
                raise MXNetError(f"unknown argument {k}")
        for k, v in (aux_params or {}).items():
            if k in self.aux_dict:
                _assign(self.aux_dict[k], v, self._ctx)

    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self._arg_names]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self._arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self._aux_names]


def _assign(dst, src, ctx):
    """Copy NDArray (or array) ``src`` into NDArray ``dst``: in place when
    the shape and dtype agree, else by replacing its tensor."""
    t = _as_nd(src).as_in_context(ctx).data
    with torch.no_grad():
        if dst.data.shape == t.shape and dst.data.dtype == t.dtype:
            dst.data.copy_(t)
        else:
            dst.data = t.clone()


def _as_nd(v):
    if isinstance(v, NDArray):
        return v
    if isinstance(v, torch.Tensor):
        return NDArray(v)
    return _nd.array(v)


# -- symbol construction -------------------------------------------------------


def var(name, attr=None, shape=None, lr_mult=None, wd_mult=None, dtype=None,
        init=None, stype=None, **kwargs):
    """A variable symbol (ref: mx.sym.var/Variable)."""
    attrs = dict(AttrScope.current_attrs())
    attrs.update(attr or {})
    if shape is not None:
        attrs["__shape__"] = tuple(shape)
    if dtype is not None:
        attrs["__dtype__"] = str(np.dtype(dtype))
    return Symbol(_Node(None, name, attrs, []))


Variable = var


def _make_op_symbol(op_name, input_syms, attrs, name=None):
    entry = _registry.entry(op_name)
    name = name or _auto_name(entry.name)
    inputs = [(s._node, s._index) for s in input_syms]
    scope = AttrScope.current_attrs()
    if scope:
        attrs = {**scope, **attrs}
    return Symbol(_Node(entry.name, name, attrs, inputs))


# the scalar ops the arithmetic emits (ref: mxnet_tpu/symbol/symbol.py:895)
def _plus_scalar(x, scalar):
    return x + scalar


def _minus_scalar(x, scalar):
    return x - scalar


def _rminus_scalar(x, scalar):
    return scalar - x


def _mul_scalar(x, scalar):
    return x * scalar


def _div_scalar(x, scalar):
    return x / scalar


def _rdiv_scalar(x, scalar):
    return scalar / x


def _power_scalar(x, scalar):
    return x ** scalar


for _fn in (_plus_scalar, _minus_scalar, _rminus_scalar, _mul_scalar,
            _div_scalar, _rdiv_scalar, _power_scalar):
    if not _registry.exists(_fn.__name__):
        _registry.register(_fn.__name__, _fn)


def Group(symbols):
    """Group heads into one multi-output symbol (ref: mx.sym.Group): a
    ``_group`` node that forwards its inputs' values."""
    syms = list(symbols)
    if not syms:
        raise MXNetError("sym.Group: empty symbol list")
    node = _Node("_group", _auto_name("group"),
                 {}, [(s._node, s._index) for s in syms])
    return Symbol(node, 0)


def load(fname):
    with open(fname) as f:
        return fromjson(f.read())


def fromjson(js):
    data = json.loads(js)
    built = []
    for meta in data["nodes"]:
        attrs = {}
        for k, v in meta.get("attrs", {}).items():
            try:
                attrs[k] = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                attrs[k] = v
        inputs = [(built[i], oi) for i, oi, _ in meta.get("inputs", [])]
        op = None if meta["op"] == "null" else meta["op"]
        built.append(_Node(op, meta["name"], attrs, inputs))
    head_idx, head_out, _ = data["heads"][0]
    return Symbol(built[head_idx], head_out)


# -- the generated sym.* namespace (the registry that builds nd.*) -------------


def _norm_attr(v):
    """An attribute as the graph keeps it (ref: ``_norm_attr``,
    mxnet_tpu/ndarray/ops.py:35): literal strings parsed, sequences as
    tuples, dtypes as their names, numpy scalars as Python numbers."""
    if isinstance(v, str):
        s = v.strip()
        if s and (s[0] in "([-0123456789" or s in ("True", "False", "None")):
            try:
                v = ast.literal_eval(s)
            except (ValueError, SyntaxError):
                return v
    if isinstance(v, (list, tuple)):
        return tuple(_norm_attr(x) for x in v)
    if isinstance(v, np.dtype):
        return str(v)
    if isinstance(v, type):
        return str(np.dtype(v))
    if isinstance(v, np.generic):
        return v.item()
    return v


def _sym_wrapper(entry):
    def wrapper(*args, **kwargs):
        name = kwargs.pop("name", None)
        kwargs.pop("ctx", None)
        # the port's layers hand the training flag to the ops that take
        # it; a graph's executor supplies it instead
        kwargs.pop("_train", None)
        input_syms = list(args)
        for k in list(kwargs):
            v = kwargs[k]
            if isinstance(v, Symbol):
                if k in entry.arg_names:
                    idx = entry.arg_names.index(k)
                    while len(input_syms) <= idx:
                        input_syms.append(None)
                    input_syms[idx] = v
                else:
                    input_syms.append(v)
                kwargs.pop(k)
        attrs = {k: _norm_attr(v) for k, v in kwargs.items()}
        # trailing Nones are absent optional inputs (a bias with no_bias)
        while input_syms and input_syms[-1] is None:
            input_syms.pop()
        filled = []
        for i, s in enumerate(input_syms):
            if s is None:
                # a missing input in the middle: an implicit variable
                nm = f"{name or _auto_name(entry.name)}_{entry.arg_names[i]}"
                s = var(nm)
            filled.append(s)
        if any(not isinstance(s, Symbol) for s in filled):
            raise MXNetError(f"sym.{entry.name} requires Symbol inputs")
        if not filled and entry.arg_names:
            raise MXNetError(
                f"sym.{entry.name} needs at least one of its inputs "
                f"{entry.arg_names}")
        if name is None and entry.name in ("FullyConnected", "Convolution",
                                           "BatchNorm", "Embedding", "RNN",
                                           "Deconvolution"):
            name = _auto_name(entry.name)
        return _make_op_symbol(entry.name, filled, attrs, name)

    wrapper.__name__ = entry.name
    return wrapper


_NN_PARAM_SUFFIX = {
    "FullyConnected": ["weight", "bias"],
    "Convolution": ["weight", "bias"],
    "Deconvolution": ["weight", "bias"],
    "BatchNorm": ["gamma", "beta", "moving_mean", "moving_var"],
    "LayerNorm": ["gamma", "beta"],
    "InstanceNorm": ["gamma", "beta"],
    "Embedding": ["weight"],
    "RNN": ["parameters", "state", "state_cell"],
    "LeakyReLU": ["gamma"],
    # the loss heads make their label variable (ref: SoftmaxOutput makes
    # `<name>_label`)
    "SoftmaxOutput": ["label"],
    "LinearRegressionOutput": ["label"],
    "LogisticRegressionOutput": ["label"],
    "MAERegressionOutput": ["label"],
}


def _make_nn_wrapper(entry):
    """The layers' wrapper: the parameter variables the caller did not pass
    are made as ``<name>_<suffix>`` (MXNet's implicit parameters)."""
    base = _sym_wrapper(entry)

    def wrapper(*args, **kwargs):
        name = kwargs.get("name") or _auto_name(entry.name)
        kwargs["name"] = name
        input_syms = list(args)
        for k in list(kwargs):
            if k in entry.arg_names and isinstance(kwargs[k], Symbol):
                idx = entry.arg_names.index(k)
                while len(input_syms) <= idx:
                    input_syms.append(None)
                input_syms[idx] = kwargs.pop(k)
        needed = len(entry.arg_names)
        no_bias = kwargs.get("no_bias", False)
        suffixes = _NN_PARAM_SUFFIX.get(entry.name, [])
        while len(input_syms) < needed and len(input_syms) - 1 < len(suffixes):
            sfx = suffixes[len(input_syms) - 1]
            if sfx == "bias" and no_bias:
                break
            if sfx == "state_cell" and kwargs.get("mode", "lstm") != "lstm":
                break
            input_syms.append(var(f"{name}_{sfx}"))
        return base(*input_syms, **kwargs)

    wrapper.__name__ = entry.name
    return wrapper


def _install_wrappers():
    """``mx.sym.<op>`` for every registered op not yet here (the ops that
    modules register later are added at their first use through
    ``symbol.__getattr__``)."""
    this = _sys.modules[__name__]
    for name, entry in list(_registry.canonical_items()):
        w = (_make_nn_wrapper(entry) if entry.name in _NN_PARAM_SUFFIX
             else _sym_wrapper(entry))
        for alias in (name,) + entry.aliases:
            if not hasattr(this, alias):
                setattr(this, alias, w)


_install_wrappers()


def __getattr__(name):
    # an op registered after this module was imported (``subgraph``'s)
    if _registry.exists(name):
        _install_wrappers()
        return globals()[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def zeros(shape, dtype=None, **kw):
    """Symbolic creation ops are not ported by the JAX package either
    (ROADMAP caveat (o)): make begin states variables."""
    raise MXNetError("sym.zeros: use mx.nd for eager creation; symbolic "
                     "init ops land with the next parity pass")
