"""Products split over the mesh's ``mp`` axis, and the reads of sharded
parameters inside the mesh step (the port's own: in the JAX package GSPMD
inserts these collectives into the compiled step).

How an op learns that a weight is sharded.  While
:class:`~.lowering.SpmdStepCompiler` runs the forward of a step on a mesh
of more than one rank it sets a :func:`split_scope`, which maps each
sharded parameter of the step (``Parameter``) and its shard (the tensor
the parameter holds at rest, an autograd leaf) to its spec.  Inside it:

- a block whose class lists a parameter attribute in ``_split_params``
  (``nn.Dense``: its weight and bias; BERT's and the Transformer's layers:
  the in- and out-projections of ``multihead_attention``) is handed that
  parameter's shard.  ``FullyConnected`` and ``multihead_attention`` pass
  every weight through :func:`linear`, which finds the shard in the scope
  (:func:`split_of`) and computes on it:

  - a column split (weight ``('mp', None)``: the output features):
    ``x @ W_r.T + b_r`` on this rank, then an all-gather of the outputs
    along the last dim.  The backward takes this rank's slice of the
    output gradient (the consumers are replicated over ``mp``, so every
    ``mp`` rank holds the same gradient), forms the weight and bias
    gradients locally and all-reduces the input gradient ``gy_r @ W_r``
    over ``mp``;
  - a row split (weight ``(None, 'mp')``): this rank's slice of ``x``'s
    last dim, the local product, an all-reduce over ``mp``, then the bias
    added once.  The backward forms the weight gradient locally and
    all-gathers the input gradient along the last dim;

- every other read of a sharded parameter -- ``Parameter.data()``, by any
  block or op (Embedding, LayerNorm, Convolution, a bias whose weight is
  not split the same way) -- gets the full tensor, all-gathered over the
  parameter's axes once a forward and cached (gather-for-compute, as GSPMD
  does for a consumer it does not partition).  Its backward is this
  rank's slice of the full gradient, with no collective: the ranks of one
  ``mp`` group hold the same activations, so the same full gradient.

The collectives run on ``parallel.mesh.Group``: the split products' are
counted in ``comm_stats()`` as ``"act"``, the gathers of parameters as
``"param"``.  :func:`split_counts` counts the products computed on a
shard.  Results are within rounding of the unsplit product, not equal to
it: a narrower product may take another cuBLAS algorithm, and a row split
adds its partial sums in another order.  Outside a scope :func:`linear`
is ``torch.nn.functional.linear``.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as tF

_tls = threading.local()
_counts = {"column": 0, "row": 0}


def split_counts():
    """``{"column": n, "row": n}``: products computed on a shard since
    :func:`reset_split_counts`."""
    return dict(_counts)


def reset_split_counts():
    for k in _counts:
        _counts[k] = 0


def current():
    """The active :class:`SplitScope`, or None."""
    return getattr(_tls, "scope", None)


@contextlib.contextmanager
def split_scope(scope):
    prev = getattr(_tls, "scope", None)
    _tls.scope = scope
    try:
        yield scope
    finally:
        _tls.scope = prev


def gather_full(shard, spec, shape, mesh, kind="param"):
    """The full tensor of ``shape`` that ``shard`` (this rank's slice under
    ``spec``) is part of: one all-gather over the spec's axes."""
    from .. import mesh as _mesh

    group = mesh.group(_mesh.spec_mesh_axes(spec))
    parts = group.all_gather(shard.detach().contiguous(), kind)
    full = torch.empty(shape, dtype=shard.dtype, device=shard.device)
    for member, part in zip(group.members, parts):
        full[_mesh.shard_slices(spec, shape, mesh, member)] = part
    return full


class _GatherParam(torch.autograd.Function):
    """A sharded parameter gathered for compute; the gradient of the shard
    is this rank's slice of the full gradient."""

    @staticmethod
    def forward(ctx, shard, entry, mesh):
        from .. import mesh as _mesh

        ctx.slices = _mesh.shard_slices(entry.spec, entry.shape, mesh)
        return gather_full(shard, entry.spec, entry.shape, mesh)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.slices].contiguous(), None, None


class _CopyToGroup(torch.autograd.Function):
    """The identity; its backward sums the gradient over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce_(g.contiguous().clone(), "act"), None


class _ReduceGroup(torch.autograd.Function):
    """The sum over the group; its backward is the identity."""

    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce_(x.contiguous().clone(), "act")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    """Every member's ``y`` concatenated along the last dim, in group
    order; the backward is this member's columns of the gradient."""

    @staticmethod
    def forward(ctx, y, group):
        ctx.width, ctx.index = y.shape[-1], group.index
        return torch.cat(group.all_gather(y.contiguous(), "act"), dim=-1)

    @staticmethod
    def backward(ctx, g):
        n, i = ctx.width, ctx.index
        return g[..., i * n:(i + 1) * n].contiguous(), None


class _SliceLast(torch.autograd.Function):
    """This member's columns of ``x``; the backward all-gathers the
    gradient along the last dim."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = x.shape[-1] // group.size
        return x[..., group.index * n:(group.index + 1) * n].contiguous()

    @staticmethod
    def backward(ctx, g):
        return torch.cat(ctx.group.all_gather(g.contiguous(), "act"),
                         dim=-1), None


class Entry:
    """One sharded parameter of a step: its name, ``Parameter``, shard
    (the tensor it holds), spec (one entry a dim) and full shape.  ``kind``
    is ``"column"`` or ``"row"`` for a 2-D weight split over ``mp`` on dim
    0 or 1, ``"vector"`` for a 1-D one over ``mp`` (a column split's bias),
    else None."""

    __slots__ = ("name", "param", "shard", "spec", "shape", "kind")

    def __init__(self, name, param, shard, spec, shape):
        self.name, self.param, self.shard = name, param, shard
        self.shape = tuple(shape)
        self.spec = tuple(spec) + (None,) * (len(self.shape) - len(spec))
        self.kind = {("mp", None): "column", (None, "mp"): "row",
                     ("mp",): "vector"}.get(self.spec)


class SplitScope:
    """The sharded parameters of one forward on ``mesh``: ``entries`` (one
    :class:`Entry` each).  ``gathered`` lists the names gathered for
    compute, in order; :meth:`commit` writes the gathered values of the
    parameters that take no gradient (BatchNorm's moving statistics, which
    the forward updates in place) back into their shards."""

    def __init__(self, mesh, entries):
        self.mesh = mesh
        self.mp = mesh.group(("mp",)) if "mp" in mesh.axis_names else None
        self._by_param = {id(e.param): e for e in entries}
        self._by_shard = {id(e.shard): e for e in entries}
        self._full = {}
        self.gathered = []

    def entry(self, t):
        """The entry whose shard is the tensor ``t``, or None."""
        return self._by_shard.get(id(t))

    def full(self, e):
        """The full value of entry ``e``, gathered once a forward."""
        got = self._full.get(id(e.param))
        if got is None:
            if e.shard.requires_grad and torch.is_grad_enabled():
                got = _GatherParam.apply(e.shard, e, self.mesh)
            else:
                with torch.no_grad():
                    got = gather_full(e.shard, e.spec, e.shape, self.mesh)
            self._full[id(e.param)] = got
            self.gathered.append(e.name)
        return got

    def read(self, p):
        """What ``p.data()`` gives inside the forward: the full value of a
        sharded parameter of this scope, else None."""
        e = self._by_param.get(id(p))
        return None if e is None else self.full(e)

    def value(self, p, split_ok):
        """A block's value of parameter ``p``: its shard where the block
        feeds it to a split product (``split_ok``) and it is split so,
        else ``p.data()``."""
        e = self._by_param.get(id(p))
        if e is not None and split_ok and e.kind is not None:
            return e.shard
        return p.data()

    def full_of(self, t):
        """``t``, or the full value where ``t`` is a shard of this scope."""
        e = self.entry(t)
        return t if e is None else self.full(e)

    def commit(self):
        from .. import mesh as _mesh

        with torch.no_grad():
            for e in self._by_param.values():
                full = self._full.get(id(e.param))
                if full is not None and not e.shard.requires_grad:
                    e.shard.copy_(full[_mesh.shard_slices(
                        e.spec, e.shape, self.mesh)])


def split_of(t):
    """The split (``"column"``, ``"row"``) of weight ``t`` in the active
    scope, else None."""
    scope = current()
    if scope is None:
        return None
    e = scope.entry(t)
    return e.kind if e is not None and e.kind in ("column", "row") else None


def full_of(t):
    """``t``, or its full value where it is a shard of the active scope."""
    scope = current()
    return t if scope is None else scope.full_of(t)


def linear(x, weight, bias=None):
    """``x @ weight.T + bias``: on the shard of a split weight (the module
    docstring), else ``torch.nn.functional.linear`` on full tensors."""
    scope = current()
    if scope is None:
        return tF.linear(x, weight, bias)
    e = scope.entry(weight)
    kind = e.kind if e is not None else None
    if kind not in ("column", "row"):
        return tF.linear(x, scope.full_of(weight),
                         None if bias is None else scope.full_of(bias))
    group = scope.mp
    if kind == "column":
        be = scope.entry(bias) if bias is not None else None
        local_b = bias if be is not None and be.kind == "vector" else None
        y = tF.linear(_CopyToGroup.apply(x, group), weight, local_b)
        _counts["column"] += 1
        y = _GatherLast.apply(y, group)
        if bias is not None and local_b is None:
            y = y + scope.full_of(bias)
        return y
    y = tF.linear(_SliceLast.apply(x, group), weight)
    _counts["row"] += 1
    y = _ReduceGroup.apply(y, group)
    if bias is not None:
        y = y + scope.full_of(bias)
    return y
