"""ShardingPlan: the layout of each parameter and optimizer state on a
multi-axis mesh (ref: ``mxnet_tpu/parallel/spmd/plan.py``).

A spec is a tuple of mesh axis names (or tuples of them) and ``None``, one
entry a dimension, as ``PartitionSpec`` is (``parallel.mesh``); a JAX
``PartitionSpec`` given to :meth:`ShardingPlan.override` is read as the
tuple it holds.  A spec is a layout: it says which slice of the global
array each rank keeps, and the step computes the same global values
whatever the specs say (within the rounding of sums taken in another
order).

Auto-rules, applied by parameter name and shape (the JAX package's):

- 2-D weights (``(units, in_units)``): dim 0, the output features, over
  ``'mp'`` when ``mp`` divides it (the column split), else dim 1 (the row
  split), else replicated.  Names matching an output-projection pattern
  (``*out_proj*``, ``*o_proj*``, ``*outproj*``, ``*proj_out*``) try dim 1
  first, pairing a row split with the column split before it;
- 4-D convolution kernels: dim 0 (output channels) when ``mp`` divides it;
- 1-D vectors (biases, LayerNorm's gamma and beta): dim 0 when ``mp``
  divides it;
- everything else replicated.

Optimizer states follow their parameter's spec and, with ZeRO-1
(``Trainer(zero_shard=True)``), add ``'dp'`` on the first dimension still
free that ``dp`` divides: a state then holds 1/(dp*mp) of its bytes a rank.

The plan reads only ``mesh.shape`` and ``mesh.axis_names``, so any object
with those two attributes will do for resolving specs.
"""
from __future__ import annotations

from fnmatch import fnmatchcase

from ...base import MXNetError
from .. import mesh as _mesh

# name patterns whose 2-D weights prefer a ROW split (dim 1): the output
# projection after a heads-split attention or MLP block
_ROW_FIRST = ("*out_proj*", "*o_proj*", "*outproj*", "*proj_out*")


class ShardingPlan:
    """The spec of every parameter and state for one mesh.

    ``override(pattern, spec)`` pins every parameter whose full name
    matches the glob ``pattern`` (the first match wins, in registration
    order); the others take the auto-rules.  A spec may name only axes the
    mesh has: an unknown axis raises at once."""

    def __init__(self, mesh):
        self.mesh = mesh
        self._overrides = []  # [(pattern, spec)]

    # -- declaration --------------------------------------------------------

    def override(self, pattern, spec):
        """Pin parameters matching glob ``pattern`` to ``spec`` (a tuple of
        axis names or None a dimension, or a JAX ``PartitionSpec``).
        Returns the plan, for chaining."""
        spec = tuple(spec)
        for axis in spec:
            for a in _mesh.spec_axes(axis):
                if a not in self.mesh.axis_names:
                    raise MXNetError(
                        f"ShardingPlan override {pattern!r} names mesh "
                        f"axis {a!r} but the mesh axes are "
                        f"{tuple(self.mesh.axis_names)}")
        self._overrides.append((str(pattern), spec))
        return self

    # -- resolution ---------------------------------------------------------

    def param_spec(self, name, shape):
        """The spec of parameter ``name`` of ``shape``."""
        shape = tuple(int(d) for d in shape)
        for pattern, spec in self._overrides:
            if fnmatchcase(name, pattern):
                if len(spec) > len(shape):
                    raise MXNetError(
                        f"ShardingPlan override {pattern!r} has "
                        f"{len(spec)} dims but param {name!r} has "
                        f"shape {shape}")
                return spec
        mp = self.mesh.shape.get("mp", 1)
        if mp <= 1:
            return ()
        if len(shape) == 2:
            order = (1, 0) if any(fnmatchcase(name, p)
                                  for p in _ROW_FIRST) else (0, 1)
            for d in order:
                if shape[d] % mp == 0 and shape[d] >= mp:
                    dims = [None, None]
                    dims[d] = "mp"
                    return tuple(dims)
            return ()
        if len(shape) in (1, 4) and shape[0] % mp == 0 and shape[0] >= mp:
            return ("mp",)
        return ()

    def state_spec(self, name, shape, zero=False):
        """The spec of parameter ``name``'s optimizer states: its own, and
        under ZeRO ``'dp'`` on the first dimension it leaves free that the
        ``dp`` size divides."""
        shape = tuple(int(d) for d in shape)
        pspec = self.param_spec(name, shape)
        if not zero:
            return pspec
        dp = self.mesh.shape.get("dp", 1)
        if dp <= 1:
            return pspec
        dims = list(pspec) + [None] * (len(shape) - len(pspec))
        for i, d in enumerate(dims):
            if d is None and shape[i] % dp == 0 and shape[i] >= dp:
                dims[i] = "dp"
                break
        return tuple(dims)

    def batch_spec(self):
        """Dim 0 of a batch over the data axes of the mesh (``('dcn',
        'dp')`` where both exist)."""
        axes = _mesh.data_axes(self.mesh)
        if not axes:
            return ()
        return (axes if len(axes) > 1 else axes[0],)

    # -- shardings ----------------------------------------------------------

    def param_sharding(self, name, shape):
        return _mesh.Sharding(self.mesh, self.param_spec(name, shape))

    def state_sharding(self, name, shape, zero=False):
        return _mesh.Sharding(self.mesh,
                              self.state_spec(name, shape, zero=zero))

    def batch_sharding(self):
        return _mesh.Sharding(self.mesh, self.batch_spec())

    def replicated(self):
        return _mesh.replicated(self.mesh)

    def constrain(self, x, *spec):
        """Declare the layout ``spec`` for the activation ``x`` (ref:
        ``with_sharding_constraint``): the axes are checked against the
        mesh and ``x`` is returned unchanged.  In the JAX package the
        constraint steers where GSPMD puts its collectives and never
        changes a value; every rank of the port holds its activations
        whole, so there is nothing to move."""
        for axis in spec:
            for a in _mesh.spec_axes(axis):
                if a not in self.mesh.axis_names:
                    raise MXNetError(
                        f"ShardingPlan.constrain names mesh axis {a!r} but "
                        f"the mesh axes are {tuple(self.mesh.axis_names)}")
        return x
