"""Custom operators: ``mx.operator`` (ref: python/mxnet/operator.py,
src/operator/custom/custom.cc; ``mxnet_tpu/operator.py`` of the JAX
package).

Users subclass :class:`CustomOp` (the kernel, written on NDArrays) and
:class:`CustomOpProp` (shape and type inference and the operator
factory), register the prop with ``@mx.operator.register("name")`` and
call the op as ``mx.nd.Custom(..., op_type="name")`` or
``mx.sym.Custom(..., op_type="name")``.

The op runs the host Python of ``CustomOp.forward`` in a
``torch.autograd.Function`` whose backward calls ``CustomOp.backward``:
the inputs arrive as NDArrays over the tensors (detached), the outputs
and input gradients as zero NDArrays that ``assign`` writes.  One
operator instance serves a call's forward and its backward, so state
kept on ``self`` in forward is there in backward, as the reference's
per-node instance.
"""
from __future__ import annotations

import torch

from .base import MXNetError

_custom_registry = {}


def register(op_type):
    """Decorator registering a :class:`CustomOpProp` subclass under
    ``op_type`` (ref: mx.operator.register)."""

    def _do(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise MXNetError("register expects a CustomOpProp subclass")
        _custom_registry[op_type] = prop_cls
        return prop_cls

    return _do


def get_all_registered_operators():
    return list(_custom_registry)


class CustomOp:
    """Base class of the custom kernel (ref: mx.operator.CustomOp)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Write ``src`` into ``dst`` as the request says."""
        from .ndarray.ndarray import NDArray, array

        if req == "null":
            return
        if not isinstance(src, NDArray):
            src = array(src, ctx=dst.context)
        if req in ("write", "inplace"):
            dst.data = src.data.to(dst.data.device)
        elif req == "add":
            dst.data = dst.data + src.data.to(dst.data.device)
        else:
            raise MXNetError(f"unknown req {req!r}")


class CustomOpProp:
    """Shape and type inference and the factory (ref:
    mx.operator.CustomOpProp)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return (in_type, [in_type[0]] * len(self.list_outputs()),
                [in_type[0]] * len(self.list_auxiliary_states()))

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        raise NotImplementedError


def _wrap(tensors):
    from .ndarray.ndarray import NDArray

    return [NDArray(t.detach()) for t in tensors]


class _CustomFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, holder, train, *xs):
        from .ndarray.ndarray import NDArray

        ins = _wrap(xs)
        outs = [NDArray(torch.zeros(s, dtype=d, device=xs[0].device))
                for s, d in zip(holder["shapes"], holder["dtypes"])]
        holder["op"].forward(is_train=bool(train),
                             req=["write"] * len(outs), in_data=ins,
                             out_data=outs, aux=[])
        results = tuple(o.data.to(xs[0].device) for o in outs)
        ctx.holder = holder
        ctx.save_for_backward(*xs, *results)
        ctx.n_in = len(xs)
        return results

    @staticmethod
    def backward(ctx, *cts):
        from .ndarray.ndarray import NDArray

        saved = ctx.saved_tensors
        xs, outs = saved[:ctx.n_in], saved[ctx.n_in:]
        gins = [NDArray(torch.zeros_like(x)) for x in xs]
        ctx.holder["op"].backward(
            req=["write"] * len(xs), out_grad=_wrap(
                [c if c is not None else torch.zeros_like(o)
                 for c, o in zip(cts, outs)]),
            in_data=_wrap(xs), out_data=_wrap(outs), in_grad=gins, aux=[])
        return (None, None) + tuple(g.data.to(x.device)
                                    for g, x in zip(gins, xs))


def _k_custom(*arrays, op_type, _train=False, **kwargs):
    """The registry's ``Custom`` op behind ``nd.Custom``/``sym.Custom``
    (ref: ``_k_custom``, mxnet_tpu/operator.py:108)."""
    from .ndarray.ndarray import to_torch_dtype

    prop_cls = _custom_registry.get(op_type)
    if prop_cls is None:
        raise MXNetError(f"custom op {op_type!r} is not registered")
    prop = prop_cls(**{k: str(v) for k, v in kwargs.items()})
    in_shapes = [tuple(a.shape) for a in arrays]
    in_dtypes = [str(a.dtype).replace("torch.", "") for a in arrays]
    _, out_shapes, _ = prop.infer_shape([list(s) for s in in_shapes])
    _, out_dtypes, _ = prop.infer_type(list(in_dtypes))
    holder = {"shapes": [tuple(int(d) for d in s) for s in out_shapes],
              "dtypes": [to_torch_dtype(d) for d in out_dtypes],
              "op": prop.create_operator(None, in_shapes, in_dtypes)}
    out = _CustomFunction.apply(holder, bool(_train), *arrays)
    return out if len(out) > 1 else out[0]


from .ops import registry as _registry  # noqa: E402

_registry.register("Custom", _k_custom, variadic=True, train_aware=True)
