"""The port's tensor ops against the JAX package's, through ``mx.nd``.

One parametrised test holds every op that ``mxnet_tpu/ops/tensor.py``
registers and the port's ``ops/tensor.py`` gained (with the reshape
codes and the two interleaved attention ops of ``ops/attention.py``)
against the JAX op called through ``mxnet_tpu.nd``: the same numpy inputs
(fixed seeds) as NDArrays of both packages, the output's shape, dtype and
values, and, where the op is differentiable, the gradient of
``sum(out * c)`` for a fixed ``c`` through each package's autograd.
Values agree within ``ATOL`` absolute plus ``RTOL`` relative (float32
math in other orders) unless a case states its own.
"""
import numpy as np
import pytest

import mxnet_tpu_torch as tmx

ATOL, RTOL = 1e-5, 1e-5


def _r(*shape, seed=0, lo=-2.0, hi=2.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


X = _r(3, 4)
POS = _r(3, 4, lo=0.2, hi=3.0)
UNIT = _r(3, 4, lo=-0.9, hi=0.9)
BIG = _r(3, 4, lo=1.1, hi=4.0)
Y = _r(3, 4, seed=1)
INTS = np.array([[3, 1, 3, 0], [2, 2, 7, 1], [0, 5, 5, 5]], np.float32)
X3 = _r(2, 3, 4, seed=2)
NCHW = _r(2, 8, 4, 6, seed=3)

_UNARY = {
    "exp": X, "log2": POS, "log10": POS, "log1p": POS, "expm1": X,
    "sqrt": POS, "cbrt": POS, "sign": X, "floor": X, "ceil": X,
    "round": X, "rint": X, "trunc": X, "fix": X, "reciprocal": POS,
    "rsqrt": POS, "rcbrt": POS, "sin": X, "cos": X, "tan": UNIT,
    "arcsin": UNIT, "arccos": UNIT, "arctan": X, "sinh": X, "cosh": X,
    "arcsinh": X, "arccosh": BIG, "arctanh": UNIT, "degrees": X,
    "radians": X, "erf": X, "erfinv": UNIT, "gamma": POS, "digamma": POS,
    "logical_not": INTS, "isnan": X, "isinf": X, "softsign": X,
    "softrelu": X, "hard_sigmoid": X, "identity": X, "zeros_like": X,
    "ones_like": X, "_contrib_div_sqrt_dim": X,
}
_BINARY = ["broadcast_mod", "broadcast_maximum", "broadcast_minimum",
           "broadcast_hypot", "_maximum", "_minimum", "broadcast_equal",
           "broadcast_not_equal", "broadcast_greater",
           "broadcast_greater_equal", "broadcast_lesser_equal",
           "broadcast_logical_and", "broadcast_logical_or",
           "broadcast_logical_xor"]


def _case(name, inputs, attrs=None, label=None, tol=None):
    return pytest.param(name, inputs, attrs or {}, tol,
                        id=label or name)


CASES = (
    [_case(n, [a]) for n, a in _UNARY.items()]
    + [_case(n, [INTS if "logical" in n or "equal" in n else POS,
                 INTS[::-1].copy() + 1 if "logical" in n or "equal" in n
                 else _r(3, 4, seed=5, lo=0.2, hi=3.0)]) for n in _BINARY]
    + [_case("broadcast_maximum", [X, _r(1, 4, seed=4)], label="broadcast"),
       _case("clip", [X], {"a_min": -0.5, "a_max": 1.0}),
       _case("smooth_l1", [X], {"scalar": 1.5}),
       _case("prod", [POS], {"axis": 1}),
       _case("prod", [INTS.astype(np.int32)], {"axis": (0, 1)},
             label="prod-int32"),
       _case("max", [X3], {"axis": (0, 2), "keepdims": True}),
       _case("min", [X3], {"axis": 1}),
       _case("nansum", [np.where(X > 1, np.nan, X).astype(np.float32)],
             {"axis": 0}),
       _case("nanprod", [np.where(X > 1, np.nan, POS).astype(np.float32)]),
       _case("norm", [X3], {"ord": 1, "axis": 2}),
       _case("norm", [X3], {"axis": (1, 2), "keepdims": True},
             label="norm-l2"),
       _case("argmax", [X3], {"axis": 1}),
       _case("argmin", [X3], {"axis": 2, "keepdims": True}),
       _case("argmax_channel", [X3]),
       _case("dot", [X, _r(4, 5, seed=1)]),
       _case("dot", [X, _r(5, 4, seed=1)], {"transpose_b": True},
             label="dot-transpose_b"),
       _case("dot", [X3, _r(4, 5, seed=1)], label="dot-3d"),
       _case("batch_dot", [X3, _r(2, 4, 5, seed=1)]),
       _case("batch_dot", [_r(2, 4, 3), _r(2, 4, 5, seed=1)],
             {"transpose_a": True}, label="batch_dot-transpose_a"),
       _case("khatri_rao", [_r(3, 4), _r(2, 4, seed=1)]),
       _case("transpose", [X3], {"axes": (1, 0, 2)}),
       _case("transpose", [X3], label="transpose-reversed"),
       _case("add_n", [X, Y, POS]),
       _case("broadcast_axis", [_r(3, 1)], {"axis": 1, "size": 4}),
       _case("broadcast_to", [_r(1, 4)], {"shape": (3, 0)}),
       _case("broadcast_like", [_r(1, 4), X]),
       _case("tile", [X], {"reps": (2, 1, 3)}),
       _case("repeat", [X], {"repeats": 2, "axis": 1}),
       _case("repeat", [X], {"repeats": 3}, label="repeat-flat"),
       _case("depth_to_space", [NCHW], {"block_size": 2}),
       _case("space_to_depth", [NCHW], {"block_size": 2}),
       _case("slice", [X3], {"begin": (0, 1, None), "end": (2, 3, None),
                             "step": (1, 1, 2)}),
       _case("slice", [X3], {"begin": (None, None, 3),
                             "end": (None, None, 0),
                             "step": (1, 1, -1)}, label="slice-negative"),
       _case("slice_like", [X3, _r(1, 2, 3)], {"axes": (1, 2)}),
       _case("gather_nd", [X3, np.array([[0, 1, 1], [2, 0, 1]],
                                        np.float32)]),
       _case("scatter_nd", [_r(3), np.array([[0, 1, 1], [2, 0, 3]],
                                            np.float32)],
             {"shape": (2, 4)}),
       _case("one_hot", [np.array([1, 0, 4, 7], np.float32)],
             {"depth": 5, "on_value": 2.0, "off_value": -1.0}),
       _case("boolean_mask", [X, np.array([1, 0, 1], np.float32)]),
       _case("sort", [INTS], {"axis": 1, "is_ascend": False}),
       _case("sort", [X3], {"axis": 0}, label="sort-axis0"),
       _case("argsort", [INTS], {"axis": 1}),
       _case("argsort", [INTS], {"axis": 0, "is_ascend": False,
                                 "dtype": "int32"}, label="argsort-desc"),
       _case("topk", [INTS], {"k": 2, "ret_typ": "both"}),
       _case("topk", [X3], {"k": 2, "axis": 1, "is_ascend": True,
                            "ret_typ": "value"}, label="topk-ascend"),
       _case("topk", [INTS], {"k": 2, "axis": 0, "ret_typ": "mask"},
             label="topk-mask"),
       _case("cast", [X], {"dtype": "int32"}),
       _case("shape_array", [X3]),
       _case("size_array", [X3]),
       _case("diag", [_r(4)], {"k": 1}),
       _case("diag", [X3], {"k": -1}, label="diag-3d"),
       _case("SequenceLast", [X3]),
       _case("SequenceLast", [X3, np.array([1, 3], np.float32)],
             {"use_sequence_length": True, "axis": 1}, label="SequenceLast-len"),
       _case("cumsum", [X3], {"axis": 1}),
       _case("cumsum", [INTS.astype(np.int32)], label="cumsum-int32"),
       _case("batch_take", [X, np.array([3, 0, 2], np.float32)]),
       _case("_ravel_multi_index", [np.array([[1, 2], [0, 3]], np.int32)],
             {"shape": (3, 4)}),
       _case("_unravel_index", [np.array([5, 11, 0], np.int32)],
             {"shape": (3, 4)}),
       _case("Crop", [NCHW], {"offset": (1, 2), "h_w": (2, 3)}),
       _case("Crop", [NCHW], {"h_w": (2, 4), "center_crop": True},
             label="Crop-center"),
       _case("reshape_like", [X3, _r(4, 6)]),
       _case("reshape_like", [X3, _r(6, 2)],
             {"lhs_begin": 0, "lhs_end": 2, "rhs_begin": 0, "rhs_end": 1},
             label="reshape_like-axes"),
       _case("reshape", [X3], {"shape": (-3, -2)}, label="reshape--3"),
       _case("reshape", [X3], {"shape": (-4, 1, 2, -2)}, label="reshape--4"),
       _case("reshape", [X3], {"shape": (0, -1), "reverse": True},
             label="reshape-reverse"),
       _case("IdentityAttachKLSparseReg", [_r(4, 3, lo=0.05, hi=0.95)],
             {"sparseness_target": 0.2, "penalty": 0.01}),
       _case("_contrib_interleaved_matmul_selfatt_qk", [_r(5, 2, 24)],
             {"heads": 2}),
       _case("_contrib_interleaved_matmul_selfatt_valatt",
             [_r(5, 2, 24), _r(4, 5, 5, seed=1)], {"heads": 2})])


def _jax_inputs(arrays):
    import mxnet_tpu as jmx

    return [jmx.nd.array(a, dtype=a.dtype) for a in arrays]


def _port_inputs(arrays):
    return [tmx.nd.array(a, dtype=a.dtype, ctx=tmx.cpu()) for a in arrays]


def _outputs(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _differentiable(name, arrays):
    from mxnet_tpu.ops import registry

    return not registry.get(name).nondiff and arrays[0].dtype == np.float32


@pytest.mark.parametrize("name,arrays,attrs,tol", CASES)
def test_op_matches_jax(name, arrays, attrs, tol):
    """Forward (shape, dtype, values) and, for differentiable ops, the
    gradient of every float input."""
    import mxnet_tpu as jmx

    atol, rtol = tol or (ATOL, RTOL)
    jin, tin = _jax_inputs(arrays), _port_inputs(arrays)
    grad = _differentiable(name, arrays)
    if grad:
        for a in jin + tin:
            if a.dtype == np.float32:
                a.attach_grad()
    with jmx.autograd.record():
        jout = _outputs(getattr(jmx.nd, name)(*jin, **attrs))
    with tmx.autograd.record():
        tout = _outputs(getattr(tmx.nd, name)(*tin, **attrs))
    assert len(tout) == len(jout)
    for t, j in zip(tout, jout):
        assert isinstance(t, tmx.nd.NDArray) and t.context == tmx.cpu()
        assert t.shape == j.shape and t.dtype == j.dtype, \
            (t.shape, j.shape, t.dtype, j.dtype)
        np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), atol=atol,
                                   rtol=rtol, equal_nan=True)
    if not grad or jout[0].dtype != np.float32:
        return
    c = np.random.RandomState(9).uniform(0.5, 1.5, jout[0].shape).astype(
        np.float32)
    with jmx.autograd.record():
        jout = _outputs(getattr(jmx.nd, name)(*jin, **attrs))
        (jout[0] * jmx.nd.array(c)).sum().backward()
    with tmx.autograd.record():
        tout = _outputs(getattr(tmx.nd, name)(*tin, **attrs))
        (tout[0] * tmx.nd.array(c, ctx=tmx.cpu())).sum().backward()
    for t, j in zip(tin, jin):
        if j.dtype == np.float32:
            np.testing.assert_allclose(t.grad.asnumpy(), j.grad.asnumpy(),
                                       atol=atol * 10, rtol=rtol * 10)


def test_every_tensor_and_attention_name_is_registered_with_its_aliases():
    """Each name (aliases too) of the JAX ``ops/tensor.py``, ``ops/
    random_ops.py`` and the interleaved attention ops is in the port's
    registry, and an alias names the same op as its canonical name."""
    from mxnet_tpu.ops import registry as jreg
    from mxnet_tpu_torch.ops import registry

    wanted = [n for n in jreg.list_ops()
              if jreg.get(n).fn.__module__ in ("mxnet_tpu.ops.tensor",
                                               "mxnet_tpu.ops.random_ops")
              or "interleaved" in n]
    missing = [n for n in wanted if not registry.exists(n)]
    assert not missing, missing
    for n in wanted:
        assert registry.entry(n).name == jreg.get(n).name, n
    tested = {p.values[0] for p in CASES}
    # the ops the earlier slices ported have parity tests of their own
    # (tests/test_torch_ops.py, test_torch_rnn_cell.py)
    earlier = {"reshape", "flatten", "slice_axis", "take", "Embedding",
               "broadcast_lesser", "broadcast_add", "broadcast_sub",
               "broadcast_mul", "broadcast_div", "broadcast_power",
               "negative", "stop_gradient", "make_loss", "square", "abs",
               "relu", "sigmoid", "tanh", "log", "gammaln", "expand_dims",
               "squeeze", "stack", "concat", "split", "flip", "where",
               "SequenceMask", "SequenceReverse", "swapaxes", "pad", "sum",
               "mean", "pick"}
    untested = {registry.entry(n).name for n in wanted
                if "random" not in jreg.get(n).fn.__module__} - tested
    assert not untested - earlier, sorted(untested - earlier)


def test_registry_lacks_at_most_132_of_the_jax_names():
    """The port's registry against the JAX registry's 389 names (each
    package with its subgraph pass and symbolic API imported)."""
    import mxnet_tpu.subgraph  # noqa: F401  (registers the fused op)
    import mxnet_tpu.symbol  # noqa: F401  (registers the scalar ops)
    import mxnet_tpu_torch.subgraph  # noqa: F401
    from mxnet_tpu.ops import registry as jreg
    from mxnet_tpu_torch.ops import registry

    missing = sorted(set(jreg.list_ops()) - set(registry.list_ops()))
    print(f"{len(missing)} of {len(jreg.list_ops())} JAX names missing: "
          f"{missing}")
    assert len(missing) <= 132


def test_symbolic_graph_of_new_ops_matches_jax():
    """``mx.sym.exp``/``transpose``/``dot`` bound through ``Executor``:
    forward and the input gradients against the JAX graph."""
    import mxnet_tpu as jmx

    a, b = _r(3, 4), _r(3, 5, seed=1)
    outs = []
    for mx, ctx in ((jmx, jmx.cpu()), (tmx, tmx.cpu())):
        x, w = mx.sym.var("x"), mx.sym.var("w")
        y = mx.sym.dot(mx.sym.transpose(mx.sym.exp(x)), w)
        args = {"x": mx.nd.array(a, ctx=ctx), "w": mx.nd.array(b, ctx=ctx)}
        grads = {k: mx.nd.zeros(v.shape, ctx=ctx) for k, v in args.items()}
        ex = y.bind(ctx, args, args_grad=grads)
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward([mx.nd.ones(out.shape, ctx=ctx)])
        outs.append((out, {k: g.asnumpy() for k, g in grads.items()}))
    (jo, jg), (to, tg) = outs
    assert to.shape == jo.shape == (4, 5)
    np.testing.assert_allclose(to, jo, atol=1e-5, rtol=1e-5)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], atol=1e-5, rtol=1e-5)

