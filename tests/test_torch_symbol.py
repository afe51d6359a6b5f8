"""The symbolic API of the PyTorch port (``symbol/``, the Executor, the
registry's metadata, the loss heads, ``operator``, ``name``) against the
JAX package, on the CPU.

Every graph is built in the port and loaded into the JAX package from the
port's JSON (so each parity test also moves a symbol file across); both
are bound to the same numpy arrays from a seed.  Tolerances: forward
outputs, gradients and auxiliary states within 1e-5 absolute plus 1e-5
relative (float32 on both sides, sums in other orders); shapes, names,
JSON and integer outputs exactly.

The ``gpu``-marked test needs the card and skips here; run it on the GPU
machine with ``python -m pytest -m gpu --noconftest
tests/test_torch_symbol.py``.
"""
import json

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
# every op registers at import, so each worker collects the same op list
from mxnet_tpu_torch import subgraph  # noqa: F401
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.base import MXNetError

CPU = tmx.cpu()
TOL = dict(rtol=1e-5, atol=1e-5)


def _jmx():
    import mxnet_tpu as jmx

    return jmx


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale) \
        .astype(np.float32)


def _arrays(sym, seed=0, **shapes):
    """Numpy arrays for every argument and auxiliary state of ``sym`` at
    the shapes the port infers from ``shapes``; labels are class ids
    (``labels``: name -> number of classes)."""
    labels = shapes.pop("labels", {})
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args = {}
    for i, (n, s) in enumerate(zip(sym.list_arguments(), arg_shapes)):
        if n in labels:
            args[n] = np.random.RandomState(seed + i).randint(
                0, labels[n], size=s).astype(np.float32)
        else:
            args[n] = _rand(s, seed + i, 0.5)
    aux = {n: (np.abs(_rand(s, seed + 50 + i)) + 0.5) if "var" in n
           else _rand(s, seed + 50 + i, 0.1)
           for i, (n, s) in enumerate(zip(sym.list_auxiliary_states(),
                                          aux_shapes))}
    return args, aux


def _bind_both(sym, args, aux, grad_req="write"):
    """The port's executor and the JAX package's, on the same arrays."""
    jmx = _jmx()
    jsym = jmx.sym.fromjson(sym.tojson())
    tex = sym.bind(CPU, {k: tmx.nd.array(v, ctx=CPU) for k, v in args.items()},
                   args_grad={k: tmx.nd.zeros(v.shape, ctx=CPU)
                              for k, v in args.items()},
                   grad_req=grad_req,
                   aux_states={k: tmx.nd.array(v, ctx=CPU)
                               for k, v in aux.items()})
    jex = jsym.bind(jmx.cpu(), {k: jmx.nd.array(v) for k, v in args.items()},
                    args_grad={k: jmx.nd.zeros(v.shape)
                               for k, v in args.items()},
                    grad_req=grad_req,
                    aux_states={k: jmx.nd.array(v) for k, v in aux.items()})
    return tex, jex


def _close(t, j, **tol):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), **(tol or TOL))


def _mlp(bn=True, head="softmax"):
    x = tsym.var("data")
    h = tsym.FullyConnected(x, num_hidden=8, name="fc1")
    h = tsym.Activation(h, act_type="tanh", name="act1")
    if bn:
        h = tsym.BatchNorm(h, fix_gamma=False, name="bn1")
    h = tsym.FullyConnected(h, num_hidden=5, name="fc2")
    if head == "softmax":
        return tsym.SoftmaxOutput(h, name="softmax")
    return h


def _cnn():
    x = tsym.var("data")
    h = tsym.Convolution(x, kernel=(3, 3), num_filter=4, pad=(1, 1),
                         name="conv1")
    h = tsym.BatchNorm(h, fix_gamma=False, name="bn1")
    h = tsym.Activation(h, act_type="relu", name="relu1")
    h = tsym.Pooling(h, kernel=(2, 2), stride=(2, 2), pool_type="max",
                     name="pool1")
    h = tsym.flatten(h, name="flat")
    h = tsym.FullyConnected(h, num_hidden=6, name="fc")
    return tsym.SoftmaxOutput(h, name="softmax")


def _lstm_lm(V=30, E=8, H=12, L=2):
    data, label = tsym.var("data"), tsym.var("softmax_label")
    emb = tsym.Embedding(data, input_dim=V, output_dim=E, name="embed")
    x = tsym.swapaxes(emb, dim1=0, dim2=1)
    rnn = tsym.RNN(x, state_size=H, num_layers=L, mode="lstm", name="lstm")
    y = tsym.swapaxes(rnn, dim1=0, dim2=1)
    pred = tsym.FullyConnected(y, num_hidden=V, flatten=False, name="pred")
    pred = tsym.reshape(pred, shape=(-1, V))
    return tsym.SoftmaxOutput(pred, tsym.reshape(label, shape=(-1,)),
                              name="softmax", use_ignore=True,
                              ignore_label=0)


GRAPHS = {"mlp": (_mlp, dict(data=(6, 7))),
          "cnn": (_cnn, dict(data=(4, 3, 8, 8))),
          "lstm_lm": (_lstm_lm, dict(data=(3, 5), softmax_label=(3, 5)))}


# -- the registry --------------------------------------------------------------


def _port_ops():
    from mxnet_tpu_torch.ops import registry

    return [n for n, _ in registry.canonical_items()]


@pytest.mark.parametrize("name", _port_ops())
def test_registry_metadata_matches_jax(name):
    """Every op the port registers carries the JAX entry's metadata (the
    port's ``arange`` op aside: the JAX package makes ``nd.arange`` outside
    its registry)."""
    import mxnet_tpu.subgraph  # noqa: F401  (registers the fused op)
    import mxnet_tpu.symbol  # noqa: F401  (registers the scalar ops)
    from mxnet_tpu.ops import registry as jreg
    from mxnet_tpu_torch.ops import registry

    t = registry.entry(name)
    if name == "arange":
        assert not jreg.exists(name) and t.arg_names == () and t.nondiff
        return
    j = jreg.get(name)
    for key in ("arg_names", "needs_rng", "train_aware", "nondiff",
                "variadic", "num_outputs", "mutate_aux"):
        assert getattr(t, key) == getattr(j, key), key
    assert registry.get(name) is t.fn


def test_symbol_op_names_cover_the_operators():
    """The names ``Symbol``'s operators emit exist in the port."""
    from mxnet_tpu_torch.ops import registry

    for name in ("broadcast_add", "broadcast_sub", "broadcast_mul",
                 "broadcast_div", "broadcast_power", "negative",
                 "_plus_scalar", "_minus_scalar", "_rminus_scalar",
                 "_mul_scalar", "_div_scalar", "_rdiv_scalar",
                 "_power_scalar", "SoftmaxOutput", "LinearRegressionOutput",
                 "LogisticRegressionOutput", "MAERegressionOutput",
                 "SVMOutput", "make_loss", "MakeLoss", "stop_gradient",
                 "BlockGrad", "Custom"):
        assert registry.exists(name), name


# -- composition and naming ----------------------------------------------------


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_graph_queries_and_json_match_jax(graph):
    jmx = _jmx()
    build, shapes = GRAPHS[graph]
    with tmx.name.NameManager():
        t = build()
    jsym = jmx.sym.fromjson(t.tojson())
    assert jsym.tojson() == t.tojson()
    assert t.list_arguments() == jsym.list_arguments()
    assert t.list_auxiliary_states() == jsym.list_auxiliary_states()
    assert t.list_outputs() == jsym.list_outputs()
    assert t.list_inputs() == jsym.list_inputs()
    assert t.attr_dict() == jsym.attr_dict()
    assert t.infer_shape(**shapes) == jsym.infer_shape(**shapes)
    assert t.infer_type() == jsym.infer_type()
    got = t.get_internals()
    want = jsym.get_internals()
    assert [s.list_outputs()[s._index] for s in got] == \
        [s.list_outputs()[s._index] for s in want]


def test_auto_names_match_jax():
    jmx = _jmx()

    def build(mx):
        x = mx.sym.var("x")
        a = mx.sym.Activation(mx.sym.FullyConnected(x, num_hidden=3),
                              act_type="relu")
        with mx.name.Prefix("blk_"):
            b = mx.sym.FullyConnected(a, num_hidden=2) + 1.0
        return mx.sym.Group([a * 2, -b, 3.0 - b, 1.0 / (b ** 2)])

    with tmx.name.NameManager():
        t = build(tmx)
    with jmx.name.NameManager():
        j = build(jmx)
    assert t.tojson() == j.tojson()


def test_json_written_by_jax_loads_in_the_port(tmp_path):
    jmx = _jmx()
    with jmx.name.NameManager():
        x = jmx.sym.var("data")
        j = jmx.sym.SoftmaxOutput(jmx.sym.FullyConnected(
            jmx.sym.BatchNorm(jmx.sym.Convolution(
                x, kernel=(3, 3), num_filter=2), fix_gamma=False),
            num_hidden=4), name="softmax")
    j.save(str(tmp_path / "j-symbol.json"))
    t = tsym.load(str(tmp_path / "j-symbol.json"))
    assert t.tojson() == j.tojson()
    shapes = dict(data=(2, 3, 6, 6))
    assert t.infer_shape(**shapes) == j.infer_shape(**shapes)
    t.save(str(tmp_path / "t-symbol.json"))
    assert (tmp_path / "t-symbol.json").read_text() == \
        (tmp_path / "j-symbol.json").read_text()


def test_nhwc_convolution_fails_shape_inference_like_jax():
    """ROADMAP caveat (m): the weight of a channel-last convolution is
    filled from ``x[1]`` (a spatial dim), in both packages: one such
    convolution infers the same wrong weight shape, and a second one after
    it makes ``infer_shape`` (so ``Module.bind``) fail in both."""
    jmx = _jmx()
    x = tsym.var("data")
    one = tsym.BatchNorm(tsym.Convolution(x, kernel=(3, 3), num_filter=4,
                                          layout="NHWC", no_bias=True),
                         axis=-1)
    shapes = dict(data=(2, 8, 8, 3))
    got = one.infer_shape(**shapes)
    assert got == jmx.sym.fromjson(one.tojson()).infer_shape(**shapes)
    assert got[0][1] == (4, 8, 3, 3)
    two = tsym.Convolution(one, kernel=(3, 3), num_filter=5, layout="NHWC",
                           no_bias=True)
    with pytest.raises(MXNetError, match="infer_shape failed"):
        two.infer_shape(**shapes)
    with pytest.raises(jmx.base.MXNetError, match="infer_shape failed"):
        jmx.sym.fromjson(two.tojson()).infer_shape(**shapes)


def test_infer_shape_partial_and_missing():
    x = tsym.var("data")
    y = tsym.FullyConnected(x, num_hidden=3, name="fc") + tsym.var("other")
    args, outs, _ = y.infer_shape_partial(data=(2, 4))
    assert args == [(2, 4), (3, 4), (3,), None] and outs is None
    with pytest.raises(MXNetError, match="other"):
        y.infer_shape(data=(2, 4))


def test_zeros_raises_as_in_jax():
    """ROADMAP caveat (o): symbolic creation ops are not ported."""
    with pytest.raises(MXNetError, match="sym.zeros"):
        tsym.zeros((2, 3))


def test_method_style_ops_and_indexing():
    x = tsym.var("x")
    y = x.reshape(shape=(-1,))
    assert y.attr("shape") == (-1,)
    bn = tsym.BatchNorm(x, name="bn")
    assert len(list(bn)) == 3 and bn["bn_output1"]._index == 1
    with pytest.raises(AttributeError):
        x.no_such_op
    with pytest.raises(MXNetError, match="requires Symbol inputs"):
        tsym.broadcast_add(x, 1.0)


# -- the executor --------------------------------------------------------------


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("is_train", [False, True])
def test_forward_backward_match_jax(graph, is_train):
    build, shapes = GRAPHS[graph]
    with tmx.name.NameManager():
        t = build()
    labels = {"softmax_label": {"mlp": 5, "cnn": 6, "lstm_lm": 30}[graph]}
    if graph == "lstm_lm":
        labels["data"] = 30
    args, aux = _arrays(t, seed=3, labels=labels, **shapes)
    tex, jex = _bind_both(t, args, aux)
    for o_t, o_j in zip(tex.forward(is_train=is_train),
                        jex.forward(is_train=is_train)):
        _close(o_t.asnumpy(), o_j.asnumpy())
    tex.backward()
    jex.backward()
    for name in args:
        _close(tex.grad_dict[name].asnumpy(), jex.grad_dict[name].asnumpy())
    for name in aux:
        _close(tex.aux_dict[name].asnumpy(), jex.aux_dict[name].asnumpy())


@pytest.mark.parametrize("req", ["write", "add", "null"])
def test_grad_req_matches_jax(req):
    t = _mlp()
    args, aux = _arrays(t, seed=5, labels={"softmax_label": 5},
                        data=(4, 7))
    tex, jex = _bind_both(t, args, aux, grad_req=req)
    for ex in (tex, jex):
        for _ in range(2):
            ex.forward(is_train=True)
            ex.backward()
    for name in args:
        _close(tex.grad_dict[name].asnumpy(), jex.grad_dict[name].asnumpy())
    if req == "null":
        assert all(not tex.grad_dict[n].asnumpy().any() for n in args)


def test_out_grads_and_backward_after_a_predict_forward():
    t = _mlp(bn=False, head=None)
    args, aux = _arrays(t, seed=6, data=(4, 7))
    tex, jex = _bind_both(t, args, aux)
    og = _rand((4, 5), 7)
    tex.forward(is_train=False)
    jex.forward(is_train=False)
    tex.backward(tmx.nd.array(og, ctx=CPU))
    jex.backward(_jmx().nd.array(og))
    for name in args:
        _close(tex.grad_dict[name].asnumpy(), jex.grad_dict[name].asnumpy())


def test_backward_before_forward_raises():
    tex, _ = _bind_both(_mlp(bn=False), *_arrays(
        _mlp(bn=False), seed=1, labels={"softmax_label": 5}, data=(2, 7)))
    with pytest.raises(MXNetError, match="backward before forward"):
        tex.backward()


def test_simple_bind_eval_and_copy_params_from():
    t = _mlp(bn=False)
    ex = t.simple_bind(CPU, data=(3, 7), softmax_label=(3,))
    assert [a.shape for a in ex.arg_arrays] == \
        t.infer_shape(data=(3, 7), softmax_label=(3,))[0]
    args, _ = _arrays(t, seed=8, labels={"softmax_label": 5}, data=(3, 7))
    ex.copy_params_from({k: tmx.nd.array(v, ctx=CPU)
                         for k, v in args.items()})
    out = ex.forward()[0].asnumpy()
    got = t.eval(CPU, **{k: tmx.nd.array(v, ctx=CPU)
                         for k, v in args.items()})[0].asnumpy()
    np.testing.assert_array_equal(out, got)
    with pytest.raises(MXNetError, match="unknown argument"):
        ex.copy_params_from({"nope": tmx.nd.zeros((1,), ctx=CPU)})
    ex.copy_params_from({"nope": tmx.nd.zeros((1,), ctx=CPU)},
                        allow_extra_params=True)


def test_arithmetic_matches_jax():
    jmx = _jmx()
    a, b = tsym.var("a"), tsym.var("b")
    outs = [a + b, a - b, a * b, a / b, a ** 2.0, -a, a + 1.5, a - 2.0,
            3.0 - a, a * 0.5, a / 4.0, 2.0 / b, b ** a, 1.0 + a, 2.0 * b]
    g = tsym.Group(outs)
    av = np.abs(_rand((3, 4), 1)) + 0.5
    bv = np.abs(_rand((3, 4), 2)) + 0.5
    tout = g.eval(CPU, a=tmx.nd.array(av, ctx=CPU),
                  b=tmx.nd.array(bv, ctx=CPU))
    jout = jmx.sym.fromjson(g.tojson()).eval(
        jmx.cpu(), a=jmx.nd.array(av), b=jmx.nd.array(bv))
    assert len(tout) == len(outs)
    for o_t, o_j in zip(tout, jout):
        _close(o_t.asnumpy(), o_j.asnumpy())


def test_internals_bind_to_a_hidden_output():
    t = _cnn()
    inner = t.get_internals()["relu1_output"]
    args, aux = _arrays(t, seed=9, labels={"softmax_label": 6},
                        data=(2, 3, 8, 8))
    names = inner.list_arguments()
    tex, jex = _bind_both(inner, {n: args[n] for n in names}, aux)
    _close(tex.forward()[0].asnumpy(), jex.forward()[0].asnumpy())
    assert t.get_internals()["fc"].name == "fc"


def test_group2ctx_places_stages_and_matches_the_unplaced_graph():
    """``AttrScope(ctx_group=...)`` with ``group2ctx`` over cpu(0)/cpu(1):
    forward, backward and the BatchNorm update equal the unplaced run's,
    and the JAX package's placed run."""
    jmx = _jmx()
    x = tsym.var("data")
    with tmx.AttrScope(ctx_group="stage1"):
        h = tsym.FullyConnected(x, num_hidden=8, name="fc1")
        h = tsym.BatchNorm(h, fix_gamma=False, name="bn1")
    with tmx.AttrScope(ctx_group="stage2"):
        h = tsym.Activation(h, act_type="relu")
        out = tsym.SoftmaxOutput(tsym.FullyConnected(h, num_hidden=3,
                                                     name="fc2"),
                                 name="softmax")
    assert out.attr_dict()["fc1"]["__ctx_group__"] == "stage1"
    args, aux = _arrays(out, seed=10, labels={"softmax_label": 3},
                        data=(4, 5))
    placed, jex = _bind_both(out, args, aux)
    placed = out.bind(CPU, {k: tmx.nd.array(v, ctx=CPU)
                            for k, v in args.items()},
                      args_grad={k: tmx.nd.zeros(v.shape, ctx=CPU)
                                 for k, v in args.items()},
                      aux_states={k: tmx.nd.array(v, ctx=CPU)
                                  for k, v in aux.items()},
                      group2ctx={"stage1": tmx.cpu(0),
                                 "stage2": tmx.cpu(1)})
    plain, _ = _bind_both(out, args, aux)
    jex = _jmx().sym.fromjson(out.tojson()).bind(
        jmx.cpu(), {k: jmx.nd.array(v) for k, v in args.items()},
        args_grad={k: jmx.nd.zeros(v.shape) for k, v in args.items()},
        aux_states={k: jmx.nd.array(v) for k, v in aux.items()},
        group2ctx={"stage1": jmx.cpu(0), "stage2": jmx.cpu(1)})
    outs = [ex.forward(is_train=True)[0].asnumpy()
            for ex in (placed, plain, jex)]
    for ex in (placed, plain, jex):
        ex.backward()
    np.testing.assert_array_equal(outs[0], outs[1])
    _close(outs[0], outs[2])
    for name in args:
        np.testing.assert_array_equal(placed.grad_dict[name].asnumpy(),
                                      plain.grad_dict[name].asnumpy())
        _close(placed.grad_dict[name].asnumpy(),
               jex.grad_dict[name].asnumpy())
    for name in aux:
        _close(placed.aux_dict[name].asnumpy(), jex.aux_dict[name].asnumpy())


# -- the loss heads ------------------------------------------------------------


def _head_grads(head, data, label, **attrs):
    """Forward and data gradient of one loss head in both packages (the
    head's gradient, whatever the cotangent)."""
    d, lab = tsym.var("data"), tsym.var("label")
    t = getattr(tsym, head)(d, lab, name="head", **attrs)
    args = {"data": data, "label": label}
    tex, jex = _bind_both(t, args, {})
    outs = (tex.forward(is_train=True)[0].asnumpy(),
            jex.forward(is_train=True)[0].asnumpy())
    tex.backward()
    jex.backward()
    return outs, (tex.grad_dict["data"].asnumpy(),
                  jex.grad_dict["data"].asnumpy()), tex


@pytest.mark.parametrize("attrs", [
    {}, {"normalization": "batch"}, {"normalization": "valid"},
    {"use_ignore": True, "ignore_label": 2.0, "normalization": "valid"},
    {"grad_scale": 0.5, "smooth_alpha": 0.1},
    {"preserve_shape": True}], ids=lambda a: ",".join(map(str, a.values()))
    or "defaults")
def test_softmax_output_matches_jax(attrs):
    data = _rand((6, 4), 11)
    label = np.random.RandomState(12).randint(0, 4, 6).astype(np.float32)
    (ot, oj), (gt, gj), tex = _head_grads("SoftmaxOutput", data, label,
                                          **attrs)
    _close(ot, oj)
    _close(gt, gj)
    assert not tex.grad_dict["label"].asnumpy().any()


def test_softmax_output_multi_axis_and_one_hot_labels():
    data = _rand((2, 3, 4), 13)
    ids = np.random.RandomState(14).randint(0, 3, (2, 4)).astype(np.float32)
    (ot, oj), (gt, gj), _ = _head_grads("SoftmaxOutput", data, ids)
    _close(ot, oj)
    _close(gt, gj)
    dense = _rand((5, 3), 15)
    (ot, oj), (gt, gj), _ = _head_grads("SoftmaxOutput", _rand((5, 3), 16),
                                        np.abs(dense))
    _close(gt, gj)


@pytest.mark.parametrize("head", ["LinearRegressionOutput",
                                  "LogisticRegressionOutput",
                                  "MAERegressionOutput"])
def test_regression_outputs_match_jax(head):
    data, label = _rand((5, 3), 17), _rand((5, 3), 18)
    (ot, oj), (gt, gj), _ = _head_grads(head, data, label, grad_scale=0.7)
    _close(ot, oj)
    _close(gt, gj)


@pytest.mark.parametrize("use_linear", [False, True])
def test_svm_output_matches_jax(use_linear):
    data = _rand((6, 4), 19)
    label = np.random.RandomState(20).randint(0, 4, 6).astype(np.float32)
    (ot, oj), (gt, gj), _ = _head_grads("SVMOutput", data, label,
                                        margin=0.8, use_linear=use_linear,
                                        regularization_coefficient=1.5)
    _close(ot, oj)
    _close(gt, gj)


def test_make_loss_and_block_grad_match_jax():
    jmx = _jmx()
    x, w = tsym.var("x"), tsym.var("w")
    stopped = tsym.BlockGrad(x * w)
    loss = tsym.MakeLoss(tsym.sum(tsym.square(x * w) + stopped * x))
    args = {"x": _rand((3, 2), 21), "w": _rand((3, 2), 22)}
    tex, jex = _bind_both(loss, args, {})
    _close(tex.forward(is_train=True)[0].asnumpy(),
           jex.forward(is_train=True)[0].asnumpy())
    tex.backward()
    jex.backward()
    for n in args:
        _close(tex.grad_dict[n].asnumpy(), jex.grad_dict[n].asnumpy())
    assert jmx  # the JAX package ran the same graph


# -- custom operators ----------------------------------------------------------


def _register_scale(mx, op_name):
    class Scale(mx.operator.CustomOp):
        def __init__(self, k):
            self.k = k

        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0],
                        mx.nd.array(in_data[0].asnumpy() * self.k))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0],
                        mx.nd.array(out_grad[0].asnumpy() * self.k
                                    + in_data[0].asnumpy()))

    @mx.operator.register(op_name)
    class ScaleProp(mx.operator.CustomOpProp):
        def __init__(self, k="2.0"):
            super().__init__(need_top_grad=True)
            self.k = float(k)

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return Scale(self.k)

    return ScaleProp


def test_custom_op_matches_jax():
    jmx = _jmx()
    _register_scale(jmx, "port_parity_scale")
    with CPU:
        _register_scale(tmx, "port_parity_scale")
        assert "port_parity_scale" in \
            tmx.operator.get_all_registered_operators()
        x = tsym.var("x")
        y = tsym.sum(tsym.Custom(x * 2.0, op_type="port_parity_scale",
                                 k=3.0))
        args = {"x": _rand((2, 5), 23)}
        tex, jex = _bind_both(y, args, {})
        _close(tex.forward(is_train=True)[0].asnumpy(),
               jex.forward(is_train=True)[0].asnumpy())
        tex.backward()
        jex.backward()
        _close(tex.grad_dict["x"].asnumpy(), jex.grad_dict["x"].asnumpy())
    with pytest.raises(MXNetError, match="not registered"):
        tmx.nd.Custom(torch.zeros(2), op_type="no_such_custom_op")


def test_attr_scope_nests_and_tags_variables():
    with tmx.AttrScope(ctx_group="a", lr_mult="2"):
        v = tsym.var("v")
        with tmx.AttrScope(ctx_group="b"):
            w = tsym.var("w")
    assert v.attr("ctx_group") == "a" and w.attr("ctx_group") == "b"
    assert w.attr("lr_mult") == "2"
    assert tsym.var("u").attr("ctx_group") is None
    assert tmx.attribute.AttrScope is tmx.AttrScope
    d = json.loads(tsym.Group([v, w]).tojson())
    assert d["arg_nodes"] == [0, 1]


@pytest.mark.gpu
def test_lstm_lm_graph_on_the_card_matches_the_cpu():
    """The LSTM LM graph bound on gpu(0) (the recurrence kernels) against
    the same graph on the CPU: outputs and gradients within the RNN tests'
    tolerances (1e-4 relative, ``tests/test_torch_rnn.py``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine with -m gpu")
    t = _lstm_lm(V=200, E=32, H=64)
    args, aux = _arrays(t, seed=24, labels={"softmax_label": 200,
                                            "data": 200},
                        data=(8, 20), softmax_label=(8, 20))
    res = []
    for ctx in (CPU, tmx.gpu(0)):
        ex = t.bind(ctx, {k: tmx.nd.array(v, ctx=ctx)
                          for k, v in args.items()},
                    args_grad={k: tmx.nd.zeros(v.shape, ctx=ctx)
                               for k, v in args.items()})
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward()
        res.append((out, {k: ex.grad_dict[k].asnumpy() for k in args}))
    np.testing.assert_allclose(res[1][0], res[0][0], rtol=1e-4, atol=1e-6)
    for k in args:
        a, b = res[1][1][k], res[0][1][k]
        assert np.linalg.norm(a - b) <= 1e-4 * max(np.linalg.norm(b), 1e-6)
