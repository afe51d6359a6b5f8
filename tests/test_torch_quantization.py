"""The int8 tier of the PyTorch port against the JAX package, on the CPU.

Every op of ``ops/quantization.py`` gets the same numpy inputs (made from
a seed) in both packages: int8, uint8 and int32 outputs are equal, float
outputs agree within 1e-6 absolute.  The calibration statistics, the KL
threshold search and ``quantize_net`` (calibrated ranges within 1e-6
relative of the JAX package's) follow, then a quantized ``bert_tiny`` fed
the JAX package's int8 model (its ``qweight``, ``wscale`` and ranges
carried across by ``load_numpy_params``).  ``quantize_model`` rewrites the
same symbol in both packages (an FC graph, a no-bias convolution, a
calibrated FC and an exported LeNet): the rewritten JSON node for node
(calibrated ranges within 1e-6 relative), the offline-quantized weights
equal, every int8/int32 value of the bound graph equal and its output
within 1e-6 absolute.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib import quantization as tqz
from mxnet_tpu_torch.ops import quantization as tq

FLOAT_ATOL = 1e-6


def _jop(name):
    from mxnet_tpu.ops import registry

    return registry.get(name).fn


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale) \
        .astype(np.float32)


def _i8(*shape, seed=0):
    return np.random.RandomState(seed).randint(
        -127, 128, size=shape).astype(np.int8)


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    import jax.numpy as jnp

    return jnp.asarray(a)


def _same(t_out, j_out):
    """Integer outputs equal, float outputs within FLOAT_ATOL."""
    t_out = t_out if isinstance(t_out, (tuple, list)) else (t_out,)
    j_out = j_out if isinstance(j_out, (tuple, list)) else (j_out,)
    assert len(t_out) == len(j_out)
    for t, j in zip(t_out, j_out):
        t, j = t.numpy(), np.asarray(j)
        assert t.shape == j.shape, (t.shape, j.shape)
        if np.issubdtype(j.dtype, np.integer):
            assert t.dtype == j.dtype
            np.testing.assert_array_equal(t, j)
        else:
            np.testing.assert_allclose(t, j, atol=FLOAT_ATOL, rtol=0)


# -- the ops ------------------------------------------------------------------


@pytest.mark.parametrize("out_type", ["int8", "uint8"])
def test_quantize_matches_jax(out_type):
    x = _rand(4, 33, seed=1, scale=2.0)
    _same(tq._k_quantize(_t(x), -1.5, 2.5, out_type=out_type),
          _jop("_contrib_quantize")(_j(x), -1.5, 2.5, out_type=out_type))


@pytest.mark.parametrize("calib", [None, (-0.75, 1.25)])
def test_quantize_v2_matches_jax(calib):
    x = _rand(3, 17, seed=2)
    kw = {} if calib is None else {"min_calib_range": calib[0],
                                   "max_calib_range": calib[1]}
    _same(tq._k_quantize_v2(_t(x), **kw),
          _jop("_contrib_quantize_v2")(_j(x), **kw))


@pytest.mark.parametrize("kind", ["int8", "uint8", "int32", "per_channel"])
def test_dequantize_matches_jax(kind):
    rs = np.random.RandomState(3)
    if kind == "uint8":
        q = rs.randint(0, 256, size=(5, 7)).astype(np.uint8)
    elif kind == "int32":
        q = rs.randint(-2**30, 2**30, size=(5, 7)).astype(np.int32)
    else:
        q = _i8(5, 7, seed=3)
    mn, mx = np.float32(-0.8), np.float32(1.3)
    if kind == "per_channel":
        mn = -np.abs(_rand(7, seed=4))
        mx = np.abs(_rand(7, seed=5))
    _same(tq._k_dequantize(_t(q), _t(mn), _t(mx)),
          _jop("_contrib_dequantize")(_j(q), _j(mn), _j(mx)))


@pytest.mark.parametrize("calib", [None, (-3.0, 2.0)])
def test_requantize_matches_jax(calib):
    q = np.random.RandomState(6).randint(-2**28, 2**28, size=(6, 9)) \
        .astype(np.int32)
    kw = {} if calib is None else {"min_calib_range": calib[0],
                                   "max_calib_range": calib[1]}
    _same(tq._k_requantize(_t(q), -40.0, 40.0, **kw),
          _jop("_contrib_requantize")(_j(q), -40.0, 40.0, **kw))


@pytest.mark.parametrize("act", [None, "relu"])
def test_requantize_v2_matches_jax(act):
    q = np.random.RandomState(7).randint(-2**28, 2**28, size=(6, 9)) \
        .astype(np.int32)
    r = np.abs(_rand(9, seed=8)) * 100     # per-channel accumulator range
    args = (-r, r, np.float32(-2.5), np.float32(3.0))
    _same(tq._k_requantize_v2(_t(q), *map(_t, args), act=act),
          _jop("_contrib_requantize_v2")(_j(q), *map(_j, args), act=act))


@pytest.mark.parametrize("no_bias,flatten", [(False, True), (True, True),
                                             (False, False)])
def test_quantized_fully_connected_matches_jax(no_bias, flatten):
    x = _i8(3, 4, 10, seed=9)
    w = _i8(6, 40 if flatten else 10, seed=10)
    b = _i8(6, seed=11)
    ranges = [np.float32(v) for v in (-1.0, 1.5, -0.3, 0.2, -0.1, 0.05)]
    if no_bias:
        args = (None,) + tuple(ranges[:4])
    else:
        args = (b, ranges[0], ranges[1], ranges[2], ranges[3], ranges[4],
                ranges[5])
    kw = dict(num_hidden=6, no_bias=no_bias, flatten=flatten)
    t = tq._k_quantized_fully_connected(
        _t(x), _t(w), *[None if a is None else _t(a) for a in args], **kw)
    j = _jop("_contrib_quantized_fully_connected")(
        _j(x), _j(w), *[None if a is None else _j(a) for a in args], **kw)
    _same(t, j)


_CONVS = [dict(kernel=(3, 3)),
          dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1)),
          dict(kernel=(1, 1), num_group=2),
          dict(kernel=(3, 3), dilate=(2, 2), pad=(2, 2), no_bias=True),
          dict(kernel=(3,), pad=(1,)),
          dict(kernel=(3, 3, 3), pad=(1, 1, 1)),
          dict(kernel=(3, 2, 3), stride=(2, 1, 2), dilate=(1, 2, 1),
               num_group=2, no_bias=True)]


@pytest.mark.parametrize("conv", _CONVS)
def test_quantized_conv_matches_jax(conv):
    conv = dict(conv)
    nd = len(conv["kernel"])
    no_bias = conv.pop("no_bias", False)
    g = conv.get("num_group", 1)
    x = _i8(*((2, 4) + (9,) * nd), seed=12)
    w = _i8(*((6, 4 // g) + conv["kernel"]), seed=13)
    b = _i8(6, seed=14)
    ranges = (np.float32(-2.0), np.float32(1.0), np.float32(-0.5),
              np.float32(0.5))
    args = ((None,) + ranges if no_bias
            else (b,) + ranges + (np.float32(-0.2), np.float32(0.2)))
    kw = dict(conv, num_filter=6, no_bias=no_bias)
    t = tq._k_quantized_conv(
        _t(x), _t(w), *[None if a is None else _t(a) for a in args], **kw)
    j = _jop("_contrib_quantized_conv")(
        _j(x), _j(w), *[None if a is None else _j(a) for a in args], **kw)
    _same(t, j)


@pytest.mark.parametrize("no_bias", [False, True])
def test_quantized_dense_pc_matches_jax(no_bias):
    x = _i8(5, 24, seed=15)
    w = _i8(7, 24, seed=16)
    wr = np.abs(_rand(7, seed=17)) + 0.1
    b = _rand(7, seed=18)
    rest = ((np.float32(-1.2), np.float32(0.9)) if no_bias
            else (b, np.float32(-1.2), np.float32(0.9)))
    t = tq._k_quantized_dense_pc(_t(x), _t(w), _t(wr), *map(_t, rest),
                                 num_hidden=7, no_bias=no_bias)
    j = _jop("_contrib_quantized_dense_pc")(
        _j(x), _j(w), _j(wr), *map(_j, rest), num_hidden=7,
        no_bias=no_bias)
    _same(t, j)


@pytest.mark.parametrize("no_bias", [False, True])
def test_quantized_conv_pc_matches_jax(no_bias):
    x = _i8(2, 3, 8, 8, seed=19)
    w = _i8(5, 3, 3, 3, seed=20)
    wr = np.abs(_rand(5, seed=21)) + 0.1
    b = _rand(5, seed=22)
    rest = ((np.float32(-1.0), np.float32(1.0)) if no_bias
            else (b, np.float32(-1.0), np.float32(1.0)))
    kw = dict(kernel=(3, 3), pad=(1, 1), num_filter=5, no_bias=no_bias)
    t = tq._k_quantized_conv_pc(_t(x), _t(w), _t(wr), *map(_t, rest), **kw)
    j = _jop("_contrib_quantized_conv_pc")(_j(x), _j(w), _j(wr),
                                           *map(_j, rest), **kw)
    _same(t, j)


@pytest.mark.parametrize("pool", [
    dict(kernel=(2, 2), stride=(2, 2), pool_type="max"),
    dict(kernel=(3, 3), pad=(1, 1), pool_type="max"),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg"),
    dict(kernel=(2,), pool_type="avg", dims=1),
    dict(global_pool=True, pool_type="max"),
    dict(global_pool=True, pool_type="avg")])
def test_quantized_pooling_matches_jax(pool):
    pool = dict(pool)
    nd = pool.pop("dims", 2)
    x = _i8(*((2, 3) + (7,) * nd), seed=23)
    _same(tq._k_quantized_pooling(_t(x), -1.0, 1.0, **pool),
          _jop("_contrib_quantized_pooling")(_j(x), -1.0, 1.0, **pool))


def test_quantized_flatten_matches_jax():
    x = _i8(2, 3, 4, seed=24)
    _same(tq._k_quantized_flatten(_t(x), -1.0, 1.0),
          _jop("_contrib_quantized_flatten")(_j(x), -1.0, 1.0))


def test_ops_reach_the_F_namespace():
    x = _t(_rand(2, 5, seed=25))
    q, mn, mx = tmx.nd.contrib.quantize_v2(x)
    assert q.dtype == torch.int8 and float(mx) == float(x.abs().max())
    assert tmx.nd.quantized_flatten is tmx.nd.contrib.quantized_flatten


# -- the s8 x s8 -> s32 product -----------------------------------------------


@pytest.mark.parametrize("mkn,want", [
    ((8, 64, 256), (32, 64, 256)),        # a decode step of 8 slots
    ((16, 768, 30522), (32, 768, 30528)),  # BERT's MLM decoder, 16 rows
    ((17, 12, 5), (17, 16, 8)),
    ((4096, 3072, 768), (4096, 3072, 768))])
def test_int_mm_padding_rule(mkn, want):
    """The shape cuBLAS is given: more than 16 rows, inner and outer
    sizes multiples of 8 (decided from the shapes alone)."""
    assert tq.int_mm_shape(*mkn) == want


@pytest.mark.parametrize("m,k,n", [(5, 12, 7), (1, 8, 3), (33, 40, 16)])
def test_int8_matmul_is_exact(m, k, n):
    x, w = _i8(m, k, seed=26), _i8(n, k, seed=27)
    got = tq.int8_matmul(_t(x), _t(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), x.astype(np.int64) @ w.astype(np.int64).T)


def test_int8_matmul_exact_at_full_range_on_the_host():
    """Full-range int8 operands at BERT's FFN depth (K = 3072), the values
    where a u8 x s8 pair sum of oneDNN's non-VNNI path saturates int16:
    the CPU product is exact."""
    rs = np.random.RandomState(70)
    x = rs.choice([-127, 127], size=(64, 3072)).astype(np.int8)
    w = rs.choice([-127, 127], size=(48, 3072)).astype(np.int8)
    got = tq.int8_matmul(_t(x), _t(w)).numpy()
    np.testing.assert_array_equal(
        got, x.astype(np.int64) @ w.astype(np.int64).T)


def test_int8_conv_exact_past_float32():
    """127 * 127 * K passes 2^24 at K = 2304 (256 channels, 3x3): the
    unfold + integer product stays exact where a float32 convolution
    rounds."""
    x = np.full((1, 256, 3, 3), 127, np.int8)
    w = np.full((2, 256, 3, 3), 127, np.int8)
    w[1] = -127
    w[1, 0, 0, 0] = 126
    out = tq._conv_i32(_t(x), _t(w), (3, 3), (), (), (), 1)
    want = np.array([127 * 127 * 2304, -127 * 127 * 2303 + 127 * 126])
    np.testing.assert_array_equal(out.numpy().reshape(2), want)
    f32 = torch.nn.functional.conv2d(_t(x).float(), _t(w).float())
    assert int(f32.reshape(2)[1]) != want[1]   # float32 rounds here


def test_int8_matmul_rejects_other_dtypes():
    with pytest.raises(MXNetError, match="int8"):
        tq.int8_matmul(torch.zeros(4, 8), torch.zeros(2, 8))


# -- calibration --------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_optimal_threshold_equals_jax(seed):
    from mxnet_tpu.contrib import quantization as jqz

    rs = np.random.RandomState(seed)
    a = np.concatenate([rs.randn(20000), rs.randn(40) * 12.0])
    assert tqz._get_optimal_threshold(a) == jqz._get_optimal_threshold(a)
    hist, edges = np.histogram(np.abs(a), bins=2001,
                               range=(0.0, np.abs(a).max()))
    assert tqz._optimal_threshold_from_hist(hist, edges) == \
        jqz._optimal_threshold_from_hist(hist, edges)


@pytest.mark.parametrize("entropy", [False, True])
def test_calib_stats_match_jax(entropy):
    """Same min/max, and in entropy mode the same |x| histogram, bin for
    bin (the JAX package's binning order, counted by bincount)."""
    from mxnet_tpu.contrib import quantization as jqz

    x = _rand(64, 257, seed=28, scale=3.0)
    t = tqz._k_calib_stats(_t(x), entropy=entropy)
    j = jqz._k_calib_stats(_j(x), entropy=entropy)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


FEAT = 20


def _jax_mlp(seed):
    import mxnet_tpu as jmx
    from mxnet_tpu.gluon import nn

    jmx.random.seed(seed)
    net = nn.HybridSequential()
    net.add(nn.Dense(32, activation="relu", in_units=FEAT),
            nn.Dense(32, activation="relu", in_units=32),
            nn.Dense(10, in_units=32))
    net.initialize(jmx.init.Xavier())
    return net


def _port_mlp(jnet):
    from mxnet_tpu_torch.gluon import nn

    net = nn.HybridSequential()
    net.add(nn.Dense(32, activation="relu", in_units=FEAT),
            nn.Dense(32, activation="relu", in_units=32),
            nn.Dense(10, in_units=32))
    net.initialize(ctx=tmx.cpu())
    tmx.load_numpy_params(net, {
        k: p.data().asnumpy().copy()
        for k, p in jnet._collect_params_with_prefix().items()})
    return net


def _params(net):
    return {k: np.array(v.data().asnumpy() if hasattr(v.data(), "asnumpy")
                        else v.data().detach().numpy())
            for k, v in net._collect_params_with_prefix().items()}


@pytest.mark.parametrize("mode", ["naive", "entropy"])
def test_quantize_net_ranges_match_jax(mode):
    """The same float32 weights and calibration batches give the same
    quantized weights and scales and, within 1e-6 relative, the same
    calibrated ranges in both packages."""
    from mxnet_tpu.contrib import quantization as jqz

    calib = _rand(96, FEAT, seed=29)
    batches = [calib[i:i + 32] for i in range(0, 96, 32)]
    jnet = _jax_mlp(31)
    tnet = _port_mlp(jnet)
    jqz.quantize_net(jnet, calib_data=iter(batches), calib_mode=mode)
    with tmx.cpu():
        tqz.quantize_net(tnet, calib_data=iter(batches), calib_mode=mode)
    jp, tp = _params(jnet), _params(tnet)
    assert sorted(jp) == sorted(tp)
    for k in jp:
        if k.endswith(("qweight", "wscale", "bias")):
            np.testing.assert_array_equal(tp[k], jp[k], err_msg=k)
        else:
            np.testing.assert_allclose(tp[k], jp[k], rtol=1e-6, atol=0,
                                       err_msg=k)
    assert [lyr._out_int8 for lyr in tnet._layers] == \
        [lyr._out_int8 for lyr in jnet._layers] == [True, True, False]


def test_quantize_net_outputs_match_jax_with_ranges_carried():
    """The JAX package's int8 MLP carried across: the same int8 model, the
    same logits within 1e-5 (the dequantized outputs are quanta of the
    calibrated range; both packages round the same values)."""
    import mxnet_tpu as jmx
    from mxnet_tpu.contrib import quantization as jqz

    calib = _rand(64, FEAT, seed=32)
    jnet = _jax_mlp(33)
    tnet = _port_mlp(jnet)
    jqz.quantize_net(jnet, calib_data=calib, calib_mode="naive")
    with tmx.cpu():
        tqz.quantize_net(tnet, calib_data=calib * 0.5, calib_mode="naive")
    tmx.load_numpy_params(tnet, _params(jnet))
    x = _rand(16, FEAT, seed=34)
    want = jnet(jmx.nd.array(x)).asnumpy()
    got = tnet(tmx.nd.array(x, ctx=tmx.cpu())).asnumpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_uncalibrated_port_net_adopts_the_jax_ranges():
    """``load_numpy_params`` gives a port net quantized without
    calibration the range parameters of a calibrated JAX net."""
    import mxnet_tpu as jmx
    from mxnet_tpu.contrib import quantization as jqz

    jnet = _jax_mlp(35)
    tnet = _port_mlp(jnet)
    jqz.quantize_net(jnet, calib_data=_rand(64, FEAT, seed=36),
                     calib_mode="naive", fold=False)
    with tmx.cpu():
        tqz.quantize_net(tnet)
    assert not any(lyr._calibrated for lyr in tnet._layers)
    tmx.load_numpy_params(tnet, _params(jnet))
    assert all(lyr._calibrated for lyr in tnet._layers)
    x = _rand(8, FEAT, seed=37)
    np.testing.assert_allclose(
        tnet(tmx.nd.array(x, ctx=tmx.cpu())).asnumpy(),
        jnet(jmx.nd.array(x)).asnumpy(), atol=1e-5, rtol=0)


VOCAB = 1000
# the int8 BERT's logits, port against the JAX package, both running the
# same int8 model: they differ by float32 rounding (the two packages sum
# the attention and LayerNorm in other orders, ~5e-8 of the norm at these
# seeds); an activation moved across a rounding boundary by it would cost
# one quantum of its calibrated range, ~1e-3 of the norm, and fail
BERT_REL_TOL = 1e-4


def _bert_calib_forward(pkg):
    def fwd(net, x):
        ids = x.asnumpy().astype(np.int32)
        ctx = {} if pkg is None else {"ctx": pkg.cpu()}
        mod = pkg or __import__("mxnet_tpu")
        net(mod.nd.array(ids, dtype="int32", **ctx),
            mod.nd.array(np.zeros_like(ids), dtype="int32", **ctx),
            mod.nd.array(np.full(ids.shape[0], ids.shape[1], np.float32),
                         **ctx))
    return fwd


def test_quantize_net_bert_tiny_matches_jax():
    """``quantize_net(bert_tiny)``: the 4 FFN Dense layers, the pooler and
    the three heads become int8 (the attention projections are raw
    parameters and stay float32); with the JAX package's int8 parameters
    carried across, the MLM and NSP logits agree within BERT_REL_TOL of
    their norm."""
    import mxnet_tpu as jmx
    from mxnet_tpu.contrib import quantization as jqz
    from mxnet_tpu.models.bert import bert_tiny

    rs = np.random.RandomState(38)
    calib = rs.randint(1, VOCAB, size=(8, 16)).astype(np.float32)
    jmx.random.seed(11)
    jnet = bert_tiny(vocab_size=VOCAB)
    jnet.initialize()
    jqz.quantize_net(jnet, calib_data=calib, calib_mode="naive",
                     calib_forward=_bert_calib_forward(None))
    tnet = tmx.models.bert_tiny(vocab_size=VOCAB)
    tnet.initialize(ctx=tmx.cpu())
    with tmx.cpu():
        tnet(*(tmx.nd.array(a) for a in (
            np.ones((1, 4), np.int32), np.zeros((1, 4), np.int32),
            np.full(1, 4, np.float32))))   # deferred shapes
        tqz.quantize_net(tnet)
    wrapped = sorted(p[:-1] for p, _ in tqz._iter_quantized(tnet))
    assert len(wrapped) == 8 and not any("attn" in p for p in wrapped)
    tmx.load_numpy_params(tnet, _params(jnet))
    ids = rs.randint(1, VOCAB, size=(3, 16)).astype(np.int32)
    valid = np.array([16, 9, 4], np.float32)
    jmlm, jnsp = jnet(jmx.nd.array(ids, dtype="int32"),
                      jmx.nd.array(np.zeros_like(ids), dtype="int32"),
                      jmx.nd.array(valid))
    cpu = tmx.cpu()
    tmlm, tnsp = tnet(tmx.nd.array(ids, ctx=cpu),
                      tmx.nd.array(np.zeros_like(ids), ctx=cpu),
                      tmx.nd.array(valid, ctx=cpu))
    for t, j in ((tmlm, jmlm), (tnsp, jnsp)):
        t, j = t.asnumpy(), j.asnumpy()
        assert t.shape == j.shape and np.isfinite(t).all()
        rel = np.linalg.norm(t - j) / np.linalg.norm(j)
        assert rel < BERT_REL_TOL, rel


# -- quantize_model: the symbolic graph rewrite --------------------------------


def _jsym():
    import mxnet_tpu as jmx
    from mxnet_tpu.contrib import quantization as jqz

    return jmx, jqz


def _int8_internals(qsym):
    """The graph's int8 values: every quantize, int8 product and requantize
    node's outputs (the values and their ranges)."""
    return [s for s in qsym.get_internals()
            if s.name.endswith(("_quantize", "_int8", "_requantize"))
            and s.list_arguments()]


def _bind_outputs(mx, sym, args, aux, x):
    feed = {k: v for k, v in dict(args, data=mx.nd.array(x)).items()
            if k in sym.list_arguments()}
    aux = {k: v for k, v in aux.items()
           if k in sym.list_auxiliary_states()}
    return [o.asnumpy() for o in sym.bind(
        mx.cpu(), feed, grad_req="null", aux_states=aux).forward()]


def _json_close(a, b):
    """Two symbol JSONs node for node; float attributes (calibrated ranges,
    from float32 statistics of each package's float32 graph) within 1e-6
    relative."""
    import json

    na, nb = json.loads(a)["nodes"], json.loads(b)["nodes"]
    assert [(n["op"], n["name"], n["inputs"]) for n in na] == \
        [(n["op"], n["name"], n["inputs"]) for n in nb]
    for x, y in zip(na, nb):
        assert x["attrs"].keys() == y["attrs"].keys()
        for k, v in x["attrs"].items():
            if k.endswith("calib_range"):
                np.testing.assert_allclose(float(v), float(y["attrs"][k]),
                                           rtol=1e-6)
            else:
                assert v == y["attrs"][k], (x["name"], k)


def _quantize_both(sym, args, aux, x, **kw):
    """``quantize_model`` of one graph in both packages (the port's JSON
    and arrays carried into the JAX package); the int8 internals and the
    output of each, bound on the CPU.  Integer values must be equal;
    float values (ranges, dequantized outputs) agree within FLOAT_ATOL
    relative to their scale."""
    jmx, jqz = _jsym()
    cpu = tmx.cpu()
    with cpu:
        targs = {k: tmx.nd.array(v) for k, v in args.items()}
        taux = {k: tmx.nd.array(v) for k, v in aux.items()}
        q, qa, qx = tqz.quantize_model(sym, targs, taux, **kw)
        tint = _bind_outputs(tmx, tmx.sym.Group(_int8_internals(q)), qa, qx,
                             x)
        tout = _bind_outputs(tmx, q, qa, qx, x)[0]
    jq, jqa, jqx = jqz.quantize_model(
        jmx.sym.fromjson(sym.tojson()),
        {k: jmx.nd.array(v) for k, v in args.items()},
        {k: jmx.nd.array(v) for k, v in aux.items()}, **kw)
    _json_close(q.tojson(), jq.tojson())
    assert sorted(qa) == sorted(jqa)
    for k in qa:
        np.testing.assert_array_equal(qa[k].asnumpy(), jqa[k].asnumpy())
    jint = _bind_outputs(jmx, jmx.sym.fromjson(
        tmx.sym.Group(_int8_internals(q)).tojson()), jqa, jqx, x)
    jout = _bind_outputs(jmx, jq, jqa, jqx, x)[0]
    assert len(tint) == len(jint) and tint
    for t, j in zip(tint, jint):
        assert t.dtype == j.dtype
        if np.issubdtype(t.dtype, np.integer):
            np.testing.assert_array_equal(t, j)
        else:
            np.testing.assert_allclose(t, j, rtol=FLOAT_ATOL, atol=0)
    np.testing.assert_allclose(tout, jout, atol=FLOAT_ATOL, rtol=0)
    return q, tout


def test_quantize_model_fc_graph_matches_jax():
    data = tmx.sym.var("data")
    fc = tmx.sym.FullyConnected(data, num_hidden=8, name="fcq")
    out = tmx.sym.FullyConnected(tmx.sym.Activation(fc, act_type="relu"),
                                 num_hidden=4, name="fcq2")
    args = {"fcq_weight": _rand(8, 12, seed=50, scale=0.5),
            "fcq_bias": _rand(8, seed=51, scale=0.1),
            "fcq2_weight": _rand(4, 8, seed=52, scale=0.5),
            "fcq2_bias": _rand(4, seed=53, scale=0.1)}
    x = _rand(6, 12, seed=54)
    q, got = _quantize_both(out, args, {}, x, calib_mode="none")
    with tmx.cpu():
        ref = out.eval(tmx.cpu(), data=tmx.nd.array(x), **{
            k: tmx.nd.array(v) for k, v in args.items()})[0].asnumpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 0.06
    assert "_contrib_quantized_fully_connected" in q.tojson()


def test_quantize_model_no_bias_conv_graph_matches_jax():
    data = tmx.sym.var("data")
    out = tmx.sym.Convolution(data, kernel=(3, 3), num_filter=8,
                              no_bias=True, name="convq")
    args = {"convq_weight": _rand(8, 3, 3, 3, seed=55, scale=0.2)}
    x = _rand(4, 3, 10, 10, seed=56)
    q, _ = _quantize_both(out, args, {}, x, calib_mode="none")
    import json
    node = [n for n in json.loads(q.tojson())["nodes"]
            if n["op"] == "_contrib_quantized_conv"][0]
    assert len(node["inputs"]) == 6 and node["attrs"]["no_bias"] == "True"


def test_quantize_model_calibrated_fc_matches_jax():
    data = tmx.sym.var("data")
    out = tmx.sym.FullyConnected(data, num_hidden=8, name="fcq")
    args = {"fcq_weight": _rand(8, 12, seed=57, scale=0.5),
            "fcq_bias": _rand(8, seed=58, scale=0.1)}
    calib = _rand(64, 12, seed=59)
    for mode in ("naive", "entropy"):
        q, _ = _quantize_both(out, args, {}, calib[:16], calib_mode=mode,
                              calib_data=calib)
        assert "_requantize" in q.tojson()


def test_quantize_model_exported_lenet_matches_jax(tmp_path):
    """An exported LeNet (the port's, from a seed) quantized with naive
    calibration in both packages: every int8 and int32 value of the
    graph equal, the output within FLOAT_ATOL; top-1 agreement with the
    float32 net at the JAX test's limit (0.75)."""
    cpu = tmx.cpu()
    x = np.random.RandomState(60).rand(4, 1, 28, 28).astype(np.float32)
    with cpu:
        tmx.random.seed(61)
        net = tmx.gluon.model_zoo.vision.lenet(prefix="lenet_")
        net.initialize(tmx.init.Xavier(), ctx=cpu)
        ref = net(tmx.nd.array(x)).asnumpy()
        with tmx.name.NameManager():
            net.export(str(tmp_path / "lenet"))
        sym, ap, xp = tmx.model.load_checkpoint(str(tmp_path / "lenet"), 0)
    args = {k: v.asnumpy() for k, v in ap.items()}
    q, got = _quantize_both(sym, args, {}, x, calib_mode="naive",
                            calib_data=x)
    assert q.tojson().count('"_contrib_quantized_conv"') == 2
    assert (got.argmax(1) == ref.argmax(1)).mean() >= 0.75


def test_quantize_model_rejects_and_excludes():
    data = tmx.sym.var("data")
    out = tmx.sym.FullyConnected(tmx.sym.FullyConnected(
        data, num_hidden=4, name="a"), num_hidden=2, name="b")
    args = {"a_weight": tmx.nd.array(_rand(4, 3, seed=62), ctx=tmx.cpu()),
            "a_bias": tmx.nd.array(_rand(4, seed=63), ctx=tmx.cpu()),
            "b_weight": tmx.nd.array(_rand(2, 4, seed=64), ctx=tmx.cpu()),
            "b_bias": tmx.nd.array(_rand(2, seed=65), ctx=tmx.cpu())}
    with tmx.cpu():
        q, qa, _ = tqz.quantize_model(out, args, excluded_sym_names=["b"])
        with pytest.raises(MXNetError, match="needs calib_data"):
            tqz.quantize_model(out, args, calib_mode="naive")
        with pytest.raises(MXNetError, match="quantized_dtype"):
            tqz.quantize_model(out, args, quantized_dtype="uint8")
    assert "b_weight" in qa and "a_weight_quantize" in qa
    assert q.tojson().count("_contrib_quantized_fully_connected") == 1


@pytest.mark.parametrize("no_bias", [False, True])
def test_quantized_conv_pc_3d_matches_jax(no_bias):
    x = _i8(2, 3, 6, 7, 5, seed=66)
    w = _i8(4, 3, 3, 3, 2, seed=67)
    wr = np.abs(_rand(4, seed=68)) + 0.1
    b = _rand(4, seed=69)
    rest = ((np.float32(-1.0), np.float32(1.0)) if no_bias
            else (b, np.float32(-1.0), np.float32(1.0)))
    kw = dict(kernel=(3, 3, 2), pad=(1, 0, 1), stride=(1, 2, 1),
              num_filter=4, no_bias=no_bias)
    t = tq._k_quantized_conv_pc(_t(x), _t(w), _t(wr), *map(_t, rest), **kw)
    j = _jop("_contrib_quantized_conv_pc")(_j(x), _j(w), _j(wr),
                                           *map(_j, rest), **kw)
    _same(t, j)


# -- the port's own contracts -------------------------------------------------


def _tmlp(seed):
    from mxnet_tpu_torch.gluon import nn

    tmx.random.seed(seed)
    net = nn.HybridSequential()
    net.add(nn.Dense(32, activation="relu", in_units=FEAT),
            nn.Dense(32, activation="relu", in_units=32),
            nn.Dense(10, in_units=32))
    net.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    return net


def test_quantized_net_tracks_float32_and_folds():
    x = _rand(16, FEAT, seed=39)
    net = _tmlp(40)
    with tmx.cpu():
        ref = net(tmx.nd.array(x)).asnumpy()
        tqz.reset_quantize_stats()
        tqz.quantize_net(net, calib_data=_rand(64, FEAT, seed=41),
                         calib_mode="naive")
        got = net(tmx.nd.array(x)).asnumpy()
    assert all(type(lyr).__name__ == "QuantizedDense"
               for lyr in net._layers)
    err = np.abs(got - ref).max()
    assert 0 < err < 0.08 * np.abs(ref).max()
    st = tmx.profiler.sections()["quantize"]
    assert st["layers_quantized"] == 3 and st["requant_folds"] == 2
    assert st["calib_batches"] == 1 and st["calib_ms"] > 0


def test_quantized_net_hybridizes_and_drops_stale_graphs():
    net = _tmlp(42)
    net.hybridize()
    x = tmx.nd.array(_rand(8, FEAT, seed=43), ctx=tmx.cpu())
    ref = net(x).asnumpy()
    with tmx.cpu():
        tqz.quantize_net(net, calib_data=_rand(32, FEAT, seed=44))
    assert net._cached_op is None and net._active
    got = net(x).asnumpy()
    assert 0 < np.abs(got - ref).max() < 0.08 * np.abs(ref).max()


def test_requantize_from_writes_in_place_against_stored_scales():
    """A reload writes the existing Parameters' values (a captured graph
    reads them where they live): same tensors, new int8 weights at the
    stored scales, ranges kept."""
    src = _tmlp(45)
    net = _tmlp(46)
    with tmx.cpu():
        tqz.quantize_net(net, calib_data=_rand(32, FEAT, seed=47))
    first = net._layers[0]
    tensors = {k: p.data() for k, p in
               net._collect_params_with_prefix().items()}
    scales = first.wscale.data().numpy().copy()
    in_max = float(first.in_max.data())
    tqz.apply_fp32_params(net, {k: p.data() for k, p in
                                src._collect_params_with_prefix().items()})
    assert all(p.data() is tensors[k] for k, p in
               net._collect_params_with_prefix().items())
    w = src._layers[0].weight.data().detach().numpy()
    expect = np.clip(np.round(w * (127.0 / scales[:, None])),
                     -127, 127).astype(np.int8)
    np.testing.assert_array_equal(first.qweight.data().numpy(), expect)
    np.testing.assert_array_equal(first.wscale.data().numpy(), scales)
    assert float(first.in_max.data()) == in_max


def test_load_serving_params_both_flavours_and_mismatch():
    net = _tmlp(48)
    with tmx.cpu():
        tqz.quantize_net(net, calib_data=_rand(32, FEAT, seed=49))
    own = {k: p.data().clone() for k, p in
           net._collect_params_with_prefix().items()}
    tqz.apply_fp32_params(net, {k: p.data() for k, p in _tmlp(50)
                                ._collect_params_with_prefix().items()})
    tqz.load_serving_params(net, own)      # int8-native: copied back
    for k, p in net._collect_params_with_prefix().items():
        assert torch.equal(p.data(), own[k])
    with pytest.raises(MXNetError, match="line up"):
        tqz.load_serving_params(net, {**own, "extra.qweight": own[
            "0.qweight"]})
    with pytest.raises(MXNetError, match="no parameters"):
        tqz.load_serving_params(net, {})
    with pytest.raises(MXNetError, match="missing"):
        tqz.apply_fp32_params(net, {"0.bias": np.zeros(32, np.float32)})


def test_save_load_roundtrip_and_container_mismatch(tmp_path):
    calib = _rand(64, FEAT, seed=51)
    x = tmx.nd.array(_rand(8, FEAT, seed=52), ctx=tmx.cpu())
    with tmx.cpu():
        qnet = tqz.quantize_net(_tmlp(53), calib_data=calib)
        twin = tqz.quantize_net(_tmlp(54), calib_data=calib * 0.3)
    ref = qnet(x).asnumpy()
    f = str(tmp_path / "qnet.params")
    qnet.save_parameters(f)
    twin.load_parameters(f)
    np.testing.assert_array_equal(twin(x).asnumpy(), ref)
    f32 = str(tmp_path / "fp32.params")
    _tmlp(55).save_parameters(f32)
    with pytest.raises(MXNetError, match="INT8-quantized"):
        qnet.load_parameters(f32)
    with pytest.raises(MXNetError, match="INT8-quantized param"):
        _tmlp(56).load_parameters(f)


def test_calibration_must_cover_every_layer_and_int8_inputs_need_ranges():
    from mxnet_tpu_torch.gluon import nn

    class TwoBranch(nn.HybridBlock):
        def __init__(self):
            super().__init__()
            self.head = nn.Dense(8, in_units=16, flatten=False)
            self.tail = nn.Dense(4, in_units=16, flatten=False)

        def hybrid_forward(self, F, x):
            return self.head(x) + 0 * self.tail(x).sum()

    net = TwoBranch()
    net.initialize(ctx=tmx.cpu())
    with tmx.cpu(), pytest.raises(MXNetError, match="never exercised"):
        tqz.quantize_net(net, calib_data=_rand(16, 16, seed=57),
                         calib_forward=lambda m, x: m.head(x))
    with tmx.cpu():
        calibrated = tqz.quantize_net(_tmlp(58),
                                      calib_data=_rand(32, FEAT, seed=59))
        q8 = calibrated._layers[0](tmx.nd.array(_rand(4, FEAT, seed=60)))
        assert q8.dtype == np.int8
        dynamic = tqz.quantize_net(_tmlp(61))
        with pytest.raises(MXNetError, match="calibrated ranges"):
            dynamic._layers[1](q8)


def test_calibration_syncs_once_a_tensor():
    """The statistics stay on the device until ``finalize``: one transfer
    for each of the 3 layers' input and output over 5 batches."""
    calls = {"n": 0}
    orig = tqz._Stats.finalize

    def counting(self):
        if self._dev:
            calls["n"] += 1
        return orig(self)

    tqz._Stats.finalize = counting
    try:
        calib = _rand(160, FEAT, seed=62)
        with tmx.cpu():
            tqz.quantize_net(_tmlp(63), calib_mode="entropy",
                             calib_data=iter([calib[i:i + 32]
                                              for i in range(0, 160, 32)]))
    finally:
        tqz._Stats.finalize = orig
    assert calls["n"] == 6


def test_quantized_conv_net_tracks_float32():
    from mxnet_tpu_torch.gluon import nn

    tmx.random.seed(64)
    net = nn.HybridSequential()
    net.add(nn.Conv2D(8, kernel_size=3, use_bias=False, in_channels=3),
            nn.Conv2D(4, kernel_size=1, in_channels=8))
    net.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    x = np.random.RandomState(65).rand(2, 3, 12, 12).astype(np.float32)
    with tmx.cpu():
        ref = net(tmx.nd.array(x)).asnumpy()
        tqz.quantize_net(net, calib_data=x)
        got = net(tmx.nd.array(x)).asnumpy()
    assert type(net._layers[0]).__name__ == "QuantizedConv"
    assert np.abs(got - ref).max() < 0.08 * np.abs(ref).max()


# -- on the card --------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (cuBLAS's int8 product has no "
                    "CPU mode here); run on the GPU machine with -m gpu")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(8, 64, 256), (16, 768, 30522),
                                   (1, 768, 2), (17, 12, 5),
                                   (512, 768, 3072)])
def test_int8_matmul_pads_to_what_cublas_takes(cuda_device, m, k, n):
    """Shapes cuBLAS refuses (16 rows or fewer, sizes not multiples of 8)
    are padded by ``int_mm_shape`` and sliced: exact against a float64
    product (exact below 2^53) on the card."""
    x = torch.from_numpy(_i8(m, k, seed=66)).to(cuda_device)
    w = torch.from_numpy(_i8(n, k, seed=67)).to(cuda_device)
    tq.reset_int_mm_counts()
    got = tq.int8_matmul(x, w)
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    want = (x.double() @ w.double().t()).to(torch.int64)
    assert torch.equal(got.to(torch.int64), want)
    padded = tq.int_mm_shape(m, k, n) != (m, k, n)
    assert tq.int_mm_counts == {"calls": 1, "padded": int(padded)}


@pytest.mark.gpu
def test_int8_conv_3d_on_card_equals_cpu(cuda_device):
    x, w = _i8(2, 8, 7, 9, 9, seed=70), _i8(6, 4, 3, 3, 3, seed=71)
    args = ((3, 3, 3), (2, 1, 2), (1, 2, 1), (1, 1, 1), 2)
    cpu = tq._conv_i32(_t(x), _t(w), *args)
    card = tq._conv_i32(_t(x).to(cuda_device), _t(w).to(cuda_device), *args)
    assert torch.equal(card.cpu(), cpu)


@pytest.mark.gpu
def test_int8_conv_on_card_equals_cpu(cuda_device):
    x, w = _i8(2, 8, 9, 9, seed=68), _i8(6, 4, 3, 3, seed=69)
    cpu = tq._conv_i32(_t(x), _t(w), (3, 3), (2, 2), (), (1, 1), 2)
    card = tq._conv_i32(_t(x).to(cuda_device), _t(w).to(cuda_device),
                        (3, 3), (2, 2), (), (1, 1), 2)
    assert torch.equal(card.cpu(), cpu)
