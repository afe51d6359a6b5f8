"""The Gluon basics of the port against the JAX package: the nn ops and
modes (``Deconvolution``, the normalizations, ``LRN``, ``softmin``, the
resizes, the ``LeakyReLU`` flavours, ``lp`` pooling, ``pad``'s edge and
reflect modes), the layers over them, the initializers, the losses,
``PixelShuffle1D/2D/3D`` and ``gluon.utils``' file helpers.

The same numpy inputs (fixed seeds) go through both packages on the CPU.
Ops: the forward within 1e-5 and the gradient of ``sum(out * c)`` within
1e-4 (float32 sums in other orders).  Layers: the JAX layer's initial
weights carried into the port's (``convert.load_numpy_params``), eager and
hybridized, the output within 1e-5 and every gradient within 1e-4.
Initializers: bit-identical arrays after one ``mx.random.seed``.  Losses:
the value and the gradient of the prediction within 1e-5.  The tests
marked ``gpu`` hold the same ops and a net of the new layers on the card
against the CPU.
"""
import hashlib
import types

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

CPU = tmx.cpu()
FWD, GRAD = 1e-5, 1e-4


def _jmx():
    import mxnet_tpu as jmx

    return jmx


def _r(*shape, seed=0, lo=-2.0, hi=2.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _numpy(a):
    """An array of either package (a JAX NDArray, a port tensor) in numpy."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else a.asnumpy()


def _close(got, want, tol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=what)


# -- the ops ------------------------------------------------------------------

X4 = _r(2, 4, 5, 6, seed=1)
X3 = _r(2, 4, 7, seed=2)
X5 = _r(1, 4, 3, 4, 5, seed=3)


def _deconv(nd, stride, adj, dilate, pad, groups=2, bias=False, seed=4):
    """A transposed convolution's inputs: data (N, 4, ...) and MXNet's
    weight (in, out/groups, *k)."""
    spatial = {1: (5,), 2: (5, 4), 3: (3, 4, 3)}[nd]
    kernel = {1: (3,), 2: (3, 2), 3: (2, 3, 2)}[nd]
    per = 3
    arrays = [_r(2, 4, *spatial, seed=seed),
              _r(4, per, *kernel, seed=seed + 1, lo=-0.5, hi=0.5)]
    if bias:
        arrays.append(_r(per * groups, seed=seed + 2))
    attrs = dict(kernel=kernel, stride=(stride,) * nd, dilate=(dilate,) * nd,
                 pad=(pad,) * nd, adj=(adj,) * nd, num_filter=per * groups,
                 num_group=groups, no_bias=not bias)
    return arrays, attrs


def _case(label, name, arrays, attrs=None):
    return pytest.param(name, arrays, attrs or {}, id=label)


OP_CASES = [
    _case(f"deconv{nd}d-g2-s2-adj1-d2", "Deconvolution",
          *_deconv(nd, 2, 1, 2, 1)) for nd in (1, 2, 3)] + [
    _case("deconv2d-bias-adj-past-stride", "Deconvolution",
          *_deconv(2, 2, 3, 1, 0, groups=1, bias=True)),
    _case("deconv1d-plain", "Deconvolution", *_deconv(1, 1, 0, 1, 0, 1)),
    _case("instance_norm", "InstanceNorm",
          [X4, _r(4, seed=5), _r(4, seed=6)]),
    _case("instance_norm-3d-eps", "InstanceNorm",
          [X3, _r(4, seed=5), _r(4, seed=6)], {"eps": 1e-5}),
    _case("group_norm", "GroupNorm", [X4, _r(2, seed=5), _r(2, seed=6)],
          {"num_groups": 2}),
    _case("group_norm-5d", "GroupNorm", [X5, _r(4, seed=5), _r(4, seed=6)],
          {"num_groups": 4, "eps": 1e-3}),
    _case("l2norm-instance", "L2Normalization", [X4]),
    _case("l2norm-channel", "L2Normalization", [X4], {"mode": "channel"}),
    _case("l2norm-spatial", "L2Normalization", [X4], {"mode": "spatial"}),
    _case("lrn-3", "LRN", [X4], {"nsize": 3}),
    _case("lrn-5", "LRN", [X4], {"nsize": 5, "alpha": 1e-3, "beta": 0.5,
                                "knorm": 1.0}),
    _case("softmin", "softmin", [X3]),
    _case("softmin-axis1", "softmin", [X3], {"axis": 1}),
    _case("upsampling-nearest", "UpSampling", [X4], {"scale": 2}),
    _case("upsampling-bilinear", "UpSampling", [X4],
          {"scale": 3, "sample_type": "bilinear"}),
    _case("bilinear-grow", "_contrib_BilinearResize2D", [X4],
          {"height": 9, "width": 13}),
    _case("bilinear-shrink", "_contrib_BilinearResize2D",
          [_r(2, 3, 11, 13, seed=7)], {"height": 4, "width": 5}),
    _case("bilinear-scale", "_contrib_BilinearResize2D",
          [_r(2, 3, 11, 12, seed=8)], {"scale_height": 0.5,
                                       "scale_width": 1.5}),
    _case("pool-lp2-window", "Pooling", [X4],
          {"kernel": (2, 3), "stride": (1, 2), "pad": (1, 1),
           "pool_type": "lp", "p_value": 2}),
    _case("pool-lp3-window-1d", "Pooling", [X3],
          {"kernel": (3,), "stride": (2,), "pool_type": "lp",
           "p_value": 3}),
    _case("pool-lp3-full", "Pooling", [X4],
          {"kernel": (2, 2), "stride": (2, 2), "pool_type": "lp",
           "p_value": 3, "pooling_convention": "full"}),
    _case("pool-lp2-global", "Pooling", [X4],
          {"kernel": (1, 1), "global_pool": True, "pool_type": "lp",
           "p_value": 2}),
    _case("pool-lp3-global-3d", "Pooling", [X5],
          {"kernel": (1, 1, 1), "global_pool": True, "pool_type": "lp",
           "p_value": 3}),
    _case("pad-reflect", "pad", [X4],
          {"mode": "reflect", "pad_width": (0, 0, 0, 0, 2, 3, 1, 4)}),
    _case("pad-reflect-past-axis", "pad", [_r(1, 2, 3, 4, seed=9)],
          {"mode": "reflect", "pad_width": (0, 0, 0, 0, 5, 4, 0, 7)}),
    _case("pad-edge", "pad", [X4],
          {"mode": "edge", "pad_width": (0, 0, 0, 0, 1, 2, 3, 0)}),
    _case("pad-edge-channel-axis", "pad", [X4],
          {"mode": "edge", "pad_width": (0, 0, 2, 1, 0, 0, 1, 1)}),
    _case("pad-reflect-5d", "pad", [X5],
          {"mode": "reflect", "pad_width": (0, 0, 0, 0, 1, 1, 2, 2, 1, 3)}),
] + [
    _case(f"leaky_relu-{act}", "LeakyReLU", [X4], {"act_type": act})
    for act in ("leaky", "elu", "selu", "gelu", "rrelu")] + [
    _case("leaky_relu-prelu", "LeakyReLU", [X4, _r(4, seed=10, lo=0, hi=0.5)],
          {"act_type": "prelu"}),
    _case("leaky_relu-prelu-2d", "LeakyReLU",
          [_r(3, 5, seed=11), _r(1, seed=12, lo=0, hi=0.5)],
          {"act_type": "prelu"}),
    _case("leaky_relu-elu-slope", "LeakyReLU", [X3],
          {"act_type": "elu", "slope": 0.7}),
    _case("leaky_relu-rrelu-bounds", "LeakyReLU", [X3],
          {"act_type": "rrelu", "lower_bound": 0.1, "upper_bound": 0.5}),
]


def _run_op(mx, name, arrays, attrs, ctx=None):
    """The op's output and the gradients of ``sum(out * c)`` for every
    input, through ``mx.nd`` and ``mx.autograd``."""
    kw = {} if ctx is None else {"ctx": ctx}
    ins = [mx.nd.array(a, **kw) for a in arrays]
    for a in ins:
        a.attach_grad()
    with mx.autograd.record():
        out = getattr(mx.nd, name)(*ins, **attrs)
        c = mx.nd.array(np.random.RandomState(9).uniform(
            0.5, 1.5, out.shape).astype(np.float32), **kw)
        (out * c).sum().backward()
    return out.asnumpy(), [a.grad.asnumpy() for a in ins]


@pytest.mark.parametrize("name,arrays,attrs", OP_CASES)
def test_op_matches_jax(name, arrays, attrs):
    jout, jgrads = _run_op(_jmx(), name, arrays, attrs)
    tout, tgrads = _run_op(tmx, name, arrays, attrs, ctx=CPU)
    _close(tout, jout, FWD, "out")
    for i, (t, j) in enumerate(zip(tgrads, jgrads)):
        _close(t, j, GRAD, f"grad of input {i}")


def test_deconvolution_output_size_and_target_shape():
    x = tmx.nd.array(_r(1, 2, 4, 4), ctx=CPU)
    w = tmx.nd.array(_r(2, 3, 3, 3, seed=1), ctx=CPU)
    out = tmx.nd.Deconvolution(x, w, kernel=(3, 3), stride=(2, 2),
                               pad=(1, 1), adj=(1, 1), num_filter=3)
    assert out.shape == (1, 3, 8, 8)  # (4-1)*2 - 2 + 2 + 1 + 1
    with pytest.raises(MXNetError, match="target_shape"):
        tmx.nd.Deconvolution(x, w, kernel=(3, 3), num_filter=3,
                             target_shape=(8, 8))
    with pytest.raises(MXNetError, match="channel-first"):
        tmx.nd.Deconvolution(x, w, kernel=(3, 3), num_filter=3,
                             layout="NHWC")


def test_unknown_modes_raise():
    x = tmx.nd.array(X4, ctx=CPU)
    for call in (lambda: tmx.nd.LeakyReLU(x, act_type="bogus"),
                 lambda: tmx.nd.pad(x, mode="wrap",
                                    pad_width=(0,) * 8),
                 lambda: tmx.nd.Pooling(x, kernel=(2, 2),
                                        pool_type="bogus"),
                 lambda: tmx.nd.UpSampling(x, scale=2, sample_type="bogus")):
        with pytest.raises(MXNetError):
            call()


# -- the layers ---------------------------------------------------------------


def _seq(mx, cls):
    net = getattr(mx.gluon.nn, cls)()
    net.add(mx.gluon.nn.Conv2D(3, 3, padding=1), mx.gluon.nn.ELU(0.5),
            mx.gluon.nn.Conv2D(2, 1))
    return net


LAYERS = {
    "Sequential": (lambda mx: _seq(mx, "Sequential"), (2, 4, 5, 6), False),
    "Lambda": (lambda mx: mx.gluon.nn.Lambda(lambda x: x * 2 + 1),
               (2, 4, 5), False),
    "HybridLambda-str": (lambda mx: mx.gluon.nn.HybridLambda("tanh"),
                         (2, 4, 5), True),
    "HybridLambda-fn": (lambda mx: mx.gluon.nn.HybridLambda(
        lambda F, x: F.relu(x) * 3), (2, 4, 5), True),
    "LeakyReLU": (lambda mx: mx.gluon.nn.LeakyReLU(0.2), (2, 4, 5), True),
    "PReLU": (lambda mx: mx.gluon.nn.PReLU(
        alpha_initializer=mx.init.Constant(0.3), in_channels=4),
        (2, 4, 5, 3), True),
    "ELU": (lambda mx: mx.gluon.nn.ELU(0.8), (2, 4, 5), True),
    "SELU": (lambda mx: mx.gluon.nn.SELU(), (2, 4, 5), True),
    "GELU": (lambda mx: mx.gluon.nn.GELU(), (2, 4, 5), True),
    "Swish": (lambda mx: mx.gluon.nn.Swish(1.5), (2, 4, 5), True),
    "InstanceNorm": (lambda mx: mx.gluon.nn.InstanceNorm(
        gamma_initializer=mx.init.Uniform(1.0),
        beta_initializer=mx.init.Uniform(1.0)), (2, 4, 5, 6), True),
    "GroupNorm": (lambda mx: mx.gluon.nn.GroupNorm(
        num_groups=2, gamma_initializer=mx.init.Uniform(1.0),
        beta_initializer=mx.init.Uniform(1.0)), (2, 4, 5, 6), True),
    "ReflectionPad2D": (lambda mx: mx.gluon.nn.ReflectionPad2D(2),
                        (2, 3, 5, 6), True),
    "ReflectionPad2D-tuple": (lambda mx: mx.gluon.nn.ReflectionPad2D(
        (1, 2, 3, 0)), (2, 3, 5, 6), True),
    "Conv1D": (lambda mx: mx.gluon.nn.Conv1D(6, 3, strides=2, padding=1,
                                             groups=2, activation="relu"),
               (2, 4, 9), True),
    "Conv3D": (lambda mx: mx.gluon.nn.Conv3D(3, (2, 3, 2), padding=1,
                                             dilation=(1, 2, 1)),
               (2, 2, 4, 5, 4), True),
    "Conv1DTranspose": (lambda mx: mx.gluon.nn.Conv1DTranspose(
        4, 3, strides=2, padding=1, output_padding=1, groups=2),
        (2, 4, 6), True),
    "Conv2DTranspose": (lambda mx: mx.gluon.nn.Conv2DTranspose(
        3, (3, 2), strides=(2, 1), padding=(1, 0), output_padding=(1, 0),
        dilation=(1, 2), in_channels=4), (2, 4, 4, 5), True),
    "Conv3DTranspose": (lambda mx: mx.gluon.nn.Conv3DTranspose(
        4, 2, strides=2, groups=2, use_bias=False), (1, 2, 2, 3, 2), True),
    "MaxPool1D": (lambda mx: mx.gluon.nn.MaxPool1D(3, 2, 1),
                  (2, 3, 9), True),
    "MaxPool3D": (lambda mx: mx.gluon.nn.MaxPool3D(2, ceil_mode=True),
                  (2, 3, 5, 4, 5), True),
    "AvgPool1D": (lambda mx: mx.gluon.nn.AvgPool1D(
        3, 2, 1, count_include_pad=False), (2, 3, 9), True),
    "AvgPool3D": (lambda mx: mx.gluon.nn.AvgPool3D((2, 2, 3)),
                  (2, 3, 4, 4, 6), True),
    "GlobalMaxPool1D": (lambda mx: mx.gluon.nn.GlobalMaxPool1D(),
                        (2, 3, 9), True),
    "GlobalMaxPool2D": (lambda mx: mx.gluon.nn.GlobalMaxPool2D(),
                        (2, 3, 5, 4), True),
    "GlobalMaxPool3D": (lambda mx: mx.gluon.nn.GlobalMaxPool3D(),
                        (2, 3, 3, 4, 2), True),
    "GlobalAvgPool1D": (lambda mx: mx.gluon.nn.GlobalAvgPool1D(),
                        (2, 3, 9), True),
    "GlobalAvgPool3D": (lambda mx: mx.gluon.nn.GlobalAvgPool3D(),
                        (2, 3, 3, 4, 2), True),
    "PixelShuffle2D-block": (lambda mx: mx.gluon.contrib.nn.PixelShuffle2D(
        (2, 3)), (2, 12, 3, 2), True),
}


def _layer_run(mx, layer, x, params, hybridize, ctx=None):
    """The layer's output and the gradients of ``sum(out * c)`` of its
    input and parameters."""
    kw = {} if ctx is None else {"ctx": ctx}
    if hybridize:
        layer.hybridize()
    xa = mx.nd.array(x, **kw)
    xa.attach_grad()
    with mx.autograd.record():
        out = layer(xa)
        c = mx.nd.array(np.random.RandomState(9).uniform(
            0.5, 1.5, out.shape).astype(np.float32), **kw)
        (out * c).sum().backward()
    grads = {k: _numpy(p.grad()) for k, p in params.items()
             if p.grad_req != "null"}
    return out.asnumpy(), xa.grad.asnumpy(), grads


@pytest.mark.parametrize("name,hybridize", [
    pytest.param(n, h, id=f"{n}-{'hybridized' if h else 'eager'}")
    for n in sorted(LAYERS) for h in (False, True) if LAYERS[n][2] or not h])
def test_layer_matches_jax(name, hybridize):
    jmx = _jmx()
    make, shape, _ = LAYERS[name]
    x = _r(*shape, seed=3)
    jmx.random.seed(1)
    jl = make(jmx)
    jl.initialize(ctx=jmx.cpu())
    jl(jmx.nd.array(x))   # deferred shapes
    weights = {k: p.data().asnumpy()
               for k, p in jl._collect_params_with_prefix().items()}
    with tmx.cpu():
        tl = make(tmx)
        tl.initialize(ctx=CPU)
        tl(tmx.nd.array(x, ctx=CPU))
        tmx.convert.load_numpy_params(tl, weights)
    jout, jdx, jg = _layer_run(jmx, jl, x,
                               jl._collect_params_with_prefix(), hybridize)
    tout, tdx, tg = _layer_run(tmx, tl, x,
                               tl._collect_params_with_prefix(), hybridize,
                               ctx=CPU)
    _close(tout, jout, FWD, "out")
    _close(tdx, jdx, GRAD, "input grad")
    assert sorted(tg) == sorted(jg)
    for k in jg:
        _close(tg[k], jg[k], GRAD, k)


def test_groupnorm_affine_is_per_group_and_fixed_without_scale():
    g = tmx.gluon.nn.GroupNorm(num_groups=3, scale=False, center=False)
    assert g.gamma.shape == (3,) and g.beta.shape == (3,)
    assert g.gamma.grad_req == "null" and g.beta.grad_req == "null"
    assert tmx.gluon.nn.PReLU().alpha.init == "zeros"


def test_sequential_indexing_and_slices():
    net = _seq(tmx, "Sequential")
    assert len(net) == 3 and isinstance(net[1], tmx.gluon.nn.ELU)
    sub = net[1:]
    assert isinstance(sub, tmx.gluon.nn.Sequential) and len(sub) == 2
    assert list(net)[2] is net[2]
    assert not isinstance(net, tmx.gluon.HybridBlock)


# -- the initializers -----------------------------------------------------------


INITS = {
    "Constant": (lambda m: m.init.Constant(0.37), (3, 4)),
    "Constant-array": (lambda m: m.init.Constant(
        np.arange(4, dtype=np.float32)), (3, 4)),
    "TruncNorm": (lambda m: m.init.TruncNorm(mean=0.1, stdev=0.5), (64, 33)),
    "Orthogonal-uniform": (lambda m: m.init.Orthogonal(), (6, 2, 3)),
    "Orthogonal-normal": (lambda m: m.init.Orthogonal(
        scale=0.9, rand_type="normal"), (4, 10)),
    "Orthogonal-tall": (lambda m: m.init.Orthogonal(), (10, 4)),
    "MSRAPrelu": (lambda m: m.init.MSRAPrelu(slope=0.1), (8, 3, 3, 3)),
    "MSRAPrelu-in": (lambda m: m.init.MSRAPrelu("in"), (5, 7)),
    "Bilinear": (lambda m: m.init.Bilinear(), (3, 1, 4, 4)),
    "Bilinear-odd": (lambda m: m.init.Bilinear(), (2, 1, 5, 3)),
    "LSTMBias": (lambda m: m.init.LSTMBias(forget_bias=2.5), (16,)),
    "Mixed": (lambda m: m.init.Mixed(
        ["dense_w.*", ".*"], [m.init.TruncNorm(stdev=0.3),
                              m.init.Constant(4.0)]), (5, 3)),
    "create-truncnorm": (lambda m: m.init.create("truncnorm", stdev=0.2),
                         (7, 9)),
}


@pytest.mark.parametrize("name", sorted(INITS))
def test_initializer_bit_identical_to_jax(name):
    jmx = _jmx()
    make, shape = INITS[name]
    for pname in ("dense_weight", "other_weight"):
        jarr = np.zeros(shape, np.float32)
        jmx.random.seed(13)
        make(jmx)(jmx.init.InitDesc(pname), jarr)
        tarr = torch.zeros(shape)
        tmx.random.seed(13)
        make(tmx)(tmx.init.InitDesc(pname), tarr)
        np.testing.assert_array_equal(tarr.numpy(), jarr, err_msg=pname)


def test_initializers_through_parameters_bit_identical():
    """``initialize(init)`` of a Dense and a transposed convolution: the
    same draws in the same order as the JAX package's."""
    jmx = _jmx()

    def build(mx):
        net = mx.gluon.nn.HybridSequential()
        net.add(mx.gluon.nn.Dense(6, in_units=5),
                mx.gluon.nn.Dense(4, in_units=6,
                                  weight_initializer=mx.init.Orthogonal()))
        return net

    jmx.random.seed(5)
    jnet = build(jmx)
    jnet.initialize(init=jmx.init.MSRAPrelu(), ctx=jmx.cpu())
    tmx.random.seed(5)
    tnet = build(tmx)
    tnet.initialize(init=tmx.init.MSRAPrelu(), ctx=CPU)
    jp = jnet._collect_params_with_prefix()
    tp = tnet._collect_params_with_prefix()
    for k in jp:
        np.testing.assert_array_equal(_numpy(tp[k].data()),
                                      jp[k].data().asnumpy(), err_msg=k)
    up = tmx.gluon.nn.Conv2DTranspose(3, 4, strides=2, padding=1,
                                      in_channels=3, groups=3,
                                      weight_initializer=tmx.init.Bilinear())
    up.initialize(ctx=CPU)
    jup = jmx.gluon.nn.Conv2DTranspose(3, 4, strides=2, padding=1,
                                       in_channels=3, groups=3,
                                       weight_initializer=jmx.init.Bilinear())
    jup.initialize(ctx=jmx.cpu())
    np.testing.assert_array_equal(_numpy(up.weight.data()),
                                  jup.weight.data().asnumpy())


def test_mixed_first_match_and_raise():
    init = tmx.init.Mixed(["a_.*", "a_w.*", ".*"],
                          [tmx.init.Constant(1.0), tmx.init.Constant(2.0),
                           tmx.init.Constant(3.0)])
    arr = torch.zeros(2, 2)
    init(tmx.init.InitDesc("a_weight"), arr)
    assert (arr == 1.0).all()
    init(tmx.init.InitDesc("b_weight"), arr)
    assert (arr == 3.0).all()
    with pytest.raises(ValueError, match="matched none"):
        tmx.init.Mixed(["a_.*"], [tmx.init.One()])(
            tmx.init.InitDesc("b_weight"), arr)
    with pytest.raises(ValueError, match="pair up"):
        tmx.init.Mixed(["a_.*", ".*"], [tmx.init.One()])
    for name in ("constant", "truncnorm", "orthogonal", "msraprelu",
                 "bilinear", "lstmbias", "mixed"):
        assert tmx.init._registry[name].__name__.lower() == name


# -- the losses -----------------------------------------------------------------


def _signed(*shape, seed):
    return np.where(_r(*shape, seed=seed) > 0, 1.0, -1.0).astype(np.float32)


PRED = _r(4, 6, seed=20)
SW = _r(4, 1, seed=21, lo=0.2, hi=1.5)
LOSSES = {
    "KLDivLoss": (lambda m: m.gluon.loss.KLDivLoss(),
                  [np.log(_r(4, 6, seed=22, lo=0.05, hi=1.0)),
                   _r(4, 6, seed=23, lo=0.05, hi=1.0)], SW),
    "KLDivLoss-logits": (lambda m: m.gluon.loss.KLDivLoss(
        from_logits=False, axis=1), [PRED, _r(4, 6, seed=23, lo=0.05,
                                              hi=1.0)], SW),
    "HuberLoss": (lambda m: m.gluon.loss.HuberLoss(rho=0.7),
                  [PRED, _r(4, 6, seed=24)], SW),
    "HingeLoss": (lambda m: m.gluon.loss.HingeLoss(margin=1.5),
                  [PRED, _signed(4, 6, seed=25)], SW),
    "SquaredHingeLoss": (lambda m: m.gluon.loss.SquaredHingeLoss(),
                         [PRED, _signed(4, 6, seed=25)], SW),
    "LogisticLoss": (lambda m: m.gluon.loss.LogisticLoss(),
                     [PRED, _signed(4, 6, seed=26)], SW),
    "LogisticLoss-binary": (lambda m: m.gluon.loss.LogisticLoss(
        label_format="binary"), [PRED, (_signed(4, 6, seed=26) + 1) / 2],
        SW),
    "TripletLoss": (lambda m: m.gluon.loss.TripletLoss(margin=2.0),
                    [PRED, _r(4, 6, seed=27), _r(4, 6, seed=28)],
                    SW[:, 0]),
    "PoissonNLLLoss": (lambda m: m.gluon.loss.PoissonNLLLoss(),
                       [PRED * 0.5, np.floor(_r(4, 6, seed=29, lo=0,
                                                hi=5))], SW),
    "PoissonNLLLoss-full": (lambda m: m.gluon.loss.PoissonNLLLoss(
        from_logits=False, compute_full=True),
        [_r(4, 6, seed=30, lo=0.2, hi=4), np.floor(_r(4, 6, seed=29, lo=0,
                                                      hi=5))], SW),
    "CosineEmbeddingLoss": (lambda m: m.gluon.loss.CosineEmbeddingLoss(
        margin=0.2), [PRED, _r(4, 6, seed=31), _signed(4, seed=32)],
        SW[:, 0]),
    "CTCLoss": (lambda m: m.gluon.loss.CTCLoss(),
                [_r(4, 7, 5, seed=33), np.array(
                    [[0, 1, 1], [2, 3, -1], [3, -1, -1], [-1, -1, -1]],
                    np.float32)], SW[:, 0]),
}


def _run_loss(mx, name, **kw):
    """A loss of ``LOSSES`` with its sample weights, and the gradient of
    its prediction."""
    make, arrays, sw = LOSSES[name]
    ins = [mx.nd.array(a, **kw) for a in arrays]
    ins[0].attach_grad()
    with mx.autograd.record():
        loss = make(mx)(*ins, mx.nd.array(sw, **kw))
    loss.backward()
    return loss.asnumpy(), ins[0].grad.asnumpy()


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_jax(name):
    jl, jg = _run_loss(_jmx(), name)
    tl, tg = _run_loss(tmx, name, ctx=CPU)
    _close(tl, jl, FWD, "loss")
    _close(tg, jg, FWD, "grad")


# -- PixelShuffle, gluon.utils, the names ---------------------------------------


@pytest.mark.parametrize("cls,factor,shape", [
    ("PixelShuffle1D", 3, (2, 6, 5)),
    ("PixelShuffle2D", 2, (2, 8, 3, 4)),
    ("PixelShuffle2D", (3, 2), (1, 12, 2, 3)),
    ("PixelShuffle3D", 2, (1, 16, 2, 3, 2)),
    ("PixelShuffle3D", (1, 2, 3), (2, 12, 2, 2, 3)),
])
def test_pixel_shuffle_exact(cls, factor, shape):
    jmx = _jmx()
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    want = getattr(jmx.gluon.contrib.nn, cls)(factor)(jmx.nd.array(x))
    got = getattr(tmx.gluon.contrib.nn, cls)(factor)(
        tmx.nd.array(x, ctx=CPU))
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


def test_check_sha1_and_download(tmp_path):
    f = tmp_path / "blob.bin"
    data = np.random.RandomState(0).bytes(3 * 1048576 + 17)
    f.write_bytes(data)
    digest = hashlib.sha1(data).hexdigest()
    assert tmx.gluon.utils.check_sha1(str(f), digest)
    assert not tmx.gluon.utils.check_sha1(str(f), "0" * 40)
    with pytest.raises(MXNetError, match="no network"):
        tmx.gluon.utils.download("http://example.invalid/x.params",
                                 path=str(tmp_path))


def _defined_names(mod):
    """The public names ``mod`` defines itself (or, for a package, its
    submodules define), aliases included."""
    out = set()
    for k in dir(mod):
        v = getattr(mod, k)
        if k.startswith("_") or isinstance(v, types.ModuleType):
            continue
        home = getattr(v, "__module__", None) or ""
        if home == mod.__name__ or home.startswith(mod.__name__ + "."):
            out.add(k)
    return out


@pytest.mark.parametrize("path", ["gluon.nn", "gluon.loss", "init",
                                  "gluon.utils", "gluon.contrib.nn"])
def test_every_public_name_of_the_jax_module_exists(path):
    jmod, tmod = _jmx(), tmx
    for part in path.split("."):
        jmod, tmod = getattr(jmod, part), getattr(tmod, part)
    missing = sorted(_defined_names(jmod) - set(dir(tmod)))
    assert not missing, missing


# -- on the card ------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device (the CPU runs the port's plain ops); "
                    "run on the GPU machine with -m gpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return tmx.gpu(0)


@pytest.mark.gpu
@pytest.mark.parametrize("name,arrays,attrs", OP_CASES)
def test_op_on_card_matches_cpu(name, arrays, attrs, cuda_device):
    cout, cgrads = _run_op(tmx, name, arrays, attrs, ctx=CPU)
    gout, ggrads = _run_op(tmx, name, arrays, attrs, ctx=cuda_device)
    _close(gout, cout, FWD, "out")
    for i, (g, c) in enumerate(zip(ggrads, cgrads)):
        _close(g, c, GRAD, f"grad of input {i}")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(n for n in LAYERS
                                        if LAYERS[n][2]))
def test_layer_on_card_matches_cpu(name, cuda_device):
    make, shape, _ = LAYERS[name]
    x = _r(*shape, seed=3)
    tmx.random.seed(1)
    with CPU:
        ref = make(tmx)
        ref.initialize(ctx=CPU)
        ref(tmx.nd.array(x, ctx=CPU))
    weights = {k: _numpy(p.data())
               for k, p in ref._collect_params_with_prefix().items()}
    card = make(tmx)
    card.initialize(ctx=cuda_device)
    card(tmx.nd.array(x, ctx=cuda_device))
    tmx.convert.load_numpy_params(card, weights)
    cout, cdx, cg = _layer_run(tmx, ref, x,
                               ref._collect_params_with_prefix(), True,
                               ctx=CPU)
    gout, gdx, gg = _layer_run(tmx, card, x,
                               card._collect_params_with_prefix(), True,
                               ctx=cuda_device)
    _close(gout, cout, FWD, "out")
    _close(gdx, cdx, GRAD, "input grad")
    for k in cg:
        _close(gg[k], cg[k], GRAD, k)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_on_card_matches_cpu(name, cuda_device):
    cl, cg = _run_loss(tmx, name, ctx=CPU)
    gl, gg = _run_loss(tmx, name, ctx=cuda_device)
    _close(gl, cl, FWD, "loss")
    _close(gg, cg, FWD, "grad")
