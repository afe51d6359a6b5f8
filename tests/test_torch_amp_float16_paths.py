"""The float16 AMP paths of rows 7-14 in the PyTorch port against the JAX
package, on the CPU: a narrow fused NHWC ResNet-50 v1 trained by
``gluon.Trainer`` under ``amp.init("float16")`` and by
``DataParallelTrainer(compute_dtype="float16")``, and the LSTM and GRU
language model of MXNet 1.x's ``example/gluon/word_language_model``
(``Embedding`` -> 2-layer ``gluon.rnn.LSTM``/``GRU`` -> ``Dense``) under
float16 AMP.

On the CPU the port's wrappers take their kernels' plain versions; the JAX
package's Pallas kernels run in interpret mode (``interpret_pallas``,
``MXTPU_CONV_FUSED_INTERPRET=1``, and ``MXTPU_RNN_IMPL=pallas`` for both
packages' recurrences).  The ResNet's 1x1 convolutions whose K and N are
multiples of 64 pass the JAX kernels' gates and run them; the narrower
ones (16 channels) take the JAX package's jnp references, as they would on
its TPU.  Weights are the JAX package's, carried across after
``convert_model``; inputs are numpy from seeds.

Tolerances, stated from measurement.  Float16 rounds at 2^-11: through 17
BatchNorm layers that normalize 16 values a channel at the narrow net's
last stage, one ulp of a layer's input moves the gradients below it by
about 0.5% of their largest value.  The net is chaotic at these widths: at
lr 0.01 the two packages' weights part by 3e-3 after one step and their
second losses by 0.4-4% (measured), so the steps take lr 1e-3.  Under
``gluon.Trainer``: losses within 4e-3 relative (measured 8.7e-5 and
2.0e-3: the stem's 3x3 convolution sums 27 products in another order), the
float32 masters within 3e-3 (measured 8.6e-4) with 99.9% of them within
1.5e-3 (measured 3.7e-4), the float16 moving statistics within 5e-3 of
their largest value (measured 1.7e-3 on running variances near 1).
``DataParallelTrainer`` runs one compiled step on the JAX side, whose
fusions round float16 at other places than the port's ops, and returns
the loss in float16: the same limits (measured 1.2e-3 and 9.9e-4 on the
losses, two float16 ulps; masters 1.0e-3, 99.9% within 5.7e-4;
statistics 1.6e-3).  The language models (2 x 32 units, vocabulary 50,
bptt 8, batch 4, SGD lr 0.1 with masters): losses within 2e-4 relative
(measured: the first bit-identical, the second 1.6e-5 and 3.2e-5), masters
within 1e-3 (measured 1.7e-4 and 4.9e-5): the recurrences' float16
outputs are two ulps apart at most, as the kernels' tests hold them.
"""
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.parallel import DataParallelTrainer

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_amp import _masters  # noqa: E402

CPU = tmx.cpu()
RESNET_BATCH, RESNET_IMAGE, RESNET_CLASSES = 4, 16, 10
SGD = {"learning_rate": 1e-3, "momentum": 0.9, "wd": 1e-4}
LOSS_RTOL, MASTER_MAX, MASTER_Q999, STATS_TOL = 4e-3, 3e-3, 1.5e-3, 5e-3


def _resnet(pkg):
    """ResNet-50 v1's bottleneck at widths 16-64: one bottleneck a stage,
    the 3x3 stem without pooling (16^2 images keep 2^2 at the last
    stage)."""
    nz = pkg.gluon.model_zoo.vision.resnet
    return nz.ResNetV1(nz.BottleneckV1, [1, 1, 1, 1], [16, 64, 64, 64, 64],
                       classes=RESNET_CLASSES, thumbnail=True, layout="NHWC")


def _resnet_batch():
    rng = np.random.RandomState(14)
    x = rng.rand(RESNET_BATCH, RESNET_IMAGE, RESNET_IMAGE, 3)
    y = rng.randint(0, RESNET_CLASSES, RESNET_BATCH)
    return x.astype(np.float32), y.astype(np.float32)


def _arrays(net, jax_side):
    return {k: (p.data().asnumpy() if jax_side
                else p.data().detach().numpy()).copy()
            for k, p in net._collect_params_with_prefix().items()}


def _start(jmx, build, sample, amp):
    """The JAX net (initialized, shapes resolved on ``sample``), the port's
    net with its weights, both AMP-converted to float16 when ``amp``."""
    jmx.random.seed(0)
    jnet = build(jmx)
    jnet.initialize(jmx.init.Xavier())
    with jmx.autograd.pause():
        jnet(jmx.nd.array(sample, dtype=str(sample.dtype)))
    tnet = build(tmx)
    tnet.initialize(ctx=CPU)
    if amp:
        for pkg in (jmx, tmx):
            pkg.amp.init("float16")
        jmx.amp.convert_model(jnet)
        tmx.amp.convert_model(tnet)
    tmx.load_numpy_params(tnet, _arrays(jnet, True))
    return jnet, tnet


def _amp_steps(pkg, net, x, y, loss_fn, steps, batch, opt):
    """``steps`` AMP steps as MXNet 1.x scripts write them (the scaled
    loss's backward under ``record``, then ``step``), from a loss scale of
    2**6 (the default 2**16 overflows this net's float16 gradients for its
    first steps, in both packages); returns (losses, trainer)."""
    tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                           dict(opt, multi_precision=True),
                           update_on_kvstore=False)
    tr._amp_loss_scaler = pkg.amp.LossScaler(init_scale=2.0 ** 6)
    losses = []
    for _ in range(steps):
        with pkg.autograd.record():
            loss = loss_fn(net(x), y)
            with pkg.amp.scale_loss(loss, tr) as scaled:
                pkg.autograd.backward(scaled)
        tr.step(batch)
        losses.append(float(loss.asnumpy().astype(np.float32).mean()))
    assert tr._amp_loss_scaler.loss_scale == 2.0 ** 6  # no step skipped
    return losses, tr


def _moving_stats(net, jax_side):
    return {k: v for k, v in _arrays(net, jax_side).items()
            if "running" in k}


def _close_masters(got, want):
    gap = np.abs(got - want)
    assert gap.max() <= MASTER_MAX and np.quantile(gap, 0.999) <= \
        MASTER_Q999, (gap.max(), np.quantile(gap, 0.999))


def _close_stats(tstats, jstats, atol_of_max):
    assert set(tstats) == set(jstats) and tstats
    for k, j in jstats.items():
        t = tstats[k]
        assert t.dtype == j.dtype, k
        j = j.astype(np.float32)
        np.testing.assert_allclose(
            t.astype(np.float32), j, rtol=0, err_msg=k,
            atol=atol_of_max * max(1.0, float(np.abs(j).max())))


@pytest.fixture
def fused(monkeypatch, interpret_pallas):
    monkeypatch.setenv("MXTPU_CONV_EPILOGUE", "pallas")
    monkeypatch.setenv("MXTPU_CONV_FUSED_INTERPRET", "1")
    yield
    import mxnet_tpu as jmx

    for pkg in (jmx, tmx):
        pkg.amp.init("bfloat16")


def test_narrow_fused_resnet_under_float16_amp_matches_jax(fused):
    """Two ``gluon.Trainer`` SGD steps (momentum 0.9, wd 1e-4, float32
    masters) under float16 AMP, the batch fed in float16: the losses, the
    masters and the float16 moving statistics; the net's dtypes are
    ``convert_model``'s split and every bottleneck ran fused."""
    import mxnet_tpu as jmx

    x, y = _resnet_batch()
    x16 = x.astype(np.float16)
    jnet, tnet = _start(jmx, _resnet, x, amp=True)
    assert all(blk._fuse for blk in tnet.features[1:5]
               for blk in blk._children.values())
    runs = {}
    for key, pkg, net, xa, ya in (
            ("jax", jmx, jnet, jmx.nd.array(x16, dtype="float16"),
             jmx.nd.array(y)),
            ("port", tmx, tnet, tmx.nd.array(x16, ctx=CPU, dtype="float16"),
             tmx.nd.array(y, ctx=CPU))):
        runs[key] = _amp_steps(pkg, net, xa, ya,
                               pkg.gluon.loss.SoftmaxCrossEntropyLoss(), 2,
                               RESNET_BATCH, SGD)
    (jl, jtr), (tl, ttr) = runs["jax"], runs["port"]
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    _close_masters(_masters(ttr, "port"), _masters(jtr, "jax"))
    dts = {str(p.data().dtype) for p in tnet.collect_params().values()}
    assert dts == {"torch.float16", "torch.float32"}
    _close_stats(_moving_stats(tnet, False), _moving_stats(jnet, True),
                 STATS_TOL)


def test_narrow_fused_resnet_data_parallel_float16_matches_jax(fused):
    """``DataParallelTrainer(compute_dtype="float16")`` (fp32 masters and
    moving statistics, the forward and backward in float16), two SGD
    steps against the JAX trainer on a one-device mesh: losses, then the
    masters and moving statistics after ``sync_to_block``."""
    import jax
    import mxnet_tpu as jmx
    from mxnet_tpu.parallel import data_parallel as jdp
    from mxnet_tpu.parallel import mesh as jmesh

    x, y = _resnet_batch()
    jnet, tnet = _start(jmx, _resnet, x, amp=False)
    jtr = jdp.DataParallelTrainer(
        jnet, jmx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd", dict(SGD),
        mesh=jmesh.make_mesh(devices=jax.devices()[:1]),
        compute_dtype="float16")
    ttr = DataParallelTrainer(tnet, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                              "sgd", dict(SGD), compute_dtype="float16")
    jl = [float(jtr.step(x, y).asnumpy()) for _ in range(2)]
    tl = [float(ttr.step(x, y).asnumpy()) for _ in range(2)]
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    jtr.sync_to_block()
    ttr.sync_to_block()
    tw, jw = _arrays(tnet, False), _arrays(jnet, True)
    assert all(v.dtype == np.float32 for v in tw.values())
    keys = [k for k in jw if "running" not in k]
    _close_masters(np.concatenate([tw[k].ravel() for k in keys]),
                   np.concatenate([jw[k].ravel() for k in keys]))
    _close_stats(_moving_stats(tnet, False), _moving_stats(jnet, True),
                 STATS_TOL)


LM_VOCAB, LM_UNITS, LM_BPTT, LM_BATCH = 50, 32, 8, 4


def _lm(cell):
    """``example/gluon/word_language_model``'s RNNModel, untied, dropout 0:
    ``Embedding`` -> 2-layer ``cell`` -> ``Dense`` over the vocabulary."""
    def build(pkg):
        class RNNModel(pkg.gluon.HybridBlock):
            def __init__(self):
                super().__init__()
                layer = pkg.gluon.rnn.LSTM if cell == "lstm" \
                    else pkg.gluon.rnn.GRU
                self.encoder = pkg.gluon.nn.Embedding(LM_VOCAB, LM_UNITS)
                self.rnn = layer(LM_UNITS, 2, input_size=LM_UNITS)
                self.decoder = pkg.gluon.nn.Dense(LM_VOCAB,
                                                  in_units=LM_UNITS)

            def hybrid_forward(self, F, x):
                out = self.rnn(self.encoder(x))
                return self.decoder(F.reshape(out, shape=(-1, LM_UNITS)))
        return RNNModel()
    return build


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_lm_under_float16_amp_matches_jax(cell, monkeypatch,
                                          interpret_pallas):
    """Two SGD steps (lr 0.1, float32 masters) of the language model
    under float16 AMP, both packages' recurrences on their kernels (the
    JAX Pallas kernels in interpret mode, the port's plain versions):
    losses and masters; the recurrent layer's output is float16."""
    import mxnet_tpu as jmx

    monkeypatch.setenv("MXTPU_RNN_IMPL", "pallas")
    rng = np.random.RandomState(29)
    toks = rng.randint(0, LM_VOCAB, (LM_BPTT + 1, LM_BATCH))
    x, y = toks[:-1].astype(np.float32), toks[1:].reshape(-1)
    try:
        jnet, tnet = _start(jmx, _lm(cell), x, amp=True)
        with tmx.autograd.pause():
            ys = tnet.rnn(tnet.encoder(tmx.nd.array(x, ctx=CPU)))
        assert ys.dtype == np.float16
        runs = {}
        for key, pkg, net, xa, ya in (
                ("jax", jmx, jnet, jmx.nd.array(x),
                 jmx.nd.array(y.astype(np.float32))),
                ("port", tmx, tnet, tmx.nd.array(x, ctx=CPU),
                 tmx.nd.array(y.astype(np.float32), ctx=CPU))):
            runs[key] = _amp_steps(
                pkg, net, xa, ya, pkg.gluon.loss.SoftmaxCrossEntropyLoss(),
                2, LM_BATCH, {"learning_rate": 0.1})
    finally:
        for pkg in (jmx, tmx):
            pkg.amp.init("bfloat16")
    (jl, jtr), (tl, ttr) = runs["jax"], runs["port"]
    np.testing.assert_allclose(tl, jl, rtol=2e-4)
    gap = np.abs(_masters(ttr, "port") - _masters(jtr, "jax"))
    assert gap.max() <= 1e-3, gap.max()


@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_of_float16_rounds_its_normalize_once_as_jax(train):
    """Queue 3, item 19: the BatchNorm op's normalize ``x*scale + shift``
    of float16 data (float32 gamma and beta, float16 moving statistics,
    as ``convert_model`` leaves a ResNet) rounded twice in the port, once
    in the reference (one XLA computation widens float16 and rounds the
    result once): one ulp apart on about a quarter of the outputs, which
    the narrow ResNet's 17 layers grew to 3% of its logits.  Now
    bit-identical, in training and in predict mode.  The JAX op runs
    jitted, as the package's ``invoke`` runs every registered op."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.ops import nn as jnn
    from mxnet_tpu_torch.ops import nn as tnn

    rng = np.random.RandomState(19)
    x = (rng.randn(8, 8, 8, 32) * 3 + 1).astype(np.float16)
    g, b = (rng.randn(32).astype(np.float32) for _ in range(2))
    mm = rng.randn(32).astype(np.float16)
    mv = (rng.rand(32) + 0.5).astype(np.float16)
    kw = dict(axis=-1, fix_gamma=False, _train=train)
    want = jax.jit(lambda *a: jnn._k_batch_norm(*a, **kw))(
        *(jnp.asarray(a) for a in (x, g, b, mm, mv)))
    got = tnn._k_batch_norm(*(torch.from_numpy(a) for a in (x, g, b, mm, mv)),
                            **kw)
    for name, t, j in zip(("out", "moving_mean", "moving_var"), got, want):
        j = np.asarray(j)
        assert t.dtype == torch.float16 and j.dtype == np.float16, name
        np.testing.assert_array_equal(t.detach().numpy(), j, err_msg=name)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_rnn_layer_under_float16_amp_on_the_loop_matches_jax(cell):
    """Queue 3, item 20: on the plain time loop (the CPU's path, and the
    JAX package's off the TPU), an AMP-converted ``gluon.rnn.LSTM``/``GRU``
    (float16 weights) with its float32 zero states raised in the port
    (``h @ Wh.T`` of float32 and float16).  The reference promotes each
    product to float32, as jnp does, so its outputs are float32.  Now
    the same: a 2-layer layer's output and its input's gradient within
    1e-5 of their largest value (fp32 sums in other orders; measured
    5.2e-8 and 1.9e-6)."""
    import mxnet_tpu as jmx

    rng = np.random.RandomState(20)
    x = (rng.randn(6, 3, 16) * 0.5).astype(np.float16)
    gy = rng.randn(6, 3, 32).astype(np.float32)

    def build(pkg):
        layer = pkg.gluon.rnn.LSTM if cell == "lstm" else pkg.gluon.rnn.GRU
        return layer(32, 2, input_size=16)

    try:
        jnet, tnet = _start(jmx, build, x.astype(np.float32), amp=True)
        outs = {}
        for key, pkg, net in (("jax", jmx, jnet), ("port", tmx, tnet)):
            ctx = {} if key == "jax" else {"ctx": CPU}
            xa = pkg.nd.array(x, dtype="float16", **ctx)
            xa.attach_grad()
            with pkg.autograd.record():
                y = net(xa)
                head = (y.astype("float32") * pkg.nd.array(gy, **ctx)).sum()
            head.backward()
            outs[key] = (y.asnumpy(), xa.grad.asnumpy())
    finally:
        for pkg in (jmx, tmx):
            pkg.amp.init("bfloat16")
    (jy, jg), (ty, tg) = outs["jax"], outs["port"]
    assert ty.dtype == jy.dtype == np.float32 and tg.dtype == jg.dtype
    for got, want in ((ty, jy), (tg, jg)):
        want = want.astype(np.float32)
        np.testing.assert_allclose(
            got.astype(np.float32), want, rtol=0,
            atol=1e-5 * max(1.0, float(np.abs(want).max())))
