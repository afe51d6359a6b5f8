"""ResNet's path in the PyTorch port against the JAX package, on the CPU:
the convolution, pooling and BatchNorm layers, ``BottleneckV1``'s fused
forward against its standard one, a narrow ``ResNetV1`` with weights
carried across, ``DataParallelTrainer`` (sgd with momentum, adam, and
``accum_steps``), and the synthetic-LeNet convergence gate of
``tests/test_gluon.py`` with three optimizers.  Inputs are numpy from a
seed; weights are carried across by structural name with
``load_numpy_params``.  Where the JAX side runs the fused path, its Pallas
kernels run in interpret mode (``interpret_pallas`` and
``MXTPU_CONV_FUSED_INTERPRET=1``).  The tests marked ``gpu`` run the fused
path on the card.

Tolerances (fp32 on both sides).  Layer outputs: 1e-5 absolute plus 1e-5
relative (one convolution or pooling, sums in other orders).  Through the
narrow ResNet: outputs within 1e-4 absolute plus 1e-4 relative, moving
statistics within 1e-5 plus 1e-4, gradients within 1e-4 of each one's
largest magnitude plus 1e-3 relative (17 BatchNorm layers, whose backward
divides by the batch's standard deviation, amplify fp32 rounding).
``DataParallelTrainer`` after 3 steps: losses within 1e-4 relative,
parameters within 1e-4 absolute plus 1e-3 relative.  The fused bottleneck
against the standard one: as ``tests/test_conv_fused.py`` holds the JAX
package's (1e-5 on outputs and moving statistics, 1e-4 on gradients).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as trn
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.parallel import DataParallelTrainer

CPU = tmx.cpu()


def _close(a, b, atol=1e-5, rtol=1e-5, msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=rtol, err_msg=msg)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else t.asnumpy()


def _weights(block):
    return {k: _np(p.data()).copy()
            for k, p in block._collect_params_with_prefix().items()}


# -- convolution and pooling --------------------------------------------------


CONV_CASES = [  # (layout, kernel, stride, pad, dilate, groups, bias)
    ("NCHW", (3, 3), (1, 1), (1, 1), (1, 1), 1, True),
    ("NHWC", (3, 3), (2, 2), (1, 1), (1, 1), 1, False),
    ("NHWC", (1, 1), (2, 2), (0, 0), (1, 1), 1, True),
    ("NHWC", (7, 7), (2, 2), (3, 3), (1, 1), 1, False),
    ("NCHW", (3, 3), (1, 1), (2, 2), (2, 2), 2, True),
    ("NHWC", (3, 3), (1, 1), (1, 1), (1, 1), 4, True),
]


@pytest.mark.parametrize("case", CONV_CASES, ids=str)
def test_convolution_matches_jax(case):
    """``Convolution`` with NCHW/OIHW and NHWC/OHWI, stride, pad, dilate,
    groups and bias: output and gradients of data, weight and bias."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.ops import nn as jnn

    layout, k, s, p, d, g, bias = case
    rng = np.random.RandomState(len(str(case)))
    cin, cout = 8, 12
    dshape = (2, 9, 9, cin) if layout == "NHWC" else (2, cin, 9, 9)
    wshape = (cout,) + k + (cin // g,) if layout == "NHWC" \
        else (cout, cin // g) + k
    arrays = [rng.randn(*dshape).astype(np.float32),
              (rng.randn(*wshape) * 0.2).astype(np.float32),
              rng.randn(cout).astype(np.float32)]
    kw = dict(kernel=k, stride=s, pad=p, dilate=d, num_filter=cout,
              num_group=g, no_bias=not bias, layout=layout)
    jout = jnn._k_convolution(*map(jnp.asarray, arrays), **kw)
    gy = rng.randn(*jout.shape).astype(np.float32)
    jg = jax.grad(lambda *a: jnp.sum(jnn._k_convolution(*a, **kw) * gy),
                  (0, 1, 2))(*map(jnp.asarray, arrays))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    tout = tnn._k_convolution(*ts, **kw)
    tg = torch.autograd.grad((tout * torch.from_numpy(gy)).sum(), ts,
                             allow_unused=True)
    _close(_np(tout), np.asarray(jout), 1e-4, 1e-5)
    for name, t, j in zip(("data", "weight", "bias"), tg, jg):
        if t is None:  # no_bias: the bias takes no part
            assert not bias and not np.asarray(j).any()
            continue
        _close(_np(t), np.asarray(j), 1e-4 * max(1, np.abs(j).max()), 1e-4,
               name)


POOL_CASES = [  # (pool_type, kernel, stride, pad, convention, incl_pad)
    ("max", (3, 3), (2, 2), (1, 1), "valid", True),
    ("max", (3, 3), (2, 2), (0, 0), "full", True),
    ("avg", (2, 2), (2, 2), (0, 0), "valid", True),
    ("avg", (3, 3), (2, 2), (1, 1), "valid", False),
    ("avg", (3, 3), (2, 2), (1, 1), "full", True),
    ("avg", (3, 3), (2, 2), (1, 1), "full", False),
    ("sum", (3, 3), (1, 1), (1, 1), "valid", True),
    ("max", (4, 4), (1, 1), (3, 3), "valid", True),
]


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", POOL_CASES, ids=str)
def test_pooling_matches_jax(case, layout):
    """``Pooling``: max, avg and sum, conventions valid and full,
    ``count_include_pad``, padding wider than PyTorch pads in place."""
    import jax.numpy as jnp
    from mxnet_tpu.ops import nn as jnn

    pool_type, k, s, p, conv, incl = case
    rng = np.random.RandomState(1)
    shape = (2, 10, 11, 3) if layout == "NHWC" else (2, 3, 10, 11)
    x = rng.randn(*shape).astype(np.float32)
    kw = dict(kernel=k, stride=s, pad=p, pool_type=pool_type,
              pooling_convention=conv, count_include_pad=incl,
              layout=layout)
    jout = jnn._k_pooling(jnp.asarray(x), **kw)
    tout = tnn._k_pooling(torch.from_numpy(x), **kw)
    assert tuple(tout.shape) == jout.shape
    _close(_np(tout), np.asarray(jout))


@pytest.mark.parametrize("pool_type", ["max", "avg", "sum"])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_global_pooling_matches_jax(pool_type, layout):
    import jax.numpy as jnp
    from mxnet_tpu.ops import nn as jnn

    x = np.random.RandomState(2).randn(2, 5, 6, 7).astype(np.float32)
    kw = dict(global_pool=True, pool_type=pool_type, layout=layout)
    _close(_np(tnn._k_pooling(torch.from_numpy(x), **kw)),
           np.asarray(jnn._k_pooling(jnp.asarray(x), **kw)))


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_conv_and_pool_layers_match_jax(layout):
    """``Conv2D`` (deferred input channels), ``MaxPool2D``, ``AvgPool2D``,
    ``GlobalAvgPool2D`` and ``Flatten`` as layers, the weight carried
    across in the JAX package's shape."""
    import mxnet_tpu as jmx

    x = np.random.RandomState(3).rand(2, 12, 12, 4).astype(np.float32)
    if layout == "NCHW":
        x = x.transpose(0, 3, 1, 2).copy()
    outs = []
    for pkg, ctx in ((jmx, None), (tmx, CPU)):
        nn = pkg.gluon.nn
        net = nn.HybridSequential()
        net.add(nn.Conv2D(8, 3, padding=1, layout=layout, activation="relu"),
                nn.MaxPool2D(3, 2, 1, layout=layout),
                nn.AvgPool2D(2, layout=layout),
                nn.GlobalAvgPool2D(layout=layout), nn.Flatten())
        if ctx is None:
            net.initialize(pkg.init.Xavier())
            out = net(pkg.nd.array(x))
            weights = {k: p.data().asnumpy() for k, p in
                       net._collect_params_with_prefix().items()}
        else:
            net.initialize(ctx=ctx)
            tmx.load_numpy_params(net, weights)
            out = net(pkg.nd.array(x, ctx=ctx))
        outs.append(out.asnumpy())
    wshape = weights["0.weight"].shape
    assert wshape == ((8, 3, 3, 4) if layout == "NHWC" else (8, 4, 3, 3))
    assert outs[1].shape == (2, 8)
    _close(outs[1], outs[0], 1e-5, 1e-5)


def test_xavier_reads_the_fans_of_an_ohwi_weight():
    """Channel-last convolutions hand Xavier their exact fans: an OHWI
    weight (64, 1, 1, 256) has fan-in 256 and fan-out 64, not the 1 and 64
    its shape would say."""
    tmx.random.seed(0)
    conv = tmx.gluon.nn.Conv2D(64, 1, in_channels=256, layout="NHWC")
    conv.initialize(tmx.init.Xavier(), ctx=CPU)
    w = _np(conv.weight.data())
    bound = np.sqrt(3.0 / ((256 + 64) / 2.0))
    assert w.shape == (64, 1, 1, 256)
    assert np.abs(w).max() <= bound and np.abs(w).max() > 0.95 * bound


# -- BatchNorm ----------------------------------------------------------------


@pytest.mark.parametrize("axis", [1, -1])
def test_batchnorm_layer_commits_moving_stats_like_jax(axis):
    """The layer normalizes with the batch in training and commits the
    moving statistics; in predict mode it reads them and commits nothing."""
    import mxnet_tpu as jmx

    rng = np.random.RandomState(5)
    x = (rng.randn(4, 6, 5, 5) * 2 + 1).astype(np.float32)
    res = []
    for pkg, ctx in ((jmx, None), (tmx, CPU)):
        bn = pkg.gluon.nn.BatchNorm(axis=axis, momentum=0.8)
        if ctx is None:
            bn.initialize()
            xa = pkg.nd.array(x)
        else:
            bn.initialize(ctx=ctx)
            xa = pkg.nd.array(x, ctx=ctx)
        with pkg.autograd.record():
            train_out = bn(xa)
        stats = [_np(bn.running_mean.data()), _np(bn.running_var.data())]
        eval_out = bn(xa)
        assert np.array_equal(_np(bn.running_mean.data()), stats[0])
        res.append([train_out.asnumpy(), eval_out.asnumpy()] + stats)
    for t, j in zip(res[1], res[0]):
        _close(t, j, 1e-5, 1e-5)


# -- the fused bottleneck and a narrow ResNet ---------------------------------


def _bottleneck(fuse, monkeypatch, seed=3, channels=64, in_channels=32):
    monkeypatch.setenv("MXTPU_CONV_EPILOGUE", "pallas" if fuse else "")
    tmx.random.seed(seed)
    blk = trn.BottleneckV1(channels, 2, downsample=True,
                           in_channels=in_channels, layout="NHWC")
    blk.initialize(tmx.init.Xavier(), ctx=CPU)
    return blk


def _sync_params(src, dst):
    """Pair by structural order (the auto-generated prefixes differ between
    two builds) and reset the moving statistics on both."""
    for p1, p2 in zip(src.collect_params().values(),
                      dst.collect_params().values()):
        p2.set_data(p1.data().detach().clone())
    for blk in (src, dst):
        for k, p in blk.collect_params().items():
            if "running_mean" in k:
                p.set_data(torch.zeros(p.shape))
            if "running_var" in k:
                p.set_data(torch.ones(p.shape))


def test_fused_bottleneck_matches_standard(monkeypatch):
    """The port's ``MXTPU_CONV_EPILOGUE=pallas`` bottleneck against its
    standard one: the train forward, parameter gradients, moving
    statistics, and the eval forward (ref: test_conv_fused.py:146)."""
    x = tmx.nd.array(np.random.RandomState(0).rand(2, 8, 8, 32), ctx=CPU)
    blk_a = _bottleneck(False, monkeypatch)
    blk_b = _bottleneck(True, monkeypatch)
    assert blk_b._fuse and not blk_a._fuse
    blk_a(x)
    blk_b(x)  # resolves the deferred shapes through the standard path
    _sync_params(blk_a, blk_b)
    outs = []
    for blk in (blk_a, blk_b):
        with tmx.autograd.record():
            y = blk(x)
        y.backward()
        outs.append(y.asnumpy())
    _close(outs[0], outs[1], 1e-5, 0)
    for (k, pa), pb in zip(blk_a.collect_params().items(),
                           blk_b.collect_params().values()):
        if pa.grad_req == "write":
            _close(_np(pa.grad()), _np(pb.grad()), 1e-4, 0, k)
        else:
            _close(_np(pa.data()), _np(pb.data()), 1e-6, 0, k)
    _close(blk_a(x).asnumpy(), blk_b(x).asnumpy(), 1e-5, 0)


def _narrow_resnet(pkg, layout="NHWC"):
    nz = pkg.gluon.model_zoo.vision.resnet
    return nz.ResNetV1(nz.BottleneckV1, [1, 1, 1, 1],
                       [64, 256, 256, 256, 256], classes=10, layout=layout)


@pytest.mark.parametrize("fuse", [False, True])
def test_narrow_resnet_matches_jax(fuse, monkeypatch, interpret_pallas):
    """``ResNetV1(BottleneckV1, [1,1,1,1], [64,256,256,256,256])`` at
    2x64x64x3 (stage M = 512, 128, 32, 8, all on the kernels' gates) with
    the JAX package's weights: train forward, gradients, moving
    statistics, eval forward; fused (both packages through their fused
    ops, the JAX kernels in interpret mode) or standard.

    The input's seed is one at which no ReLU input of the port's forward
    lies within 1e-5 of zero (the smallest is 1.3e-5): the two packages'
    forwards differ by ~1e-6 there, so both take the same side of every
    ReLU.  Where an input lies within that rounding of zero, its ReLU can
    open in one package and not in the other, which moves the gradient of
    every layer below it by a few percent (seed 11 has one at 9.5e-7)."""
    import mxnet_tpu as jmx

    monkeypatch.setenv("MXTPU_CONV_EPILOGUE", "pallas" if fuse else "")
    monkeypatch.setenv("MXTPU_CONV_FUSED_INTERPRET", "1")
    rng = np.random.RandomState(14)
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    gy = rng.randn(2, 10).astype(np.float32)
    jmx.random.seed(0)
    jnet = _narrow_resnet(jmx)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(x))  # deferred shapes, predict mode: no BN update
    weights = {k: p.data().asnumpy().copy()
               for k, p in jnet._collect_params_with_prefix().items()}
    tnet = _narrow_resnet(tmx)
    tnet.initialize(ctx=CPU)
    tmx.load_numpy_params(tnet, weights)
    res = {}
    for name, pkg, net, xa in (
            ("jax", jmx, jnet, jmx.nd.array(x)),
            ("torch", tmx, tnet, tmx.nd.array(x, ctx=CPU))):
        hg = pkg.nd.array(gy) if name == "jax" else tmx.nd.array(gy, ctx=CPU)
        with pkg.autograd.record():
            out = net(xa)
            head = (out * hg).sum() if name == "jax" \
                else tmx.nd.NDArray((out.data * hg.data).sum())
        head.backward()
        params = net._collect_params_with_prefix()
        res[name] = dict(
            train=out.asnumpy(), eval=net(xa).asnumpy(),
            grads={k: _np(p.grad()) for k, p in params.items()
                   if p.grad_req == "write"},
            stats={k: _np(p.data()) for k, p in params.items()
                   if "running" in k})
    j, t = res["jax"], res["torch"]
    _close(t["train"], j["train"], 1e-4, 1e-4, "train forward")
    _close(t["eval"], j["eval"], 1e-4, 1e-4, "eval forward")
    # 17 BatchNorm layers: the stem's and 4 per bottleneck (downsample's)
    assert set(t["grads"]) == set(j["grads"]) and len(t["stats"]) == 34
    for k in j["grads"]:
        scale = max(1.0, float(np.abs(j["grads"][k]).max()))
        _close(t["grads"][k], j["grads"][k], 1e-4 * scale, 1e-3, k)
    for k in j["stats"]:
        _close(t["stats"][k], j["stats"][k], 1e-5, 1e-4, k)


# -- DataParallelTrainer ------------------------------------------------------


def _small_net(pkg):
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Conv2D(8, 3, padding=1, use_bias=False, layout="NHWC"),
            nn.BatchNorm(axis=-1), nn.Activation("relu"),
            nn.Conv2D(16, 3, strides=2, padding=1, use_bias=False,
                      layout="NHWC"),
            nn.BatchNorm(axis=-1), nn.Activation("relu"),
            nn.GlobalAvgPool2D(layout="NHWC"), nn.Flatten(), nn.Dense(5))
    return net


@pytest.mark.parametrize("opt,params,accum", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}, 1),
    ("adam", {"learning_rate": 0.01, "wd": 1e-4}, 1),
    ("adamw", {"learning_rate": 0.01, "wd": 0.01}, 1),
    ("lamb", {"learning_rate": 0.01, "wd": 0.01, "clip_gradient": 1.0}, 1),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}, 2),
])
def test_data_parallel_trainer_matches_jax(opt, params, accum):
    """Three steps against the JAX trainer (on a one-device mesh) from the
    same weights, for each update rule of ``apply_opt``: losses, then the
    parameters and moving statistics after ``sync_to_block``.  With
    ``accum_steps=2`` both take the moving statistics from the last
    micro-batch (ROADMAP caveat (c)).  Until
    ``sync_to_block`` the block's own parameters stay as they were, as the
    JAX trainer's do."""
    import jax
    import mxnet_tpu as jmx
    from mxnet_tpu.parallel import data_parallel as jdp
    from mxnet_tpu.parallel import mesh as jmesh

    rng = np.random.RandomState(21)
    x = rng.rand(8, 8, 8, 3).astype(np.float32)
    y = rng.randint(0, 5, 8).astype(np.float32)
    jmx.random.seed(1)
    jnet = _small_net(jmx)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(x[:2]))
    start = {k: p.data().asnumpy().copy()
             for k, p in jnet._collect_params_with_prefix().items()}
    tnet = _small_net(tmx)
    tnet.initialize(ctx=CPU)
    tmx.load_numpy_params(tnet, start)
    jtr = jdp.DataParallelTrainer(
        jnet, jmx.gluon.loss.SoftmaxCrossEntropyLoss(), opt, dict(params),
        mesh=jmesh.make_mesh(devices=jax.devices()[:1]), accum_steps=accum)
    ttr = DataParallelTrainer(tnet, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                              opt, dict(params), accum_steps=accum)
    jl = [float(jtr.step(x, y).asnumpy()) for _ in range(3)]
    tl = [float(ttr.step(x, y).asnumpy()) for _ in range(3)]
    _close(tl, jl, 0, 1e-4, "losses")
    for k, p in tnet._collect_params_with_prefix().items():
        assert np.array_equal(_np(p.data()), start[k]), k
    jtr.sync_to_block()
    ttr.sync_to_block()
    tw = _weights(tnet)
    for k, p in jnet._collect_params_with_prefix().items():
        _close(tw[k], p.data().asnumpy(), 1e-4, 1e-3, k)


def test_data_parallel_trainer_compute_dtype_keeps_fp32_masters():
    """``compute_dtype='bfloat16'``: the forward runs in bf16, the masters,
    the optimizer states and the moving statistics stay fp32, and the
    loss falls."""
    tmx.random.seed(2)
    net = _small_net(tmx)
    net.initialize(tmx.init.Xavier(), ctx=CPU)
    tr = DataParallelTrainer(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                             "sgd", {"learning_rate": 0.1, "momentum": 0.9},
                             compute_dtype="bfloat16")
    rng = np.random.RandomState(3)
    x = rng.rand(8, 8, 8, 3).astype(np.float32)
    y = rng.randint(0, 5, 8).astype(np.float32)
    losses = tr.step_many(x, y, n_steps=5).asnumpy()
    assert losses.shape == (5,) and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert all(p.dtype == torch.float32 for p in tr._params)
    assert all(s.dtype == torch.float32 for s in tr._states if s is not None)


def test_data_parallel_trainer_raises_for_later_slices():
    net = _small_net(tmx)
    net.initialize(ctx=CPU)
    loss = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    for kw, slice_no in ((dict(mesh=object()), 7),
                         (dict(shard_params=True), 7),
                         (dict(shard_opt_states=True), 7),
                         (dict(param_spec_fn=lambda n, s: None), 7),
                         (dict(remat=True), 7)):
        with pytest.raises(MXNetError, match=f"slice {slice_no}"):
            DataParallelTrainer(net, loss, "sgd", **kw)
    # checkpoints came with slice 6; before a step there is nothing to save
    # and nothing to load into, as in the JAX class
    tr = DataParallelTrainer(net, loss, "sgd")
    with pytest.raises(MXNetError, match="before the first step"):
        tr.save_states("p")
    with pytest.raises(MXNetError, match="requires a built trainer"):
        tr.load_states("p")
    with pytest.raises(MXNetError, match="sgd/adam"):
        DataParallelTrainer(net, loss, "rmsprop")


# -- the LeNet gate -----------------------------------------------------------


@pytest.mark.parametrize("opt,params", [
    ("sgd", {"learning_rate": 0.1}),
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.002}),
])
def test_lenet_synthetic_convergence(opt, params):
    """tests/test_gluon.py's gate in the port: LeNet, hybridized, learns
    synthetic MNIST-like data (class k has a bright k-quadrant) to above
    95% train accuracy, with the loss more than halved."""
    np.random.seed(42)
    tmx.random.seed(42)
    n = 256
    X = np.random.rand(n, 1, 28, 28).astype(np.float32) * 0.1
    y = np.random.randint(0, 2, n)
    X[y == 0, :, :14, :14] += 0.9
    X[y == 1, :, 14:, 14:] += 0.9
    nn = tmx.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Conv2D(8, kernel_size=5, activation="relu"),
            nn.MaxPool2D(2),
            nn.Conv2D(16, kernel_size=5, activation="relu"),
            nn.MaxPool2D(2),
            nn.Flatten(),
            nn.Dense(64, activation="relu"),
            nn.Dense(2))
    net.initialize(tmx.init.Xavier(), ctx=CPU)
    net.hybridize()
    trainer = tmx.gluon.Trainer(net.collect_params(), opt, dict(params))
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    bs, losses = 32, []
    for _ in range(3):
        for i in range(0, n, bs):
            xb = tmx.nd.array(X[i:i + bs], ctx=CPU)
            yb = tmx.nd.array(y[i:i + bs], ctx=CPU)
            with tmx.autograd.record():
                loss = loss_fn(net(xb), yb)
            loss.backward()
            trainer.step(bs)
            losses.append(float(loss.asnumpy().mean()))
    pred = net(tmx.nd.array(X, ctx=CPU)).asnumpy().argmax(axis=1)
    acc = float((pred == y).mean())
    assert acc > 0.95, (acc, losses[:5], losses[-5:])
    assert losses[-1] < losses[0] * 0.5


# -- on the card --------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernels have no CPU "
                    "mode); run on the GPU machine with -m gpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_fused_bottleneck_launches_kernels_and_matches_cpu_on_card(
        cuda_device, monkeypatch):
    """One training forward and backward of the fused bottleneck on the
    card: matmul_bn_stats twice (conv1, downsample), bn_stats once (bn2),
    bn_act_matmul_stats once (conv3), no plain call; then a predict-mode
    forward launches bn_act_matmul once.  Output and gradients equal the
    CPU's within 1e-4 plus 1e-4 relative of each gradient's largest
    magnitude (fp32, TF32 off)."""
    from mxnet_tpu_torch.ops import kernels

    # widths on the kernels' gates: K and N multiples of 64, M of 8
    x = np.random.RandomState(0).rand(4, 16, 16, 64).astype(np.float32)
    res = {}
    for dev in ("cpu", "gpu"):
        blk = _bottleneck(True, monkeypatch, channels=256, in_channels=64)
        ctx = tmx.cpu() if dev == "cpu" else tmx.gpu(0)
        if dev == "cpu":
            blk(tmx.nd.array(x, ctx=ctx))
            weights = _weights(blk)
        else:
            blk.initialize(ctx=ctx, force_reinit=True)
            tmx.load_numpy_params(blk, weights)
        xa = tmx.nd.array(x, ctx=ctx)
        kernels.reset_counts()
        with tmx.autograd.record():
            out = blk(xa)
        out.backward()
        counts = {k: (c.launches, c.plain_calls_on_cuda)
                  for k, c in kernels.KERNEL_COUNTS.items()}
        blk(xa)
        res[dev] = (out.asnumpy(), {k: _np(p.grad().cpu()) for k, p in
                                    blk._collect_params_with_prefix().items()
                                    if p.grad_req == "write"})
        if dev == "gpu":
            assert counts["matmul_bn_stats"] == (2, 0)
            assert counts["bn_stats"] == (1, 0)
            assert counts["bn_act_matmul_stats"] == (1, 0)
            assert kernels.KERNEL_COUNTS["bn_act_matmul"].launches == 1
    _close(res["gpu"][0], res["cpu"][0], 1e-4, 1e-4)
    for k, g in res["cpu"][1].items():
        _close(res["gpu"][1][k], g, 1e-4 * max(1, np.abs(g).max()), 1e-4, k)


@pytest.mark.gpu
def test_trainer_bf16_step_on_card(cuda_device, monkeypatch):
    """A bf16 DataParallelTrainer step of the narrow fused ResNet on the
    card launches every training kernel once per bottleneck and none on
    the plain path."""
    from mxnet_tpu_torch.ops import kernels

    monkeypatch.setenv("MXTPU_CONV_EPILOGUE", "pallas")
    tmx.random.seed(0)
    net = _narrow_resnet(tmx)
    net.initialize(tmx.init.Xavier(), ctx=tmx.gpu(0))
    tr = DataParallelTrainer(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                             "sgd", {"learning_rate": 0.1, "momentum": 0.9},
                             compute_dtype="bfloat16")
    rng = np.random.RandomState(1)
    x = rng.rand(8, 64, 64, 3).astype(np.float32)
    y = rng.randint(0, 10, 8).astype(np.float32)
    tr.build(x)
    kernels.reset_counts()
    losses = [float(tr.step(x, y).asnumpy()) for _ in range(3)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    c = kernels.KERNEL_COUNTS
    # every bottleneck of this net has a downsample: 4 conv1 + 4 downsample
    assert c["matmul_bn_stats"].launches == 3 * 8
    assert c["bn_stats"].launches == 3 * 4
    assert c["bn_act_matmul_stats"].launches == 3 * 4
    assert all(v.plain_calls_on_cuda == 0 for v in c.values())
