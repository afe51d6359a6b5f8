"""The captured whole step of the PyTorch port (``gluon/whole_step.py``,
``Trainer.whole_step``, ``DataParallelTrainer.step``/``step_many``).

On the CPU the step body runs eagerly at every call, so these tests hold
its arithmetic and its bookkeeping: against the JAX package's
``Trainer(whole_step=True)`` and ``DataParallelTrainer``, and bit for bit
against the port's own eager paths (the fused step, the sequential step
with ``aggregate_num=1`` and the record/backward/step loop).  The net and
data are ``tests/test_whole_step.py``'s: 3 x Dense(16, relu) + Dense(4),
X and Y from ``RandomState(1)`` and ``RandomState(2)``.

Tolerances.  Against the JAX package: 1e-6 absolute plus 1e-5 relative,
``tests/test_torch_train.py``'s for one update, on the losses and the
weights after 5 steps (float32 on both sides, the same arithmetic summed
in other orders).  The port's own paths: bit for bit.

The ``gpu``-marked tests need the card (a CUDA graph has no CPU mode) and
skip here; run them on the GPU machine with
``python -m pytest -m gpu --noconftest tests/test_torch_whole_step.py``.
They hold the captured step against the eager one bit for bit.
"""
import logging

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import _imperative
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon import trainer as trainer_mod
from mxnet_tpu_torch.ops.kernels import build as kbuild
from mxnet_tpu_torch.parallel import DataParallelTrainer

CPU = tmx.cpu()
X = np.random.RandomState(1).rand(8, 16).astype(np.float32)
Y = np.random.RandomState(2).rand(8, 4).astype(np.float32)
OPTS = [
    ("sgd", {"learning_rate": 0.05, "wd": 0.01}),
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 0.01}),
    ("adam", {"learning_rate": 0.01, "wd": 0.01}),
]
OPT_IDS = ["sgd", "sgd_mom", "adam"]


def loss_fn(out, y):
    return (out - y) ** 2


def _mlp(pkg, layers=3):
    net = pkg.gluon.nn.HybridSequential()
    for _ in range(layers):
        net.add(pkg.gluon.nn.Dense(16, in_units=16, activation="relu"))
    net.add(pkg.gluon.nn.Dense(4, in_units=16))
    return net


def build(whole_step, opt="sgd", opt_args=None, ctx=CPU, aggregate_num=None,
          weights=None):
    """The MLP on ``ctx`` (Xavier from seed 0, or ``weights``) and its
    Trainer."""
    tmx.random.seed(0)
    np.random.seed(0)
    net = _mlp(tmx)
    net.initialize(tmx.init.Xavier(), ctx=ctx)
    if weights is not None:
        tmx.load_numpy_params(net, weights)
    kwargs = dict(opt_args or {"learning_rate": 0.05, "momentum": 0.9,
                               "wd": 0.01})
    if aggregate_num is not None:
        kwargs["aggregate_num"] = aggregate_num
    tr = tmx.gluon.Trainer(net.collect_params(), opt, kwargs,
                           whole_step=whole_step)
    return net, tr


def weights(net):
    return [p.data().detach().cpu().clone() for p in
            net.collect_params().values()]


def assert_bitwise(a, b, msg=""):
    assert len(a) == len(b), msg
    for i, (u, v) in enumerate(zip(a, b)):
        assert torch.equal(u, v), f"{msg} tensor {i}"


# -- against the JAX package ---------------------------------------------------


@pytest.mark.parametrize("opt,opt_args", OPTS, ids=OPT_IDS)
def test_whole_step_matches_jax_whole_step(opt, opt_args):
    """5 whole steps per package from the JAX package's initial weights
    (carried across with ``load_numpy_params``): losses and weights."""
    import mxnet_tpu as jmx

    jmx.random.seed(0)
    np.random.seed(0)
    jnet = _mlp(jmx)
    jnet.initialize(jmx.init.Xavier())
    start = {k: p.data().asnumpy().copy()
             for k, p in jnet._collect_params_with_prefix().items()}
    jtr = jmx.gluon.Trainer(jnet.collect_params(), opt, dict(opt_args),
                            whole_step=True)
    jl = [float(jtr.whole_step(jnet, loss_fn, X, Y).asnumpy())
          for _ in range(5)]
    tnet, ttr = build(True, opt, opt_args, weights=start)
    tl = [float(ttr.whole_step(tnet, loss_fn, X, Y).asnumpy())
          for _ in range(5)]
    np.testing.assert_allclose(tl, jl, atol=1e-6, rtol=1e-5)
    tparams = tnet._collect_params_with_prefix()
    for name, p in jnet._collect_params_with_prefix().items():
        np.testing.assert_allclose(
            tparams[name].data().detach().numpy(), p.data().asnumpy(),
            atol=1e-6, rtol=1e-5, err_msg=name)


# -- the port's own bit contracts ----------------------------------------------


@pytest.mark.parametrize("opt,opt_args", OPTS, ids=OPT_IDS)
def test_whole_step_bit_parity_vs_fused_and_sequential(opt, opt_args):
    """The whole step, the eager fused step and the eager sequential step
    (``aggregate_num=1``) through the same ``whole_step`` call: weights
    and losses bit for bit after 5 steps, and the same update count."""
    arms = {}
    for name, ws, agg in (("whole", True, None), ("fused", False, None),
                          ("seq", False, 1)):
        net, tr = build(ws, opt, opt_args, aggregate_num=agg)
        losses = [tr.whole_step(net, loss_fn, X, Y).data for _ in range(5)]
        arms[name] = (weights(net), losses, tr)
    for name in ("fused", "seq"):
        assert_bitwise(arms["whole"][0], arms[name][0], name)
        assert_bitwise(arms["whole"][1], arms[name][1], name + " losses")
        assert arms["whole"][2].optimizer.num_update == \
            arms[name][2].optimizer.num_update


def test_whole_step_matches_record_backward_step_loop():
    """The whole step equals the user's loop (``autograd.record``, the
    forward, ``autograd.backward`` of the unreduced loss, ``trainer.step``)
    bit for bit."""
    net_w, tr_w = build(True)
    for _ in range(4):
        tr_w.whole_step(net_w, loss_fn, X, Y)
    net_c, tr_c = build(False)
    for _ in range(4):
        with tmx.autograd.record():
            out = net_c(torch.from_numpy(X))
            loss = loss_fn(out, torch.from_numpy(Y))
        tmx.autograd.backward(loss)
        tr_c.step(8)
    assert_bitwise(weights(net_w), weights(net_c))


class _Mixed(tmx.gluon.HybridBlock):
    """Parameters of two dtypes: separate update groups."""

    def __init__(self):
        super().__init__()
        self.w32 = self.params.get("w32", shape=(16, 4), dtype="float32",
                                   init=tmx.init.Xavier())
        self.w16 = self.params.get("w16", shape=(16, 4), dtype="float16",
                                   init=tmx.init.Xavier())
        self.b32 = self.params.get("b32", shape=(4,), dtype="float32",
                                   init="zeros")

    def hybrid_forward(self, F, x, w32=None, w16=None, b32=None):
        return x @ w32 + (x.half() @ w16).float() + b32


def test_whole_step_mixed_dtype_params_bit_parity():
    """fp32 and fp16 parameters ride separate chunks of the plan, as they
    ride separate groups of the fused step: whole, fused and sequential
    agree bit for bit."""
    arms = []
    for ws, agg in ((True, None), (False, None), (False, 1)):
        tmx.random.seed(0)
        blk = _Mixed()
        blk.initialize(ctx=CPU)
        kw = {"learning_rate": 0.05, "momentum": 0.9}
        if agg is not None:
            kw["aggregate_num"] = agg
        tr = tmx.gluon.Trainer(blk.collect_params(), "sgd", kw,
                               whole_step=ws)
        for _ in range(4):
            tr.whole_step(blk, loss_fn, X, Y)
        arms.append(weights(blk))
    assert {w.dtype for w in arms[0]} == {torch.float32, torch.float16}
    for other in arms[1:]:
        assert_bitwise(arms[0], other)


def test_whole_step_batchnorm_moving_stats():
    """BatchNorm's moving statistics stay on the whole step (committed in
    place by the forward) and move as the eager step moves them."""
    def build_bn(ws):
        tmx.random.seed(0)
        net = nn.HybridSequential()
        net.add(nn.Dense(8, in_units=16), nn.BatchNorm(in_channels=8),
                nn.Dense(4, in_units=8))
        net.initialize(tmx.init.Xavier(), ctx=CPU)
        tr = tmx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.05}, whole_step=ws)
        return net, tr

    arms = []
    for ws in (True, False):
        net, tr = build_bn(ws)
        start = weights(net)
        for _ in range(3):
            tr.whole_step(net, loss_fn, X, Y)
        arms.append(weights(net))
    names = list(net.collect_params())
    moved = [n for n, a, b in zip(names, start, arms[0])
             if "running" in n and not torch.equal(a, b)]
    assert len(moved) == 2
    assert_bitwise(arms[0], arms[1])


# -- counters and caches --------------------------------------------------------


def test_whole_step_no_new_signature_under_decaying_lr():
    """15 steps under a decaying FactorScheduler after 3 warm steps: no
    new step signature, one dispatch a step, and the lr did decay."""
    tmx.random.seed(0)
    net = nn.HybridSequential()
    for _ in range(4):
        net.add(nn.Dense(16, in_units=16))
    net.initialize(tmx.init.Xavier(), ctx=CPU)
    sched = tmx.lr_scheduler.FactorScheduler(step=3, factor=0.9,
                                             base_lr=0.1)
    tr = tmx.gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": 0.1, "lr_scheduler": sched},
                           whole_step=True)
    y16 = np.random.RandomState(3).rand(8, 16).astype(np.float32)
    for _ in range(3):
        tr.whole_step(net, loss_fn, X, y16)
    lr0 = tr.learning_rate
    trainer_mod.reset_trainer_step_stats()
    c0 = _imperative.compiled_executable_count()
    d0 = _imperative.device_dispatch_count()
    for _ in range(15):
        tr.whole_step(net, loss_fn, X, y16)
    stats = trainer_mod.trainer_step_stats()
    assert _imperative.compiled_executable_count() == c0
    assert _imperative.device_dispatch_count() - d0 == 15
    assert stats["whole_step_steps"] == 15
    assert stats["whole_step_compiles"] == 0
    assert stats["whole_step_fallbacks"] == 0
    assert stats["dispatches_per_step"] == 1.0
    assert tr.learning_rate < lr0


def test_whole_step_closure_cache_bounded_under_unstable_loss_fn(caplog):
    """A fresh lambda per call makes a new closure each time, but the
    cache stays bounded (and says so once); a stable loss_fn trains on."""
    net, tr = build(True)
    with caplog.at_level(logging.WARNING, "mxnet_tpu_torch.whole_step"):
        for i in range(14):
            tr.whole_step(net, lambda out, y, _i=i: (out - y) ** 2, X, Y)
            comp = tr._whole_step_compiler
            assert len(comp._closures) <= comp.MAX_CLOSURES
    assert sum("overflow" in r.message for r in caplog.records) == 1
    before = weights(net)
    tr.whole_step(net, loss_fn, X, Y)
    tr.whole_step(net, loss_fn, X, Y)
    assert any(not torch.equal(a, b) for a, b in zip(before, weights(net)))
    assert len(comp._closures) <= comp.MAX_CLOSURES
    assert len(comp._seen_sigs) <= comp.MAX_CLOSURES


def test_whole_step_disabled_runs_eager_silently():
    net, tr = build(False)
    trainer_mod.reset_trainer_step_stats()
    tr.whole_step(net, loss_fn, X, Y)
    stats = trainer_mod.trainer_step_stats()
    assert stats["steps"] == 1
    assert stats["whole_step_steps"] == 0
    assert stats["whole_step_fallbacks"] == 0  # disabled is not a bypass


def test_whole_step_env_knob(monkeypatch):
    monkeypatch.setenv("MXTPU_WHOLE_STEP", "1")
    _, tr = build(None)
    assert tr.whole_step_enabled
    monkeypatch.setenv("MXTPU_WHOLE_STEP", "0")
    _, tr2 = build(None)
    assert not tr2.whole_step_enabled
    monkeypatch.setenv("MXTPU_WHOLE_STEP", "1")
    _, tr3 = build(False)  # the argument wins over the knob
    assert not tr3.whole_step_enabled


@pytest.mark.parametrize("case", ["grad_add", "foreign_param"])
def test_whole_step_bypass_falls_back_loudly(case, caplog):
    """A configuration the whole step cannot take runs the eager step,
    warns once and counts one fallback; the step still trains."""
    tmx.random.seed(0)
    net = nn.HybridSequential()
    net.add(nn.Dense(4, in_units=16))
    net.initialize(tmx.init.Xavier(), ctx=CPU)
    params = list(net.collect_params().values())
    if case == "grad_add":
        for p in params:
            p.grad_req = "add"
    else:
        extra = tmx.gluon.Parameter("extra", shape=(3,))
        extra.initialize(ctx=CPU)
        params.append(extra)
    tr = tmx.gluon.Trainer(params, "sgd", {"learning_rate": 0.01},
                           whole_step=True)
    before = weights(net)
    trainer_mod.reset_trainer_step_stats()
    with caplog.at_level(logging.WARNING, "mxnet_tpu_torch.whole_step"):
        tr.whole_step(net, loss_fn, X, Y)
        if case == "grad_add":
            tr.whole_step(net, loss_fn, X, Y)
    stats = trainer_mod.trainer_step_stats()
    calls = 2 if case == "grad_add" else 1
    assert stats["whole_step_fallbacks"] == calls
    assert stats["whole_step_steps"] == 0
    assert sum("bypassed" in r.message for r in caplog.records) == 1
    assert any(not torch.equal(a, b) for a, b in zip(before, weights(net)))


def test_whole_step_completes_deferred_shapes_eagerly():
    """A net with deferred shapes: the first whole step runs the eager twin
    (which infers them) and later ones take the whole step; the result
    equals the eager path's bit for bit."""
    arms = []
    for ws in (True, False):
        tmx.random.seed(0)
        net = nn.HybridSequential()
        net.add(nn.Dense(16, activation="relu"), nn.Dense(4))
        net.initialize(tmx.init.Xavier(), ctx=CPU)
        tr = tmx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 0.01}, whole_step=ws)
        trainer_mod.reset_trainer_step_stats()
        losses = [tr.whole_step(net, loss_fn, X, Y).data for _ in range(3)]
        arms.append((weights(net), losses,
                     trainer_mod.trainer_step_stats()))
        if ws:
            tr_whole, net_whole = tr, net
    assert_bitwise(arms[0][0], arms[1][0])
    assert_bitwise(arms[0][1], arms[1][1])
    assert arms[0][2]["whole_step_steps"] == 3
    assert arms[0][2]["steps"] == 3
    # the eager twin warmed this signature: on the card the next call
    # captures
    comp = tr_whole._whole_step_compiler
    assert list(comp._warm) == [(net_whole, loss_fn, (
        ((8, 16), torch.float32), ((8, 4), torch.float32)))]


def test_whole_step_plan_refuses_before_any_tick():
    """A refused plan leaves the update counts alone; an accepted one ticks
    every index as fused_update does, and groups as it does."""
    opt = tmx.optimizer.create("sgd", learning_rate=0.1, aggregate_num=2)
    ws = [torch.ones(3), torch.ones(2, dtype=torch.int32)]
    plan, svals, reason = opt.whole_step_plan([0, 1], ws, [None, None])
    assert plan is None and "non-float" in reason
    assert opt.num_update == 0 and not opt._index_update_count
    ws = [torch.ones(3), torch.ones(2), torch.ones(4, dtype=torch.float16)]
    plan, svals, reason = opt.whole_step_plan([0, 1, 2], ws, [None] * 3)
    assert reason is None and opt.num_update == 1
    assert [c[4] for c in plan] == [(0, 1), (2,)]
    assert [c[5] for c in plan] == [("lr", "t", "wd", "rescale")] * 2
    assert svals[0] == (0.1, 1.0, 0.0, 1.0)


# -- launch counts under replay and the generators ------------------------------


def test_captured_launches_count_once_per_replay(monkeypatch):
    """The launches made on the capture stream during a capture stay out
    of the counters, and are added at each replay."""
    counts = kbuild.KernelCounts("reg_launches")
    counts.add("launches")
    # on the card, the launches of the capture stream (no stream captures
    # on the CPU)
    monkeypatch.setattr(kbuild, "launch_is_captured", lambda: True)
    rec = kbuild.CapturedLaunches()
    counts.add("launches", "reg_launches")
    counts.add("plain_calls_on_cuda")
    rec.finish()
    assert (counts.launches, counts.reg_launches,
            counts.plain_calls_on_cuda) == (1, 0, 0)
    for _ in range(3):
        rec.replay()
    assert (counts.launches, counts.reg_launches,
            counts.plain_calls_on_cuda) == (4, 3, 3)


def test_seed_reseeds_generators_in_place():
    """``mx.random.seed`` keeps each device's generator object (a captured
    graph holds it) and restarts its stream."""
    tmx.random.seed(4)
    gen = tmx.random.generator("cpu")
    first = torch.rand(3, generator=gen)
    tmx.random.seed(4)
    assert tmx.random.generator("cpu") is gen
    assert tmx.random.default_pool.generators("cpu") == [gen]
    assert torch.equal(torch.rand(3, generator=gen), first)


# -- DataParallelTrainer ---------------------------------------------------------


def _small_net(pkg):
    nn_ = pkg.gluon.nn
    net = nn_.HybridSequential()
    net.add(nn_.Conv2D(8, 3, padding=1, use_bias=False, layout="NHWC"),
            nn_.BatchNorm(axis=-1), nn_.Activation("relu"),
            nn_.GlobalAvgPool2D(layout="NHWC"), nn_.Flatten(), nn_.Dense(5))
    return net


def _dp_data(k=None, seed=21):
    rng = np.random.RandomState(seed)
    lead = () if k is None else (k,)
    x = rng.rand(*lead, 8, 8, 8, 3).astype(np.float32)
    y = rng.randint(0, 5, lead + (8,)).astype(np.float32)
    return x, y


@pytest.mark.parametrize("opt,params", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}),
    ("adam", {"learning_rate": 0.01, "wd": 1e-4}),
], ids=["sgd_mom", "adam"])
def test_data_parallel_step_matches_jax(opt, params):
    """4 steps against the JAX trainer (one-device mesh) from the same
    weights: losses within 1e-4 relative, then the parameters and moving
    statistics within 1e-4 plus 1e-3 relative after ``sync_to_block``
    (``tests/test_torch_resnet.py``'s limits for this trainer)."""
    import jax
    import mxnet_tpu as jmx
    from mxnet_tpu.parallel import data_parallel as jdp
    from mxnet_tpu.parallel import mesh as jmesh

    x, y = _dp_data()
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
        mesh=jmesh.make_mesh(devices=jax.devices()[:1]))
    ttr = DataParallelTrainer(tnet, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                              opt, dict(params))
    jl = [float(jtr.step(x, y).asnumpy()) for _ in range(4)]
    tl = [float(ttr.step(x, y).asnumpy()) for _ in range(4)]
    np.testing.assert_allclose(tl, jl, atol=0, rtol=1e-4)
    jtr.sync_to_block()
    ttr.sync_to_block()
    tparams = tnet._collect_params_with_prefix()
    for k, p in jnet._collect_params_with_prefix().items():
        np.testing.assert_allclose(tparams[k].data().detach().numpy(),
                                   p.data().asnumpy(), atol=1e-4, rtol=1e-3,
                                   err_msg=k)


def _dp_trainer(opt="adam"):
    tmx.random.seed(2)
    net = _small_net(tmx)
    net.initialize(tmx.init.Xavier(), ctx=CPU)
    params = {"learning_rate": 0.01, "momentum": 0.9} if opt == "sgd" \
        else {"learning_rate": 0.01, "wd": 1e-4}
    tr = DataParallelTrainer(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                             opt, params)
    tr.build(_dp_data()[0])  # deferred shapes, drawn from seed 2
    return tr


@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "reused"])
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_data_parallel_step_many_equals_k_steps(opt, stacked):
    """``step_many`` over a staged stack of 3 batches, or one batch reused
    3 times, equals 3 ``step`` calls bit for bit: losses, masters and
    states."""
    xs, ys = _dp_data(k=3)
    a, b = _dp_trainer(opt), _dp_trainer(opt)
    if stacked:
        many = a.step_many(xs, ys).data
        one = [b.step(xs[i], ys[i]).data for i in range(3)]
    else:
        many = a.step_many(xs[0], ys[0], n_steps=3).data
        one = [b.step(xs[0], ys[0]).data for _ in range(3)]
    assert many.shape == (3,)
    assert torch.equal(many, torch.stack(one))
    assert_bitwise(a._params, b._params, "masters")
    sa = [s for st in a._states if st is not None
          for s in (st if isinstance(st, tuple) else (st,))]
    sb = [s for st in b._states if st is not None
          for s in (st if isinstance(st, tuple) else (st,))]
    assert_bitwise(sa, sb, "states")
    assert a._t == b._t == 3


def test_data_parallel_signatures_are_counted_once():
    tr = _dp_trainer()
    x, y = _dp_data()
    c0 = _imperative.compiled_executable_count()
    d0 = _imperative.device_dispatch_count()
    for _ in range(4):
        tr.step(x, y)
    tr.step(x[:4], y[:4])
    assert _imperative.compiled_executable_count() - c0 == 2
    assert _imperative.device_dispatch_count() - d0 == 5


# -- the attention op's routing (ROADMAP queue 3, repaired) ----------------------


def test_sdpa_op_takes_the_oracle_on_cpu_tensors_as_the_jax_op():
    """The repaired fault.  b=2, h=2, s=128, d=64, fp32 inputs from
    ``RandomState(0)`` x 0.5 and a (b,1,1,s) mask whose batch row 1 is all
    -1e9: at this length the flash entry takes CPU tensors, but the op
    must take the oracle there, as the JAX op does off a TPU.  Forward and
    gradients (dead row included) within 1e-6 of the JAX op's; through the
    flash entry the dead row's gradients differed by up to 17.5."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.ops import attention as jattn

    from mxnet_tpu_torch.ops import attention as tattn

    b, h, s, d = 2, 2, 128, 64
    rng = np.random.RandomState(0)
    q, k, v, do = (rng.randn(b, h, s, d).astype(np.float32) * 0.5
                   for _ in range(4))
    mask = np.zeros((b, 1, 1, s), np.float32)
    mask[1] = -1e9

    def jloss(q, k, v):
        return jnp.sum(jattn._k_sdpa(q, k, v, jnp.asarray(mask)) * do)

    jout = jattn._k_sdpa(*map(jnp.asarray, (q, k, v)), jnp.asarray(mask))
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = tattn._k_sdpa(*ts, torch.from_numpy(mask))
    grads = torch.autograd.grad(out, ts, torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-6, rtol=0)
    for g, jg, name in zip(grads, jgrads, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-6,
                                   rtol=0, err_msg="d" + name)


def test_disable_pallas_knob_keeps_cpu_tensors_on_the_oracle(monkeypatch):
    from mxnet_tpu_torch.ops import attention as tattn

    monkeypatch.setenv("MXTPU_DISABLE_PALLAS", "1")
    q = torch.from_numpy(
        np.random.RandomState(0).randn(1, 2, 128, 64).astype(np.float32))
    torch.testing.assert_close(tattn._k_sdpa(q, q, q),
                               tattn.sdpa_reference(q, q, q), rtol=0, atol=0)


# -- on the card -----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph and the kernels have "
                    "no CPU mode); run on the GPU machine with -m gpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _counts():
    from mxnet_tpu_torch.ops import kernels

    return {k: c.snapshot() for k, c in kernels.KERNEL_COUNTS.items()}


def _gain(before, after):
    return {k: {n: after[k][n] - before[k][n] for n in after[k]
                if after[k][n] != before[k][n]}
            for k in after if after[k] != before[k]}


def _eager_vs_captured(make, step, n=4):
    """Run ``n`` steps eagerly and ``n`` through the captured path from the
    same start (``make(whole)`` builds a fresh model and its trainer);
    returns both arms' (losses, tensors) and the launch gains of each
    eager step and each replay."""
    arms = {}
    for whole in (False, True):
        model, tr, tensors = make(whole)
        losses, gains = [], []
        for _ in range(n):
            before = _counts()
            losses.append(step(model, tr).detach().clone())
            torch.cuda.synchronize()
            gains.append(_gain(before, _counts()))
        arms[whole] = (losses, [t.detach().clone() for t in tensors()],
                       gains)
    return arms


def _assert_captured_equals_eager(arms, replays_from=1):
    (el, et, eg), (cl, ct, cg) = arms[False], arms[True]
    assert_bitwise(el, cl, "losses")
    assert_bitwise(et, ct, "tensors")
    for i in range(replays_from, len(cg)):
        assert cg[i] == eg[i], f"launches of step {i}"


@pytest.mark.gpu
@pytest.mark.parametrize("opt,opt_args", OPTS, ids=OPT_IDS)
def test_captured_mlp_equals_eager_on_card(cuda_device, opt, opt_args):
    c0 = _imperative.graph_capture_count()
    r0 = _imperative.graph_replay_count()

    def make(whole):
        net, tr = build(whole, opt, opt_args, ctx=tmx.gpu(0))
        return net, tr, lambda: [p.data() for p in
                                 net.collect_params().values()]

    arms = _eager_vs_captured(
        make, lambda net, tr: tr.whole_step(net, loss_fn, X, Y).data, n=5)
    _assert_captured_equals_eager(arms)
    assert _imperative.graph_capture_count() - c0 == 1
    assert _imperative.graph_replay_count() - r0 == 4


@pytest.mark.gpu
def test_captured_bert_with_dropout_equals_eager_on_card(cuda_device):
    """A 2-layer BERT (units 128, 2 heads of 64, dropout 0.1) through the
    MLM head at s=128 with padding: 4 AdamW whole steps equal 4 eager
    steps bit for bit (dropout draws the same masks at each replay), and
    each replay launches the flash kernels as the eager step does."""
    b, s = 4, 128
    rng = np.random.RandomState(10)
    ids = rng.randint(4, 1000, (b, s)).astype(np.int32)
    types = np.zeros((b, s), np.int32)
    valid = np.array([128, 100, 77, 128], np.float32)

    class MLM(tmx.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.bert = tmx.models.BERTModel(1000, 128, 256, 2, 2,
                                             max_length=128, dropout=0.1,
                                             use_classifier=False,
                                             use_pooler=False)

        def hybrid_forward(self, F, ids, types, valid):
            return F.mean(F.log_softmax(self.bert(ids, types, valid)))

    def make(whole):
        tmx.random.seed(0)
        net = MLM()
        net.initialize(tmx.init.Normal(0.02), ctx=tmx.gpu(0))
        tr = tmx.gluon.Trainer(net.collect_params(), "adamw",
                               {"learning_rate": 1e-3, "wd": 0.01},
                               whole_step=whole)
        return net, tr, lambda: [p.data() for p in
                                 net.collect_params().values()]

    batch = [tmx.nd.array(a, ctx=tmx.gpu(0)) for a in (ids, types, valid)]
    arms = _eager_vs_captured(
        make, lambda net, tr: tr.whole_step(net, lambda out: out, batch,
                                            batch_size=1).data)
    _assert_captured_equals_eager(arms, replays_from=2)
    assert arms[True][2][3]["flash_attention_fwd"]["launches"] == 2


@pytest.mark.gpu
def test_captured_resnet_data_parallel_equals_eager_on_card(
        cuda_device, monkeypatch):
    """The narrow fused ResNet through ``DataParallelTrainer`` in bf16: the
    captured steps equal the eager ones bit for bit where cuDNN's
    convolutions are deterministic; the launches of each replay equal an
    eager step's."""
    monkeypatch.setenv("MXTPU_CONV_EPILOGUE", "pallas")
    torch.backends.cudnn.deterministic = True
    try:
        nz = tmx.gluon.model_zoo.vision.resnet
        rng = np.random.RandomState(1)
        x = torch.from_numpy(rng.rand(8, 64, 64, 3).astype(np.float32)) \
            .cuda()
        y = torch.from_numpy(rng.randint(0, 10, 8).astype(np.float32)) \
            .cuda()

        def make(whole):
            tmx.random.seed(0)
            net = nz.ResNetV1(nz.BottleneckV1, [1, 1, 1, 1],
                              [64, 256, 256, 256, 256], classes=10,
                              layout="NHWC")
            net.initialize(tmx.init.Xavier(), ctx=tmx.gpu(0))
            tr = DataParallelTrainer(
                net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                {"learning_rate": 0.1, "momentum": 0.9},
                compute_dtype="bfloat16", capture=whole)
            tr.build(x)
            return net, tr, lambda: list(tr._params)

        def step(net, tr):
            return tr.step(x, y).data

        arms = _eager_vs_captured(make, step)
        _assert_captured_equals_eager(arms)
    finally:
        torch.backends.cudnn.deterministic = False


def _rnn_make(cell, route, whole, T, N, H):
    from mxnet_tpu_torch.ops.kernels import rnn as kr

    tmx.random.seed(0)
    layer = (tmx.gluon.rnn.LSTM if cell == "lstm" else tmx.gluon.rnn.GRU)(
        H, num_layers=1, input_size=H)
    layer.initialize(tmx.init.Xavier(), ctx=tmx.gpu(0))
    tr = tmx.gluon.Trainer(layer.collect_params(), "adam",
                           {"learning_rate": 1e-3}, whole_step=whole)
    return layer, tr


@pytest.mark.gpu
@pytest.mark.parametrize("cell,route,N,H", [
    ("lstm", "reg", 32, 40), ("lstm", "mma", 896, 40),
    ("lstm", "split", 32, 40), ("gru", "cluster", 32, 200),
    ("gru", "split", 32, 200)])
def test_captured_rnn_layers_equal_eager_on_each_route_on_card(
        cuda_device, monkeypatch, cell, route, N, H):
    """Small LSTM and GRU layers, each pinned to one recurrence route: 4
    whole steps equal 4 eager steps bit for bit, and each replay launches
    the forward and backward kernels on that route."""
    from mxnet_tpu_torch.ops.kernels import rnn as kr

    real_plan = kr.plan

    def pinned(G, backward, n, h, dev, r=None):
        want = route if (route != "mma" or not backward) else None
        return real_plan(G, backward, n, h, dev, want)

    monkeypatch.setattr(kr, "plan", pinned)
    T = 12
    rng = np.random.RandomState(5)
    xs = tmx.nd.array(rng.randn(T, N, H) * 0.5, ctx=tmx.gpu(0))
    target = tmx.nd.array(np.tanh(rng.randn(T, N, H)), ctx=tmx.gpu(0))

    def make(whole):
        layer, tr = _rnn_make(cell, route, whole, T, N, H)
        return layer, tr, lambda: [p.data() for p in
                                   layer.collect_params().values()]

    arms = _eager_vs_captured(
        make, lambda layer, tr: tr.whole_step(
            layer, lambda out, y: (out - y) ** 2, xs, target).data)
    _assert_captured_equals_eager(arms)
    fwd = f"{cell}_fwd"
    assert arms[True][2][3][fwd][f"{route}_launches"] == 1


@pytest.mark.gpu
def test_lr_decay_gives_one_capture_and_a_replay_a_step_on_card(
        cuda_device):
    net, tr = build(True, "adam", {"learning_rate": 0.1, "lr_scheduler":
                                   tmx.lr_scheduler.FactorScheduler(
                                       step=3, factor=0.9, base_lr=0.1)},
                    ctx=tmx.gpu(0))
    tr.whole_step(net, loss_fn, X, Y)   # the warm-up
    c0 = _imperative.graph_capture_count()
    r0 = _imperative.graph_replay_count()
    lr0 = tr.learning_rate
    for _ in range(15):
        tr.whole_step(net, loss_fn, X, Y)
    assert _imperative.graph_capture_count() - c0 == 1
    assert _imperative.graph_replay_count() - r0 == 15
    assert tr.learning_rate < lr0


@pytest.mark.gpu
def test_failed_capture_raises_with_no_eager_step_behind_it(cuda_device):
    """A loss that synchronises with the host cannot be captured: the call
    raises, and no eager step runs in its place."""
    net, tr = build(True, ctx=tmx.gpu(0))

    def host_loss(out, y):
        loss = (out - y) ** 2
        if float(loss.detach().sum()) < 0:   # a host read: illegal there
            loss = -loss
        return loss

    tr.whole_step(net, host_loss, X, Y)   # the warm-up runs eagerly
    torch.cuda.synchronize()
    before = weights(net)
    trainer_mod.reset_trainer_step_stats()
    with pytest.raises(Exception):
        tr.whole_step(net, host_loss, X, Y)
    stats = trainer_mod.trainer_step_stats()
    assert stats["whole_step_fallbacks"] == 0 and stats["steps"] == 0
    assert_bitwise(before, weights(net))
    # the device's generator left the failed capture usable
    gen = tmx.random.generator(cuda_device)
    assert torch.rand(4, device=cuda_device, generator=gen).isfinite().all()


@pytest.mark.gpu
def test_disable_pallas_knob_raises_on_cuda_tensors(cuda_device,
                                                    monkeypatch):
    from mxnet_tpu_torch.ops import attention as tattn

    monkeypatch.setenv("MXTPU_DISABLE_PALLAS", "1")
    q = torch.zeros(1, 2, 128, 64, device=cuda_device)
    with pytest.raises(tmx.MXNetError, match="DISABLE_PALLAS"):
        tattn._k_sdpa(q, q, q)


def collection_inside_a_capture(dev):
    """Capture a body that lets the last reference to a reference cycle
    holding an earlier graph go, then makes the collector run: the shape
    of a block and its CachedOp, or a trainer and its compiler, left dead
    by an earlier phase.  Returns the new graph's replayed output."""
    import gc

    from mxnet_tpu_torch.gluon.whole_step import CapturedStep

    x = torch.ones(1024, device=dev)
    keep = []
    for _ in range(3):
        old = CapturedStep(lambda t: (t * 3).sum(), [x.clone()], dev)
        cycle = {"graph": old}
        cycle["self"] = cycle
        keep.append(cycle)
    del old, cycle
    thresholds = gc.get_threshold()

    def body(t):
        keep.clear()                      # the cycles die inside the capture
        gc.set_threshold(1, 1, 1)
        junk = [[i] for i in range(2000)]   # automatic collections
        return (t * 2).sum() + len(junk) * 0
    try:
        step = CapturedStep(body, [x], dev)
        out = step.replay([x]).item()
    finally:
        gc.set_threshold(*thresholds)
        gc.collect()
    return out


@pytest.mark.gpu
def test_a_collection_cannot_destroy_a_dead_graph_inside_a_capture(
        cuda_device):
    """Found on the card (ROADMAP queue 3): torch no longer collects
    before a capture, so an earlier phase's dead graphs, held in reference
    cycles, were destroyed by a collection inside the next capture, which
    failed with cudaErrorStreamCaptureInvalidated.  Captures now run with
    the cyclic collector off."""
    assert collection_inside_a_capture(cuda_device) == 2048.0
