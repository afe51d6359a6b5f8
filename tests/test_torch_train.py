"""The training path of the PyTorch port against the JAX package, on the
CPU: autograd's ``grad_req`` semantics, the losses, the optimizers'
update rules, the fused step against the sequential one, the learning-rate
schedules, ``clip_global_norm``, the Trainer's surface, the blocks'
forward hooks, and a short MLM+NSP run of a narrow BERT.  Inputs are made
with numpy from a seed and weights are carried across with
``load_numpy_params``.

Tolerances (float32 on both sides).  Gradients, losses and one optimizer
update: 1e-6 absolute plus 1e-5 relative (the same arithmetic summed in
other orders; Adam's ``beta**t`` is float32 in both).  The fused step
against the sequential one: bit for bit.  The BERT run: losses within
1e-5 relative and parameters within 1e-5 absolute after 5 steps (two
packages through two encoder layers: sums in other orders; on the CPU
both packages' attention op takes its oracle).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx

CPU = tmx.cpu()


def _t(a, **kw):
    return tmx.nd.array(a, ctx=CPU, **kw)


def _close(a, b, atol=1e-6, rtol=1e-5, msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=rtol, err_msg=msg)


# -- autograd -----------------------------------------------------------------


def _dense_pair(seed=0, units=3, in_units=4, req="write"):
    """The same Dense layer in both packages, its weight's grad_req set
    before initialization (the JAX package reads it only there)."""
    import mxnet_tpu as jmx

    rng = np.random.RandomState(seed)
    w = rng.randn(units, in_units).astype(np.float32)
    b = rng.randn(units).astype(np.float32)
    jnet = jmx.gluon.nn.Dense(units, in_units=in_units)
    jnet.weight.grad_req = req
    jnet.initialize()
    jnet.weight.set_data(jmx.nd.array(w))
    jnet.bias.set_data(jmx.nd.array(b))
    tnet = tmx.gluon.nn.Dense(units, in_units=in_units)
    tnet.weight.grad_req = req
    tnet.initialize(ctx=CPU)
    tnet.weight.set_data(w)
    tnet.bias.set_data(b)
    return jnet, tnet


def _hook_run(pkg, net, x):
    """Calls of a pre-hook and a forward hook (both return something, which
    must be ignored) around three calls of ``net``: both hooks on, the
    forward hook detached, then the pre-hook detached by its handle's
    ``with`` block."""
    calls = []

    def pre(block, args):
        calls.append(("pre", block is net, len(args), tuple(args[0].shape)))
        return 1

    def post(block, args, out):
        calls.append(("post", block is net, len(args), tuple(out.shape)))
        return "replaced?"

    pre_h = net.register_forward_pre_hook(pre)
    post_h = net.register_forward_hook(post)
    outs = [net(x).asnumpy()]
    post_h.detach()
    post_h.detach()   # twice is harmless
    with pre_h:
        outs.append(net(x).asnumpy())
    outs.append(net(x).asnumpy())
    return calls, outs


def test_forward_hooks_match_jax():
    """MXNet's hooks, not torch.nn.Module's: handles with detach() that
    are context managers, return values ignored (ROADMAP queue 3)."""
    import mxnet_tpu as jmx

    jnet, tnet = _dense_pair(seed=3)
    x = np.ones((2, 4), np.float32)
    tcalls, touts = _hook_run(tmx, tnet, _t(x))
    jcalls, jouts = _hook_run(jmx, jnet, jmx.nd.array(x))
    assert tcalls == jcalls == [("pre", True, 1, (2, 4)),
                                ("post", True, 1, (2, 3)),
                                ("pre", True, 1, (2, 4))]
    for a, b in zip(touts, jouts):
        _close(a, b)


def test_hybridized_parent_fires_its_hooks_on_every_call_as_jax():
    import mxnet_tpu as jmx

    def run(pkg, ctx):
        net = pkg.gluon.nn.HybridSequential()
        net.add(pkg.gluon.nn.Dense(3, in_units=4))
        net.initialize(ctx=ctx)
        net.hybridize()
        seen = []
        net.register_forward_pre_hook(lambda b, a: seen.append("pre"))
        net.register_forward_hook(lambda b, a, o: seen.append("post"))
        for _ in range(3):
            net(pkg.nd.array(np.ones((2, 4), np.float32), ctx=ctx))
        return seen

    assert run(tmx, CPU) == run(jmx, jmx.cpu()) == ["pre", "post"] * 3


@pytest.mark.gpu
def test_hooks_around_a_replayed_serve_graph_on_card():
    """On the card a hybridized block's own hooks fire on every call,
    replays included; its children's fire only when its forward runs
    eagerly (the warm-up and the capture), as a JAX child fires only while
    its parent is traced."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a serve graph has no CPU mode); "
                    "run on the GPU machine with -m gpu")
    from mxnet_tpu_torch import _imperative

    net = tmx.gluon.nn.HybridSequential()
    net.add(tmx.gluon.nn.Dense(3, in_units=4))
    net.initialize(ctx=tmx.gpu(0))
    net.hybridize()
    outer, inner = [], []
    net.register_forward_hook(lambda b, a, o: outer.append(o.shape))
    net[0].register_forward_hook(lambda b, a, o: inner.append(1))
    x = tmx.nd.array(np.ones((2, 4), np.float32), ctx=tmx.gpu(0))
    r0 = _imperative.graph_replay_count()
    with tmx.autograd.predict_mode():
        for _ in range(4):
            net(x)
    assert _imperative.graph_replay_count() - r0 == 3
    assert len(outer) == 4 and len(inner) == 2


def _sq_loss(pkg):
    class SqLoss(pkg.gluon.HybridBlock):
        """sum(net(x)^2): a scalar head through a block."""

        def __init__(self, net, **kw):
            super().__init__(**kw)
            self.net = net

        def hybrid_forward(self, F, x):
            return F.sum(F.square(self.net(x)))

    return SqLoss


def _backward_twice(pkg, net, x):
    head = _sq_loss(pkg)(net)
    for _ in range(2):
        with pkg.autograd.record():
            loss = head(x)
        loss.backward()
    return net.weight.grad().asnumpy() if hasattr(
        net.weight.grad(), "asnumpy") else net.weight.grad().numpy()


@pytest.mark.parametrize("req", ["write", "add"])
def test_grad_req_write_and_add_match_jax(req):
    """Two backward passes in a row: 'write' gives the gradient of one,
    'add' twice it; both as the JAX package gives them."""
    import mxnet_tpu as jmx

    x = np.random.RandomState(1).randn(5, 4).astype(np.float32)
    jnet, tnet = _dense_pair(req=req)
    jg = _backward_twice(jmx, jnet, jmx.nd.array(x))
    tg = _backward_twice(tmx, tnet, _t(x))
    _close(tg, jg)
    # the port also takes a grad_req set after initialization
    _, late = _dense_pair()
    late.weight.grad_req = req
    once = _backward_twice(tmx, _dense_pair()[1], _t(x))
    _close(_backward_twice(tmx, late, _t(x)),
           once * (2 if req == "add" else 1))
    _close(tg, once * (2 if req == "add" else 1))


def test_grad_req_null_and_unreached_parameters():
    """'null' drops the gradient; a parameter the backward does not reach
    keeps its previous gradient; the bias of a second layer is untouched."""
    x = np.random.RandomState(2).randn(5, 4).astype(np.float32)
    _, tnet = _dense_pair()
    _, other = _dense_pair(seed=3)
    head = _sq_loss(tmx)(tnet)
    with tmx.autograd.record():
        loss = head(_t(x))
    loss.backward()
    first = tnet.weight.grad().clone()
    other.weight.grad()[:] = 7.0  # a stale gradient the next pass must keep
    tnet.bias.grad_req = "null"
    with tmx.autograd.record():
        loss = head(_t(x))
    loss.backward()
    torch.testing.assert_close(tnet.weight.grad(), first, rtol=0, atol=0)
    assert (other.weight.grad() == 7.0).all()
    assert not tnet.bias.data().requires_grad
    with pytest.raises(tmx.MXNetError, match="no gradient"):
        tnet.bias.grad()
    tnet.bias.grad_req = "write"
    assert tnet.bias.data().requires_grad
    tnet.collect_params().zero_grad()
    assert float(tnet.weight.grad().abs().sum()) == 0.0


def test_autograd_grad_and_attach_grad_match_jax():
    """autograd.grad leaves every gradient buffer alone; attach_grad makes
    an input a variable whose .grad the backward writes."""
    import mxnet_tpu as jmx

    x = np.random.RandomState(4).randn(5, 4).astype(np.float32)
    jnet, tnet = _dense_pair()
    out = {}
    for name, pkg, net, arr in (("jax", jmx, jnet, jmx.nd.array(x)),
                                ("port", tmx, tnet, _t(x))):
        arr.attach_grad()
        head = _sq_loss(pkg)(net)
        with pkg.autograd.record():
            loss = head(arr)
        (gx,) = pkg.autograd.grad(loss, [arr], retain_graph=True)
        assert float(np.abs(arr.grad.asnumpy()).sum()) == 0.0
        loss.backward()
        out[name] = (gx.asnumpy(), arr.grad.asnumpy(), loss.asscalar())
    for a, b in zip(out["port"], out["jax"]):
        _close(a, b)


def test_pause_and_mode_scopes():
    x = np.random.RandomState(5).randn(5, 4).astype(np.float32)
    _, tnet = _dense_pair()
    head = _sq_loss(tmx)(tnet)
    ag = tmx.autograd
    assert not ag.is_recording() and not ag.is_training()
    with ag.record():
        assert ag.is_recording() and ag.is_training()
        with ag.pause():
            assert not ag.is_recording() and not ag.is_training()
            paused = head(_t(x))
        with ag.predict_mode():
            assert ag.is_recording() and not ag.is_training()
        loss = head(_t(x))
    assert paused.data.grad_fn is None and loss.data.grad_fn is not None
    with pytest.raises(tmx.MXNetError, match="cannot differentiate"):
        paused.backward()
    loss.backward()
    with ag.train_mode():
        assert ag.is_training() and not ag.is_recording()
    assert ag.set_recording(True) is False and ag.set_recording(False)
    with pytest.raises(tmx.MXNetError, match="create_graph"):
        ag.grad(loss, [tnet.weight.data()], create_graph=True)


def test_custom_function_is_a_torch_autograd_function():
    class Sigmoid(tmx.autograd.Function):
        def forward(self, x):
            y = 1 / (1 + torch.exp(-x))
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            (y,) = self.saved_tensors
            return dy * y * (1 - y)

    x = _t(np.linspace(-3, 3, 7).astype(np.float32))
    x.attach_grad()
    with tmx.autograd.record():
        y = Sigmoid()(x)
    y.backward()
    s = torch.sigmoid(x.data.detach())
    torch.testing.assert_close(y.data.detach(), s)
    torch.testing.assert_close(x.grad.data, s * (1 - s))


# -- losses -------------------------------------------------------------------


LOSSES = [
    ("L2Loss", {}, "dense"), ("L1Loss", {"weight": 0.5}, "dense"),
    ("SigmoidBinaryCrossEntropyLoss", {}, "binary"),
    ("SigmoidBinaryCrossEntropyLoss", {"from_sigmoid": True}, "prob"),
    ("SoftmaxCrossEntropyLoss", {}, "sparse"),
    ("SoftmaxCrossEntropyLoss", {"sparse_label": False}, "dist"),
]


@pytest.mark.parametrize("name,kwargs,label", LOSSES,
                         ids=[f"{n}-{lab}" for n, _, lab in LOSSES])
def test_loss_and_its_gradient_match_jax(name, kwargs, label):
    import mxnet_tpu as jmx

    rng = np.random.RandomState(6)
    pred = rng.randn(4, 5).astype(np.float32)
    if label == "prob":
        pred = 1 / (1 + np.exp(-pred))
    lab = {"dense": rng.randn(4, 5), "binary": rng.randint(0, 2, (4, 5)),
           "prob": rng.randint(0, 2, (4, 5)),
           "sparse": rng.randint(0, 5, (4,)),
           "dist": rng.dirichlet(np.ones(5), 4)}[label].astype(np.float32)
    sw = rng.rand(4, 1).astype(np.float32)
    out = {}
    for key, pkg, arr in (("jax", jmx, jmx.nd.array), ("port", tmx, _t)):
        loss_fn = getattr(pkg.gluon.loss, name)(**kwargs)
        p = arr(pred)
        p.attach_grad()
        with pkg.autograd.record():
            val = loss_fn(p, arr(lab), arr(sw))
        val.backward()
        out[key] = (val.asnumpy(), p.grad.asnumpy())
    assert out["port"][0].shape == (4,)
    for a, b in zip(out["port"], out["jax"]):
        _close(a, b)


# -- optimizers -------------------------------------------------------------

OPTIMIZERS = [
    ("sgd", {"learning_rate": 0.1, "wd": 0.01}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}),
    ("adam", {"learning_rate": 0.01, "wd": 0.01}),
    ("adamw", {"learning_rate": 0.01, "wd": 0.01}),
]
OPT_IDS = ["sgd", "sgd_mom", "nag", "adam", "adamw"]


def _opt_args(pkg, base):
    args = dict(base, clip_gradient=0.5, rescale_grad=0.25)
    args["lr_scheduler"] = pkg.lr_scheduler.FactorScheduler(
        step=2, factor=0.5, base_lr=base["learning_rate"])
    return args


def _states_np(st):
    if st is None:
        return []
    st = st if isinstance(st, (tuple, list)) else (st,)
    return [s.asnumpy() if hasattr(s, "asnumpy") else s.numpy() for s in st]


@pytest.mark.parametrize("name,base", OPTIMIZERS, ids=OPT_IDS)
def test_optimizer_updates_match_jax(name, base):
    """Three updates of each rule on the same numpy arrays, with wd,
    clip_gradient, rescale_grad and a FactorScheduler that halves the lr
    after two updates; weights and states agree after each."""
    import mxnet_tpu as jmx

    rng = np.random.RandomState(7)
    w0 = rng.randn(6, 5).astype(np.float32)
    grads = [rng.randn(6, 5).astype(np.float32) * 3 for _ in range(3)]
    jopt = jmx.optimizer.create(name, **_opt_args(jmx, base))
    topt = tmx.optimizer.create(name, **_opt_args(tmx, base))
    jw, tw = jmx.nd.array(w0), torch.from_numpy(w0.copy())
    jst, tst = jopt.create_state(0, jw), topt.create_state(0, tw)
    for g in grads:
        jopt.update(0, jw, jmx.nd.array(g), jst)
        topt.update(0, tw, torch.from_numpy(g), tst)
        _close(tw.numpy(), jw.asnumpy())
        for a, b in zip(_states_np(tst), _states_np(jst)):
            _close(a, b)
    assert topt.num_update == jopt.num_update == 3
    assert topt.learning_rate == jopt.learning_rate


def _params(specs, seed=0):
    rng = np.random.RandomState(seed)
    ps = []
    for j, shape in enumerate(specs):
        p = tmx.gluon.Parameter(f"p{j}", shape=shape,
                                wd_mult=0.5 if j == 1 else 1.0)
        p.initialize(ctx=CPU)
        p.set_data(rng.randn(*shape).astype(np.float32))
        ps.append(p)
    return ps


SPECS = [(3, 4), (17,), (2, 3, 2), (5, 5), (1,), (4, 1), (6,)]


@pytest.mark.parametrize("name,base", OPTIMIZERS, ids=OPT_IDS)
def test_fused_step_equals_sequential_step_bit_for_bit(name, base):
    """``aggregate_num=1`` (sequential) against the default (fused): the
    same weights and states to the bit after 4 steps with clipping, wd
    multipliers and a decaying lr, and the same update count."""
    out = []
    for agg in (None, 1):
        ps = _params(SPECS)
        args = _opt_args(tmx, base)
        if agg is not None:
            args["aggregate_num"] = agg
        tr = tmx.gluon.Trainer(ps, name, args)
        rng = np.random.RandomState(1)
        for _ in range(4):
            for p in ps:
                p.grad().copy_(torch.from_numpy(
                    rng.randn(*p.shape).astype(np.float32)))
            tr.step(2)
        assert tr._fusion_enabled() == (agg is None)
        out.append((ps, tr))
    (fp, ftr), (sp, strn) = out
    for a, b in zip(fp, sp):
        assert torch.equal(a.data(), b.data())
    for a, b in zip(ftr._states, strn._states):
        for x, y in zip(_states_np(a), _states_np(b)):
            np.testing.assert_array_equal(x, y)
    assert ftr.optimizer.num_update == strn.optimizer.num_update == 4


def test_aggregation_knob_wins_over_the_argument(monkeypatch):
    monkeypatch.setenv("MXNET_OPTIMIZER_AGGREGATION_SIZE", "1")
    assert tmx.optimizer.create("sgd", aggregate_num=8).aggregate_num == 1
    monkeypatch.setenv("MXTPU_OPTIMIZER_AGGREGATION_SIZE", "3")
    assert tmx.optimizer.create("sgd").aggregate_num == 3
    monkeypatch.delenv("MXTPU_OPTIMIZER_AGGREGATION_SIZE")
    monkeypatch.delenv("MXNET_OPTIMIZER_AGGREGATION_SIZE")
    assert tmx.optimizer.create("sgd").aggregate_num == 64


def test_fused_groups_respect_aggregate_num_and_lr_mult():
    ps = _params(SPECS)
    ps[2].lr_mult = 0.1
    tr = tmx.gluon.Trainer(ps, "sgd", {"learning_rate": 0.1, "wd": 0.01,
                                       "aggregate_num": 3})
    tmx.gluon.trainer.reset_trainer_step_stats()
    tr.step(1)
    st = tmx.gluon.trainer.trainer_step_stats()
    # wd_mult and lr_mult split 7 params into groups of 5, 1 and 1; the
    # group of 5 runs as chunks of 3 and 2
    assert st["steps"] == 1 and st["params_fused"] == 7
    assert st["dispatches"] == 4


def test_updater_and_registry():
    opt = tmx.optimizer.create("sgd", learning_rate=0.5, momentum=0.5)
    upd = tmx.optimizer.get_updater(opt)
    w = torch.ones(3)
    upd(0, torch.ones(3), w)
    blob = upd.get_states()
    upd2 = tmx.optimizer.get_updater(
        tmx.optimizer.create("sgd", learning_rate=0.5, momentum=0.5))
    upd2.set_states(blob)
    torch.testing.assert_close(upd2.states[0], upd.states[0])

    @tmx.optimizer.register
    class MyOpt(tmx.optimizer.SGD):
        pass

    assert isinstance(tmx.optimizer.create("myopt"), MyOpt)
    with pytest.raises(tmx.MXNetError, match="unknown optimizer"):
        tmx.optimizer.create("lars")


def test_lr_schedulers_match_jax():
    import mxnet_tpu as jmx

    def make(pkg):
        s = pkg.lr_scheduler
        return [s.FactorScheduler(3, 0.5, base_lr=1.0, warmup_steps=2),
                s.MultiFactorScheduler([2, 5], 0.1, base_lr=1.0),
                s.PolyScheduler(10, base_lr=1.0, pwr=2, warmup_steps=2,
                                warmup_mode="constant", warmup_begin_lr=0.1),
                s.CosineScheduler(10, base_lr=1.0, final_lr=0.1)]

    for js, ts in zip(make(jmx), make(tmx)):
        assert [ts(n) for n in range(12)] == [js(n) for n in range(12)]


def test_clip_global_norm_matches_jax():
    import mxnet_tpu as jmx

    rng = np.random.RandomState(8)
    arrs = [rng.randn(4, 3).astype(np.float32),
            rng.randn(5).astype(np.float32)]
    ja = [jmx.nd.array(a) for a in arrs]
    ta = [torch.from_numpy(a.copy()) for a in arrs]
    jn = jmx.gluon.utils.clip_global_norm(ja, 1.0)
    tn = tmx.gluon.utils.clip_global_norm(ta, 1.0)
    assert abs(tn - jn) <= 1e-5 * jn
    for t, j in zip(ta, ja):
        _close(t.numpy(), j.asnumpy())
    small = [torch.full((2,), 0.1)]
    assert tmx.gluon.utils.clip_global_norm(small, 1.0) < 1.0
    torch.testing.assert_close(small[0], torch.full((2,), 0.1))
    with pytest.raises(tmx.MXNetError, match="not finite"):
        tmx.gluon.utils.clip_global_norm([torch.tensor([np.inf])], 1.0)


def test_split_and_load():
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    parts = tmx.gluon.utils.split_and_load(x, [CPU, CPU, CPU])
    assert [p.shape for p in parts] == [(2, 2)] * 3
    np.testing.assert_array_equal(parts[2].asnumpy(), x[4:])
    parts = tmx.gluon.utils.split_data(_t(x), 4, even_split=False)
    assert [p.shape[0] for p in parts] == [1, 1, 1, 3]
    with pytest.raises(tmx.MXNetError, match="divisible"):
        tmx.gluon.utils.split_data(_t(x), 4)


# -- the Trainer's surface ----------------------------------------------------


@pytest.mark.parametrize("kwargs,match", [
    pytest.param({"kvstore": "dist_async"}, "distributed",
                 id="kwargs0-distributed"),
    pytest.param({"kvstore": "dist_device_async", "update_on_kvstore": True},
                 "update_on_kvstore", id="kwargs1-update_on_kvstore"),
    # a mesh shape is parsed at construction (the mesh is made at the
    # first whole step: tests/test_torch_spmd.py): a malformed one raises
    pytest.param({"zero_shard": True, "mesh_shape": "mp=2,dp=2"},
                 "canonical order", id="kwargs2-ZeRO"),
    pytest.param({"sharding_plan": {"dp": 2}}, "sharding_plan given but no "
                 "mesh_shape", id="kwargs3-sharding_plan"),
    pytest.param({"mesh_shape": "dp=2,tp=2"}, "unknown mesh axis 'tp'",
                 id="kwargs4-mesh_shape"),
    pytest.param({"compression_params": {"type": "1bit"}}, "compression",
                 id="kwargs5-compression"),
])
def test_trainer_raises_for_what_later_slices_bring(kwargs, match):
    ps = _params([(2,)])
    with pytest.raises(tmx.MXNetError, match=match):
        tmx.gluon.Trainer(ps, "sgd", **kwargs)


def test_trainer_env_knobs_are_not_ignored(monkeypatch):
    monkeypatch.setenv("MXTPU_WHOLE_STEP", "1")
    assert tmx.gluon.Trainer(_params([(2,)]), "sgd").whole_step_enabled
    monkeypatch.setenv("MXTPU_ZERO_SHARD", "1")
    assert tmx.gluon.Trainer(_params([(2,)]), "sgd")._zero_shard


def test_trainer_learning_rate_and_stale_gradients():
    ps = _params([(3,), (2,)])
    tr = tmx.gluon.Trainer(ps, "sgd", {"learning_rate": 0.5},
                           kvstore="local")
    assert tr.learning_rate == 0.5
    tr.set_learning_rate(0.25)
    assert tr.learning_rate == 0.25
    before = [p.data().clone() for p in ps]
    x = _t(np.ones(3, np.float32))
    x.attach_grad()

    class Uses0(tmx.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return F.sum(ps[0].data() * x)

    with tmx.autograd.record():
        loss = Uses0()(x)
    loss.backward()
    ps[1].grad()[:] = 1.0  # stale: no backward wrote it
    tr.step(1, ignore_stale_grad=True)
    torch.testing.assert_close(ps[0].data(), before[0] - 0.25)
    torch.testing.assert_close(ps[1].data(), before[1])
    tr.step(1)  # the reference's rule: stale gradients are applied
    torch.testing.assert_close(ps[1].data(), before[1] - 0.25)


# -- a short BERT run ---------------------------------------------------------

VOCAB = 1000


def _pretrain_block(pkg):
    class BERTForPretrain(pkg.gluon.HybridBlock):
        """MLM + NSP loss head over the backbone, one scalar loss out
        (after examples/bert/pretrain_bert.py)."""

        def __init__(self, model, **kwargs):
            super().__init__(**kwargs)
            self.model = model

        def hybrid_forward(self, F, inputs, token_types, mlm_targets,
                           nsp_labels, mask_weight, valid_length,
                           masked_positions):
            mlm_scores, nsp_scores = self.model(inputs, token_types,
                                                valid_length,
                                                masked_positions)
            mlm_log = F.log_softmax(mlm_scores)
            mlm_ll = F.pick(mlm_log, mlm_targets, axis=-1)
            mlm_loss = -F.sum(mlm_ll * mask_weight) / (F.sum(mask_weight) + 1)
            nsp_log = F.log_softmax(nsp_scores)
            nsp_loss = -F.mean(F.pick(nsp_log, nsp_labels, axis=-1))
            return mlm_loss + nsp_loss

    return BERTForPretrain


def _synthetic_batch(rng, bs, seq_len, vocab, mask_frac=0.15):
    """After examples/bert/pretrain_bert.py's synthetic_batch, with valid
    lengths drawn in [seq_len/4, seq_len] and padding ids 0."""
    K = max(1, int(round(seq_len * mask_frac)))
    valid = rng.randint(seq_len // 4, seq_len + 1, bs)
    tokens = rng.randint(4, vocab, (bs, seq_len))
    tokens[np.arange(seq_len)[None, :] >= valid[:, None]] = 0
    types = np.zeros((bs, seq_len), np.int32)
    types[:, seq_len // 2:] = 1
    positions = np.stack([rng.choice(v, K, replace=False)
                          for v in valid]).astype(np.int32)
    targets = np.take_along_axis(tokens, positions, 1)
    inputs = tokens.copy()
    np.put_along_axis(inputs, positions, 3, 1)  # 3 = [MASK]
    weights = np.ones((bs, K), np.float32)
    nsp = rng.randint(0, 2, (bs,))
    return (inputs.astype(np.int32), types, targets.astype(np.int32),
            nsp.astype(np.int32), weights, valid.astype(np.float32),
            positions)


@pytest.mark.parametrize("opt,args", [
    ("adamw", {"learning_rate": 1e-3, "wd": 0.01}),
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9}),
], ids=["adamw", "sgd_mom"])
def test_short_bert_pretraining_run_matches_jax(opt, args):
    """A narrow BERT with heads of 64 (units 128, 2 heads, 2 layers,
    hidden 256, vocab 1000, dropout 0), with MLM+NSP heads: 5 Trainer
    steps per package on one batch."""
    import mxnet_tpu as jmx
    from mxnet_tpu.models.bert import BERTModel as JBERT

    def bert(pkg_cls):
        return pkg_cls(VOCAB, 128, 256, 2, 2, max_length=128, dropout=0.0)

    jmx.random.seed(9)
    jnet = _pretrain_block(jmx)(bert(JBERT))
    jnet.initialize(init=jmx.init.Normal(0.02))
    batch = _synthetic_batch(np.random.RandomState(10), 4, 128, VOCAB)
    jbatch = [jmx.nd.array(a, dtype=a.dtype) for a in batch]
    with jmx.autograd.pause():
        jnet(*jbatch)  # finish deferred init before copying the weights
    tnet = _pretrain_block(tmx)(bert(tmx.models.BERTModel))
    tnet.initialize(ctx=CPU)
    tmx.load_numpy_params(tnet, {
        k: p.data().asnumpy()
        for k, p in jnet._collect_params_with_prefix().items()})
    tbatch = [_t(a) for a in batch]
    losses = {"jax": [], "port": []}
    for key, pkg, net, b in (("jax", jmx, jnet, jbatch),
                             ("port", tmx, tnet, tbatch)):
        trainer = pkg.gluon.Trainer(net.collect_params(), opt, dict(args))
        for _ in range(5):
            with pkg.autograd.record():
                loss = net(*b)
            loss.backward()
            trainer.step(1)
            losses[key].append(float(loss.asscalar()))
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-5)
    assert losses["port"][-1] < losses["port"][0]
    tparams = tnet._collect_params_with_prefix()
    for name, jp in jnet._collect_params_with_prefix().items():
        _close(tparams[name].data().detach().numpy(), jp.data().asnumpy(),
               atol=1e-5, rtol=0, msg=name)
