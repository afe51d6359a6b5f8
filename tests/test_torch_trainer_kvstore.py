"""``gluon.Trainer`` over a kvstore on several contexts, and multi-context
parameters, in the port against the JAX package, on the CPU.

The MXNet 1.x loop: ``net.initialize(ctx=ctxs)``,
``gluon.utils.split_and_load`` of the batch onto ``ctxs``, a forward and
loss a context under ``autograd.record``, ``autograd.backward`` of the
losses and ``trainer.step(batch_size)``.  Contexts are ``cpu(0..3)`` in
both packages (eight virtual devices in the JAX package, eight slots of
one torch device in the port); inputs and weights come from
``np.random.RandomState``.

Tolerances.  A 2-layer MLP and BERT-tiny (2 layers, width 64, one head,
dropout 0), 3 steps of SGD with momentum and of Adam, over 2 and 4
contexts, with ``update_on_kvstore`` False and True and with 2-bit
compression: the losses within 1e-5 relative (MLP) and 1e-4 (BERT-tiny),
the parameters after the last step within 1e-5 of each one's largest
value (MLP) and 1e-4 of the largest value of all of them (BERT-tiny:
the key part of ``attn_in_bias`` has a gradient of rounding noise, which
Adam scales up), the same arithmetic in two frameworks summed in other
orders in the layers; the kvstore's sums are bit-identical.  The fused and the
sequential step, one context with or without a kvstore, the eager whole
step and the hand-written loop: bit for bit.  The ``gpu``-marked tests
need CUDA devices and skip here.
"""
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import trainer as ttrainer
from mxnet_tpu_torch.gluon.parameter import Parameter

FEAT, HIDDEN, NCLS, BATCH = 12, 16, 4, 16
VOCAB = 1000


def _ctxs(pkg, n):
    return [pkg.cpu(i) for i in range(n)]


# -- multi-context parameters ---------------------------------------------------


def test_parameter_copies_per_context():
    ctxs = _ctxs(tmx, 3)
    p = Parameter("w", shape=(4, 3))
    p.initialize(init=tmx.init.Normal(1.0), ctx=ctxs)
    assert p.list_ctx() == ctxs and p.context == ctxs[0]
    vals = p.list_data()
    assert len({id(v) for v in vals}) == 3
    for c, v in zip(ctxs, vals):
        assert p.data(c) is v
        torch.testing.assert_close(v, vals[0], rtol=0, atol=0)
    assert p.data() is vals[0]
    grads = p.list_grad()
    assert len({id(g) for g in grads}) == 3 and all(
        (g == 0).all() for g in grads)
    grads[1].fill_(2.0)
    p.zero_grad()
    assert (p.grad(ctxs[1]) == 0).all()
    new = np.arange(12, dtype=np.float32).reshape(4, 3)
    p.set_data(new)
    for v in p.list_data():
        np.testing.assert_array_equal(v.detach().numpy(), new)
    with pytest.raises(MXNetError, match="not initialized on cpu\\(5\\)"):
        p.data(tmx.cpu(5))
    p.reset_ctx([tmx.cpu(5), tmx.cpu(6)])
    assert p.list_ctx() == [tmx.cpu(5), tmx.cpu(6)]
    np.testing.assert_array_equal(p.data(tmx.cpu(6)).detach().numpy(), new)
    one = Parameter("v", shape=(2,))
    one.initialize(ctx=[tmx.cpu(0)])
    assert one.list_ctx() == [tmx.cpu(0)] and one.list_data() == [one._data]


def test_block_reads_the_copy_of_its_input_context():
    """A forward on inputs on context c uses the parameters' copies on c
    (their gradients land there too); a ParameterDict moves together."""
    ctxs = _ctxs(tmx, 2)
    net = tmx.gluon.nn.Dense(3, in_units=4)
    net.initialize(ctx=ctxs)
    with torch.no_grad():
        net.weight.data(ctxs[1]).add_(1.0)  # make the copies differ
    x = np.random.RandomState(0).randn(2, 4).astype(np.float32)
    outs = [net(tmx.nd.array(x, ctx=c)) for c in ctxs]
    assert [o.context for o in outs] == ctxs
    w = [net.weight.data(c).detach().numpy() for c in ctxs]
    b = net.bias.data(ctxs[0]).detach().numpy()
    for o, wc in zip(outs, w):
        np.testing.assert_allclose(o.asnumpy(), x @ wc.T + b, rtol=1e-5,
                                   atol=1e-6)
    with tmx.autograd.record():
        loss = net(tmx.nd.array(x, ctx=ctxs[1]))
    loss.backward()
    assert (net.weight.grad(ctxs[0]) == 0).all()
    assert (net.weight.grad(ctxs[1]) != 0).any()
    params = net.collect_params()
    params.reset_ctx(tmx.cpu(3))
    assert all(p.list_ctx() == [tmx.cpu(3)] for p in params.values())


# -- the reference's fused-step cases (tests/test_trainer_fused.py:119-170) -----


def _make_params(specs, ctx, seed=0):
    rng = np.random.RandomState(seed)
    params = []
    for j, (shape, dtype) in enumerate(specs):
        p = Parameter(f"p{j}", shape=shape, dtype=dtype)
        p.initialize(ctx=ctx)
        p.set_data(rng.randn(*shape).astype(dtype))
        params.append(p)
    return params


def _set_grads(params, seed):
    """Per-(parameter, context) gradients, different on every context."""
    rng = np.random.RandomState(seed)
    for p in params:
        for c in p.list_ctx():
            g = rng.randn(*p.shape).astype(p.dtype)
            p.grad(c).copy_(torch.from_numpy(g))


def _run_steps(opt, opt_args, specs, n_steps, ctx, aggregate_num=None,
               batch_size=1):
    params = _make_params(specs, ctx)
    kwargs = dict(opt_args)
    if aggregate_num is not None:
        kwargs["aggregate_num"] = aggregate_num
    tr = tmx.gluon.Trainer(params, opt, kwargs)
    for step in range(n_steps):
        _set_grads(params, seed=step)
        tr.step(batch_size)
    return params, tr


def test_fused_multi_device_allreduce_and_grad_writeback():
    ctxs = _ctxs(tmx, 2)
    specs = [((4, 3), "float32"), ((7,), "float32"), ((2, 2), "float32"),
             ((9,), "float32")]
    outcome = {}
    for agg in (None, 1):
        params, tr = _run_steps("sgd", {"learning_rate": 0.1,
                                        "momentum": 0.9}, specs, 3, ctxs,
                                aggregate_num=agg)
        outcome[agg] = params
        if agg is None:
            assert tr._kvstore is not None
    # gradients summed across contexts, written into every buffer
    rng = np.random.RandomState(2)  # the seed of the last step
    for p in outcome[None]:
        want = sum(rng.randn(*p.shape).astype(p.dtype)
                   for _ in p.list_ctx())
        for c in p.list_ctx():
            np.testing.assert_allclose(p.grad(c).numpy(), want, rtol=2e-6,
                                       atol=2e-6)
    for pa, pb in zip(outcome[None], outcome[1]):
        ref = pa.data(pa.list_ctx()[0]).detach().numpy()
        for c in pa.list_ctx():
            # fused == sequential, and every context identical
            np.testing.assert_array_equal(pa.data(c).detach().numpy(),
                                          pb.data(c).detach().numpy())
            np.testing.assert_array_equal(pa.data(c).detach().numpy(), ref)


def test_bucket_size_cap_builds_multiple_buckets(monkeypatch):
    monkeypatch.setenv("MXTPU_KVSTORE_BUCKET_MB", "0.0001")
    ctxs = _ctxs(tmx, 2)
    specs = [((10, 4), "float32"), ((37,), "float32"), ((6, 5), "float32"),
             ((40,), "float32")]
    ttrainer.reset_trainer_step_stats()
    fused, _ = _run_steps("sgd", {"learning_rate": 0.1}, specs, 2, ctxs)
    assert ttrainer.trainer_step_stats()["buckets_built"] >= 2 * 4
    monkeypatch.delenv("MXTPU_KVSTORE_BUCKET_MB")
    seq, _ = _run_steps("sgd", {"learning_rate": 0.1}, specs, 2, ctxs,
                        aggregate_num=1)
    for a, b in zip(fused, seq):
        for c in a.list_ctx():
            np.testing.assert_array_equal(a.data(c).detach().numpy(),
                                          b.data(c).detach().numpy())


def test_step_counters_match_jax():
    """buckets_built and dispatches of a fused 2-context step, as the JAX
    package counts them."""
    import mxnet_tpu as jmx
    from mxnet_tpu.gluon import trainer as jtrainer
    from mxnet_tpu.gluon.parameter import Parameter as JParameter

    specs = [((4, 3), "float32"), ((7,), "float32"), ((5,), "float16")]
    stats = []
    for pkg, mod, cls in ((tmx, ttrainer, Parameter),
                          (jmx, jtrainer, JParameter)):
        ctxs = _ctxs(pkg, 2)
        params = []
        for j, (shape, dtype) in enumerate(specs):
            p = cls(f"q{j}", shape=shape, dtype=dtype)
            p.initialize(ctx=ctxs)
            params.append(p)
        tr = pkg.gluon.Trainer(params, "sgd", {"learning_rate": 0.1})
        mod.reset_trainer_step_stats()
        tr.step(1)
        s = mod.trainer_step_stats()
        stats.append((s["steps"], s["buckets_built"]))
    assert stats[0] == stats[1] == (1, 2)


# -- training loops against the JAX package ---------------------------------------


def _mlp(pkg):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(HIDDEN, activation="relu", in_units=FEAT),
            pkg.gluon.nn.Dense(NCLS, in_units=HIDDEN))
    return net


def _mlp_weights(seed=0):
    rng = np.random.RandomState(seed)
    return {"0.weight": rng.randn(HIDDEN, FEAT).astype(np.float32) * 0.3,
            "0.bias": rng.randn(HIDDEN).astype(np.float32) * 0.1,
            "1.weight": rng.randn(NCLS, HIDDEN).astype(np.float32) * 0.3,
            "1.bias": rng.randn(NCLS).astype(np.float32) * 0.1}


def _mlp_data(seed=1):
    rng = np.random.RandomState(seed)
    return (rng.rand(BATCH, FEAT).astype(np.float32),
            rng.randint(0, NCLS, BATCH).astype(np.float32))


def _build_mlp(pkg, ctxs, weights):
    net = _mlp(pkg)
    net.initialize(ctx=ctxs)
    params = net._collect_params_with_prefix()
    for k, v in weights.items():
        params[k].set_data(pkg.nd.array(v) if pkg is not tmx else v)
    return net


def _loss_value(pkg, loss):
    return float(np.asarray(loss.asnumpy(), np.float64).sum())


def _train_mlp(pkg, n_ctx, opt, args, mode, steps=3, weights=None,
               data=None):
    ctxs = _ctxs(pkg, n_ctx)
    net = _build_mlp(pkg, ctxs, weights or _mlp_weights())
    x, y = data or _mlp_data()
    trainer = pkg.gluon.Trainer(net.collect_params(), opt, dict(args),
                                **_MODES[mode])
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for _ in range(steps):
        xs = pkg.gluon.utils.split_and_load(x, ctxs)
        ys = pkg.gluon.utils.split_and_load(y, ctxs)
        with pkg.autograd.record():
            ls = [loss_fn(net(a), b) for a, b in zip(xs, ys)]
        pkg.autograd.backward(ls)
        trainer.step(BATCH)
        losses.append(sum(_loss_value(pkg, l) for l in ls) / BATCH)
    return net, trainer, losses


_MODES = {"device": {"kvstore": "device"},
          "update_on_kvstore": {"kvstore": "device",
                                "update_on_kvstore": True},
          "compression": {"kvstore": "device",
                          "compression_params": {"type": "2bit",
                                                 "threshold": 0.5}},
          "local": {"kvstore": "local"},
          "nccl": {"kvstore": "nccl"}}
_OPTS = {"sgd_mom": ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
         "adam": ("adam", {"learning_rate": 0.01})}


def _params_np(net, pkg, ctx=None):
    out = {}
    for k, p in net._collect_params_with_prefix().items():
        v = p.data(ctx) if ctx is not None else p.data()
        # a copy: on the CPU .numpy() shares the tensor's memory, which
        # the next step writes in place
        out[k] = v.detach().numpy().copy() if pkg is tmx else v.asnumpy()
    return out


def _assert_params(got, want, rel, model_scale=False):
    """Each parameter within ``rel`` of its largest |value| (or, with
    ``model_scale``, of the largest |value| of all the parameters)."""
    top = max(float(np.abs(v).max()) for v in want.values())
    for k in want:
        scale = top if model_scale else max(float(np.abs(want[k]).max()),
                                            1e-30)
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= rel * scale, (k, err, scale)


@pytest.mark.parametrize("n_ctx", [2, 4])
@pytest.mark.parametrize("mode", ["device", "update_on_kvstore",
                                  "compression", "local", "nccl"])
@pytest.mark.parametrize("opt", ["sgd_mom", "adam"])
def test_mlp_trainer_over_contexts_matches_jax(n_ctx, mode, opt):
    import mxnet_tpu as jmx

    name, args = _OPTS[opt]
    tnet, ttr, tl = _train_mlp(tmx, n_ctx, name, args, mode)
    jnet, jtr, jl = _train_mlp(jmx, n_ctx, name, args, mode)
    assert ttr._kvstore is not None and jtr._kvstore is not None
    assert ttr._update_on_kvstore == jtr._update_on_kvstore
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    want = _params_np(jnet, jmx)
    for c in _ctxs(tmx, n_ctx):  # every context holds the same values
        _assert_params(_params_np(tnet, tmx, c), want, 1e-5)


def _bert(pkg):
    from test_torch_train import _pretrain_block

    if pkg is tmx:
        cls = tmx.models.BERTModel
    else:
        from mxnet_tpu.models.bert import BERTModel as cls
    return _pretrain_block(pkg)(cls(VOCAB, 64, 128, 2, 1, max_length=64,
                                    dropout=0.0))


def _bert_weights():
    """Numpy weights of a JAX-initialized BERT-tiny, by structural name."""
    import mxnet_tpu as jmx
    from test_torch_train import _synthetic_batch

    jmx.random.seed(9)
    jnet = _bert(jmx)
    jnet.initialize(init=jmx.init.Normal(0.02))
    batch = _synthetic_batch(np.random.RandomState(10), 2, 32, VOCAB)
    with jmx.autograd.pause():
        jnet(*[jmx.nd.array(a, dtype=a.dtype) for a in batch])
    return {k: p.data().asnumpy()
            for k, p in jnet._collect_params_with_prefix().items()}


def _train_bert(pkg, n_ctx, opt, args, mode, weights, batch, steps=3):
    ctxs = _ctxs(pkg, n_ctx)
    net = _bert(pkg)
    net.initialize(init=pkg.init.Normal(0.02), ctx=ctxs)
    if pkg is tmx:
        tmx.load_numpy_params(net, weights)
    else:
        with pkg.autograd.pause():  # finish the deferred shapes
            with ctxs[0]:
                net(*[pkg.nd.array(a[:1], ctx=ctxs[0], dtype=a.dtype)
                      for a in batch])
        params = net._collect_params_with_prefix()
        for k, v in weights.items():
            params[k].set_data(pkg.nd.array(v))
    trainer = pkg.gluon.Trainer(net.collect_params(), opt, dict(args),
                                **_MODES[mode])
    parts = [pkg.gluon.utils.split_and_load(a, ctxs) for a in batch]
    losses = []
    for _ in range(steps):
        ls = []
        with pkg.autograd.record():
            for r, c in enumerate(ctxs):
                # the JAX package's BERT makes its position ids on the
                # default context (ROADMAP caveat (j)): make it the slice's
                with c:
                    ls.append(net(*[p[r] for p in parts]))
        pkg.autograd.backward(ls)
        trainer.step(n_ctx)
        losses.append(sum(_loss_value(pkg, l) for l in ls) / n_ctx)
    return net, losses


@pytest.fixture(scope="module")
def bert_setup():
    from test_torch_train import _synthetic_batch

    batch = _synthetic_batch(np.random.RandomState(11), 8, 32, VOCAB)
    batch = tuple(a.astype(np.float32) if a.dtype == np.float64 else a
                  for a in batch)
    return _bert_weights(), batch


@pytest.mark.parametrize("n_ctx", [2, 4])
@pytest.mark.parametrize("mode", ["device", "update_on_kvstore",
                                  "compression"])
@pytest.mark.parametrize("opt", ["sgd_mom", "adam"])
def test_bert_tiny_trainer_over_contexts_matches_jax(bert_setup, n_ctx,
                                                     mode, opt):
    import mxnet_tpu as jmx

    weights, batch = bert_setup
    name, args = _OPTS[opt]
    args = dict(args, learning_rate=args["learning_rate"] * 0.1)
    tnet, tl = _train_bert(tmx, n_ctx, name, args, mode, weights, batch)
    jnet, jl = _train_bert(jmx, n_ctx, name, args, mode, weights, batch)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    want = _params_np(jnet, jmx)
    for c in _ctxs(tmx, n_ctx):
        # the key part of attn_in_bias has a gradient of rounding noise
        # alone (softmax ignores a shift of every key's score), which Adam
        # scales up to lr-sized steps: BERT's parameters are held against
        # the model's largest value
        _assert_params(_params_np(tnet, tmx, c), want, 1e-4,
                       model_scale=True)


# -- one context ------------------------------------------------------------------


@pytest.mark.parametrize("kvstore,uok", [
    ("device", None), ("local", None), ("nccl", None), (None, None),
    ("dist_sync", None), ("dist_sync", False), ("device", True)])
def test_one_context_with_any_kvstore_is_todays_step(kvstore, uok):
    """One context: no kvstore for local/device/nccl (as the reference), and
    under dist_sync in one process a kvstore whose sums are identities;
    the step equals the plain Trainer's bit for bit."""
    x, y = _mlp_data()
    results = []
    for kw in ({}, {"kvstore": kvstore, "update_on_kvstore": uok}):
        net = _build_mlp(tmx, [tmx.cpu()], _mlp_weights())
        tr = tmx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 0.01}, **kw)
        loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
        for _ in range(3):
            with tmx.autograd.record():
                loss = loss_fn(net(tmx.nd.array(x, ctx=tmx.cpu())),
                               tmx.nd.array(y, ctx=tmx.cpu()))
            loss.backward()
            tr.step(BATCH)
        results.append((_params_np(net, tmx), tr))
    assert (results[1][1]._kvstore is not None) == (kvstore == "dist_sync")
    for k, v in results[0][0].items():
        np.testing.assert_array_equal(results[1][0][k], v)


# -- states with a "kvstore" blob ----------------------------------------------------


def _one_step(pkg, net, tr, seed):
    x, y = _mlp_data(seed=seed)
    ctxs = tr._contexts
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    xs = pkg.gluon.utils.split_and_load(x, ctxs)
    ys = pkg.gluon.utils.split_and_load(y, ctxs)
    with pkg.autograd.record():
        ls = [loss_fn(net(a), b) for a, b in zip(xs, ys)]
    pkg.autograd.backward(ls)
    tr.step(BATCH)
    return _params_np(net, pkg)


@pytest.mark.parametrize("how", ["blob", "file"])
@pytest.mark.parametrize("src", ["port", "jax"])
def test_kvstore_states_round_trip_between_packages(tmp_path, src, how):
    """Two Adam steps with update_on_kvstore over 2 contexts in one
    package; its states (``states_dict`` with the "kvstore" blob, or the
    ``save_states`` file, the updater's) loaded by a Trainer of the other
    package at the same weights; one more step in each: the same
    parameters."""
    import mxnet_tpu as jmx

    pkgs = {"port": tmx, "jax": jmx}
    dst = "jax" if src == "port" else "port"
    name, args = _OPTS["adam"]
    snet, s_tr, _ = _train_mlp(pkgs[src], 2, name, args,
                               "update_on_kvstore", steps=2)
    dnet, d_tr, _ = _train_mlp(pkgs[dst], 2, name, args,
                               "update_on_kvstore", steps=0,
                               weights=_params_np(snet, pkgs[src]))
    if how == "blob":
        blob = s_tr.states_dict()
        assert isinstance(blob["kvstore"], bytes)
        assert blob["num_update"] == 2
        d_tr.load_states_dict(pickle.loads(pickle.dumps(blob)))
    else:
        f = str(tmp_path / "kv.states")
        s_tr.save_states(f)
        d_tr.load_states(f)
        # the updater's file holds no counters, in either package
        d_tr.optimizer.num_update = 2
        d_tr.optimizer._index_update_count = dict(
            s_tr.optimizer._index_update_count)
    want = _one_step(pkgs[src], snet, s_tr, seed=5)
    got = _one_step(pkgs[dst], dnet, d_tr, seed=5)
    _assert_params(got, want, 1e-5)


def test_kvstore_states_and_local_states_do_not_mix():
    name, args = _OPTS["adam"]
    _, kv_tr, _ = _train_mlp(tmx, 2, name, args, "update_on_kvstore",
                             steps=1)
    _, local_tr, _ = _train_mlp(tmx, 2, name, args, "device", steps=1)
    with pytest.raises(MXNetError, match="kvstore-side updater"):
        local_tr.load_states_dict(kv_tr.states_dict())
    with pytest.raises(MXNetError, match="local-update"):
        kv_tr.load_states_dict(local_tr.states_dict())
    with pytest.raises(MXNetError, match="illegal"):
        kv_tr.allreduce_grads()
    with pytest.raises(MXNetError, match="illegal"):
        kv_tr.update(BATCH)


def test_checkpoint_manager_saves_kvstore_states(tmp_path):
    """CheckpointManager round trip of a Trainer whose states live in the
    kvstore's updater: the restored run continues bit-identically."""
    from mxnet_tpu_torch import checkpoint as tck

    name, args = _OPTS["adam"]
    net, tr, _ = _train_mlp(tmx, 2, name, args, "update_on_kvstore",
                            steps=2)
    mgr = tck.CheckpointManager(str(tmp_path))
    mgr.save(2, params=net, trainer=tr, sync=True)
    net2, tr2, _ = _train_mlp(tmx, 2, name, args, "update_on_kvstore",
                              steps=1, weights=_mlp_weights(seed=7))
    mgr.restore(step=2, params=net2, trainer=tr2)
    assert tr2.optimizer.num_update == 2
    x, y = _mlp_data(seed=6)
    outs = []
    for n, t in ((net, tr), (net2, tr2)):
        ctxs = _ctxs(tmx, 2)
        loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
        xs = tmx.gluon.utils.split_and_load(x, ctxs)
        ys = tmx.gluon.utils.split_and_load(y, ctxs)
        with tmx.autograd.record():
            ls = [loss_fn(n(a), b) for a, b in zip(xs, ys)]
        tmx.autograd.backward(ls)
        t.step(BATCH)
        outs.append(_params_np(n, tmx, tmx.cpu(1)))
    for k, v in outs[0].items():
        np.testing.assert_array_equal(outs[1][k], v)


# -- the whole step -------------------------------------------------------------------


def test_whole_step_over_contexts():
    """The whole step over a kvstore runs eagerly (decided at the first
    step, logged once, counted in ``whole_step_eager``): with the whole
    step on or off it splits the batch over the contexts and equals the
    hand-written loop bit for bit.  A ``dist_sync`` trainer takes the whole
    step too."""
    name, args = _OPTS["sgd_mom"]
    x, y = _mlp_data()
    ctxs = _ctxs(tmx, 2)
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    ref_net, _, ref_losses = _train_mlp(tmx, 2, name, args, "device")
    tmx.gluon.Trainer(_build_mlp(tmx, ctxs, _mlp_weights()).collect_params(),
                      name, dict(args), kvstore="dist_sync", whole_step=True)
    for whole in (True, False):
        net = _build_mlp(tmx, ctxs, _mlp_weights())
        tr = tmx.gluon.Trainer(net.collect_params(), name, dict(args),
                               whole_step=whole)
        ttrainer.reset_trainer_step_stats()
        total = [float(tr.whole_step(net, loss_fn, x, y).asscalar())
                 for _ in range(3)]
        stats = ttrainer.trainer_step_stats()
        assert stats["whole_step_eager"] == (3 if whole else 0)
        assert stats["whole_step_fallbacks"] == 0
        np.testing.assert_allclose(np.asarray(total) / BATCH, ref_losses,
                                   rtol=1e-6)
        for c in ctxs:
            got, want = _params_np(net, tmx, c), _params_np(ref_net, tmx, c)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])


# -- on the card -----------------------------------------------------------------------


@pytest.mark.gpu
def test_trainer_over_cards_matches_cpu_contexts():
    """The Trainer over gpu(0..n-1) (n >= 2) against the same run over
    cpu(0..n-1): every card holds the same values, within fp32 rounding
    of the CPU's."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip(f"needs 2 CUDA devices, {n} visible (the Trainer over "
                    "several cards); run on a multi-GPU machine with -m gpu")
    name, args = _OPTS["adam"]
    x, y = _mlp_data()
    runs = []
    for ctxs in ([tmx.gpu(i) for i in range(n)],
                 [tmx.cpu(i) for i in range(n)]):
        net = _build_mlp(tmx, ctxs, _mlp_weights())
        tr = tmx.gluon.Trainer(net.collect_params(), name, dict(args))
        loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
        for _ in range(3):
            xs = tmx.gluon.utils.split_and_load(x, ctxs)
            ys = tmx.gluon.utils.split_and_load(y, ctxs)
            with tmx.autograd.record():
                ls = [loss_fn(net(a), b) for a, b in zip(xs, ys)]
            tmx.autograd.backward(ls)
            tr.step(BATCH)
        runs.append([{k: v.detach().cpu().numpy() for k, v in
                      ((k, p.data(c)) for k, p in
                       net._collect_params_with_prefix().items())}
                     for c in ctxs])
    for per_ctx in runs[0][1:]:
        for k, v in runs[0][0].items():
            np.testing.assert_array_equal(per_ctx[k], v)
    _assert_params(runs[0][0], runs[1][0], 1e-5)
