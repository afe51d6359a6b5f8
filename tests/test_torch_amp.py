"""Mixed precision in the PyTorch port against the JAX package: the dtype
rules of the ops under AMP, ``cast``, the weight carry-over, ``amp``'s
``LossScaler`` and ``scale_loss``, the Trainer's overflow skip, and a
narrow BERT pretrained under float16 and bfloat16 AMP.

Inputs are made with numpy from seeds. Tolerances: an op's output dtype is
the JAX op's exactly; its values within one ulp of that dtype (a fused
torch kernel rounds once where the reference rounds each step; two for a
product's sums in other orders; LayerNorm bit for bit). The BERT runs (2
layers, 128 wide, 2 heads of 64, vocab 1000, dropout 0, b=2, s=128, 3
steps, the loss scale's dynamics included): under float16 with LAMB and
``multi_precision`` (lr 1e-3) the losses within 5e-4 relative (measured
6.6e-5), every float32 master within 2 lr of the reference's and 99.9% of
their elements within 1e-5 (the port's attention runs in float16 where the
reference's runs in float32, ROADMAP caveat (t), and LAMB's first step
moves a weight by about lr whatever the size of its gradient, so a gradient
of rounding size can flip an element's step); under bfloat16 the losses
within 2e-3 (measured 7.3e-4) and the weights within 8e-3 of the largest.
The tests marked ``gpu`` run a captured block after ``cast`` and the AMP
step on the card.
"""
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_train import _pretrain_block, _synthetic_batch  # noqa: E402

CPU = tmx.cpu()


def _ulp(dtype, x):
    """One ulp of ``dtype`` at the magnitude of ``x`` (elementwise)."""
    bits = {np.float16: 10, np.float32: 23}.get(np.dtype(dtype).type, 7)
    mag = np.maximum(np.abs(np.asarray(x, np.float64)), 2.0 ** -14)
    return 2.0 ** (np.floor(np.log2(mag)) - bits)


# -- the ops' dtype rules under AMP -----------------------------------------


def test_layer_norm_of_float16_data_with_float32_params_is_float32():
    """Queue 3, item 14: LayerNorm of float16 data with the float32 gamma
    and beta that ``amp.convert_model`` leaves.  The reference normalizes
    in float16 and promotes with gamma and beta: float32 out.  The port
    returned float16 (max abs difference 2.85e-3)."""
    from mxnet_tpu.ops import nn as jnn
    import jax.numpy as jnp
    from mxnet_tpu_torch.ops import nn as tnn

    rng = np.random.RandomState(0)
    x = (rng.randn(4, 16) * 3).astype(np.float16)
    g, b = (rng.randn(16).astype(np.float32) for _ in range(2))
    want = np.asarray(jnn._k_layer_norm(jnp.asarray(x), jnp.asarray(g),
                                        jnp.asarray(b)))
    got = tnn._k_layer_norm(*(torch.from_numpy(a) for a in (x, g, b)))
    assert want.dtype == np.float32 and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _sweep_inputs():
    rng = np.random.RandomState(5)
    x16 = (rng.randn(4, 16) * 3).astype(np.float16)
    x4 = (rng.randn(4, 6, 5, 5) * 2).astype(np.float16)
    f32 = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    w16 = (rng.randn(8, 16) * 0.3).astype(np.float16)
    b8 = rng.randn(8).astype(np.float16)
    return dict(
        x16=x16, x16f=x16.astype(np.float32), g16=f32(16), b16=f32(16),
        x4=x4, g6=f32(6), b6=f32(6), mm=f32(6),
        mv=rng.rand(6).astype(np.float32) + 0.5, g3=f32(3), b3=f32(3),
        pos=np.abs(x16) + np.float16(0.1), w16=w16, b8=b8,
        b8f=b8.astype(np.float32),
        lab=rng.randint(0, 16, size=4).astype(np.float32),
        emb=rng.randn(10, 16).astype(np.float16),
        ids=rng.randint(0, 10, size=(3, 4)).astype(np.float32))


#: (op, its inputs by name, attributes): the ops ``amp.FP32_OPS`` names
#: and the products the BERT and Gluon paths reach with float16 data
SWEEP = [
    ("LayerNorm", ("x16", "g16", "b16"), {}),
    ("BatchNorm", ("x4", "g6", "b6", "mm", "mv"),
     {"fix_gamma": False, "_train": False}),
    ("BatchNorm", ("x4", "g6", "b6", "mm", "mv"),
     {"fix_gamma": False, "_train": True}),
    ("InstanceNorm", ("x4", "g6", "b6"), {}),
    ("GroupNorm", ("x4", "g3", "b3"), {"num_groups": 3}),
    ("softmax", ("x16",), {}),
    ("log_softmax", ("x16",), {}),
    ("norm", ("x16",), {}),
    ("mean", ("x16",), {"axis": 1}),
    ("sum", ("x16",), {}),
    ("SoftmaxOutput", ("x16", "lab"), {}),
    ("exp", ("x16",), {}),
    ("log", ("pos",), {}),
    ("FullyConnected", ("x16", "w16", "b8"), {"num_hidden": 8}),
    ("FullyConnected", ("x16f", "w16", "b8"), {"num_hidden": 8}),
    ("FullyConnected", ("x16", "w16", "b8f"), {"num_hidden": 8}),
    ("Embedding", ("ids", "emb"), {"input_dim": 10, "output_dim": 16}),
]
SWEEP_IDS = ["LayerNorm", "BatchNorm_predict", "BatchNorm_train",
             "InstanceNorm", "GroupNorm", "softmax", "log_softmax", "norm",
             "mean", "sum", "SoftmaxOutput", "exp", "log",
             "FullyConnected_fp16", "FullyConnected_fp32_data",
             "FullyConnected_fp32_bias", "Embedding"]


@pytest.mark.parametrize("op,names,attrs", SWEEP, ids=SWEEP_IDS)
def test_amp_dtype_rules_match_jax(op, names, attrs):
    """Float16 data, float32 norm parameters, float16 weights: each
    output's dtype is the JAX op's, its values within one ulp of it (two
    for the products' 16-term sums in other orders).
    Queue 3, item 15: ``FullyConnected`` raised for float32 data or a
    float32 bias beside float16 weights, where the reference casts the
    data down to the weights' dtype and the bias to the product's."""
    import jax
    from mxnet_tpu.ops import registry as jreg
    import jax.numpy as jnp
    from mxnet_tpu_torch.ops import registry as treg

    ins = _sweep_inputs()
    arrays = [ins[n] for n in names]
    # jitted, as the package's ``invoke`` runs a registered op: one XLA
    # computation rounds float16 where its fusions end, not after each step
    want = jax.jit(lambda *a: jreg.get(op).fn(*a, **attrs))(
        *(jnp.asarray(a) for a in arrays))
    got = treg.get(op)(*(torch.from_numpy(np.array(a)) for a in arrays),
                       **attrs)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    ulps = 2 if op == "FullyConnected" else 1
    for w, t in zip(want, got):
        w = np.asarray(w)
        assert str(t.dtype) == f"torch.{w.dtype}", (op, t.dtype, w.dtype)
        t = t.detach().float().numpy()
        gap = np.abs(t - w.astype(np.float32))
        mag = np.maximum(np.abs(t), np.abs(w.astype(np.float32)))
        assert (gap <= ulps * _ulp(w.dtype, mag) + 1e-7).all(), \
            (op, gap.max())


def test_attention_under_amp_runs_in_the_weights_dtype():
    """Caveat (t): float16 projection weights pull the inputs of
    ``multihead_attention`` down to float16, as ``FullyConnected`` does,
    so BERT's attention under float16 AMP runs in float16 (the kernels'
    dtype on the card); the reference promotes to float32 there.  On the
    CPU's oracle a float32 key-padding mask over float16 logits computes
    in float32, as the reference's oracle does (queue 3, item 16: the
    port's oracle raised)."""
    from mxnet_tpu.ops import attention as jatt
    import jax.numpy as jnp
    from mxnet_tpu_torch.ops import attention as tatt

    rng = np.random.RandomState(6)
    b, h, s, d = 2, 2, 8, 64
    q, k, v = (rng.randn(b, h, s, d).astype(np.float16) for _ in range(3))
    mask = np.where(np.arange(s) < 5, 0.0, -1e9).astype(np.float32)
    mask = np.broadcast_to(mask, (b, 1, 1, s)).copy()
    want = np.asarray(jatt.sdpa_reference(*(jnp.asarray(a)
                                            for a in (q, k, v, mask))))
    got = tatt.sdpa_reference(*(torch.from_numpy(a)
                                for a in (q, k, v, mask)))
    assert str(got.dtype) == f"torch.{want.dtype}" == "torch.float32"
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    x = torch.from_numpy(rng.randn(b, s, 128).astype(np.float32))
    w_in = torch.from_numpy((rng.randn(384, 128) * 0.05).astype(np.float16))
    w_out = torch.from_numpy((rng.randn(128, 128) * 0.05).astype(np.float16))
    out = tatt._k_multihead_attention(
        x, x, x, w_in, torch.zeros(384, dtype=torch.float16), w_out,
        torch.zeros(128, dtype=torch.float16), num_heads=2)
    assert out.dtype == torch.float16 and torch.isfinite(out).all()


# -- cast and the carry-over ------------------------------------------------


def _net(pkg, ctx):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(8, in_units=4, activation="relu"),
            pkg.gluon.nn.LayerNorm(in_channels=8),
            pkg.gluon.nn.Dense(3, in_units=8))
    net.initialize(pkg.init.Xavier(), ctx=ctx)
    return net


def test_parameter_cast_replaces_values_and_gradients():
    p = tmx.gluon.Parameter("w", shape=(3, 2))
    p.initialize(ctx=[tmx.cpu(0), tmx.cpu(1)])
    old = p.list_data()
    for g in p.list_grad():
        g.fill_(1.0)
    p.cast("float16")
    assert p.dtype == "float16"
    for o, n, g in zip(old, p.list_data(), p.list_grad()):
        assert n is not o and n.dtype == torch.float16
        assert torch.equal(n, o.detach().half())
        assert g.dtype == torch.float16 and not g.any()
        assert n.requires_grad and not o.requires_grad
    p.set_data(np.full((3, 2), 0.1, np.float32))
    assert p.data().dtype == torch.float16
    assert float(p.data()[0, 0]) == float(np.float16(0.1))
    q = tmx.gluon.Parameter("q", shape=(0, 2), allow_deferred_init=True)
    q.initialize(ctx=CPU)
    q.cast("float16")   # deferred: the value is made in the new dtype
    q.shape = (4, 2)
    q._finish_deferred_init()
    assert q.data().dtype == torch.float16


def test_block_cast_reaches_children_and_drops_captures():
    net = _net(tmx, CPU)
    net.hybridize()
    x = torch.ones(2, 4)
    net(x)
    assert net._cached_op is not None
    step = tmx.gluon.block.CachedStepOp(net)
    step._graphs["sig"] = object()
    step._warm.add("sig")
    net.cast("float16")
    assert net._cached_op is None
    assert not step._graphs and not step._warm
    assert all(p.data().dtype == torch.float16
               for p in net.collect_params().values())
    assert net[0]._parameters["weight"] is net[0].weight.data()
    assert net(x.half()).dtype == torch.float16


def test_convert_model_and_load_numpy_params_carry_an_amp_net_exactly():
    """An AMP-converted JAX net's arrays go into an AMP-converted port
    net bit for bit: float16 weights stay float16, the float32 norm
    parameters float32, and the forwards agree."""
    import mxnet_tpu as jmx

    jmx.random.seed(3)
    jnet = _net(jmx, jmx.cpu())
    x = np.random.RandomState(4).randn(5, 4).astype(np.float32)
    jnet(jmx.nd.array(x))
    jmx.amp.convert_model(jnet, "float16")
    tnet = _net(tmx, CPU)
    tmx.amp.convert_model(tnet, "float16")
    arrays = {k: p.data().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()}
    tmx.load_numpy_params(tnet, arrays)
    for k, p in tnet._collect_params_with_prefix().items():
        v = p.data().detach().numpy()
        assert v.dtype == arrays[k].dtype, k
        np.testing.assert_array_equal(v, arrays[k])
    assert tnet[1].gamma.data().dtype == torch.float32
    want = jnet(jmx.nd.array(x)).asnumpy()
    got = tnet(torch.from_numpy(x)).detach().numpy()
    assert got.dtype == want.dtype == np.float16
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32),
                               atol=float(_ulp(np.float16, want).max()))


def test_convert_model_splits_by_name_stem_as_jax():
    """The reference's split: ``..._gamma`` and ``..._beta`` stay float32,
    BatchNorm's ``..._running_mean``/``_var`` (stems mean and var) are
    cast (caveat (s))."""
    import mxnet_tpu as jmx

    dts = {}
    for key, pkg, ctx in (("jax", jmx, jmx.cpu()), ("port", tmx, CPU)):
        net = pkg.gluon.nn.HybridSequential()
        net.add(pkg.gluon.nn.Dense(4, in_units=3),
                pkg.gluon.nn.BatchNorm(in_channels=4),
                pkg.gluon.nn.LayerNorm(in_channels=4))
        net.initialize(ctx=ctx)
        pkg.amp.init("float16")
        pkg.amp.convert_model(net)
        dts[key] = {k.split("_", 1)[1]: np.dtype(str(p.data().dtype)
                                                 .replace("torch.", ""))
                    for k, p in net.collect_params().items()}
        pkg.amp.init("bfloat16")
    assert dts["port"] == dts["jax"]
    assert dts["port"]["running_mean"] == np.float16
    assert dts["port"]["gamma"] == np.float32


# -- the loss scaler and the Trainer ------------------------------------------


def test_loss_scaler_dynamics_match_jax():
    """The same overflow sequence through both scalers: the scale, the
    skip decisions and the flags agree step by step."""
    import mxnet_tpu as jmx

    seq = [False, True, False, False, False, True, True, False, False,
           False, False, False, False, False]
    trace = {}
    for key, pkg in (("jax", jmx), ("port", tmx)):
        s = pkg.amp.LossScaler(init_scale=8.0, scale_factor=2.0,
                               scale_window=3, min_scale=2.0)
        trace[key] = [(s.update(o), s.loss_scale, s.enabled) for o in seq]
        one = pkg.amp.LossScaler(init_scale=1.0)
        assert not one.enabled and one.scale(3.0) == 3.0
    assert trace["port"] == trace["jax"]
    s = tmx.amp.LossScaler(init_scale=8.0)
    assert float(s.scale(torch.tensor([2.0]))[0]) == 16.0
    assert s.has_overflow([torch.tensor([1.0, float("inf")]),
                           torch.ones(2, dtype=torch.float16)])
    assert s.has_overflow([torch.ones(2),
                           torch.tensor([float("nan")], dtype=torch.float16)])
    assert not s.has_overflow([torch.ones(2), None])
    assert float(s.unscale([torch.tensor([8.0])])[0][0]) == 1.0


def test_scale_loss_skips_the_overflowed_step_as_jax():
    """The reference's ``test_scale_loss_trainer_integration``, both
    packages side by side: the gradient carries the scale, the optimizer
    divides it out, and an overflow skips the update and halves the
    scale."""
    import mxnet_tpu as jmx

    got = {}
    for key, pkg, ctx in (("jax", jmx, jmx.cpu()), ("port", tmx, CPU)):
        pkg.amp.init("float16")
        try:
            net = pkg.gluon.nn.Dense(1, use_bias=False, in_units=1)
            net.initialize(pkg.init.Constant(2.0), ctx=ctx)
            tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 1.0})
            x = pkg.nd.ones((1, 1), ctx=ctx)
            rec = []
            for bad in (False, True, False):
                with pkg.autograd.record():
                    out = net(x)
                    loss = (out * float("inf")).sum() if bad else out.sum()
                    with pkg.amp.scale_loss(loss, tr) as scaled:
                        pass
                scaled.backward()
                g = float(np.asarray(net.weight.grad().asnumpy()
                                     if key == "jax" else
                                     net.weight.grad().numpy()).ravel()[0])
                tr.step(1)
                w = net.weight.data()
                w = float((w.asnumpy() if key == "jax"
                           else w.detach().numpy()).ravel()[0])
                rec.append((g, w, tr._amp_loss_scaler.loss_scale, tr._scale))
            got[key] = rec
        finally:
            pkg.amp.init("bfloat16")
    assert got["port"][0][0] == 65536.0 and got["port"][0][1] == 1.0
    assert got["port"][1][1] == 1.0 and got["port"][1][2] == 32768.0
    np.testing.assert_equal(got["port"], got["jax"])


def test_trainer_refuses_loss_scaling_with_update_on_kvstore():
    import mxnet_tpu as jmx

    msgs = []
    for pkg, ctx in ((jmx, [jmx.cpu(0), jmx.cpu(1)]),
                     (tmx, [tmx.cpu(0), tmx.cpu(1)])):
        net = pkg.gluon.nn.Dense(2, in_units=3)
        net.initialize(ctx=ctx)
        tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1}, kvstore="device",
                               update_on_kvstore=True)
        tr._amp_original_scale = tr._scale
        tr._amp_loss_scaler = pkg.amp.LossScaler()
        with pytest.raises(pkg.MXNetError) as e:
            tr.step(1)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "update_on_kvstore" in msgs[1]


def _mlp_trainer(dtype, **kw):
    tmx.random.seed(0)
    net = _net(tmx, CPU)
    tmx.amp.convert_model(net, dtype)
    tr = tmx.gluon.Trainer(net.collect_params(), "adamw",
                           {"learning_rate": 1e-3}, **kw)
    return net, tr


def _amp_whole_step(net, tr, x, y):
    l2 = tmx.gluon.loss.L2Loss()
    with tmx.autograd.record():
        loss = l2(net(x), y).sum()
        with tmx.amp.scale_loss(loss, tr) as scaled:
            tmx.autograd.backward(scaled)
    tr.step(x.shape[0])


def test_bfloat16_scaler_idles_and_the_whole_step_still_captures():
    """Under bfloat16 AMP the scaler idles at scale 1, disarmed: the whole
    step takes no bypass; under float16 it is armed, and the whole step
    and ZeRO bypass with the JAX package's reasons."""
    x = torch.from_numpy(np.random.RandomState(1).randn(6, 4)
                         .astype(np.float32))
    y = torch.zeros(6, 3)
    tmx.amp.init("bfloat16")
    net, tr = _mlp_trainer("bfloat16", whole_step=True)
    _amp_whole_step(net, tr, x, y)
    assert tr._amp_loss_scaler.loss_scale == 1.0
    assert not tr._amp_loss_scaler.enabled
    tmx.gluon.trainer.reset_trainer_step_stats()
    tr.whole_step(net, lambda out, yy: tmx.gluon.loss.L2Loss()(out, yy),
                  x, y)
    st = tmx.gluon.trainer.trainer_step_stats()
    assert st["whole_step_steps"] == 1 and st["whole_step_fallbacks"] == 0
    tmx.amp.init("float16")
    try:
        net, tr = _mlp_trainer("float16", whole_step=True)
        _amp_whole_step(net, tr, x, y)
        assert tr._amp_loss_scaler.enabled
        tmx.gluon.trainer.reset_trainer_step_stats()
        tr.whole_step(net, lambda out, yy: tmx.gluon.loss.L2Loss()(out, yy),
                      x, y)
        assert tmx.gluon.trainer.trainer_step_stats()[
            "whole_step_fallbacks"] == 1
        assert any("amp dynamic loss scaling" in r
                   for r in tr._whole_step_compiler._warned)
        net2 = _net(tmx, [tmx.cpu(0), tmx.cpu(1)])
        tr2 = tmx.gluon.Trainer(net2.collect_params(), "sgd",
                                {"learning_rate": 0.1}, zero_shard=True)
        tr2._init_kvstore()
        tr2._amp_loss_scaler = tmx.amp.LossScaler()
        assert tr2._zero_ineligible_reason(tr2._contexts) == \
            "amp dynamic loss scaling (the overflow skip is a host-side " \
            "decision)"
    finally:
        tmx.amp.init("bfloat16")


# -- a narrow BERT under AMP --------------------------------------------------

VOCAB = 1000


def _bert_run(dtype, opt, opt_args, steps=3):
    """Both packages from the same converted weights: per package the
    losses, the loss scales, the trainer."""
    import mxnet_tpu as jmx
    from mxnet_tpu.models.bert import BERTModel as JBERT

    def bert(cls):
        return cls(VOCAB, 128, 256, 2, 2, max_length=128, dropout=0.0)

    jmx.random.seed(9)
    jnet = _pretrain_block(jmx)(bert(JBERT))
    jnet.initialize(init=jmx.init.Normal(0.02))
    batch = _synthetic_batch(np.random.RandomState(10), 2, 128, VOCAB)
    jb = [jmx.nd.array(a, dtype=a.dtype) for a in batch]
    with jmx.autograd.pause():
        jnet(*jb)
    tnet = _pretrain_block(tmx)(bert(tmx.models.BERTModel))
    tnet.initialize(ctx=CPU)
    out = {}
    for pkg in (jmx, tmx):
        pkg.amp.init(dtype)
    try:
        jmx.amp.convert_model(jnet)
        tmx.amp.convert_model(tnet)
        tmx.load_numpy_params(tnet, {
            k: p.data().asnumpy()
            for k, p in jnet._collect_params_with_prefix().items()})
        tb = [torch.from_numpy(a) for a in batch]
        for key, pkg, net, b in (("jax", jmx, jnet, jb),
                                 ("port", tmx, tnet, tb)):
            tr = pkg.gluon.Trainer(net.collect_params(), opt,
                                   dict(opt_args), update_on_kvstore=False)
            losses, scales = [], []
            for _ in range(steps):
                with pkg.autograd.record():
                    loss = net(*b)
                    with pkg.amp.scale_loss(loss, tr) as scaled:
                        pkg.autograd.backward(scaled)
                tr.step(1)
                losses.append(float(loss.asscalar()) if key == "jax"
                              else float(loss.detach()))
                scales.append(tr._amp_loss_scaler.loss_scale)
            out[key] = (losses, scales, tr, net)
    finally:
        for pkg in (jmx, tmx):
            pkg.amp.init("bfloat16")
    return out


def _masters(tr, key):
    """The float32 values each parameter trains: its master where it has
    one, else itself."""
    vals = []
    for i, p in enumerate(tr._params):
        st = tr._states[i]
        if key == "jax":
            st = st[list(st)[0]] if isinstance(st, dict) else st
            w = p.data().asnumpy()
        else:
            w = p.data().detach().float().numpy()
        if isinstance(st, tuple) and st and getattr(st[0], "shape", None) \
                == tuple(p.shape) and str(st[0].dtype).endswith("float32") \
                and p.data().dtype != st[0].dtype:
            w = st[0].asnumpy() if key == "jax" else st[0].numpy()
        vals.append(np.asarray(w, np.float32).ravel())
    return np.concatenate(vals)


def test_narrow_bert_under_float16_amp_with_lamb_matches_jax():
    out = _bert_run("float16", "lamb", {"learning_rate": 1e-3, "wd": 0.01,
                                        "multi_precision": True})
    (jl, js, jtr, _), (tl, ts, ttr, tnet) = out["jax"], out["port"]
    assert ts == js   # the same overflow decisions and scales
    np.testing.assert_allclose(tl, jl, rtol=5e-4)
    assert all(np.isfinite(tl))
    gap = np.abs(_masters(ttr, "port") - _masters(jtr, "jax"))
    assert gap.max() <= 2e-3 and np.quantile(gap, 0.999) <= 1e-5
    dts = {str(p.data().dtype) for p in tnet.collect_params().values()}
    assert dts == {"torch.float16", "torch.float32"}
    assert all(isinstance(ttr._states[i], tuple)
               and ttr._states[i][0].dtype == torch.float32
               for i, p in enumerate(ttr._params)
               if p.data().dtype == torch.float16)


def test_narrow_bert_under_bfloat16_amp_matches_jax():
    """bfloat16 has no masters (``multi_precision`` covers float16 only)
    and the scaler idles at 1.  SGD with momentum: 3 steps, the losses
    within 2e-3 relative (bfloat16's 8 bits: its ulp is 3.9e-3 relative,
    and the port's attention runs in bfloat16, the reference's in float32)
    and the weights within 8e-3 of the largest."""
    out = _bert_run("bfloat16", "sgd", {"learning_rate": 0.05,
                                        "momentum": 0.9,
                                        "multi_precision": True})
    (jl, js, jtr, _), (tl, ts, ttr, _) = out["jax"], out["port"]
    assert ts == js == [1.0, 1.0, 1.0]
    assert not ttr._amp_loss_scaler.enabled
    np.testing.assert_allclose(tl, jl, rtol=2e-3)
    assert tl[-1] < tl[0]
    gap = np.abs(_masters(ttr, "port") - _masters(jtr, "jax"))
    scale = np.abs(_masters(jtr, "jax")).max()
    assert gap.max() <= 8e-3 * scale


def test_narrow_bert_under_bfloat16_amp_with_lamb_parts_from_jax():
    """LAMB under bfloat16 AMP: the first loss agrees within 2e-3; the
    reference's next is NaN, as its bias corrections ``1 - beta**t`` are
    computed in the weights' bfloat16, where 1 - 0.999 rounds to 0
    (caveat (u)); the port's, computed in float32, train on."""
    out = _bert_run("bfloat16", "lamb", {"learning_rate": 1e-3,
                                         "multi_precision": True}, steps=2)
    (jl, _, _, _), (tl, _, _, _) = out["jax"], out["port"]
    np.testing.assert_allclose(tl[0], jl[0], rtol=2e-3)
    assert np.isnan(jl[1]) and np.isfinite(tl).all()


# -- on the card --------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine with -m gpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_cast_drops_a_captured_serve_graph_on_card(cuda_device):
    """A hybridized block's predict forward is captured; after ``cast``
    the next calls warm up and capture again in float16, and the replay
    equals the eager forward of the cast block."""
    net = _net(tmx, tmx.gpu(0))
    net.hybridize()
    x = torch.randn(4, 4, device=cuda_device)
    for _ in range(3):
        net(x)
    assert net._cached_op._graphs
    net.cast("float16")
    assert net._cached_op is None
    xh = x.half()
    outs = [net(xh) for _ in range(3)]
    assert net._cached_op._graphs
    want = net._eager_forward(xh)
    for o in outs:
        assert o.dtype == torch.float16 and torch.equal(o, want)


@pytest.mark.gpu
def test_float16_amp_step_on_card_matches_cpu(cuda_device):
    """Float16 AMP LAMB steps with masters, on the card and on the CPU
    from the same weights, the scale starting at 2**10 (at 2**16 this
    small net's float16 gradients overflow for several steps): the same
    skip decisions and scales, masters within 2 lr (the card's float16
    products round at other places)."""
    x = np.random.RandomState(1).randn(6, 4).astype(np.float32)
    res = {}
    tmx.amp.init("float16")
    try:
        for ctx in (tmx.cpu(), tmx.gpu(0)):
            tmx.random.seed(0)
            net = _net(tmx, tmx.cpu())
            net.collect_params().reset_ctx(ctx)
            tmx.amp.convert_model(net)
            tr = tmx.gluon.Trainer(net.collect_params(), "lamb",
                                   {"learning_rate": 1e-3,
                                    "multi_precision": True})
            tr._amp_loss_scaler = tmx.amp.LossScaler(init_scale=2.0 ** 10)
            xs = torch.from_numpy(x).to(ctx.torch_device())
            scales = []
            for _ in range(3):
                _amp_whole_step(net, tr, xs, torch.zeros(6, 3,
                                                         device=xs.device))
                scales.append(tr._amp_loss_scaler.loss_scale)
            res[str(ctx)] = (scales, np.concatenate([
                tr._states[i][0].cpu().numpy().ravel()
                for i in range(len(tr._params))
                if isinstance(tr._states[i], tuple)]))
    finally:
        tmx.amp.init("bfloat16")
    assert res["cpu(0)"][0] == res["gpu(0)"][0]
    assert res["cpu(0)"][1].size > 0
    assert np.abs(res["cpu(0)"][1] - res["gpu(0)"][1]).max() <= 2e-3
