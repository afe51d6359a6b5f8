"""DeepAR in the PyTorch port against the JAX package, and the port's copy
of the time-series pipeline.

``deepar(8, 2)`` (2x8 LSTM), batch 3, T=12, dropout 0, with the JAX
network's weights carried across by structural name.  On the CPU the
port's LSTM runs its plain loop (``MXTPU_RNN_IMPL=auto`` off the card), as
the JAX package runs its scan.  Inputs are numpy from a seed.

Tolerances, fp32: the NLL and the losses of a 3-step Adam run within 1e-5
relative (the same sums in other orders); gradients within 1e-5 of their
largest magnitude plus 1e-4 relative; sampled paths within 1e-4 absolute
(the draws are numpy's from one seed; the distribution parameters differ
by rounding, and each step feeds the last draw back in).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.data import timeseries as tts

B, T, CELLS = 3, 12, 8


def _batch(seed, covariates):
    rng = np.random.RandomState(seed)
    t = np.arange(T)
    target = (np.sin(2 * np.pi * t / 6)[None] + 1.5
              + 0.1 * rng.randn(B, T)).astype(np.float32)
    cov = rng.rand(B, T, 3).astype(np.float32) - 0.5 if covariates \
        else None
    return target, cov


def _nets(distr, covariates, seed=0):
    """The JAX network (deferred shapes completed by one forward) and the
    port's with the same weights."""
    import mxnet_tpu as jmx

    jmx.random.seed(seed)
    jnet = jmx.models.deepar(CELLS, 2, dropout=0.0, distr=distr)
    jnet.initialize(jmx.init.Xavier())
    target, cov = _batch(seed, covariates)
    jnet(*_jargs(target, cov))
    tnet = tmx.models.deepar(CELLS, 2, dropout=0.0, distr=distr)
    tnet.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    tmx.load_numpy_params(tnet, {
        k: p.data().asnumpy().copy()
        for k, p in jnet._collect_params_with_prefix().items()})
    return jnet, tnet


def _jargs(target, cov):
    import mxnet_tpu as jmx

    args = [jmx.nd.array(target)]
    return args + ([jmx.nd.array(cov)] if cov is not None else [])


def _targs(target, cov):
    args = [tmx.nd.array(target, ctx=tmx.cpu())]
    return args + ([tmx.nd.array(cov, ctx=tmx.cpu())] if cov is not None
                   else [])


def _rel(a, b):
    return abs(a - b) / abs(b)


@pytest.mark.parametrize("covariates", [False, True])
@pytest.mark.parametrize("distr", ["student_t", "gaussian"])
def test_nll_matches_jax(distr, covariates):
    jnet, tnet = _nets(distr, covariates)
    target, cov = _batch(1, covariates)
    j = jnet(*_jargs(target, cov)).asscalar()
    t = tnet(*_targs(target, cov)).asscalar()
    assert _rel(t, j) <= 1e-5, (t, j)


def test_every_gradient_matches_jax():
    import mxnet_tpu as jmx

    jnet, tnet = _nets("student_t", True)
    target, cov = _batch(2, True)
    with jmx.autograd.record():
        jl = jnet(*_jargs(target, cov))
    jl.backward()
    with tmx.autograd.record():
        tl = tnet(*_targs(target, cov))
    tl.backward()
    jp = jnet._collect_params_with_prefix()
    tp = tnet._collect_params_with_prefix()
    assert set(jp) == set(tp) and len(tp) == 10
    for name in jp:
        ref = jp[name].grad().asnumpy()
        got = tp[name].grad().detach().numpy()
        scale = max(1e-30, float(np.abs(ref).max()))
        np.testing.assert_allclose(got, ref, atol=1e-5 * scale, rtol=1e-4,
                                   err_msg=name)


def test_adam_trajectory_matches_jax():
    import mxnet_tpu as jmx

    jnet, tnet = _nets("student_t", True)
    jtr = jmx.gluon.Trainer(jnet.collect_params(), "adam",
                            {"learning_rate": 1e-2})
    ttr = tmx.gluon.Trainer(tnet.collect_params(), "adam",
                            {"learning_rate": 1e-2})
    for step in range(3):
        target, cov = _batch(10 + step, True)
        with jmx.autograd.record():
            jl = jnet(*_jargs(target, cov))
        jl.backward()
        jtr.step(B)
        with tmx.autograd.record():
            tl = tnet(*_targs(target, cov))
        tl.backward()
        ttr.step(B)
        assert _rel(tl.asscalar(), jl.asscalar()) <= 1e-5, step


@pytest.mark.parametrize("covariates", [False, True])
def test_predict_paths_match_jax(covariates):
    import mxnet_tpu as jmx

    jnet, tnet = _nets("student_t", covariates)
    target, _ = _batch(3, False)
    P = 3
    cov = np.random.RandomState(4).rand(B, T + P, 3).astype(np.float32) \
        if covariates else None
    kw = dict(prediction_length=P, num_samples=4, seed=7)
    j = jnet.predict(jmx.nd.array(target), covariates=cov, **kw)
    t = tnet.predict(tmx.nd.array(target, ctx=tmx.cpu()), covariates=cov,
                     **kw)
    assert t.shape == j.shape == (B, 4, P)
    np.testing.assert_allclose(t, j, atol=1e-4, rtol=0)


def test_structural_names_equal_across_packages():
    """DeepAR's and a bidirectional GRU's parameters carry across by
    structural name, layer 0's deferred i2h_weight included."""
    import mxnet_tpu as jmx

    jgru = jmx.gluon.rnn.GRU(6, num_layers=2, bidirectional=True)
    jgru.initialize()
    jgru(jmx.nd.array(np.ones((4, 2, 5), np.float32)))
    tgru = tmx.gluon.rnn.GRU(6, num_layers=2, bidirectional=True)
    tgru.initialize(ctx=tmx.cpu())
    assert tgru.l0_i2h_weight.shape == (18, 0)
    names = []
    for jnet, tnet in (_nets("student_t", True), (jgru, tgru)):
        jshapes = {k: p.shape for k, p in
                   jnet._collect_params_with_prefix().items()}
        tmx.load_numpy_params(tnet, {k: np.zeros(s, np.float32)
                                     for k, s in jshapes.items()})
        assert {k: tuple(p.shape) for k, p in tnet.named_parameters()} == \
            {k: tuple(s) for k, s in jshapes.items()}
        names.append(set(jshapes))
    assert {"lstm.l0_i2h_weight", "distr_output.proj.weight"} <= names[0]
    assert {"l0_i2h_weight", "r1_h2h_bias"} <= names[1]


def test_timeseries_pipeline_matches_jax():
    from mxnet_tpu.data import timeseries as jts

    ds = {mod: mod.synthetic_dataset(np.random.RandomState(5), n_series=4,
                                     length=60, freq="H")
          for mod in (tts, jts)}
    for je, te in zip(ds[jts], ds[tts]):
        np.testing.assert_array_equal(te["target"], je["target"])
        assert te["start"] == je["start"] and te["item_id"] == je["item_id"]
    for freq in ("H", "D", "W", "M", "B", "min"):
        np.testing.assert_array_equal(tts.time_features(freq, 17, 30),
                                      jts.time_features(freq, 17, 30))
    np.testing.assert_array_equal(tts.age_feature(9), jts.age_feature(9))
    assert tts.mean_scale(np.zeros(4)) == jts.mean_scale(np.zeros(4))
    insts = []
    for mod in (tts, jts):
        sp = mod.InstanceSplitter(24, 12, freq="H", seed=3)
        train, test = mod.train_test_split(ds[mod], 12)
        insts.append((sp.training_instances(train, 5),
                      sp.prediction_instances(train),
                      [e["target"] for e in test]))
    (ttr, tpr, tte), (jtr, jpr, jte) = insts
    for t, j in ((ttr, jtr), (tpr, jpr)):
        assert set(t) == set(j)
        for k in t:
            np.testing.assert_array_equal(t[k], j[k])
    for t, j in zip(tte, jte):
        np.testing.assert_array_equal(t, j)
    samples = np.random.RandomState(6).rand(4, 10, 12).astype(np.float32)
    truth = np.random.RandomState(7).rand(4, 12).astype(np.float32)
    assert tts.quantile_loss(truth, samples) == \
        jts.quantile_loss(truth, samples)
    with pytest.raises(tmx.MXNetError, match="freq"):
        tts.ListDataset([{"target": [1.0]}], freq="X")


def test_trains_and_predicts_with_the_splitter():
    """The chip run's recipe at toy size on the CPU: covariate batches from
    the InstanceSplitter, Adam, a falling NLL, finite forecasts."""
    tmx.random.seed(0)
    net = tmx.models.deepar(CELLS, 2)
    net.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    ds = tts.synthetic_dataset(np.random.RandomState(0), n_series=4,
                               length=48)
    sp = tts.InstanceSplitter(12, 4, seed=0)
    trainer = tmx.gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 1e-2})
    inst = sp.training_instances(ds, 8)
    losses = []
    for _ in range(8):
        with tmx.autograd.record():
            loss = net(tmx.nd.array(inst["target"], ctx=tmx.cpu()),
                       tmx.nd.array(inst["covariates"], ctx=tmx.cpu()))
        loss.backward()
        trainer.step(8)
        losses.append(loss.asscalar())
    assert losses[-1] < losses[0]
    pred = sp.prediction_instances(ds)
    out = net.predict(torch.from_numpy(pred["target"]), prediction_length=4,
                      num_samples=5, covariates=pred["covariates"])
    assert out.shape == (4, 5, 4) and np.isfinite(out).all()
