"""The Module API of the PyTorch port (``module/``, ``model``, ``callback``,
``monitor``) against the JAX package, on the CPU.

The same symbol (the port's JSON loaded into the JAX package), the same
starting parameters (numpy from a seed, carried across with
``convert.symbol_params_from_numpy``) and the same batches go through both
packages' ``Module``/``BucketingModule``.  Tolerances: outputs, losses,
perplexities and parameters within 1e-5 absolute plus 1e-5 relative
(float32 on both sides, sums in other orders); a checkpoint moved between
the packages loads bit for bit.
"""
import logging
import random

import numpy as np
import pytest

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import convert

CPU = tmx.cpu()
TOL = dict(rtol=1e-5, atol=1e-5)


def _jmx():
    import mxnet_tpu as jmx

    return jmx


def _close(t, j):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), **TOL)


def _cnn(mx):
    S = mx.sym
    x = S.var("data")
    h = S.Convolution(x, kernel=(3, 3), num_filter=4, pad=(1, 1),
                      name="conv1")
    h = S.BatchNorm(h, fix_gamma=False, name="bn1")
    h = S.Activation(h, act_type="relu", name="relu1")
    h = S.Pooling(h, kernel=(2, 2), stride=(2, 2), pool_type="max",
                  name="pool1")
    h = S.FullyConnected(S.flatten(h), num_hidden=5, name="fc")
    return S.SoftmaxOutput(h, name="softmax")


def _start_params(sym, seed, **shapes):
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    rs = np.random.RandomState(seed)
    args = {n: (rs.randn(*s) * 0.3).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in shapes}
    aux = {n: (np.ones(s, np.float32) if "var" in n
               else np.zeros(s, np.float32))
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _images(n=12, seed=1):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, 3, 8, 8).astype(np.float32),
            rs.randint(0, 5, n).astype(np.float32))


def _ce(prob, label):
    return float(-np.log(prob[np.arange(len(label)),
                              label.astype(int)] + 1e-12).mean())


def _module_steps(mx, ctx, args, aux, steps=3, contexts=None):
    """``steps`` manual forward_backward/update steps of the thin CNN at
    batch 4 (SGD, momentum 0.9): each step's loss, then the parameters
    and a predict pass."""
    with ctx:
        x, y = _images()
        sym = _cnn(mx) if mx is tmx else mx.sym.fromjson(_cnn(tmx).tojson())
        mod = mx.mod.Module(sym, context=contexts or ctx)
        it = mx.io.NDArrayIter(x, y, batch_size=4)
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        conv = (lambda d: convert.symbol_params_from_numpy(d, ctx=ctx)[0]) \
            if mx is tmx else (lambda d: {k: mx.nd.array(v)
                                          for k, v in d.items()})
        mod.init_params(arg_params=conv(args), aux_params=conv(aux))
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.1, "momentum": 0.9})
        losses = []
        for step, batch in zip(range(steps), it):
            mod.forward_backward(batch)
            mod.update()
            losses.append(_ce(mod.get_outputs()[0].asnumpy(),
                              batch.label[0].asnumpy()))
        ap, xp = convert.symbol_params_to_numpy(*mod.get_params())
        pred = mod.predict(mx.io.NDArrayIter(x, y, batch_size=4)).asnumpy()
        return losses, ap, xp, pred


def test_module_steps_match_jax():
    jmx = _jmx()
    args, aux = _start_params(_cnn(tmx), 2, data=(4, 3, 8, 8),
                              softmax_label=(4,))
    t = _module_steps(tmx, CPU, args, aux)
    j = _module_steps(jmx, jmx.cpu(), args, aux)
    _close(t[0], j[0])
    for k in t[1]:
        _close(t[1][k], j[1][k])
    for k in t[2]:
        _close(t[2][k], j[2][k])
    _close(t[3], j[3])
    assert t[3].shape == (12, 5)


def test_multi_context_module_matches_jax_and_one_context():
    """``Module(context=[cpu(0), cpu(1)])``: each replica runs half the
    batch; the summed gradients update both copies."""
    jmx = _jmx()
    args, aux = _start_params(_cnn(tmx), 3, data=(4, 3, 8, 8),
                              softmax_label=(4,))
    t2 = _module_steps(tmx, CPU, args, aux,
                       contexts=[tmx.cpu(0), tmx.cpu(1)])
    j2 = _module_steps(jmx, jmx.cpu(), args, aux,
                       contexts=[jmx.cpu(0), jmx.cpu(1)])
    for k in t2[1]:
        _close(t2[1][k], j2[1][k])
    _close(t2[3], j2[3])
    # each replica's BatchNorm normalizes its half batch, so the numbers
    # differ from a one-context run's; the shapes do not
    t1 = _module_steps(tmx, CPU, args, aux)
    assert t1[3].shape == t2[3].shape
    assert not np.array_equal(t1[1]["conv1_weight"], t2[1]["conv1_weight"])


def test_fit_score_and_checkpoints_across_packages(tmp_path):
    """``fit`` with ``do_checkpoint``: the port's checkpoint loads in the
    JAX package (and the reverse) with the same arrays, and each package's
    ``Module.load`` of the other's files predicts what the writer does."""
    jmx = _jmx()
    x, y = _images()
    args, aux = _start_params(_cnn(tmx), 4, data=(4, 3, 8, 8),
                              softmax_label=(4,))
    results = {}
    for tag, mx, ctx in (("t", tmx, CPU), ("j", jmx, jmx.cpu())):
        with ctx:
            sym = _cnn(tmx) if mx is tmx else mx.sym.fromjson(
                _cnn(tmx).tojson())
            mod = mx.mod.Module(sym, context=ctx)
            conv = {k: mx.nd.array(v) for k, v in args.items()}
            convx = {k: mx.nd.array(v) for k, v in aux.items()}
            prefix = str(tmp_path / tag)
            mod.fit(mx.io.NDArrayIter(x, y, batch_size=4), num_epoch=2,
                    optimizer="sgd",
                    optimizer_params={"learning_rate": 0.05},
                    arg_params=conv, aux_params=convx,
                    eval_metric="acc",
                    epoch_end_callback=mx.callback.do_checkpoint(prefix),
                    batch_end_callback=mx.callback.Speedometer(4, 1))
            score = mod.score(mx.io.NDArrayIter(x, y, batch_size=4),
                              "ce")[0][1]
            pred = mod.predict(mx.io.NDArrayIter(x, y, batch_size=4))
            results[tag] = (score, pred.asnumpy())
    _close(results["t"][0], results["j"][0])
    _close(results["t"][1], results["j"][1])
    for writer, reader, rctx in (("t", jmx, jmx.cpu()), ("j", tmx, CPU)):
        prefix = str(tmp_path / writer)
        with rctx:
            sym, ap, xp = reader.model.load_checkpoint(prefix, 2)
            other = tmx if reader is jmx else jmx
            _, ap2, xp2 = other.model.load_checkpoint(prefix, 2)
            for k in ap:
                np.testing.assert_array_equal(ap[k].asnumpy(),
                                              ap2[k].asnumpy())
            mod = reader.mod.Module.load(prefix, 2, context=rctx)
            mod.bind(data_shapes=[("data", (4, 3, 8, 8))],
                     label_shapes=[("softmax_label", (4,))],
                     for_training=False)
            pred = mod.predict(reader.io.NDArrayIter(x, y, batch_size=4))
        _close(pred.asnumpy(), results[writer][1])


def _lm_sym_gen(mx, V=40, E=8, H=16, L=2):
    def sym_gen(seq_len):
        S = mx.sym
        data, label = S.var("data"), S.var("softmax_label")
        emb = S.Embedding(data, input_dim=V, output_dim=E, name="embed")
        x = S.swapaxes(emb, dim1=0, dim2=1)
        rnn = S.RNN(x, state_size=H, num_layers=L, mode="lstm", name="lstm")
        y = S.swapaxes(rnn, dim1=0, dim2=1)
        pred = S.FullyConnected(y, num_hidden=V, flatten=False, name="pred")
        pred = S.reshape(pred, shape=(-1, V))
        out = S.SoftmaxOutput(pred, S.reshape(label, shape=(-1,)),
                              name="softmax", use_ignore=True,
                              ignore_label=0)
        return out, ("data",), ("softmax_label",)

    return sym_gen


def _lm_run(mx, ctx, params, contexts=None, B=4, V=40):
    rs = np.random.RandomState(5)
    sents = [list(rs.randint(1, V, size=rs.randint(3, 11)))
             for _ in range(48)]
    with ctx:
        random.seed(7)
        it = mx.rnn.BucketSentenceIter(sents, B, buckets=[5, 10],
                                       invalid_label=0)
        mod = mx.mod.BucketingModule(
            _lm_sym_gen(mx), default_bucket_key=it.default_bucket_key,
            context=contexts or ctx,
            fixed_param_names=["lstm_state", "lstm_state_cell"])
        metric = mx.metric.Perplexity(0)
        keys = []
        mod.fit(it, eval_metric=metric, num_epoch=1, optimizer="sgd",
                optimizer_params={"learning_rate": 0.5, "momentum": 0.9},
                arg_params={k: mx.nd.array(v) for k, v in params.items()
                            if "state" not in k},
                allow_missing=True, initializer=mx.init.Zero(),
                batch_end_callback=lambda p: keys.append(
                    mod._curr_bucket_key))
        train = metric.get()[1]
        score = mod.score(it, mx.metric.Perplexity(0))[0][1]
        ap, _ = mod.get_params()
        return train, score, {k: v.asnumpy() for k, v in ap.items()}, keys


def _lm_params(B=4):
    sym = _lm_sym_gen(tmx)(10)[0]
    shapes = dict(data=(B, 10), softmax_label=(B, 10))
    arg_shapes = sym.infer_shape(**shapes)[0]
    rs = np.random.RandomState(6)
    return {n: rs.uniform(-0.1, 0.1, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in shapes and "state" not in n}


def test_bucketing_module_lstm_lm_matches_jax():
    """The LSTM LM through ``BucketingModule`` over buckets 10 and 5,
    parameters shared: training and scoring perplexity and the final
    parameters equal the JAX package's."""
    jmx = _jmx()
    params = _lm_params()
    t = _lm_run(tmx, CPU, params)
    j = _lm_run(jmx, jmx.cpu(), params)
    assert set(t[3]) == {5, 10} and t[3] == j[3]
    _close(t[0], j[0])
    _close(t[1], j[1])
    assert np.isfinite(t[0]) and t[1] < t[0] * 1.5
    for k in t[2]:
        _close(t[2][k], j[2][k])


def test_multi_context_bucketing_module_matches_jax():
    jmx = _jmx()
    params = _lm_params()
    t = _lm_run(tmx, CPU, params, contexts=[tmx.cpu(0), tmx.cpu(1)])
    j = _lm_run(jmx, jmx.cpu(), params, contexts=[jmx.cpu(0), jmx.cpu(1)])
    _close(t[0], j[0])
    _close(t[1], j[1])
    for k in t[2]:
        _close(t[2][k], j[2][k])


def test_callbacks_and_monitor(tmp_path, caplog, capsys):
    from mxnet_tpu_torch.checkpoint import CheckpointManager

    metric = tmx.metric.Accuracy()
    metric.update([tmx.nd.array(np.array([0., 1.]), ctx=CPU)],
                  [tmx.nd.array(np.eye(2, dtype=np.float32), ctx=CPU)])
    with caplog.at_level(logging.INFO):
        speed = tmx.callback.Speedometer(2, frequent=1)
        for i in range(3):
            speed(tmx.callback.BatchEndParam(0, i, metric))
        tmx.callback.log_train_metric(1)(
            tmx.callback.BatchEndParam(0, 1, metric))
    assert "samples/sec" in caplog.text and "Train-accuracy" in caplog.text
    bar = tmx.callback.ProgressBar(2, length=4)
    bar(tmx.callback.BatchEndParam(0, 1, None))
    assert "[####] 2/2" in capsys.readouterr().out
    sym = _cnn(tmx)
    args, aux = _start_params(sym, 8, data=(4, 3, 8, 8), softmax_label=(4,))
    nd_args = convert.symbol_params_from_numpy(args, ctx=CPU)[0]
    manager = CheckpointManager(str(tmp_path / "ckpt"))
    tmx.callback.do_checkpoint(manager)(0, sym, nd_args, {})
    assert manager.latest() == 1
    tmx.callback.do_checkpoint(str(tmp_path / "m"), period=2)(1, sym,
                                                               nd_args, {})
    assert (tmp_path / "m-0002.params").exists()

    net = tmx.gluon.nn.HybridSequential()
    net.add(tmx.gluon.nn.Dense(3, in_units=4), tmx.gluon.nn.Activation("relu"))
    net.initialize(ctx=CPU)
    mon = tmx.mon.Monitor(1, pattern=".*").install(net)
    mon.tic()
    net(tmx.nd.array(np.ones((2, 4), np.float32), ctx=CPU))
    stats = mon.toc()
    assert [name for _, name, _ in stats] == ["0_output0", "1_output0"]
    assert all(np.isfinite(v) for _, _, v in stats)


def test_feedforward_fit_predict_save_load(tmp_path):
    x, y = _images(8, seed=9)
    with CPU:
        ff = tmx.model.FeedForward(_cnn(tmx), ctx=CPU, num_epoch=1,
                                   numpy_batch_size=4, learning_rate=0.05)
        ff.fit(x, y)
        pred = ff.predict(x)
        assert pred.shape == (8, 5)
        ff.save(str(tmp_path / "ff"))
        back = tmx.model.FeedForward.load(str(tmp_path / "ff"), 1, ctx=CPU,
                                          numpy_batch_size=4)
        np.testing.assert_array_equal(back.predict(x), pred)


def test_fit_takes_a_monitor_and_fixed_params_stay():
    x, y = _images(8, seed=10)
    sym = _cnn(tmx)
    args, aux = _start_params(sym, 11, data=(4, 3, 8, 8), softmax_label=(4,))
    with CPU:
        mod = tmx.mod.Module(sym, context=CPU, fixed_param_names=["fc_bias"])
        mod.fit(tmx.io.NDArrayIter(x, y, batch_size=4), num_epoch=1,
                arg_params=convert.symbol_params_from_numpy(args)[0],
                aux_params=convert.symbol_params_from_numpy(aux)[0],
                monitor=tmx.mon.Monitor(1))
        ap, _ = mod.get_params()
    np.testing.assert_array_equal(ap["fc_bias"].asnumpy(), args["fc_bias"])
    assert not np.array_equal(ap["fc_weight"].asnumpy(), args["fc_weight"])
    assert mod.output_shapes == [("softmax_output", (4, 5))]
    with pytest.raises(tmx.base.MXNetError, match="must divide"):
        tmx.mod.Module(sym, context=[tmx.cpu(0), tmx.cpu(1)]).bind(
            data_shapes=[("data", (3, 3, 8, 8))],
            label_shapes=[("softmax_label", (3,))])
