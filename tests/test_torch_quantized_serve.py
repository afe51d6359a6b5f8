"""Int8 serving in the PyTorch port, on the CPU: quantized nets behind
``ModelServer`` and ``DecodeServer`` (after ``tests/test_quantized_serve.py``).

A ``quantize_net`` output serves through the bucket grid with no new
signature after warm-up, books its batches into the ``quantize`` profiler
section, checkpoints through ``CheckpointManager`` and reloads both
int8-native and float32 checkpoints (re-quantized against its stored
scales) with ``reload_weights()``.  With the JAX package's int8 model
carried across (``load_numpy_params``), the port serves the same answers:
within 1e-6 through ``ModelServer`` and token for token through
``DecodeServer``.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import _imperative, serve
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.checkpoint import CheckpointManager
from mxnet_tpu_torch.contrib import quantization as qz
from mxnet_tpu_torch.gluon import nn

FEAT = 32
CPU = tmx.cpu()


def _mlp(seed=0):
    tmx.random.seed(seed)
    net = nn.HybridSequential()
    net.add(nn.Dense(64, activation="relu", in_units=FEAT, flatten=False),
            nn.Dense(64, activation="relu", in_units=64, flatten=False),
            nn.Dense(10, in_units=64, flatten=False))
    net.initialize(tmx.init.Xavier(), ctx=CPU)
    return net


def _quantized(seed=0, rs_seed=0):
    calib = np.random.RandomState(rs_seed).randn(128, FEAT) \
        .astype(np.float32)
    with CPU:
        return qz.quantize_net(_mlp(seed), calib_data=calib), calib


def _spec():
    return serve.BucketSpec(batch_sizes=(1, 2, 4), example_shape=(FEAT,))


def _served(srv, xs):
    futs = [srv.submit(x) for x in xs]
    return np.stack([f.result(timeout=120) for f in futs])


def _host_params(net):
    out = {}
    for k, p in net._collect_params_with_prefix().items():
        v = p.data()
        out[k] = np.array(v.asnumpy() if hasattr(v, "asnumpy")
                          else v.detach().numpy())
    return out


def test_int8_modelserver_matches_jax():
    """The JAX package's int8 MLP, carried across, served by both
    packages' ModelServer: the same answers within 1e-6."""
    import mxnet_tpu as jmx
    from mxnet_tpu import serve as jserve
    from mxnet_tpu.contrib import quantization as jqz
    from mxnet_tpu.gluon import nn as jnn

    jmx.random.seed(3)
    jnet = jnn.HybridSequential()
    jnet.add(jnn.Dense(64, activation="relu", in_units=FEAT, flatten=False),
             jnn.Dense(64, activation="relu", in_units=64, flatten=False),
             jnn.Dense(10, in_units=64, flatten=False))
    jnet.initialize(jmx.init.Xavier())
    calib = np.random.RandomState(1).randn(64, FEAT).astype(np.float32)
    jqz.quantize_net(jnet, calib_data=calib, calib_mode="naive")
    tnet, _ = _quantized(seed=4)
    tmx.load_numpy_params(tnet, _host_params(jnet))
    xs = list(np.random.RandomState(2).randn(9, FEAT).astype(np.float32))
    jsrv = jserve.ModelServer(jnet, jserve.BucketSpec(
        batch_sizes=(1, 2, 4), example_shape=(FEAT,)), max_queue=32)
    with jsrv:
        want = _served(jsrv, xs)
    with serve.ModelServer(tnet, _spec(), max_queue=32, ctx=CPU) as srv:
        got = _served(srv, xs)
        assert srv.stats()["graph"]["post_warmup_compiles"] == 0
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_int8_modelserver_no_new_signature_and_direct_forward():
    qnet, _ = _quantized()
    rs = np.random.RandomState(1)
    xs = [rs.randn(FEAT).astype(np.float32) for _ in range(30)]
    with serve.ModelServer(qnet, _spec(), max_queue=64, linger_ms=1.0,
                           ctx=CPU) as srv:
        res = _served(srv, xs)
        srv.drain()
        s = srv.stats()
    assert s["graph"]["post_warmup_compiles"] == 0
    assert s["served"] == s["submitted"] == 30
    direct = qnet(tmx.nd.array(np.stack(xs[:4]), ctx=CPU)).asnumpy()
    np.testing.assert_allclose(res[:4], direct, atol=1e-6, rtol=0)


def test_int8_modelserver_restart_no_new_signature():
    qnet, _ = _quantized(seed=5)
    srv = serve.ModelServer(qnet, serve.BucketSpec(
        batch_sizes=(1, 2), example_shape=(FEAT,)), max_queue=16, ctx=CPU)
    srv.start()
    srv.submit(np.zeros(FEAT, np.float32)).result(timeout=60)
    srv.drain()
    c0 = srv.stats()["graph"]["compiles"]
    srv.start()
    srv.submit(np.zeros(FEAT, np.float32)).result(timeout=60)
    srv.drain()
    assert srv.stats()["graph"]["compiles"] == c0
    srv.shutdown()


def test_int8_reload_requantizes_a_float32_checkpoint(tmp_path):
    """A float32 training checkpoint reloads into the int8 server by
    re-quantization against the stored scales, in place: the served
    answers move to the new weights, every Parameter keeps its tensor."""
    rs = np.random.RandomState(2)
    fp32 = _mlp(seed=7)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, params=fp32, sync=True)
    qnet, _ = _quantized(seed=7, rs_seed=2)
    tensors = [p.data() for p in qnet.collect_params().values()]
    x = rs.randn(4, FEAT).astype(np.float32)
    with serve.ModelServer(qnet, _spec(), checkpoint=mgr, max_queue=16,
                           ctx=CPU) as srv:
        y1 = _served(srv, list(x))
        for p in fp32.collect_params().values():
            p.set_data(p.data() * 0.9)
        mgr.save(2, params=fp32, sync=True)
        assert srv.reload_weights() == {"step": 2, "epoch": None}
        y2 = _served(srv, list(x))
        s = srv.stats()
    assert not np.array_equal(y1, y2)
    ref2 = fp32(tmx.nd.array(x, ctx=CPU)).asnumpy()
    assert (y2.argmax(1) == ref2.argmax(1)).all()
    assert s["graph"]["post_warmup_compiles"] == 0 and s["reloads"] == 1
    assert all(p.data() is t for p, t in
               zip(qnet.collect_params().values(), tensors))


def test_int8_reload_from_an_int8_native_checkpoint(tmp_path):
    rs = np.random.RandomState(4)
    qnet, calib = _quantized(seed=11, rs_seed=4)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, params=qnet, sync=True)
    with CPU:
        srv_net = qz.quantize_net(_mlp(seed=12), calib_data=calib)
    x = rs.randn(FEAT).astype(np.float32)
    with serve.ModelServer(srv_net, serve.BucketSpec(
            batch_sizes=(1, 2), example_shape=(FEAT,)), checkpoint=mgr,
            max_queue=16, ctx=CPU) as srv:
        srv.reload_weights()
        got = srv.submit(x).result(timeout=60)
    want = qnet(tmx.nd.array(x[None], ctx=CPU)).asnumpy()[0]
    np.testing.assert_array_equal(got, want)


def test_int8_checkpoint_roundtrip_via_manager(tmp_path):
    rs = np.random.RandomState(3)
    qnet, calib = _quantized(seed=9, rs_seed=3)
    x = tmx.nd.array(rs.randn(8, FEAT).astype(np.float32), ctx=CPU)
    ref = qnet(x).asnumpy()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, params=qnet, sync=True)
    with CPU:
        twin = qz.quantize_net(_mlp(seed=77), calib_data=calib * 0.5)
    assert not np.array_equal(twin(x).asnumpy(), ref)
    mgr.restore(step=5, params=twin)
    np.testing.assert_array_equal(twin(x).asnumpy(), ref)
    assert twin._layers[0].qweight.data().dtype == torch.int8


def test_reload_without_a_manager_raises():
    qnet, _ = _quantized(seed=13)
    with pytest.raises(MXNetError, match="checkpoint="):
        serve.ModelServer(qnet, _spec(), ctx=CPU).reload_weights()


def test_int8_serve_batches_counted_in_quantize_section():
    qnet, _ = _quantized(seed=15)
    qz.reset_quantize_stats()
    with serve.ModelServer(qnet, serve.BucketSpec(
            batch_sizes=(1, 2), example_shape=(FEAT,)), max_queue=16,
            ctx=CPU) as srv:
        for _ in range(3):
            srv.submit(np.zeros(FEAT, np.float32)).result(timeout=60)
        srv.drain()
        s = srv.stats()
    assert qz.quantize_stats()["int8_serve_batches"] == s["batches"] > 0
    assert tmx.profiler.sections()["quantize"]["int8_serve_batches"] \
        == s["batches"]
    tmx.profiler.sections(reset=True)
    assert qz.quantize_stats()["int8_serve_batches"] == 0


def test_float32_server_books_no_quantize_batches():
    qz.reset_quantize_stats()
    with serve.ModelServer(_mlp(seed=23), serve.BucketSpec(
            batch_sizes=(1, 2), example_shape=(FEAT,)), max_queue=16,
            ctx=CPU) as srv:
        srv.submit(np.zeros(FEAT, np.float32)).result(timeout=60)
    assert qz.quantize_stats()["int8_serve_batches"] == 0


def test_calibration_device_partials_are_bounded():
    st = qz._Stats("entropy")
    old = qz._Stats.DRAIN_EVERY
    qz._Stats.DRAIN_EVERY = 4
    try:
        rs = np.random.RandomState(0)
        for _ in range(10):
            st.update_nd(torch.from_numpy(rs.randn(32).astype(np.float32)))
            assert len(st._dev) < 4
        lo, hi = st.range()
    finally:
        qz._Stats.DRAIN_EVERY = old
    assert lo < 0 < hi


# -- the int8 decode path -----------------------------------------------------


def _calib_forward(m, x):
    b, length = x.shape
    m.prefill(x.data, torch.full((b,), length, dtype=torch.int32))


def _decode_model(quantize=True, seed=0):
    tmx.random.seed(seed)
    model = serve.TinyDecoder(vocab=64, embed=16, proj_block=True)
    model.initialize(tmx.init.Xavier(), ctx=CPU)
    if quantize:
        calib = np.random.RandomState(0).randint(0, 64, size=(16, 8)) \
            .astype(np.int32)
        with CPU:
            qz.quantize_net(model, calib_data=calib,
                            calib_forward=_calib_forward)
        assert type(model._children["proj"]).__name__ == "QuantizedDense"
    return model


def _decode_spec(lengths=(4, 8)):
    return serve.BucketSpec(batch_sizes=(1, 2, 4), example_shape=(None,),
                            lengths=lengths, dtype="int32")


def _decode(model, prompts, budgets, **kw):
    srv = serve.DecodeServer(model, kw.pop("spec", _decode_spec()),
                             max_slots=4, max_len=32, max_queue=64,
                             ctx=CPU, **kw)
    srv.start()
    try:
        hs = [srv.submit(p, max_new_tokens=b)
              for p, b in zip(prompts, budgets)]
        out = [h.result(timeout=120) for h in hs]
        srv.drain()
        return out, srv.stats()
    finally:
        srv.shutdown()


def _decode_traffic(seed, n=12, lo=1, hi=8):
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, 64, size=int(rng.randint(2, 9)))
               .astype(np.int32) for _ in range(n)]
    return prompts, [int(rng.randint(lo, hi)) for _ in range(n)]


def test_int8_decode_matches_jax_token_for_token():
    """The JAX package's int8 TinyDecoder (projection quantized and
    calibrated) carried across: the same tokens from both packages'
    DecodeServer."""
    import mxnet_tpu as jmx
    from mxnet_tpu import nd as jnd
    from mxnet_tpu import serve as jserve
    from mxnet_tpu.contrib import quantization as jqz

    jmx.random.seed(0)
    jm = jserve.TinyDecoder(vocab=64, embed=16, proj_block=True)
    jm.initialize(jmx.init.Xavier())
    calib = np.random.RandomState(0).randint(0, 64, size=(16, 8)) \
        .astype(np.int32)

    def jfwd(m, x):
        b, length = x.shape
        m.prefill(x, jnd.array(np.full(b, length, np.int32)))

    jqz.quantize_net(jm, calib_data=calib, calib_mode="naive",
                     calib_forward=jfwd)
    tm = _decode_model(seed=5)
    tmx.load_numpy_params(tm, _host_params(jm))
    prompts, budgets = _decode_traffic(8, n=10, hi=10)
    jsrv = jserve.DecodeServer(jm, jserve.BucketSpec(
        batch_sizes=(1, 2, 4), example_shape=(None,), lengths=(4, 8),
        dtype="int32"), max_slots=4, max_len=32, max_queue=64)
    with jsrv:
        want = [h.result(timeout=120) for h in
                [jsrv.submit(p, max_new_tokens=b)
                 for p, b in zip(prompts, budgets)]]
    got, _ = _decode(tm, prompts, budgets)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_int8_decode_no_new_signature_one_dispatch_a_step():
    model = _decode_model()
    prompts, budgets = _decode_traffic(0, n=20, hi=10)
    d0 = _imperative.device_dispatch_count()
    _, s = _decode(model, prompts, budgets)
    d1 = _imperative.device_dispatch_count()
    assert s["graph"]["post_warmup_compiles"] == 0
    assert d1 - d0 - (s["graph"]["compiles"] + s["graph"]["reuses"]) == 0
    assert s["served"] == s["submitted"] == 20


def test_int8_decode_continuous_matches_whole_batch():
    prompts, budgets = _decode_traffic(7)
    cont, _ = _decode(_decode_model(), prompts, budgets)
    whole, _ = _decode(_decode_model(), prompts, budgets,
                       admission="batch")
    for a, b in zip(cont, whole):
        np.testing.assert_array_equal(a, b)


def test_int8_decode_books_steps_and_groups():
    model = _decode_model()
    prompts, budgets = _decode_traffic(9, n=6)
    qz.reset_quantize_stats()
    _, s = _decode(model, prompts, budgets)
    assert qz.quantize_stats()["int8_serve_batches"] == \
        s["batches"] + s["decode_steps"]


def test_decode_server_rejects_uncalibrated_quantized_model():
    model = _decode_model(quantize=False)
    with CPU:
        qz.quantize_net(model)   # dynamic ranges
    with pytest.raises(MXNetError, match="CALIBRATED"):
        serve.DecodeServer(model, _decode_spec(lengths=(4,)), max_slots=2,
                           max_len=16, ctx=CPU)


def test_int8_decode_reload_float32_checkpoint(tmp_path):
    """A float32 TinyDecoder checkpoint reloads into the int8 decode
    server between tokens: the next sequences are the int8 model of the
    new weights, with no new signature."""
    fp32 = _decode_model(quantize=False, seed=21)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, params=fp32, sync=True)
    model = _decode_model(seed=0)
    prompts, budgets = _decode_traffic(10, n=6)
    srv = serve.DecodeServer(model, _decode_spec(), max_slots=4, max_len=32,
                             ctx=CPU, checkpoint=mgr)
    with srv:
        before = [srv.generate(p, max_new_tokens=b, timeout=60)
                  for p, b in zip(prompts, budgets)]
        assert srv.reload_weights()["step"] == 3
        after = [srv.generate(p, max_new_tokens=b, timeout=60)
                 for p, b in zip(prompts, budgets)]
        s = srv.stats()
    assert s["graph"]["post_warmup_compiles"] == 0 and s["reloads"] == 1
    twin = _decode_model(seed=0)
    qz.apply_fp32_params(twin, {k: p.data() for k, p in
                                fp32._collect_params_with_prefix().items()})
    want, _ = _decode(twin, prompts, budgets)
    assert any(not np.array_equal(a, b) for a, b in zip(before, after))
    for a, w in zip(after, want):
        np.testing.assert_array_equal(a, w)


# -- on the card --------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs and cuBLAS's int8 "
                    "product); run on the GPU machine with -m gpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _bert_serving(bert):
    class BertServing(tmx.gluon.HybridBlock):
        """Token ids (B, S) -> (MLM logits, NSP logits); id 0 pads."""

        def __init__(self, bert, **kwargs):
            super().__init__(**kwargs)
            self.bert = bert

        def hybrid_forward(self, F, ids):
            valid = (ids != 0).sum(dim=1).to(torch.float32)
            return self.bert(ids, torch.zeros_like(ids), valid)

    return BertServing(bert)


@pytest.mark.gpu
def test_int8_bert_base_reload_without_new_capture(cuda_device, tmp_path):
    """BERT-base (30522 words) quantized on the card and served on
    captured buckets; a float32 checkpoint of other weights reloads by
    re-quantization with no new capture, and the replays read it (the
    served block is the one ``quantize_net`` marks int8)."""
    gpu = tmx.gpu(0)
    rs = np.random.RandomState(0)
    calib = [rs.randint(1, 30522, size=(4, 64)).astype(np.int32)
             for _ in range(2)]

    def serving(seed, quantize):
        tmx.random.seed(seed)
        bert = tmx.models.bert_base(vocab_size=30522)
        bert.initialize(tmx.init.Normal(0.02), ctx=gpu)
        net = _bert_serving(bert)
        if quantize:
            with gpu:
                qz.quantize_net(net, calib_data=calib)
        else:
            net(tmx.nd.array(calib[0], ctx=gpu))   # deferred shapes
        return net

    net = serving(1, True)
    assert len(dict(qz._iter_quantized(net))) == 28
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, params=serving(2, False), sync=True)
    spec = serve.BucketSpec(batch_sizes=(1, 4), example_shape=(None,),
                            lengths=(128,), dtype="int32")
    reqs = [rs.randint(1, 30522, size=n).astype(np.int32)
            for n in (20, 128, 77, 5)]
    with serve.ModelServer(net, spec, checkpoint=mgr, ctx=gpu) as srv:
        before = [srv.predict(r, timeout=300) for r in reqs]
        c0 = _imperative.graph_capture_count()
        srv.reload_weights()
        after = [srv.predict(r, timeout=300) for r in reqs]
        assert _imperative.graph_capture_count() == c0
        s = srv.stats()
    assert s["graph"]["post_warmup_compiles"] == 0 and s["reloads"] == 1
    for b, a in zip(before, after):
        assert np.isfinite(a[0]).all() and not np.array_equal(a[0], b[0])
    eager = _bert_serving(net.bert)    # not hybridized: the eager forward
    x = tmx.nd.array(reqs[1][None], ctx=gpu)
    np.testing.assert_array_equal(eager(x)[0].asnumpy()[0], after[1][0])
