"""BERT and ModelServer of the PyTorch port, on the CPU.

The JAX package's ``bert_tiny`` is built and run, its weights carried
across with ``load_numpy_params``, and the port's outputs compared with
it at float32 (2e-5 absolute: the two packages sum in different orders
through two encoder layers).  The port's ``ModelServer`` then serves a
mix of request lengths on ``mx.cpu()``.
"""
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx

VOCAB = 1000


def _jax_bert(**kwargs):
    import mxnet_tpu as jmx
    from mxnet_tpu.models.bert import bert_tiny

    jmx.random.seed(11)
    net = bert_tiny(vocab_size=VOCAB, **kwargs)
    net.initialize()
    return net


def _inputs(b=3, s=24, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, VOCAB, size=(b, s)).astype(np.int32)
    valid = np.array([s, 10, 1][:b], np.float32)
    return ids, np.zeros((b, s), np.int32), valid


def _port_copy(jnet, **kwargs):
    tnet = tmx.models.bert_tiny(vocab_size=VOCAB, **kwargs)
    tnet.initialize(ctx=tmx.cpu())
    tmx.load_numpy_params(tnet, {
        k: p.data().asnumpy()
        for k, p in jnet._collect_params_with_prefix().items()})
    return tnet


def test_bert_backbone_matches_jax():
    import mxnet_tpu as jmx

    ids, types, valid = _inputs()
    jnet = _jax_bert(use_decoder=False, use_classifier=False)
    jseq, jpool = jnet(jmx.nd.array(ids, dtype="int32"),
                       jmx.nd.array(types, dtype="int32"),
                       jmx.nd.array(valid))
    tnet = _port_copy(jnet, use_decoder=False, use_classifier=False)
    cpu = tmx.cpu()
    tseq, tpool = tnet(tmx.nd.array(ids, ctx=cpu),
                       tmx.nd.array(types, ctx=cpu),
                       tmx.nd.array(valid, ctx=cpu))
    np.testing.assert_allclose(tseq.asnumpy(), jseq.asnumpy(), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(tpool.asnumpy(), jpool.asnumpy(), atol=2e-5,
                               rtol=0)


def test_bert_pretraining_heads_match_jax():
    """MLM decoder over gathered masked positions (the take path) and
    the NSP classifier."""
    import mxnet_tpu as jmx

    ids, types, valid = _inputs(b=2, s=16)
    pos = np.array([[0, 3, 15], [1, 2, 9]], np.int32)
    jnet = _jax_bert()
    jmlm, jnsp = jnet(jmx.nd.array(ids, dtype="int32"),
                      jmx.nd.array(types, dtype="int32"),
                      jmx.nd.array(valid), jmx.nd.array(pos, dtype="int32"))
    tnet = _port_copy(jnet)
    cpu = tmx.cpu()
    tmlm, tnsp = tnet(tmx.nd.array(ids, ctx=cpu),
                      tmx.nd.array(types, ctx=cpu),
                      tmx.nd.array(valid, ctx=cpu),
                      tmx.nd.array(pos, ctx=cpu))
    assert tmlm.shape == (2, 3, VOCAB)
    np.testing.assert_allclose(tmlm.asnumpy(), jmlm.asnumpy(), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(tnsp.asnumpy(), jnsp.asnumpy(), atol=2e-5,
                               rtol=0)


class _Serving(tmx.gluon.HybridBlock):
    """Token ids (B, S) -> (sequence, pooled); id 0 is padding."""

    def __init__(self, bert, **kwargs):
        super().__init__(**kwargs)
        self.bert = bert

    def hybrid_forward(self, F, ids):
        valid = (ids != 0).sum(dim=1).to(torch.float32)
        return self.bert(ids, torch.zeros_like(ids), valid)


def test_model_server_serves_mixed_lengths_on_cpu():
    tmx.random.seed(3)
    bert = tmx.models.bert_tiny(vocab_size=VOCAB, use_decoder=False,
                                use_classifier=False)
    bert.initialize(ctx=tmx.cpu())
    net = _Serving(bert)
    spec = tmx.serve.BucketSpec(batch_sizes=(1, 2, 4), example_shape=(None,),
                                lengths=(16, 32), dtype="int32")
    rng = np.random.RandomState(4)
    reqs = [rng.randint(1, VOCAB, size=int(n)).astype(np.int32)
            for n in rng.randint(1, 33, size=12)]
    results = [None] * len(reqs)
    server = tmx.serve.ModelServer(net, spec, ctx=tmx.cpu(), linger_ms=5.0)
    server.start()
    try:
        def client(idx):
            for i in idx:
                results[i] = server.submit(reqs[i]).result(timeout=60)

        threads = [threading.Thread(target=client, args=(range(c, 12, 3),))
                   for c in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        server.shutdown(drain=True, timeout=60)
    st = server.stats()
    assert st["served"] == len(reqs) and st["failed"] == 0
    assert st["warmup_batches"] == 6
    assert st["graph"]["post_warmup_compiles"] == 0
    assert st["graph"]["compiles"] == 6
    assert st["submitted"] == (st["served"] + st["expired_deadline"]
                               + st["failed"] + st["cancelled"]
                               + st["queue_depth"] + st["in_flight"])
    for ex, (seq, pooled) in zip(reqs, results):
        dseq, dpool = net(tmx.nd.array(ex[None], ctx=tmx.cpu()))
        assert seq.shape == (len(ex), 64) and pooled.shape == (64,)
        np.testing.assert_allclose(seq, dseq.asnumpy()[0], atol=1e-5)
        np.testing.assert_allclose(pooled, dpool.asnumpy()[0], atol=1e-5)


def test_model_server_rejects_after_shutdown():
    net = tmx.gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=tmx.cpu())
    spec = tmx.serve.BucketSpec(batch_sizes=(1, 2), example_shape=(3,))
    with tmx.serve.ModelServer(net, spec, ctx=tmx.cpu()) as server:
        out = server.predict(np.ones(3, np.float32), timeout=30)
        assert out.shape == (2,)
    with pytest.raises(tmx.serve.ServerClosedError):
        server.submit(np.ones(3, np.float32))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernel has no CPU "
                    "mode); run on the GPU machine with -m gpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_bert_on_the_card_matches_the_cpu(cuda_device):
    """The same weights on the card (flash kernel, TF32 off) and on the
    CPU (plain attention): float32 within 1e-4; one kernel launch per
    encoder layer.  Two layers of 128 units in 2 heads of 64: bert_tiny's
    heads of 16 are not a multiple of 64 and go to the oracle."""
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa

    def small_bert():
        return tmx.models.BERTModel(VOCAB, 128, 256, 2, 2, max_length=128,
                                    use_decoder=False, use_classifier=False)

    ids, types, valid = _inputs(b=3, s=40)
    tmx.random.seed(5)
    cpu_net = small_bert()
    cpu_net.initialize(ctx=tmx.cpu())
    cpu_out = cpu_net(*(tmx.nd.array(a, ctx=tmx.cpu())
                        for a in (ids, types, valid)))
    gpu_net = small_bert()
    gpu_net.initialize(ctx=tmx.gpu(0))
    tmx.load_numpy_params(gpu_net, {
        k: p.data().detach().numpy()
        for k, p in cpu_net._collect_params_with_prefix().items()})
    before = (fa.counts.launches, fa.counts.plain_calls_on_cuda)
    gpu_out = gpu_net(*(tmx.nd.array(a, ctx=tmx.gpu(0))
                        for a in (ids, types, valid)))
    assert (fa.counts.launches, fa.counts.plain_calls_on_cuda) == \
        (before[0] + 2, before[1])
    for g, c in zip(gpu_out, cpu_out):
        np.testing.assert_allclose(g.asnumpy(), c.asnumpy(), atol=1e-4)
