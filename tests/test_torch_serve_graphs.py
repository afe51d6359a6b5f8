"""Each serve bucket as a captured graph (``gluon.block.CachedOp``,
``serve.ModelServer``), and weights reloaded under a running server.

On the card a hybridized block's forward in predict mode, outside
``autograd.record``, runs eagerly at its first call of an input
signature, is captured at the second and replayed after; everywhere else
it runs eagerly.  The CPU tests hold the eager paths, the counters and a
server that reloads its weights from a JAX package file (the served
responses equal the JAX block's forward with those weights within 2e-5,
``tests/test_torch_bert_serve.py``'s limit).  The ``gpu``-marked tests
hold every replay to the eager forward of the same input bit for bit:
run them on the GPU machine with
``python -m pytest -m gpu --noconftest tests/test_torch_serve_graphs.py``.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import _imperative

VOCAB = 1000


class _Serving(tmx.gluon.HybridBlock):
    """Token ids (B, S) -> (sequence, pooled); id 0 is padding."""

    def __init__(self, bert, **kwargs):
        super().__init__(**kwargs)
        self.bert = bert

    def hybrid_forward(self, F, ids):
        valid = (ids != 0).sum(dim=1).to(torch.float32)
        return self.bert(ids, torch.zeros_like(ids), valid)


def _ids(b, s, seed, dead_row=True):
    """Token ids with ragged lengths; with ``dead_row`` the last row is
    all padding (a bucket's padding row)."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, VOCAB, size=(b, s)).astype(np.int32)
    for r, n in enumerate(rng.randint(1, s + 1, size=b)):
        ids[r, n:] = 0
    if dead_row and b > 1:
        ids[-1] = 0
    return ids


# -- on the CPU --------------------------------------------------------------------


def test_hybridized_block_runs_eagerly_on_cpu_and_counts_signatures():
    net = tmx.gluon.nn.Dense(3, in_units=4)
    net.initialize(ctx=tmx.cpu())
    net.hybridize(static_alloc=True, static_shape=True)
    c0 = _imperative.graph_capture_count()
    x = np.ones((2, 4), np.float32)
    outs = [net(tmx.nd.array(x, ctx=tmx.cpu())).asnumpy() for _ in range(3)]
    net(tmx.nd.array(np.ones((5, 4), np.float32), ctx=tmx.cpu()))
    with tmx.autograd.record():
        net(tmx.nd.array(x, ctx=tmx.cpu()))
    op = net._cached_op
    assert op.stats == {"compiles": 3, "reuses": 2}
    assert op._graphs == {} and not op._warm
    assert _imperative.graph_capture_count() == c0
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])


def test_server_serves_weights_reloaded_from_a_jax_file_on_cpu(tmp_path):
    """A running server whose block loads a JAX-written ``.params`` file
    answers the next requests with the JAX block's forward."""
    import mxnet_tpu as jmx
    from mxnet_tpu.models.bert import bert_tiny as jbert_tiny

    kw = dict(vocab_size=VOCAB, use_decoder=False, use_classifier=False)
    jmx.random.seed(11)
    jbert = jbert_tiny(**kw)
    jbert.initialize()
    ids = _ids(1, 16, 3, dead_row=False)
    valid = float((ids != 0).sum())
    jseq, jpool = jbert(jmx.nd.array(ids, dtype="int32"),
                        jmx.nd.array(np.zeros_like(ids), dtype="int32"),
                        jmx.nd.array([valid]))

    class JServing(jmx.gluon.HybridBlock):
        def __init__(self, bert):
            super().__init__()
            self.bert = bert

    f = str(tmp_path / "bert.params")
    JServing(jbert).save_parameters(f)   # names "bert.<structural name>"
    tmx.random.seed(2)
    bert = tmx.models.bert_tiny(**kw)
    bert.initialize(ctx=tmx.cpu())
    net = _Serving(bert)
    spec = tmx.serve.BucketSpec(batch_sizes=(1, 2), example_shape=(None,),
                                lengths=(16, 32), dtype="int32")
    server = tmx.serve.ModelServer(net, spec, ctx=tmx.cpu())
    server.start()
    try:
        req = ids[0][ids[0] != 0]
        before = server.predict(req, timeout=60)
        net.load_parameters(f)
        seq, pooled = server.predict(req, timeout=60)
    finally:
        server.shutdown(drain=True, timeout=60)
    n = len(req)
    assert not np.allclose(before[1], pooled)
    np.testing.assert_allclose(seq, jseq.asnumpy()[0][:n], atol=2e-5, rtol=0)
    np.testing.assert_allclose(pooled, jpool.asnumpy()[0], atol=2e-5, rtol=0)
    assert server.stats()["graph"]["post_warmup_compiles"] == 0


# -- on the card -------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph and the kernels have "
                    "no CPU mode); run on the GPU machine with -m gpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


BUCKETS = [(1, 128), (2, 128), (4, 128), (1, 256), (2, 256), (4, 256)]


def _card_nets(seed=5):
    """The served block (hybridized) and an eager twin over the same BERT
    (2 layers of 128 units in 2 heads of 64: the flash kernels' head)."""
    tmx.random.seed(seed)
    bert = tmx.models.BERTModel(VOCAB, 128, 256, 2, 2, max_length=256,
                                use_decoder=False, use_classifier=False)
    bert.initialize(tmx.init.Normal(0.02), ctx=tmx.gpu(0))
    net = _Serving(bert)
    net.hybridize()
    return net, _Serving(bert)


def _run(net, ids):
    return [o.data.clone() for o in net(tmx.nd.array(ids, ctx=tmx.gpu(0)))]


def _equal(a, b):
    return all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.gpu
def test_each_bucket_replay_equals_eager_on_card(cuda_device):
    """Per bucket: the first call is the warm-up, the second captures, a
    third with other ids (a dead padding row among them) replays; every
    output equals the eager forward of the same ids bit for bit, and each
    replay counts the flash forward's launches."""
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa

    net, eager = _card_nets()
    c0 = _imperative.graph_capture_count()
    for k, (b, s) in enumerate(BUCKETS):
        for j in range(2):
            ids = _ids(b, s, 10 * k + j)
            assert _equal(_run(net, ids), _run(eager, ids)), (b, s, j)
        ids = _ids(b, s, 10 * k + 7)
        r0, l0 = _imperative.graph_replay_count(), fa.counts.launches
        got = _run(net, ids)
        assert _imperative.graph_replay_count() == r0 + 1
        assert fa.counts.launches == l0 + 2
        assert _equal(got, _run(eager, ids)), (b, s)
    assert _imperative.graph_capture_count() - c0 == len(BUCKETS)
    assert net._cached_op.stats == {"compiles": len(BUCKETS),
                                    "reuses": 2 * len(BUCKETS)}


@pytest.mark.gpu
def test_a_response_survives_the_next_batch_on_card(cuda_device):
    """The graphs share one memory pool, so a replay may write where
    another bucket's outputs live: what a call returns is a copy."""
    net, eager = _card_nets()
    for b, s in ((2, 128), (4, 256)):
        for j in range(2):
            _run(net, _ids(b, s, j))
    x1 = _ids(2, 128, 20)
    out1 = [o for o in net(tmx.nd.array(x1, ctx=tmx.gpu(0)))]
    for seed in (21, 22):
        _run(net, _ids(4, 256, seed))
        _run(net, _ids(2, 128, seed))
    assert _equal([o.data for o in out1], _run(eager, x1))


@pytest.mark.gpu
def test_load_parameters_is_seen_by_replays_on_card(cuda_device, tmp_path):
    net, eager = _card_nets()
    ids = _ids(4, 128, 30)
    for _ in range(2):
        _run(net, ids)
    other, _ = _card_nets(seed=9)
    _run(other, ids)   # completes its deferred shapes
    f = str(tmp_path / "other.params")
    other.save_parameters(f)
    c0 = _imperative.graph_capture_count()
    before = _run(net, ids)
    net.load_parameters(f)
    after = _run(net, ids)
    assert _imperative.graph_capture_count() == c0
    assert not _equal(before, after)
    assert _equal(after, _run(eager, ids))
    assert _equal(after, _run(other, ids))


@pytest.mark.gpu
def test_a_replaced_parameter_value_is_captured_again_on_card(cuda_device):
    """``initialize(force_reinit=True)`` makes new values rather than
    writing in place: the next call captures again and reads them."""
    net, eager = _card_nets()
    ids = _ids(2, 128, 50)
    for _ in range(2):
        _run(net, ids)
    c0 = _imperative.graph_capture_count()
    tmx.random.seed(8)
    net.initialize(tmx.init.Normal(0.02), ctx=tmx.gpu(0), force_reinit=True)
    got = _run(net, ids)
    assert _imperative.graph_capture_count() == c0 + 1
    assert _equal(got, _run(eager, ids))


@pytest.mark.gpu
def test_training_and_recording_calls_are_not_captured_on_card(cuda_device):
    net, eager = _card_nets()
    ids = _ids(2, 128, 40)
    c0 = _imperative.graph_capture_count()
    for _ in range(3):
        with tmx.autograd.record():
            _run(net, ids)
        with tmx.autograd.train_mode():
            _run(net, ids)
    assert _imperative.graph_capture_count() == c0


@pytest.mark.gpu
def test_model_server_runs_captured_buckets_on_card(cuda_device):
    """``start()`` captures every bucket; each batch is one replay, and
    every response equals the eager forward of its padded batch bit for
    bit."""
    import threading

    net, eager = _card_nets()
    spec = tmx.serve.BucketSpec(batch_sizes=(1, 2, 4), example_shape=(None,),
                                lengths=(128, 256), dtype="int32")
    batches = []
    pad = spec.pad_batch

    def recording_pad(examples, batch, length):
        padded = pad(examples, batch, length)
        batches.append((list(examples), padded))
        return padded

    spec.pad_batch = recording_pad
    rng = np.random.RandomState(3)
    reqs = [rng.randint(1, VOCAB, size=int(n)).astype(np.int32)
            for n in rng.randint(1, 257, size=16)]
    results = [None] * len(reqs)
    server = tmx.serve.ModelServer(net, spec, ctx=tmx.gpu(0))
    c0 = _imperative.graph_capture_count()
    server.start()
    assert _imperative.graph_capture_count() - c0 == 6
    r0 = _imperative.graph_replay_count()
    try:
        def client(idx):
            for i in idx:
                results[i] = server.submit(reqs[i]).result(timeout=120)

        threads = [threading.Thread(target=client, args=(range(c, 16, 4),))
                   for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        server.shutdown(drain=True, timeout=120)
    st = server.stats()
    assert st["served"] == 16 and st["graph"]["post_warmup_compiles"] == 0
    served = [b for b in batches if b[0]]
    assert _imperative.graph_replay_count() - r0 == st["batches"]
    assert len(served) == st["batches"]
    for examples, padded in served:
        seq, pooled = _run(eager, padded)
        for row, ex in enumerate(examples):
            i = next(i for i, r in enumerate(reqs) if r is ex)
            n = len(ex)
            assert np.array_equal(results[i][0], seq[row, :n].cpu().numpy())
            assert np.array_equal(results[i][1], pooled[row].cpu().numpy())
