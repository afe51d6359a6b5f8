"""The port's ``DataParallelTrainer`` on meshes of 2 ranks: accumulation
with BatchNorm and BERT-tiny with ZeRO against the JAX class over 2 of the
8 virtual CPU devices, and the port's own bit-identities.

One launch of 2 gloo ranks (``tests/torch_mesh_worker.py two``, once a
test session) runs every case:

- ``accum_steps=2`` on ``{dp:2}`` with two Conv+BatchNorm layers (SGD with
  momentum, 3 steps): a rank's micro-batch ``i`` is its half of global
  micro-batch ``i``, as the JAX step shards it; losses within 1e-5
  relative, masters within 1e-5 of their largest magnitude;
- ``remat=True`` with dropout 0.3: losses and masters bit-identical to
  ``remat=False`` from the same seed, the masters bit-identical across
  ranks; the dropout masks of a ``{dp:2}`` mesh differ across the ranks and
  those of a ``{tp:2}`` mesh agree;
- ``step_many`` over 3 stacked batches: bit-identical to 3 ``step`` calls;
- ``save_states(async_save=True)`` with ZeRO states, steps while it
  writes, and a fresh trainer resuming from it: bit-identical steps; that
  trainer (``{dp:2}``) refusing the JAX class's ``{dp:4}`` checkpoint;
- BERT-tiny (2 layers, width 64, one head of 64, MLM + NSP a row, dropout
  0) on ``{dp:2}`` with ``shard_opt_states`` and AdamW: 3 losses within
  1e-4 relative of the JAX class's.

The ``gpu``-marked tests run 2 ranks on the card (gloo on one card, NCCL
on two): the statistics' all-reduce on CUDA tensors, and the ZeRO update
of BERT-tiny bit-identical to the unsharded one; they skip here.
"""
import numpy as np
import pytest
import torch

import torch_mesh_worker as w

N = 2
RTOL = 1e-5


def _prepare(out):
    """The JAX side's files the ranks read: BERT-tiny's weights and the JAX
    class's {dp:4} checkpoint of the MLP."""
    import mxnet_tpu as jmx

    jmx.random.seed(9)
    jnet = w.bert_block(jmx)
    jnet.initialize(init=jmx.init.Normal(0.02))
    with jmx.autograd.pause():
        jnet(*[jmx.nd.array(a, dtype=a.dtype) for a in w.bert_data()])
    np.savez(out / "bert-weights.npz", **{
        k: p.data().asnumpy() for k, p in
        jnet._collect_params_with_prefix().items()})
    x, y = w.mlp_data()
    tr = _jax_trainer(w.mlp(jmx), "sgd", w.SGD_MOM, {"dp": 4})
    tr.step(x, y)
    tr.save_states(str(out / "jax-dp4"))


@pytest.fixture(scope="session")
def two(tmp_path_factory):
    out = w.shared_run("two", N, _prepare, tmp_path_factory)
    return out, w.read(out, "two", N)


def _jax_trainer(net, opt, params, shape, loss=None, **kw):
    import jax
    import mxnet_tpu as jmx
    from mxnet_tpu.parallel import data_parallel as jdp
    from mxnet_tpu.parallel import mesh as jmesh

    n = int(np.prod(list(shape.values())))
    return jdp.DataParallelTrainer(
        net, loss or jmx.gluon.loss.SoftmaxCrossEntropyLoss(), opt,
        dict(params), mesh=jmesh.make_mesh(shape, devices=jax.devices()[:n]),
        **kw)


def test_accum_steps_with_batchnorm_matches_jax(two):
    import mxnet_tpu as jmx

    _, ranks = two
    x, y = w.bn_data()
    tr = _jax_trainer(w.small_bn_net(jmx), "sgd", w.SGD_MOM, {"dp": 2},
                      accum_steps=2)
    meta, arr = ranks[0]
    losses = [float(tr.step(x, y).asnumpy()) for _ in range(w.STEPS)]
    np.testing.assert_allclose(meta["accum"]["losses"], losses, rtol=RTOL)
    for i, ref in enumerate(np.array(p) for p in tr._params):
        got = arr[f"accum/step{w.STEPS - 1}/p{i}"]
        scale = max(float(np.abs(ref).max()), 1e-12)
        assert np.abs(got - ref).max() <= RTOL * scale, i
        np.testing.assert_array_equal(
            ranks[1][1][f"accum/step{w.STEPS - 1}/p{i}"], got)


def test_remat_is_bit_identical_with_dropout(two):
    _, ranks = two
    for meta, arr in ranks:
        assert meta["remat"]["remat_children"] == 4  # fc0, drop, fc1, out
        assert meta["remat"]["losses"] == meta["noremat"]["losses"]
        keys = [k for k in arr.files if k.startswith("remat/")]
        assert len(keys) == 6 * w.STEPS
        for k in keys:
            np.testing.assert_array_equal(arr[k],
                                          arr["noremat/" + k[len("remat/"):]])
            np.testing.assert_array_equal(arr[k], ranks[0][1][k])
    assert ranks[0][0]["remat"]["losses"][-1] < \
        ranks[0][0]["remat"]["losses"][0]


def test_dropout_streams_differ_across_data_ranks_only(two):
    _, ranks = two
    a, b = (arr for _, arr in ranks)
    assert not np.array_equal(a["stream_dp/mask"], b["stream_dp/mask"])
    np.testing.assert_array_equal(a["stream_tp/mask"], b["stream_tp/mask"])
    # data rank 0 keeps the one-process stream
    np.testing.assert_array_equal(a["stream_dp/mask"], a["stream_tp/mask"])


def test_step_many_is_bit_identical_to_steps(two):
    _, ranks = two
    for meta, arr in ranks:
        assert meta["many"]["losses"] == meta["steps"]["losses"]
        for i in range(4):
            np.testing.assert_array_equal(arr[f"many/p{i}"],
                                          arr[f"steps/p{i}"])


def test_async_checkpoint_resumes_and_a_dp4_checkpoint_is_refused(two):
    _, ranks = two
    for meta, _ in ranks:
        assert meta["async"]["t"] == 3
        assert meta["async"]["resumed"] == meta["async"]["after"]
        assert "checkpoint mesh [('dp', 4)]" in meta["refuse"]["message"]
        # the reference's words: no resharding on load is promised
        assert meta["refuse"]["message"].endswith(
            "; resharding on load isn't supported")


def test_bert_tiny_zero_matches_jax(two):
    import mxnet_tpu as jmx

    out, ranks = two
    weights = np.load(out / "bert-weights.npz")
    jnet = w.bert_block(jmx)
    jnet.initialize()
    batch = w.bert_data()
    with jmx.autograd.pause():
        jnet(*[jmx.nd.array(a, dtype=a.dtype) for a in batch])
    for k, p in jnet._collect_params_with_prefix().items():
        p.set_data(jmx.nd.array(weights[k]))
    tr = _jax_trainer(jnet, "adamw", {"learning_rate": 1e-3, "wd": 0.01},
                      {"dp": 2}, loss=w.own_loss, shard_opt_states=True)
    y = np.zeros(w.BERT["batch"], np.float32)
    losses = [float(tr.step(batch, y).asnumpy()) for _ in range(w.STEPS)]
    for meta, _ in ranks:
        np.testing.assert_allclose(meta["bert"]["losses"], losses,
                                   rtol=1e-4)
        assert meta["bert"]["zero_states"] > 10
    assert losses[-1] < losses[0]


# -- on the card ----------------------------------------------------------------


def _card_run(tmp_path, mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine with -m gpu")
    rc, tail = w.launch(tmp_path, mode, N, timeout=300)
    assert rc == 0, tail
    return w.read(tmp_path, mode, N)


@pytest.mark.gpu
def test_batchnorm_statistics_allreduce_on_cuda_tensors(tmp_path):
    """2 ranks on the card: ``SyncBatchNorm`` over ``dp`` on CUDA tensors
    (each rank its 2 rows) against BatchNorm over all 4 rows on the card,
    and the backend the rule names."""
    ranks = _card_run(tmp_path, "card_bn")
    want = "nccl" if torch.cuda.device_count() >= N else "gloo"
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(4, 3, 4, 4).astype(np.float32)).cuda()
    gy = torch.from_numpy(rng.randn(4, 3, 4, 4).astype(np.float32)).cuda()
    x.requires_grad_(True)
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True)
    ref = (x - mean) / torch.sqrt(var + 1e-5)
    (dx,) = torch.autograd.grad(ref, x, gy)
    for r, (meta, arr) in enumerate(ranks):
        assert meta["run"]["backend"] == want
        sl = slice(2 * r, 2 * r + 2)
        np.testing.assert_allclose(arr["card_bn/y"],
                                   ref.detach().cpu().numpy()[sl],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(arr["card_bn/dx"], dx.cpu().numpy()[sl],
                                   rtol=1e-5, atol=1e-5)
        assert meta["card_bn"]["stats_allreduces"] == 2


@pytest.mark.gpu
def test_zero_update_of_bert_tiny_on_the_card(tmp_path):
    """2 ranks on the card: BERT-tiny under AdamW, ``shard_opt_states``
    against no sharding, 3 steps: losses and masters bit-identical, the
    ranks bit-identical."""
    ranks = _card_run(tmp_path, "card_zero")
    for meta, arr in ranks:
        assert meta["card_zero"]["zero"] == meta["card_zero"]["plain"]
        keys = [k for k in arr.files if k.startswith("card_zero/zero/")]
        assert keys
        for k in keys:
            np.testing.assert_array_equal(
                arr[k], arr[k.replace("/zero/", "/plain/")])
            np.testing.assert_array_equal(arr[k], ranks[0][1][k])
