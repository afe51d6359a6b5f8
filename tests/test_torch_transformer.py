"""The Transformer of the PyTorch port against the JAX package, on the CPU.

A model with 64 units, 4 heads of 16, 2+2 layers, vocabulary 50 and
dropout 0 is built in the JAX package (Xavier, seed 0), its weights --
the positional constant included, with the noise the JAX package's
``initialize(Xavier())`` writes into it (ROADMAP.md, reference caveat
(g)) -- carried across with ``load_numpy_params``, and both are fed the
same padded batches from numpy seeds.  On the CPU both packages' attention
op takes its oracle.

Tolerances (float32 on both sides, sums in other orders through 2+2
layers): logits within 1e-5 absolute; every parameter's gradient within
1e-4 of its largest magnitude; losses of 2 Adam steps through
``DataParallelTrainer`` within 1e-5 relative; greedy and beam sequences
equal and beam scores within 1e-5 absolute, after asserting that the
decoded path's smallest top-2 logit margin is more than 100x the logit
tolerance (so a near tie shows as that assertion, not as a flake).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.models import transformer as tt
from mxnet_tpu_torch.parallel import DataParallelTrainer

CPU = tmx.cpu()
V = 50
CFG = dict(units=64, hidden_size=128, num_layers=2, num_heads=4,
           max_length=64, dropout=0.0)
LOGIT_ATOL = 1e-5


def _ce(pkg):
    class LabelSmoothedCE(pkg.gluon.loss.Loss):
        """examples/nmt/train_transformer.py's loss: per-token
        label-smoothed cross entropy, padding (label 0) masked."""

        def __init__(self, smoothing=0.1, weight=None, batch_axis=0,
                     **kwargs):
            super().__init__(weight, batch_axis, **kwargs)
            self._eps = smoothing

        def hybrid_forward(self, F, pred, label):
            logp = F.log_softmax(pred)
            nll = -F.pick(logp, label, axis=-1)
            smooth = -F.mean(logp, axis=-1)
            loss = (1 - self._eps) * nll + self._eps * smooth
            mask = label != 0
            return F.sum(loss * mask) / (F.sum(mask) + 1e-6)

    return LabelSmoothedCE()


def _seq2seq(pkg, model):
    class Seq2SeqTrainNet(pkg.gluon.HybridBlock):
        """The example's teacher-forcing wrapper: (src, tgt_in, len)."""

        def __init__(self, model, **kwargs):
            super().__init__(**kwargs)
            self.model = model

        def hybrid_forward(self, F, src, tgt_in, src_valid_len=None):
            return self.model(src, tgt_in, src_valid_len)

    return Seq2SeqTrainNet(model)


def _jax_model(seed=0):
    import mxnet_tpu as jmx
    from mxnet_tpu.models import transformer as jt

    jmx.random.seed(seed)
    net = jt.TransformerModel(V, V, **CFG)
    net.initialize(jmx.init.Xavier())
    rng = np.random.RandomState(99)
    probe = [jmx.nd.array(rng.randint(3, V, (2, 5)), dtype="int32")
             for _ in range(2)]
    net(*probe)  # completes the Dense layers' deferred input widths
    return net


def _weights(jnet):
    return {k: p.data().asnumpy().copy()
            for k, p in jnet._collect_params_with_prefix().items()}


def _port_model(weights):
    net = tt.TransformerModel(V, V, **CFG)
    net.initialize(ctx=CPU)
    tmx.load_numpy_params(net, weights)
    return net


def _batch(seed=0, b=3, s=12, t=9, valid=(12, 7, 3), tvalid=(9, 5, 2)):
    """Padded (src, tgt_in, tgt_out, src_valid_len): ids in 3..V-1, 0
    past each row's length, every row with at least one live key."""
    rng = np.random.RandomState(seed)
    src = rng.randint(3, V, (b, s)).astype(np.int32)
    src[np.arange(s)[None, :] >= np.array(valid)[:, None]] = 0
    tgt = rng.randint(3, V, (b, t + 1)).astype(np.int32)
    tgt[:, 0] = 1
    tgt[np.arange(t + 1)[None, :] > np.array(tvalid)[:, None]] = 0
    return src, tgt[:, :-1], tgt[:, 1:], np.array(valid, np.float32)


def _jnd(a):
    import mxnet_tpu as jmx

    return jmx.nd.array(a, dtype="int32" if a.dtype == np.int32
                        else None)


def _tnd(a):
    return tmx.nd.array(a, ctx=CPU)


def test_logits_match_jax():
    jnet = _jax_model()
    tnet = _port_model(_weights(jnet))
    src, tgt_in, _, vl = _batch()
    jo = jnet(_jnd(src), _jnd(tgt_in), _jnd(vl)).asnumpy()
    to = tnet(_tnd(src), _tnd(tgt_in), _tnd(vl)).asnumpy()
    assert to.shape == jo.shape == (3, 9, V)
    np.testing.assert_allclose(to, jo, atol=LOGIT_ATOL, rtol=0)
    # without src_valid_len (no encoder mask) too
    jo = jnet(_jnd(src), _jnd(tgt_in)).asnumpy()
    to = tnet(_tnd(src), _tnd(tgt_in)).asnumpy()
    np.testing.assert_allclose(to, jo, atol=LOGIT_ATOL, rtol=0)


def test_gradients_match_jax():
    """The example's loss, backward through both packages: every
    trainable parameter's gradient within 1e-4 of its largest magnitude;
    the constant has none."""
    import mxnet_tpu as jmx

    jnet = _jax_model()
    tnet = _port_model(_weights(jnet))
    src, tgt_in, tgt_out, vl = _batch(seed=1)
    grads = []
    for pkg, net, arr in ((jmx, jnet, _jnd), (tmx, tnet, _tnd)):
        loss_fn = _ce(pkg)
        with pkg.autograd.record():
            loss = loss_fn(net(arr(src), arr(tgt_in), arr(vl)),
                           arr(tgt_out))
        loss.backward()
        grads.append({k: np.array(p.grad().asnumpy() if pkg is jmx
                                  else p.grad().numpy())
                      for k, p in net._collect_params_with_prefix().items()
                      if p.grad_req != "null"})
    jg, tg = grads
    assert set(jg) == set(tg) and "pos_const" not in tg
    assert len(tg) == len(tnet._collect_params_with_prefix()) - 1
    for k in jg:
        scale = np.abs(jg[k]).max()
        assert scale > 0, k
        err = np.abs(tg[k] - jg[k]).max()
        assert err <= 1e-4 * scale, (k, err, scale)


def test_data_parallel_trainer_two_adam_steps_match_jax():
    """The example's training step: ``DataParallelTrainer`` with Adam
    (beta2 0.98) and the label-smoothed loss, 2 steps on 2 buckets'
    batches: losses within 1e-5 relative, the weights after
    ``sync_to_block`` within 1e-4 absolute plus 1e-3 relative of the JAX
    package's (Adam divides by the gradient's own scale, so an element
    whose gradient is within rounding of zero moves by up to lr either
    way), and the constant untouched in both."""
    import jax
    import mxnet_tpu as jmx
    from mxnet_tpu.parallel import data_parallel as jdp
    from mxnet_tpu.parallel import mesh as jmesh

    jnet = _jax_model()
    start = _weights(jnet)
    tnet = _port_model(start)
    params = {"learning_rate": 1e-3, "beta2": 0.98}
    jtr = jdp.DataParallelTrainer(
        _seq2seq(jmx, jnet), _ce(jmx), "adam", dict(params),
        mesh=jmesh.make_mesh(devices=jax.devices()[:1]))
    ttr = DataParallelTrainer(_seq2seq(tmx, tnet), _ce(tmx), "adam",
                              dict(params))
    batches = [_batch(seed=2), _batch(seed=3, s=8, t=8, valid=(8, 4, 1),
                                      tvalid=(8, 3, 1))]
    jl, tl = [], []
    for src, tgt_in, tgt_out, vl in batches:
        svl = vl.astype(np.int32)
        jl.append(float(jtr.step((src, tgt_in, svl), tgt_out).asnumpy()))
        tl.append(float(ttr.step((src, tgt_in, svl), tgt_out).asnumpy()))
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    jtr.sync_to_block()
    ttr.sync_to_block()
    tw = {k: p.data().detach().numpy() for k, p in
          tnet._collect_params_with_prefix().items()}
    m = CFG["units"]
    for k, p in jnet._collect_params_with_prefix().items():
        got, want = tw[k], p.data().asnumpy()
        if k.endswith("_in_bias"):
            # the key projection's bias has a zero gradient in exact
            # arithmetic (softmax ignores a shift shared by all keys), so
            # Adam scales rounding noise to at most lr a step there
            assert np.abs(got[m:2 * m] - want[m:2 * m]).max() <= \
                2 * 2 * params["learning_rate"], k
            got, want = np.delete(got, np.s_[m:2 * m]), \
                np.delete(want, np.s_[m:2 * m])
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3,
                                   err_msg=k)
    assert np.array_equal(tw["pos_const"], start["pos_const"])


def _greedy_margin(net, src, vl, seqs):
    """The smallest top-2 margin of the logits on the decoded path: each
    step's last-position logits (teacher forcing the decoded sequences,
    one call), for the rows still live at that step."""
    logits = net(_jnd(src), _jnd(seqs[:, :-1]), _jnd(vl)).asnumpy()
    top2 = np.sort(logits, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    live = np.ones(seqs.shape[0], bool)
    least = np.inf
    for t in range(seqs.shape[1] - 1):
        least = min(least, margin[live, t].min())
        live &= seqs[:, t + 1] != 2
    return least


def test_greedy_and_beam_search_match_jax():
    jnet = _jax_model(seed=4)
    tnet = _port_model(_weights(jnet))
    src, _, _, vl = _batch(seed=5, b=4, valid=(12, 9, 5, 2),
                           tvalid=(9, 5, 2, 1))
    jg = jnet.greedy_decode(_jnd(src), max_len=10, src_valid_len=_jnd(vl))
    margin = _greedy_margin(jnet, src, vl, jg)
    assert margin > 100 * LOGIT_ATOL, margin
    tg = tnet.greedy_decode(_tnd(src), max_len=10, src_valid_len=_tnd(vl))
    assert tg.dtype == np.int32 and np.array_equal(tg, jg)
    jb, js = jnet.beam_search_decode(_jnd(src), beam_size=3, max_len=10,
                                     alpha=0.6, src_valid_len=_jnd(vl))
    tb, ts = tnet.beam_search_decode(_tnd(src), beam_size=3, max_len=10,
                                     alpha=0.6, src_valid_len=_tnd(vl))
    assert np.array_equal(tb, jb)
    np.testing.assert_allclose(ts, js, atol=1e-5, rtol=0)
    # a numpy source goes to the current context
    with CPU:
        again = tnet.greedy_decode(src, max_len=10, src_valid_len=vl)
    assert np.array_equal(again, tg)


def _live(seq, eos=2):
    seq = list(seq)
    return seq[:seq.index(eos) + 1] if eos in seq else seq


def test_beam_size_one_equals_greedy():
    """The JAX package's contract (tests/test_data_pipelines.py):
    beam 1 is greedy token for token over the live prefix."""
    jnet = _jax_model(seed=6)
    tnet = _port_model(_weights(jnet))
    src, _, _, vl = _batch(seed=7)
    greedy = tnet.greedy_decode(_tnd(src), max_len=12,
                                src_valid_len=_tnd(vl))
    beam1, scores = tnet.beam_search_decode(_tnd(src), beam_size=1,
                                            max_len=12,
                                            src_valid_len=_tnd(vl))
    assert np.isfinite(scores).all()
    for g, b in zip(greedy, beam1):
        g, b = _live(g), _live(b)
        assert g[:len(b)] == b or b[:len(g)] == g, (g, b)
    with pytest.raises(ValueError):
        tnet.beam_search_decode(_tnd(src), beam_size=0)


def _layout(net):
    return {k: tuple(p.shape) for k, p in
            net._collect_params_with_prefix().items()}


@pytest.mark.parametrize("name", ["transformer_big", "transformer_base",
                                  "transformer_tiny"])
def test_transformer_configs_match_jax(name):
    """Parameter names and shapes (deferred input widths as 0), and the
    layers' widths and head counts, as the JAX package builds them; no
    weights are made."""
    from mxnet_tpu.models import transformer as jt

    args = (32000, 32000) if name != "transformer_tiny" else ()
    jnet = getattr(jt, name)(*args)
    tnet = getattr(tt, name)(*args)
    assert _layout(tnet) == _layout(jnet)
    for a, b in ((tnet, jnet), (tnet.dec_layers[0], jnet.dec_layers[0])):
        assert a._units == b._units
    lj, lt = jnet.enc_layers[0], tnet.enc_layers[0]
    assert (lt._num_heads, lt.dropout._rate) == (lj._num_heads,
                                                 lj.dropout._rate)
    assert np.array_equal(tnet.pos_const.value.numpy(),
                          np.asarray(jnet.pos_const.value.asnumpy()))


def test_bert_large_matches_jax_layout():
    from mxnet_tpu.models import bert as jb

    jnet = jb.bert_large()
    tnet = tmx.models.bert_large()
    assert _layout(tnet) == _layout(jnet)
    assert len(list(tnet.encoder.layers)) == 24
    assert tnet.encoder.layers[0]._num_heads == 16


def test_tiny_params_file_is_byte_identical_and_loads_in_both(tmp_path):
    """``save_parameters`` of transformer_tiny, constant included, writes
    the same bytes in both packages, and each package loads the other's
    file."""
    import mxnet_tpu as jmx
    from mxnet_tpu.models import transformer as jt

    jmx.random.seed(8)
    jnet = jt.transformer_tiny(30, 30)
    jnet.initialize()
    ids = jmx.nd.array(np.random.RandomState(0).randint(3, 30, (2, 6)),
                       dtype="int32")
    jnet(ids, ids)
    tnet = tt.transformer_tiny(30, 30)
    tnet.initialize(ctx=CPU)
    tmx.load_numpy_params(tnet, _weights(jnet))
    jfile, tfile = tmp_path / "jax.params", tmp_path / "port.params"
    jnet.save_parameters(str(jfile))
    tnet.save_parameters(str(tfile))
    assert jfile.read_bytes() == tfile.read_bytes()
    other = tt.transformer_tiny(30, 30)
    other.initialize(ctx=CPU)
    other.load_parameters(str(jfile))
    back = jt.transformer_tiny(30, 30)
    back.initialize()
    back.load_parameters(str(tfile))
    want = _weights(jnet)
    for k, p in other._collect_params_with_prefix().items():
        assert np.array_equal(p.data().detach().numpy(), want[k]), k
    for k, v in _weights(back).items():
        assert np.array_equal(v, want[k]), k


def test_constant_keeps_its_value_under_initialize():
    """The port's Constant keeps the positional table under
    ``initialize(Xavier())`` (force_reinit too); the JAX package's
    ``initialize(init)`` overwrites it with the initializer's draws
    (ROADMAP.md, reference caveat (g)), and ``initialize()`` does not."""
    import mxnet_tpu as jmx
    from mxnet_tpu.models import transformer as jt

    table = tt.positional_encoding(64, 32)
    np.testing.assert_array_equal(table, jt.positional_encoding(64, 32))
    net = tt.transformer_tiny()
    net.initialize(tmx.init.Xavier(), ctx=CPU)
    assert np.array_equal(net.pos_const.data().numpy(), table)
    net.collect_params().initialize(tmx.init.Uniform(3.0), ctx=CPU,
                                    force_reinit=True)
    assert np.array_equal(net.pos_const.data().numpy(), table)
    assert net.pos_const.grad_req == "null"
    assert not net.pos_const.data().requires_grad
    jmx.random.seed(0)
    jnet = jt.transformer_tiny()
    jnet.initialize(jmx.init.Xavier())
    assert np.abs(jnet.pos_const.data().asnumpy() - table).max() > 0.1
    jnet = jt.transformer_tiny()
    jnet.initialize()
    assert np.array_equal(jnet.pos_const.data().asnumpy(), table)


def test_get_constant_and_trainers_leave_the_constant():
    """``ParameterDict.get_constant`` returns one Constant per name;
    ``gluon.Trainer`` takes no constant, and neither trainer changes it."""
    from mxnet_tpu_torch.gluon.parameter import Constant, ParameterDict

    pd = ParameterDict("m_")
    c = pd.get_constant("table", np.arange(6.0).reshape(2, 3))
    assert isinstance(c, Constant) and pd.get_constant("table") is c
    assert c.dtype == "float32" and c.shape == (2, 3)
    with pytest.raises(tmx.MXNetError):
        pd.get_constant("missing")
    tmx.random.seed(3)
    net = tt.TransformerModel(V, V, **CFG)
    net.initialize(tmx.init.Xavier(), ctx=CPU)
    table = net.pos_const.data().clone()
    trainer = tmx.gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 1e-2})
    assert all(p.grad_req != "null" for p in trainer._params)
    src, tgt_in, tgt_out, vl = _batch(seed=9)
    loss_fn = _ce(tmx)
    for _ in range(2):
        with tmx.autograd.record():
            loss = loss_fn(net(_tnd(src), _tnd(tgt_in), _tnd(vl)),
                           _tnd(tgt_out))
        loss.backward()
        trainer.step(1)
    assert torch.equal(net.pos_const.data(), table)


def test_checkpoint_manager_carries_the_constant(tmp_path):
    """CheckpointManager saves the constant and restores it into a model
    whose table was changed."""
    from mxnet_tpu_torch import checkpoint as tck

    net = tt.transformer_tiny(20, 20)
    net.initialize(ctx=CPU)
    ids = _tnd(np.random.RandomState(1).randint(3, 20, (2, 5)).astype(
        np.int32))
    net(ids, ids)
    mgr = tck.CheckpointManager(str(tmp_path), keep_n=2)
    mgr.save(1, params=net, sync=True)
    table = net.pos_const.data().clone()
    net.pos_const.set_data(np.zeros((64, 32), np.float32))
    tck.CheckpointManager(str(tmp_path)).restore(params=net)
    assert torch.equal(net.pos_const.data(), table)


def test_mask_is_made_on_the_lengths_device():
    """``_mask_from_len`` makes its steps on ``valid_length``'s device, so
    a CPU call needs no default device."""
    net = tt.transformer_tiny()
    mask = net._mask_from_len(tmx.nd, torch.tensor([3.0, 1.0]), 4, 4)
    assert mask.device.type == "cpu" and mask.shape == (2, 1, 1, 4)
    assert mask[0, 0, 0].tolist() == [0.0, 0.0, 0.0, -1e9]


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernels have no CPU "
                    "mode); run on the GPU machine with -m gpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _card_pair(dev, seed=0):
    """A head-dim-64 model (128 units, 2 heads, 2+2 layers) on the card
    and the same weights on the CPU."""
    tmx.random.seed(seed)
    cfg = dict(CFG, units=128, hidden_size=256, num_heads=2)
    cpu = tt.TransformerModel(V, V, **cfg)
    cpu.initialize(tmx.init.Xavier(), ctx=CPU)
    src, tgt_in, _, vl = _batch(seed=seed)
    cpu(_tnd(src), _tnd(tgt_in), _tnd(vl))
    card = tt.TransformerModel(V, V, **cfg)
    card.initialize(ctx=tmx.gpu(0))
    tmx.load_numpy_params(card, {k: p.data().detach().numpy().copy() for k, p in
                                 cpu._collect_params_with_prefix().items()})
    return cpu, card


@pytest.mark.gpu
def test_training_step_launches_the_kernels_on_card(cuda_device):
    """A forward and backward on the card launch the flash forward, dQ and
    dK/dV kernels once per attention (2 encoder, 2 causal decoder self,
    2 cross), with no plain call; logits and gradients match the CPU."""
    from mxnet_tpu_torch.ops import kernels

    cpu, card = _card_pair(cuda_device)
    src, tgt_in, tgt_out, vl = _batch(seed=0)
    gpu = tmx.gpu(0)
    outs = []
    kernels.reset_counts()
    for net, ctx in ((card, gpu), (cpu, CPU)):
        arr = [tmx.nd.array(a, ctx=ctx) for a in (src, tgt_in, vl, tgt_out)]
        with tmx.autograd.record():
            logits = net(*arr[:3])
            loss = _ce(tmx)(logits, arr[3])
        loss.backward()
        g = net._collect_params_with_prefix()["dec_layers.0.cross_in_weight"]
        outs.append((logits.asnumpy(), g.grad().cpu().numpy()))
    counts = kernels.KERNEL_COUNTS
    assert [counts[k].launches for k in ("flash_attention_fwd",
                                         "flash_attention_bwd_dq",
                                         "flash_attention_bwd_dkv")] == \
        [6, 6, 6]
    assert sum(c.plain_calls_on_cuda for c in counts.values()) == 0
    (cl, cg), (pl, pg) = outs
    np.testing.assert_allclose(cl, pl, atol=1e-4, rtol=0)
    assert np.abs(cg - pg).max() <= 1e-3 * np.abs(pg).max()


@pytest.mark.gpu
def test_decode_replays_equal_eager_decodes_on_card(cuda_device):
    """Hybridized, in predict mode: the first greedy and beam calls warm
    each prefix length, the second captures, the third replays; all three
    give the same sequences and scores bit for bit, one graph per
    signature, 6 forward launches a step, no plain call."""
    from mxnet_tpu_torch import _imperative
    from mxnet_tpu_torch.ops import kernels

    _, card = _card_pair(cuda_device, seed=1)
    card.hybridize()
    src, _, _, vl = _batch(seed=1)
    s = tmx.nd.array(src, ctx=tmx.gpu(0))
    v = tmx.nd.array(vl, ctx=tmx.gpu(0))
    c0 = _imperative.graph_capture_count()
    runs = []
    kernels.reset_counts()
    for _ in range(3):
        greedy = card.greedy_decode(s, max_len=8, src_valid_len=v)
        beam = card.beam_search_decode(s, beam_size=2, max_len=8,
                                       src_valid_len=v)
        runs.append((greedy, beam))
    for greedy, (seqs, scores) in runs[1:]:
        assert np.array_equal(greedy, runs[0][0])
        assert np.array_equal(seqs, runs[0][1][0])
        assert np.array_equal(scores, runs[0][1][1])
    sigs = card._cached_op._seen_sigs
    assert _imperative.graph_capture_count() - c0 == len(sigs)
    beam_steps = sum(1 for sig in sigs
                     if sig[2][0][0][0] == 2 * src.shape[0])
    greedy_steps = runs[0][0].shape[1] - 1
    assert len(sigs) == greedy_steps + beam_steps
    fwd = kernels.KERNEL_COUNTS["flash_attention_fwd"]
    assert fwd.launches == 3 * 6 * (greedy_steps + beam_steps)
    assert fwd.plain_calls_on_cuda == 0
