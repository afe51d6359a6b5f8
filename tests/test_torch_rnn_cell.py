"""The recurrent cells of the PyTorch port (``gluon.rnn.*Cell``) against
the JAX package's, on the CPU.

Each cell is built in both packages, the JAX package's weights (its
default initializer, seed 0) carried across with ``load_numpy_params``,
and both are unrolled over the same numpy inputs.  Tolerances (float32 on
both sides, the same products summed in other orders over up to 6 steps):
outputs and states within 1e-5 absolute; gradients within 1e-5 of the
largest magnitude.  The card tests hold the cells against the fused
layers (``gluon.rnn.LSTM``/``GRU``), whose recurrence kernels pin the gate
orders.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx

CPU = tmx.cpu()
N, T, I, H = 3, 6, 5, 4
VALID = np.array([6, 3, 1], np.float32)


def _cells(pkg, kind):
    """A fresh cell of ``kind`` in ``pkg``."""
    rnn = pkg.gluon.rnn
    if kind == "rnn_tanh":
        return rnn.RNNCell(H)
    if kind == "rnn_relu":
        return rnn.RNNCell(H, activation="relu")
    if kind == "lstm":
        return rnn.LSTMCell(H)
    if kind == "gru":
        return rnn.GRUCell(H)
    if kind in ("sequential", "hybrid_sequential"):
        cell = (rnn.SequentialRNNCell() if kind == "sequential"
                else rnn.HybridSequentialRNNCell())
        cell.add(rnn.LSTMCell(H))
        cell.add(rnn.GRUCell(H))
        return cell
    if kind == "residual":
        return rnn.ResidualCell(rnn.GRUCell(I))
    if kind == "dropout0":
        cell = rnn.SequentialRNNCell()
        cell.add(rnn.LSTMCell(H))
        cell.add(rnn.DropoutCell(0.0))
        return cell
    if kind == "zoneout0":
        return rnn.ZoneoutCell(rnn.LSTMCell(H), zoneout_outputs=0.0,
                               zoneout_states=0.0)
    if kind == "bidirectional":
        return rnn.BidirectionalCell(rnn.LSTMCell(H), rnn.GRUCell(H))
    raise ValueError(kind)


KINDS = ("rnn_tanh", "rnn_relu", "lstm", "gru", "sequential",
         "hybrid_sequential", "residual", "dropout0", "zoneout0",
         "bidirectional")


def _inputs(layout, seed=0):
    x = np.random.RandomState(seed).randn(N, T, I).astype(np.float32)
    return x if layout == "NTC" else np.ascontiguousarray(x.swapaxes(0, 1))


def _pair(kind, layout="NTC", train=False):
    """The JAX cell (initialized, shapes completed by one unroll) and the
    port's with its weights."""
    import mxnet_tpu as jmx

    jmx.random.seed(0)
    jcell = _cells(jmx, kind)
    jcell.initialize()
    with jmx.autograd.record(train_mode=train):
        jcell.unroll(T, jmx.nd.array(_inputs(layout)), layout=layout)
    tcell = _cells(tmx, kind)
    tcell.initialize(ctx=CPU)
    weights = {k: p.data().asnumpy().copy()
               for k, p in jcell._collect_params_with_prefix().items()}
    tmx.load_numpy_params(tcell, weights)
    return jcell, tcell


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return x.asnumpy()


def _close(got, want, atol=1e-5):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, atol)
        return
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("layout", ["NTC", "TNC"])
@pytest.mark.parametrize("merge", [None, True, False])
@pytest.mark.parametrize("valid", [False, True])
def test_unroll_matches_jax(kind, layout, merge, valid):
    """Outputs (stacked or a list of steps) and final states.  With
    ``merge_outputs=False`` and ``valid_length``, which the JAX package
    cannot run (ROADMAP.md, reference caveat (h)), the port's steps are
    held to the JAX package's masked, merged outputs split by step."""
    import mxnet_tpu as jmx

    jcell, tcell = _pair(kind, layout)
    x = _inputs(layout, seed=1)
    jvl = jmx.nd.array(VALID) if valid else None
    tvl = tmx.nd.array(VALID, ctx=CPU) if valid else None
    jmerge = True if (valid and merge is False) else merge
    jout, jstates = jcell.unroll(T, jmx.nd.array(x), layout=layout,
                                 merge_outputs=jmerge, valid_length=jvl)
    tout, tstates = tcell.unroll(T, tmx.nd.array(x, ctx=CPU),
                                 layout=layout, merge_outputs=merge,
                                 valid_length=tvl)
    want = _np(jout)
    if jmerge is not merge:
        axis = 1 if layout == "NTC" else 0
        want = [np.take(want, t, axis=axis) for t in range(T)]
    _close(_np(tout), want)
    _close(_np(tstates), _np(jstates))
    if valid:
        merged = np.stack(_np(tout), 1 if layout == "NTC" else 0) \
            if merge is False else _np(tout)
        steps = merged if layout == "TNC" else merged.swapaxes(0, 1)
        assert (steps[np.arange(T)[:, None] >= VALID[None, :]] == 0).all()


@pytest.mark.parametrize("kind", ["rnn_tanh", "lstm", "gru",
                                  "hybrid_sequential", "residual",
                                  "bidirectional"])
def test_gradients_match_jax(kind):
    """``backward`` of the outputs' weighted sum through an NTC unroll
    with ``valid_length``: every parameter's gradient, and the input's."""
    import mxnet_tpu as jmx

    jcell, tcell = _pair(kind)
    x = _inputs("NTC", seed=2)
    grads = []
    for pkg, cell, mk in ((jmx, jcell, lambda a: jmx.nd.array(a)),
                          (tmx, tcell, lambda a: tmx.nd.array(a, ctx=CPU))):
        xs = mk(x)
        xs.attach_grad()
        w = mk(np.random.RandomState(3).randn(
            *((N, T, 2 * H) if kind == "bidirectional"
              else (N, T, I if kind == "residual" else H)))
            .astype(np.float32))
        with pkg.autograd.record():
            out, _ = cell.unroll(T, xs, layout="NTC",
                                 valid_length=mk(VALID))
            loss = jmx.nd.sum(out * w) if pkg is jmx else \
                tmx.nd.NDArray(torch.sum(out.data * w.data))
        loss.backward()
        g = {k: np.array(p.grad().asnumpy() if pkg is jmx
                         else p.grad().numpy())
             for k, p in cell._collect_params_with_prefix().items()}
        g["input"] = np.array(xs.grad.asnumpy())
        grads.append(g)
    jg, tg = grads
    assert set(jg) == set(tg)
    for k in jg:
        scale = max(np.abs(jg[k]).max(), 1e-6)
        assert np.abs(tg[k] - jg[k]).max() <= 1e-5 * scale, k


@pytest.mark.parametrize("kind", ["rnn_tanh", "lstm", "gru", "sequential",
                                  "residual", "zoneout0"])
def test_one_step_and_begin_state_match_jax(kind):
    """``cell(x, states)`` one step from ``begin_state``'s zeros (a
    modifier cell's are its base cell's) and from given states;
    ``state_info``; the default states are on the input's device."""
    import mxnet_tpu as jmx

    jcell, tcell = _pair(kind)
    x = np.random.RandomState(4).randn(N, I).astype(np.float32)
    assert [i["shape"] for i in tcell.state_info(N)] == \
        [i["shape"] for i in jcell.state_info(N)]
    js = jcell.begin_state(N)
    ts = tcell.begin_state(N, ctx=CPU)
    assert all(isinstance(s, tmx.nd.NDArray) for s in ts)
    jout, jst = jcell(jmx.nd.array(x), js)
    tout, tst = tcell(tmx.nd.array(x, ctx=CPU), ts)
    _close(_np(tout), _np(jout))
    _close(_np(tst), _np(jst))
    tout2, tst2 = tcell(tmx.nd.array(x, ctx=CPU), tst)
    jout2, _ = jcell(jmx.nd.array(x), jst)
    _close(_np(tout2), _np(jout2))
    raw, _ = tcell(torch.from_numpy(x))  # tensors in, tensors out
    assert isinstance(raw, torch.Tensor)
    np.testing.assert_array_equal(raw.detach().numpy(), _np(tout))


def test_parameter_names_and_deferred_input_width_match_jax():
    """Structural names and shapes (layer 0's input width deferred to the
    first input) of every kind, as the JAX package builds them."""
    import mxnet_tpu as jmx

    for kind in KINDS:
        jcell, tcell = _pair(kind)
        want = {k: tuple(p.shape) for k, p in
                jcell._collect_params_with_prefix().items()}
        got = {k: tuple(p.shape) for k, p in
               tcell._collect_params_with_prefix().items()}
        assert got == want, kind
    fresh = _cells(tmx, "lstm")
    assert fresh.i2h_weight.shape == (4 * H, 0)
    fresh.initialize(ctx=CPU)
    fresh.unroll(2, tmx.nd.array(np.ones((N, 2, 7), np.float32), ctx=CPU))
    assert fresh.i2h_weight.shape == (4 * H, 7)
    del jmx


def test_dropout_and_zoneout_in_predict_mode_are_the_identity():
    """In predict mode DropoutCell(0.5) passes its input and
    ZoneoutCell(0.5, 0.5) is its base cell; in training at rate 0 both
    are too (``test_unroll_matches_jax``)."""
    _, tcell = _pair("lstm")
    x = tmx.nd.array(_inputs("NTC", seed=5), ctx=CPU)
    base, _ = tcell.unroll(T, x)
    zone = tmx.gluon.rnn.ZoneoutCell(tcell, 0.5, 0.5)
    out, _ = zone.unroll(T, x)
    np.testing.assert_array_equal(out.asnumpy(), base.asnumpy())
    drop = tmx.gluon.rnn.DropoutCell(0.5)
    out, states = drop(x, [])
    assert states == [] and out.data is x.data


def test_zoneout_and_dropout_in_training_mix_old_and_new():
    """In training ZoneoutCell keeps each element's previous value or
    takes the new one (the draws from the device's generator, seeded),
    and DropoutCell zeroes or scales by 1/keep."""
    _, tcell = _pair("gru")
    x = tmx.nd.array(_inputs("NTC", seed=6), ctx=CPU)
    base, _ = tcell.unroll(T, x)
    zone = tmx.gluon.rnn.ZoneoutCell(tcell, zoneout_outputs=0.5)
    tmx.random.seed(1)
    with tmx.autograd.train_mode():
        out, _ = zone.unroll(T, x)
    tmx.random.seed(1)
    zone.reset()
    with tmx.autograd.train_mode():
        again, _ = zone.unroll(T, x)
    np.testing.assert_array_equal(out.asnumpy(), again.asnumpy())
    assert not np.array_equal(out.asnumpy(), base.asnumpy())
    # step 0's previous output is zeros; the states are not zoned out, so
    # every step's base output is the predict-mode one
    step0, base0 = out.asnumpy()[:, 0], base.asnumpy()[:, 0]
    kept = step0 == 0
    assert (kept | (step0 == base0)).all() and kept.any() and not kept.all()
    drop = tmx.gluon.rnn.DropoutCell(0.5)
    with tmx.autograd.train_mode():
        y, _ = drop(tmx.nd.array(np.ones((64, 8), np.float32), ctx=CPU), [])
    assert set(np.unique(y.asnumpy())) <= {0.0, 2.0}


def test_bidirectional_cell_steps_raise_and_reverse_within_lengths():
    import mxnet_tpu as jmx

    _, tcell = _pair("bidirectional")
    x = tmx.nd.array(np.ones((N, I), np.float32), ctx=CPU)
    with pytest.raises(NotImplementedError):
        tcell(x)
    seq = np.arange(T * N, dtype=np.float32).reshape(T, N, 1)
    got = tmx.nd.SequenceReverse(torch.from_numpy(seq),
                                 torch.from_numpy(VALID),
                                 use_sequence_length=True)
    want = jmx.nd.SequenceReverse(jmx.nd.array(seq), jmx.nd.array(VALID),
                                  use_sequence_length=True)
    np.testing.assert_array_equal(got.numpy(), want.asnumpy())
    with pytest.raises(tmx.MXNetError):
        tmx.nd.SequenceReverse(torch.from_numpy(seq), axis=1)


def test_cell_ops_match_jax():
    """split, flip/reverse, where and SequenceMask (axis 0 and 1) as the
    JAX ops compute them."""
    import mxnet_tpu as jmx

    rng = np.random.RandomState(7)
    a = rng.randn(4, 6, 3).astype(np.float32)
    t = torch.from_numpy(a)
    for got, want in zip(tmx.nd.split(t, num_outputs=3, axis=1),
                         jmx.nd.split(jmx.nd.array(a), num_outputs=3,
                                      axis=1)):
        np.testing.assert_array_equal(got.numpy(), want.asnumpy())
    np.testing.assert_array_equal(
        tmx.nd.reverse(t, axis=1).numpy(),
        jmx.nd.reverse(jmx.nd.array(a), axis=1).asnumpy())
    cond = (a > 0).astype(np.float32)
    np.testing.assert_array_equal(
        tmx.nd.where(torch.from_numpy(cond), t, -t).numpy(),
        jmx.nd.where(jmx.nd.array(cond), jmx.nd.array(a),
                     -jmx.nd.array(a)).asnumpy())
    lens = np.array([2, 4, 1, 3, 0, 6], np.float32)
    for axis, data in ((0, a.swapaxes(0, 1)[:, :4]), (1, a)):
        data = np.ascontiguousarray(data)
        ln = lens[:data.shape[1 - axis]]
        np.testing.assert_array_equal(
            tmx.nd.SequenceMask(torch.from_numpy(data), torch.from_numpy(ln),
                                use_sequence_length=True, value=-1.0,
                                axis=axis).numpy(),
            jmx.nd.SequenceMask(jmx.nd.array(data), jmx.nd.array(ln),
                                use_sequence_length=True, value=-1.0,
                                axis=axis).asnumpy())
    with pytest.raises(tmx.MXNetError):
        tmx.nd.split(t, num_outputs=4, axis=1)
    u = tmx.nd.random.uniform(shape=(1000,), ctx=CPU)
    assert u.shape == (1000,) and 0.0 <= u.min() and u.max() < 1.0


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernels have no CPU "
                    "mode); run on the GPU machine with -m gpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def cells_against_fused(cell_cls, layer_cls, hidden, steps, batch, seed=0):
    """Two stacked cells (``HybridSequentialRNNCell``) given a fused
    two-layer layer's weights, both unrolled over the same TNC input on
    the card: ``(max |cells - fused| / max |fused|, the fused layer's
    kernel launches)``."""
    from mxnet_tpu_torch.ops import kernels

    gpu = tmx.gpu(0)
    tmx.random.seed(seed)
    fused = layer_cls(hidden, num_layers=2)
    fused.initialize(tmx.init.Xavier(), ctx=gpu)
    x = tmx.nd.array(np.random.RandomState(seed).randn(
        steps, batch, hidden).astype(np.float32) * 0.5, ctx=gpu)
    kernel = "lstm_fwd" if layer_cls is tmx.gluon.rnn.LSTM else "gru_fwd"
    before = kernels.KERNEL_COUNTS[kernel].launches
    want = fused(x)
    launches = kernels.KERNEL_COUNTS[kernel].launches - before
    stack = tmx.gluon.rnn.HybridSequentialRNNCell()
    for _ in range(2):
        stack.add(cell_cls(hidden))
    stack.initialize(ctx=gpu)
    fp = fused._collect_params_with_prefix()
    tmx.load_numpy_params(stack, {
        f"{layer}.{kind}": fp[f"l{layer}_{kind}"].data().detach().cpu()
        .numpy() for layer in range(2)
        for kind in ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias")})
    got, _ = stack.unroll(steps, x, layout="TNC")
    want = want.asnumpy()
    return float(np.abs(got.asnumpy() - want).max() / np.abs(want).max()), \
        launches


@pytest.mark.gpu
@pytest.mark.parametrize("cell,layer", [("LSTMCell", "LSTM"),
                                        ("GRUCell", "GRU")])
def test_cells_match_the_fused_layers_on_card(cell, layer, cuda_device):
    """The cells' gate orders are the recurrence kernels': two stacked
    cells with a fused 2-layer layer's weights give its outputs within
    1e-4 of their largest magnitude (fp32, TF32 off)."""
    rnn = tmx.gluon.rnn
    err, launches = cells_against_fused(getattr(rnn, cell),
                                        getattr(rnn, layer), 32, 7, 4)
    assert launches == 2
    assert err <= 1e-4, err
