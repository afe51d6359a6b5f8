"""The port's CTC loss against the JAX package's, and the OCR example's
CRNN (``examples/ocr/train_crnn_ctc.py``) trained in both.

The ``CTCLoss`` op (``mx.nd.CTCLoss``, the log-space alpha recursion) on
the same numpy inputs in both packages on the CPU: the loss and the
gradient of the activations within 1e-5 relative (of each one's largest
value), over both blank conventions, given lengths, repeated labels, a
zero-length label and an infeasible row (loss about 1e30, no NaN).  Then
the Gluon loss in its four layouts, a cross-check of the feasible rows
against ``torch.nn.functional.ctc_loss``, and the example's CRNN from the
same weights: its first 3 Adam steps' losses within 1e-5 relative at
batch 4.  The ``gpu`` test holds the bidirectional LSTM layer on the card
against the plain loop on the CPU.
"""
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx

CPU = tmx.cpu()
TOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jmx():
    import mxnet_tpu as jmx

    return jmx


def _rel(got, want, tol=TOL, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale, \
        (what, float(np.abs(got - want).max()), scale)


def _labels(blank_label, rows):
    """Rows of labels for 11 classes, padded with the convention's pad."""
    pad = 0 if blank_label == "first" else -1
    shift = 1 if blank_label == "first" else 0
    out = np.full((len(rows), 4), pad, np.float32)
    for i, r in enumerate(rows):
        out[i, :len(r)] = np.asarray(r) + shift
    return out


# a plain row, repeated labels, a short row, a zero-length label, a row
# infeasible at T=5 (4 repeats need 7 steps), another plain row
ROWS = [[3, 1, 4, 1], [2, 2, 7], [5], [], [6, 6, 6, 6], [0, 9, 8]]


def _case(blank_label, data_lengths, label_lengths, T=12):
    rng = np.random.RandomState(len(ROWS) + T)
    data = rng.randn(T, len(ROWS), 11).astype(np.float32) * 2
    label = _labels(blank_label, ROWS)
    dl = np.array([T, T - 3, 4, T, 5, T], np.float32) if data_lengths \
        else None
    ll = np.array([len(r) for r in ROWS], np.float32) if label_lengths \
        else None
    return data, label, dl, ll


def _ctc(mx, data, label, dl, ll, blank_label, **kw):
    d = mx.nd.array(data, **kw)
    d.attach_grad()
    extra = [mx.nd.array(a, **kw) if a is not None else None
             for a in (dl, ll)]
    with mx.autograd.record():
        loss = mx.nd.CTCLoss(d, mx.nd.array(label, **kw), *extra,
                             use_data_lengths=dl is not None,
                             use_label_lengths=ll is not None,
                             blank_label=blank_label)
    loss.backward()
    return loss.asnumpy(), d.grad.asnumpy()


@pytest.mark.parametrize("label_lengths", [False, True],
                         ids=["counted", "label_lengths"])
@pytest.mark.parametrize("data_lengths", [False, True],
                         ids=["full", "data_lengths"])
@pytest.mark.parametrize("blank_label", ["first", "last"])
def test_ctc_op_matches_jax(blank_label, data_lengths, label_lengths):
    data, label, dl, ll = _case(blank_label, data_lengths, label_lengths)
    jl, jg = _ctc(_jmx(), data, label, dl, ll, blank_label)
    tl, tg = _ctc(tmx, data, label, dl, ll, blank_label, ctx=CPU)
    _rel(tl, jl, what="loss")
    _rel(tg, jg, what="grad")
    if data_lengths:
        # the row cut to 5 steps cannot fit 4 repeated labels
        assert 9e29 < tl[4] < 1.1e30
        assert (tl[[0, 1, 2, 3, 5]] < 1e3).all()


def test_ctc_aliases_and_short_data():
    """The aliases name the op; T shorter than every label (T=2)."""
    from mxnet_tpu_torch.ops import registry

    for name in ("ctc_loss", "_contrib_ctc_loss", "_contrib_CTCLoss"):
        assert registry.entry(name).name == "CTCLoss"
    data, label, _, _ = _case("last", False, False, T=2)
    got = tmx.nd.contrib.ctc_loss(tmx.nd.array(data, ctx=CPU),
                                  tmx.nd.array(label, ctx=CPU),
                                  blank_label="last").asnumpy()
    want = _jmx().nd.contrib.ctc_loss(_jmx().nd.array(data),
                                      _jmx().nd.array(label),
                                      blank_label="last").asnumpy()
    _rel(got, want, what="loss")


def test_ctc_feasible_rows_match_torch_ctc_loss():
    """``F.ctc_loss`` (blank last, targets the labels of each row) agrees
    on every row a path fits; the port gives ~1e30 where it gives inf."""
    data, label, dl, _ = _case("last", True, False)
    loss = tmx.nd.CTCLoss(tmx.nd.array(data, ctx=CPU),
                          tmx.nd.array(label, ctx=CPU),
                          tmx.nd.array(dl, ctx=CPU), use_data_lengths=True,
                          blank_label="last").asnumpy()
    logp = torch.log_softmax(torch.from_numpy(data), dim=-1)
    lab = torch.from_numpy(label).long()
    lens = (lab >= 0).sum(1)
    ref = torch.nn.functional.ctc_loss(
        logp, lab.clamp_min(0), torch.from_numpy(dl).long(), lens,
        blank=10, reduction="none", zero_infinity=False).numpy()
    feasible = np.isfinite(ref)
    assert feasible.sum() == len(ROWS) - 1 and not feasible[4]
    np.testing.assert_allclose(loss[feasible], ref[feasible], rtol=1e-5)
    assert loss[4] > 1e29


@pytest.mark.parametrize("layout,label_layout",
                         [("NTC", "NT"), ("TNC", "NT"), ("NTC", "TN"),
                          ("TNC", "TN")])
def test_gluon_ctc_loss_layouts(layout, label_layout):
    jmx = _jmx()
    T, N = 9, len(ROWS)
    pred = np.random.RandomState(3).randn(T, N, 11).astype(np.float32)
    label = _labels("last", ROWS)
    lens = np.array([T, T, 6, 3, T, 8], np.float32)
    if layout == "NTC":
        pred = pred.transpose(1, 0, 2).copy()
    if label_layout == "TN":
        label = label.T.copy()
    sw = np.random.RandomState(4).uniform(0.5, 1.5, (N,)).astype(np.float32)

    def run(mx, **kw):
        p = mx.nd.array(pred, **kw)
        p.attach_grad()
        loss_fn = mx.gluon.loss.CTCLoss(layout=layout,
                                        label_layout=label_layout)
        with mx.autograd.record():
            loss = loss_fn(p, mx.nd.array(label, **kw),
                           mx.nd.array(lens, **kw), None,
                           mx.nd.array(sw, **kw))
        loss.backward()
        return loss.asnumpy(), p.grad.asnumpy()

    jl, jg = run(jmx)
    tl, tg = run(tmx, ctx=CPU)
    _rel(tl, jl, what="loss")
    _rel(tg, jg, what="grad")


# -- the example's CRNN ---------------------------------------------------------


def _ocr_example():
    """``examples/ocr/train_crnn_ctc.py`` as a module (its ``CRNN`` is the
    JAX package's; ``render_batch`` is numpy)."""
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    spec = importlib.util.spec_from_file_location(
        "train_crnn_ctc", os.path.join(ROOT, "examples", "ocr",
                                       "train_crnn_ctc.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_crnn(mx, num_classes=11, hidden=64):
    """The example's CRNN over the port's gluon: two 3x3 convolutions with
    ReLU and (2, 1) max pooling, the columns as time steps into a
    bidirectional LSTM, a Dense head a step."""
    gluon = mx.gluon

    class CRNN(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.conv = gluon.nn.HybridSequential()
            self.conv.add(
                gluon.nn.Conv2D(16, 3, padding=1, activation="relu"),
                gluon.nn.MaxPool2D(pool_size=(2, 1)),
                gluon.nn.Conv2D(32, 3, padding=1, activation="relu"),
                gluon.nn.MaxPool2D(pool_size=(2, 1)))
            self.rnn = gluon.rnn.LSTM(hidden, num_layers=1,
                                      bidirectional=True)
            self.head = gluon.nn.Dense(num_classes, flatten=False)

        def hybrid_forward(self, F, x):
            f = self.conv(x)
            f = F.transpose(f, axes=(3, 0, 1, 2))
            f = F.reshape(f, shape=(0, 0, -1))
            return self.head(self.rnn(f))

    return CRNN()


def test_crnn_three_adam_steps_match_jax():
    jmx = _jmx()
    ocr = _ocr_example()
    B = 4
    imgs, _ = ocr.render_batch(np.random.RandomState(0), B, 4)
    jmx.random.seed(0)
    jnet = ocr.CRNN()
    jnet.initialize(jmx.init.Xavier())
    jnet.hybridize()
    jnet(jmx.nd.array(imgs))
    weights = {k: v.data().asnumpy()
               for k, v in jnet._collect_params_with_prefix().items()}
    with CPU:
        tnet = port_crnn(tmx)
        tnet.initialize(tmx.init.Xavier(), ctx=CPU)
        tnet.hybridize()
        tnet(tmx.nd.array(imgs, ctx=CPU))
        tmx.convert.load_numpy_params(tnet, weights)
    jloss_fn = jmx.gluon.loss.CTCLoss(layout="TNC")
    tloss_fn = tmx.gluon.loss.CTCLoss(layout="TNC")
    jtr = jmx.gluon.Trainer(jnet.collect_params(), "adam",
                            {"learning_rate": 1e-2})
    ttr = tmx.gluon.Trainer(tnet.collect_params(), "adam",
                            {"learning_rate": 1e-2})
    rng = np.random.RandomState(1)
    for step in range(3):
        imgs, labels = ocr.render_batch(rng, B, 4)
        with jmx.autograd.record():
            jlogits = jnet(jmx.nd.array(imgs))
            jloss = jloss_fn(jlogits, jmx.nd.array(labels) - 1)
        jloss.backward()
        jtr.step(B)
        with tmx.autograd.record():
            tlogits = tnet(tmx.nd.array(imgs, ctx=CPU))
            tloss = tloss_fn(tlogits, tmx.nd.array(labels, ctx=CPU) - 1)
        tloss.backward()
        ttr.step(B)
        _rel(tloss.asnumpy(), jloss.asnumpy(), what=f"step {step} losses")
        _rel(tlogits.asnumpy(), jlogits.asnumpy(), tol=1e-4,
             what=f"step {step} logits")


# -- on the card ------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device (the CPU runs the port's plain ops); "
                    "run on the GPU machine with -m gpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return tmx.gpu(0)


@pytest.mark.gpu
def test_bidirectional_lstm_on_card_matches_plain_loop(cuda_device):
    """``gluon.rnn.LSTM(64, bidirectional=True)`` at the CRNN's shape
    (T=20, N=32, input 64): both directions' outputs, final states and
    every gradient on the card (the recurrence kernels, register route)
    against the plain loop on the CPU, 2 forward and 2 backward launches,
    no plain call on CUDA."""
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.ops.kernels import rnn as krnn

    T, N, I, H = 20, 32, 64, 64
    rng = np.random.RandomState(5)
    x = rng.randn(T, N, I).astype(np.float32)
    h0 = rng.randn(2, N, H).astype(np.float32) * 0.1
    c0 = rng.randn(2, N, H).astype(np.float32) * 0.1
    c = rng.uniform(0.5, 1.5, (T, N, 2 * H)).astype(np.float32)
    tmx.random.seed(5)
    with CPU:
        ref = tmx.gluon.rnn.LSTM(H, bidirectional=True, input_size=I)
        ref.initialize(tmx.init.Xavier(), ctx=CPU)
    weights = {k: p.data().detach().numpy()
               for k, p in ref._collect_params_with_prefix().items()}
    card = tmx.gluon.rnn.LSTM(H, bidirectional=True, input_size=I)
    card.initialize(ctx=cuda_device)
    tmx.convert.load_numpy_params(card, weights)

    def run(net, ctx):
        xs = tmx.nd.array(x, ctx=ctx)
        states = [tmx.nd.array(h0, ctx=ctx), tmx.nd.array(c0, ctx=ctx)]
        xs.attach_grad()
        for s in states:
            s.attach_grad()
        with tmx.autograd.record():
            out, (hn, cn) = net(xs, states)
            loss = (out * tmx.nd.array(c, ctx=ctx)).sum() + hn.sum() \
                + (cn * 2).sum()
        loss.backward()
        grads = {k: p.grad().detach().cpu().numpy()
                 for k, p in net._collect_params_with_prefix().items()}
        grads.update(dx=xs.grad.asnumpy(), dh0=states[0].grad.asnumpy(),
                     dc0=states[1].grad.asnumpy())
        return [out.asnumpy(), hn.asnumpy(), cn.asnumpy()], grads

    want, wgrads = run(ref, CPU)
    kernels.reset_counts()
    got, ggrads = run(card, cuda_device)
    torch.cuda.synchronize()
    for name, g, w in zip(("out", "hn", "cn"), got, want):
        _rel(g, w, tol=1e-4, what=name)
    for k in wgrads:
        _rel(ggrads[k], wgrads[k], tol=1e-4, what=k)
    assert krnn.lstm_fwd_counts.reg_launches == 2
    assert krnn.lstm_bwd_counts.reg_launches == 2
    assert krnn.lstm_fwd_counts.split_launches == 0
    assert krnn.lstm_bwd_counts.split_launches == 0
    assert all(cnt.plain_calls_on_cuda == 0
               for cnt in kernels.KERNEL_COUNTS.values())
