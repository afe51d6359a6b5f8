"""The LSTM and GRU recurrences of the PyTorch port against the JAX package.

On the CPU each wrapper takes its kernel's plain version.  The plain
versions are held against the JAX Pallas kernels
(``mxnet_tpu.ops.pallas.rnn.lstm_layer``/``gru_layer``) run in interpret
mode (the ``interpret_pallas`` fixture), forward outputs, saved tensors
and every gradient; then the ``RNN`` op against the JAX op for every mode,
uni- and bidirectional, with gradients of a scalar loss against
``jax.grad``; then ``gluon.rnn.LSTM``/``GRU`` with weights carried across.
Inputs are numpy from a seed.  The tests marked ``gpu`` hold each CUDA
kernel against its plain version on the card.

Tolerances, fp32.  Forward outputs within 1e-5 absolute (the same sums in
other orders, through at most 12 steps of bounded activations); gradients
within 1e-4 absolute plus 1e-4 relative (sums over T*N rows).  fp16 (the
AMP layers: x_proj, Wh, the states, ys, hn and cn in float16; gates, cell
states and every sum in fp32): ys, hn and cn within 1e-3 (two fp16 ulps of
values below 1: the same fp32 values may round to neighbouring fp16), the
fp32 gates and cell states within fp32's 1e-5; gradients rounded to fp16
at the end within 2e-3 of their largest magnitude plus 2e-3 relative (one
fp16 rounding of sums that read the rounded ys as h_prev).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import rnn as trnn
from mxnet_tpu_torch.ops.kernels import rnn as tk

FWD_TOL = dict(atol=1e-5, rtol=0)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
F16_OUT_TOL = dict(atol=1e-3, rtol=0)


def _close_f16_grad(got, ref, name):
    """A float16 gradient: 2e-3 of the largest magnitude plus 2e-3
    relative (the module's docstring)."""
    ref = np.asarray(ref, np.float32)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), ref,
                               atol=2e-3 * scale, rtol=2e-3, err_msg=name)


def _np(t):
    return t.detach().float().numpy()


def _inputs(T, N, H, G, seed, wscale=0.3):
    rng = np.random.RandomState(seed)
    return dict(
        xp=rng.randn(T, N, G * H).astype(np.float32) * 0.5,
        wh=rng.randn(G * H, H).astype(np.float32) * wscale,
        bh=rng.randn(G * H).astype(np.float32) * 0.1,
        h0=rng.randn(N, H).astype(np.float32) * 0.1,
        c0=rng.randn(N, H).astype(np.float32) * 0.1,
        dys=rng.randn(T, N, H).astype(np.float32),
        dhn=rng.randn(N, H).astype(np.float32),
        dcn=rng.randn(N, H).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


# (6, 19, 40): DeepAR's width over more rows than one 16-row tile;
# (4, 32, 40): DeepAR training's rows and width
@pytest.mark.parametrize("T,N,H", [(5, 4, 8), (12, 3, 40), (6, 19, 40),
                                   (4, 32, 40)])
def test_lstm_plain_matches_jax_kernel(interpret_pallas, T, N, H):
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.ops.pallas import rnn as jrnn

    a = _inputs(T, N, H, 4, seed=T)
    jin = [jnp.asarray(a[k]) for k in ("xp", "wh", "h0", "c0")]
    jys, jhn, jcn, jgates, jcs = jrnn._lstm_forward(*jin)
    jouts, vjp = jax.vjp(jrnn.lstm_layer, *jin)
    jgrads = vjp(tuple(jnp.asarray(a[k]) for k in ("dys", "dhn", "dcn")))

    xp, wh, h0, c0 = _t(a["xp"], a["wh"], a["h0"], a["c0"])
    ys, hn, cn, gates, cs = tk.lstm_fwd_plain(xp, wh, h0, c0)
    for got, ref in zip((ys, hn, cn, gates, cs),
                        (jys, jhn, jcn, jgates, jcs)):
        np.testing.assert_allclose(_np(got), np.asarray(ref), **FWD_TOL)
    cot = _t(a["dys"], a["dhn"], a["dcn"])
    plain = tk.lstm_bwd_plain(wh, h0, c0, ys, gates, cs, *cot)
    ins = [t.clone().requires_grad_(True) for t in (xp, wh, h0, c0)]
    outs = tk.lstm_layer(*ins)
    func = torch.autograd.grad(outs, ins, cot)
    for name, p, f, r in zip(("dxp", "dwh", "dh0", "dc0"), plain, func,
                             jgrads):
        np.testing.assert_allclose(_np(p), np.asarray(r), err_msg=name,
                                   **GRAD_TOL)
        np.testing.assert_allclose(_np(f), np.asarray(r), err_msg=name,
                                   **GRAD_TOL)


# (4, 5, 200): the GRU phase's width, which the cluster routes take;
# (3, 32, 200): the GRU phase's rows and width
@pytest.mark.parametrize("T,N,H", [(5, 4, 8), (12, 3, 40), (4, 5, 200),
                                   (3, 32, 200)])
def test_gru_plain_matches_jax_kernel(interpret_pallas, T, N, H):
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.ops.pallas import rnn as jrnn

    a = _inputs(T, N, H, 3, seed=T + 1)
    jin = [jnp.asarray(a[k]) for k in ("xp", "wh", "bh", "h0")]
    jys, jhn, jgates, jhl = jrnn._gru_forward(*jin)
    _, vjp = jax.vjp(jrnn.gru_layer, *jin)
    jgrads = vjp((jnp.asarray(a["dys"]), jnp.asarray(a["dhn"])))

    xp, wh, bh, h0 = _t(a["xp"], a["wh"], a["bh"], a["h0"])
    ys, hn, gates, hl = tk.gru_fwd_plain(xp, wh, bh, h0)
    for got, ref in zip((ys, hn, gates, hl), (jys, jhn, jgates, jhl)):
        np.testing.assert_allclose(_np(got), np.asarray(ref), **FWD_TOL)
    cot = _t(a["dys"], a["dhn"])
    plain = tk.gru_bwd_plain(wh, h0, ys, gates, hl, *cot)
    ins = [t.clone().requires_grad_(True) for t in (xp, wh, bh, h0)]
    func = torch.autograd.grad(tk.gru_layer(*ins), ins, cot)
    for name, p, f, r in zip(("dxp", "dwh", "dbh", "dh0"), plain, func,
                             jgrads):
        np.testing.assert_allclose(_np(p), np.asarray(r), err_msg=name,
                                   **GRAD_TOL)
        np.testing.assert_allclose(_np(f), np.asarray(r), err_msg=name,
                                   **GRAD_TOL)


def _f16_inputs(a, keys):
    """``a``'s arrays of ``keys`` rounded to float16, as numpy."""
    return [a[k].astype(np.float16) for k in keys]


@pytest.mark.parametrize("T,N,H", [(5, 4, 8), (12, 3, 40), (6, 32, 64)])
def test_lstm_plain_matches_jax_kernel_in_float16(interpret_pallas, T, N, H):
    """The plain forward and backward in float16 (as AMP runs the layer)
    against the JAX kernels in float16: ys, hn, cn float16, gates and cell
    states fp32, dxp, dwh, dh0, dc0 float16 through the autograd Function;
    the plain backward's fp32 gradients before that rounding."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.ops.pallas import rnn as jrnn

    a = _inputs(T, N, H, 4, seed=T + 40, wscale=H ** -0.5)
    keys = ("xp", "wh", "h0", "c0")
    h16 = _f16_inputs(a, keys)
    jin = [jnp.asarray(v) for v in h16]
    jys, jhn, jcn, jgates, jcs = jrnn._lstm_forward(*jin)
    _, vjp = jax.vjp(jrnn.lstm_layer, *jin)
    cot = [a[k].astype(np.float16) for k in ("dys", "dhn", "dcn")]
    jgrads = vjp(tuple(jnp.asarray(c) for c in cot))
    ins = [torch.from_numpy(v.copy()) for v in h16]
    fwd = tk.lstm_fwd_plain(*ins)
    assert [t.dtype for t in fwd] == [torch.float16] * 3 + [torch.float32] * 2
    for name, got, ref in zip(("ys", "hn", "cn", "gates", "cs"), fwd,
                              (jys, jhn, jcn, jgates, jcs)):
        tol = F16_OUT_TOL if got.dtype == torch.float16 else FWD_TOL
        np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32),
                                   err_msg=name, **tol)
    tcot = [torch.from_numpy(c.copy()) for c in cot]
    plain = tk.lstm_bwd_plain(ins[1], ins[2], ins[3], fwd[0], fwd[3],
                              fwd[4], tcot[0].float(), *tcot[1:])
    req = [t.clone().requires_grad_(True) for t in ins]
    func = torch.autograd.grad(tk.lstm_layer(*req), req, tcot)
    for name, p, f, r in zip(("dxp", "dwh", "dh0", "dc0"), plain, func,
                             jgrads):
        assert f.dtype == torch.float16 and r.dtype == jnp.float16, name
        _close_f16_grad(_np(p), r, name)
        _close_f16_grad(_np(f), r, name)


@pytest.mark.parametrize("T,N,H", [(5, 4, 8), (12, 3, 40), (4, 32, 200)])
def test_gru_plain_matches_jax_kernel_in_float16(interpret_pallas, T, N, H):
    """As the LSTM's float16 test, for the GRU: dbh comes back in wh's
    dtype (float16)."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.ops.pallas import rnn as jrnn

    a = _inputs(T, N, H, 3, seed=T + 41, wscale=H ** -0.5)
    h16 = _f16_inputs(a, ("xp", "wh", "bh", "h0"))
    jin = [jnp.asarray(v) for v in h16]
    jys, jhn, jgates, jhl = jrnn._gru_forward(*jin)
    _, vjp = jax.vjp(jrnn.gru_layer, *jin)
    cot = [a[k].astype(np.float16) for k in ("dys", "dhn")]
    jgrads = vjp(tuple(jnp.asarray(c) for c in cot))
    ins = [torch.from_numpy(v.copy()) for v in h16]
    fwd = tk.gru_fwd_plain(*ins)
    assert [t.dtype for t in fwd] == [torch.float16] * 2 + [torch.float32] * 2
    for name, got, ref in zip(("ys", "hn", "gates", "hn_lin"), fwd,
                              (jys, jhn, jgates, jhl)):
        tol = F16_OUT_TOL if got.dtype == torch.float16 else FWD_TOL
        np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32),
                                   err_msg=name, **tol)
    tcot = [torch.from_numpy(c.copy()) for c in cot]
    plain = tk.gru_bwd_plain(ins[1], ins[3], fwd[0], fwd[2], fwd[3],
                             tcot[0].float(), tcot[1])
    req = [t.clone().requires_grad_(True) for t in ins]
    func = torch.autograd.grad(tk.gru_layer(*req), req, tcot)
    for name, p, f, r in zip(("dxp", "dwh", "dbh", "dh0"), plain, func,
                             jgrads):
        assert f.dtype == torch.float16 and r.dtype == jnp.float16, name
        _close_f16_grad(_np(p), r, name)
        _close_f16_grad(_np(f), r, name)


def _tf32_split(x):
    """``csrc/tf32x3.cuh``'s split of fp32 ``x``: hi is x rounded to TF32
    on its bits, ``(bits + 0x1000) & 0xffffe000``; lo = x - hi in fp32, as
    the tensor core reads it (truncated to TF32)."""
    mask = np.uint32(0xffffe000)
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    hi = ((bits + np.uint32(0x1000)) & mask).view(np.float32)
    lo = (x - hi).astype(np.float32)
    return hi, (lo.view(np.uint32) & mask).view(np.float32)


def _tf32x3_matmul(a, b):
    """``a @ b`` as the tensor-core route forms it: lo*hi, hi*lo, then
    hi*hi, each product of TF32 values exact in fp32, summed in fp32."""
    ah, al = _tf32_split(a)
    bh, bl = _tf32_split(b)
    return ((al @ bh) + (ah @ bl)) + (ah @ bh)


def _sigmoid(x):
    return (1.0 / (1.0 + np.exp(-x))).astype(np.float32)


# DeepAR's training shape, and predict's rows at a shorter path
@pytest.mark.parametrize("T,N,H", [(96, 32, 40), (24, 1600, 40)])
def test_tf32x3_products_keep_the_lstm_forward_within_card_tol(T, N, H):
    """The tensor-core route's premise, checked on the CPU: with every
    step's h @ Wh^T formed as 3xTF32 (h split every step, Wh once), the
    forward recurrence stays within CARD_TOL["float32"] of the fp32 plain
    version, every output, over all T dependent steps."""
    a = _inputs(T, N, H, 4, seed=T + N, wscale=H ** -0.5)
    w = a["wh"].reshape(4 * H, H)
    h, c = a["h0"], a["c0"]
    ys, gates, cs = [], [], []
    for t in range(T):
        pre = a["xp"][t] + _tf32x3_matmul(h, w.T)
        i, f, o = (_sigmoid(pre[:, k * H:(k + 1) * H]) for k in (0, 1, 3))
        g = np.tanh(pre[:, 2 * H:3 * H])
        c = (f * c + i * g).astype(np.float32)
        h = (o * np.tanh(c)).astype(np.float32)
        ys.append(h)
        gates.append(np.stack((i, f, g, o), 1))
        cs.append(c)
    ref = tk.lstm_fwd_plain(*_t(a["xp"], a["wh"], a["h0"], a["c0"]))
    got = (np.stack(ys), h, c, np.stack(gates), np.stack(cs))
    for name, m, r in zip(("ys", "hn", "cn", "gates", "cs"), got, ref):
        _close_card(torch.from_numpy(np.ascontiguousarray(m)), r,
                    "float32", name)
    # one TF32 product alone (no lo terms) keeps ~11 bits: the premise
    # fails without the split
    hi = lambda x: _tf32_split(x)[0]  # noqa: E731
    one = a["xp"][0] + hi(a["h0"]) @ hi(w).T
    exact = a["xp"][0] + a["h0"].astype(np.float64) @ w.T.astype(np.float64)
    three = a["xp"][0] + _tf32x3_matmul(a["h0"], w.T)
    assert np.abs(one - exact).max() > 10 * np.abs(three - exact).max()


def _lstm_bwd_register_order(a, ys, gates, cs):
    """The LSTM backward as its register route sums, in fp32 numpy: per
    step, lane (u, q) forms sum_j dgp_q[j] * Wh[q][j][u] in four
    interleaved partial sums (j mod 4) over Wh's column zero-padded to KP
    (H rounded up to 8), each quad's four partials are added in the fixed
    order ((p_i + p_f) + p_g) + p_o, and dh, dc carry over.  Returns
    ``(dxp, dwh, dh0, dc0)``, dwh as one product after the recurrence."""
    T, N, H = ys.shape
    KP = -(-H // 8) * 8
    w = np.zeros((4, KP, H), np.float32)  # w[q, j, u] = Wh[q][j][u]
    w[:, :H] = a["wh"].reshape(4, H, H)
    dh, dc = a["dhn"], a["dcn"]
    dg = np.zeros((N, 4, KP), np.float32)
    dxp = np.zeros((T, N, 4, H), np.float32)
    one = np.float32(1)
    for t in reversed(range(T)):
        if t < T - 1:
            acc = np.zeros((4, N, 4, H), np.float32)  # partial m, n, q, u
            for k4 in range(KP // 4):
                for m in range(4):
                    j = 4 * k4 + m
                    acc[m] += dg[:, :, j, None] * w[None, :, j]
            p = (acc[0] + acc[1]) + (acc[2] + acc[3])
            dh = ((p[:, 0] + p[:, 1]) + p[:, 2]) + p[:, 3]
        i, f, g, o = (gates[t, :, q] for q in range(4))
        cp = cs[t - 1] if t > 0 else a["c0"]
        dhv = dh + a["dys"][t]
        tc = np.tanh(cs[t])
        dcv = dhv * o * (one - tc * tc) + dc
        dgp = ((dcv * g) * i * (one - i), (dcv * cp) * f * (one - f),
               (dcv * i) * (one - g * g), (dhv * tc) * o * (one - o))
        for q in range(4):
            dg[:, q, :H] = dxp[t, :, q] = dgp[q]
        dc = dcv * f
    acc = np.zeros((4, N, 4, H), np.float32)
    for k4 in range(KP // 4):
        for m in range(4):
            acc[m] += dg[:, :, 4 * k4 + m, None] * w[None, :, 4 * k4 + m]
    p = (acc[0] + acc[1]) + (acc[2] + acc[3])
    dh = ((p[:, 0] + p[:, 1]) + p[:, 2]) + p[:, 3]
    h_prev = np.concatenate([a["h0"][None], ys[:-1]], 0).reshape(T * N, H)
    dwh = dxp.reshape(T * N, 4 * H).T @ h_prev
    return dxp.reshape(T, N, 4 * H), dwh, dh, dc


# DeepAR training's shape, and a ragged width (KP = 24 > H = 17)
@pytest.mark.parametrize("T,N,H", [(96, 32, 40), (12, 3, 17)])
def test_register_order_keeps_the_lstm_backward_within_card_tol(
        interpret_pallas, T, N, H):
    """The LSTM backward's register route, its summation order modelled on
    the CPU (:func:`_lstm_bwd_register_order`), stays within
    CARD_TOL["float32"] of the JAX kernel, every output, over all T
    dependent steps."""
    import jax.numpy as jnp
    from mxnet_tpu.ops.pallas import rnn as jrnn

    a = _inputs(T, N, H, 4, seed=T + H, wscale=H ** -0.5)
    jin = [jnp.asarray(a[k]) for k in ("xp", "wh", "h0", "c0")]
    ys, _, _, gates, cs = (np.asarray(x) for x in jrnn._lstm_forward(*jin))
    ref = jrnn._lstm_backward(jin[1], jin[2], jin[3], ys, gates, cs,
                              *(jnp.asarray(a[k])
                                for k in ("dys", "dhn", "dcn")))
    got = _lstm_bwd_register_order(a, ys, gates, cs)
    for name, m, r in zip(("dxp", "dwh", "dh0", "dc0"), got, ref):
        r = torch.from_numpy(np.array(r).reshape(m.shape))
        _close_card(torch.from_numpy(np.ascontiguousarray(m)), r, "float32",
                    name)


def _gru_fwd_cluster_order(a, JB):
    """The GRU forward as its cluster route sums, in fp32 numpy: block
    units of JB, each product of a unit's row of Wh[g] with h split over
    chunks of ch float4 columns (the layout's, from 256 threads a block),
    two partial sums a chunk (components x, z and y, w), the chunks'
    partials added in order, then bh.  Returns ``(ys, hn, gates,
    hn_lin)``."""
    T, N, G3 = a["xp"].shape
    H = G3 // 3
    hk = -(-H // 4) * 4
    k4 = hk // 4
    s = min(max(256 // JB, 1), k4)
    ch = -(-k4 // s)
    w = np.zeros((3, H, hk), np.float32)
    w[:, :, :H] = a["wh"].reshape(3, H, H)
    b = a["bh"].reshape(3, H)
    xp = a["xp"].reshape(T, N, 3, H)
    h = a["h0"].copy()
    ys, gates, hl = [], [], []
    one = np.float32(1)
    for t in range(T):
        hp = np.zeros((N, hk), np.float32)
        hp[:, :H] = h
        gh = np.zeros((3, N, H), np.float32)
        for c0 in range(0, k4, ch):
            acc = np.zeros((2, 3, N, H), np.float32)
            for k in range(c0, min(c0 + ch, k4)):
                for m in range(4):
                    kk = 4 * k + m
                    acc[m % 2] += hp[None, :, kk, None] * w[:, None, :, kk]
            gh = gh + (acc[0] + acc[1])
        gh = gh + b[:, None]
        r = (one / (one + np.exp(-(xp[t, :, 0] + gh[0])))).astype(np.float32)
        z = (one / (one + np.exp(-(xp[t, :, 1] + gh[1])))).astype(np.float32)
        n = np.tanh(xp[t, :, 2] + r * gh[2])
        h = (one - z) * n + z * h
        ys.append(h)
        gates.append(np.stack((r, z, n), 1))
        hl.append(gh[2])
    return np.stack(ys), h, np.stack(gates), np.stack(hl)


# the GRU phase's shape (clusters of 8 blocks of 25 units), and a width
# whose last float4 column and last block are ragged
@pytest.mark.parametrize("T,N,H,JB", [(35, 32, 200, 25), (6, 3, 97, 25)])
def test_cluster_order_keeps_the_gru_forward_within_card_tol(
        interpret_pallas, T, N, H, JB):
    """The GRU forward's cluster route, its summation order modelled on
    the CPU (:func:`_gru_fwd_cluster_order`), stays within
    CARD_TOL["float32"] of the JAX kernel, every output, over all T
    dependent steps."""
    import jax.numpy as jnp
    from mxnet_tpu.ops.pallas import rnn as jrnn

    a = _inputs(T, N, H, 3, seed=T + H, wscale=H ** -0.5)
    ref = jrnn._gru_forward(*(jnp.asarray(a[k])
                              for k in ("xp", "wh", "bh", "h0")))
    got = _gru_fwd_cluster_order(a, JB)
    for name, m, r in zip(("ys", "hn", "gates", "hn_lin"), got, ref):
        _close_card(torch.from_numpy(np.ascontiguousarray(m)),
                    torch.from_numpy(np.array(r)), "float32", name)


def test_missing_cotangents_are_zeros_and_dtypes_follow_inputs():
    """A loss of ys alone leaves hn/cn without cotangents (zeros, as the
    JAX rule's ``_is_zero``); in bf16, dxp comes back in ys's dtype and
    dwh in wh's."""
    a = _inputs(4, 2, 8, 4, seed=9)
    xp, wh, h0, c0 = _t(a["xp"], a["wh"], a["h0"], a["c0"])
    ins = [t.clone().requires_grad_(True) for t in (xp, wh, h0, c0)]
    got = torch.autograd.grad(tk.lstm_layer(*ins)[0].sum(), ins)
    ref_ins = [t.clone().requires_grad_(True) for t in (xp, wh, h0, c0)]
    ref = torch.autograd.grad(tk.lstm_layer_plain(*ref_ins)[0].sum(),
                              ref_ins)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(_np(g), _np(r), **GRAD_TOL)
    b16 = [xp.to(torch.bfloat16).requires_grad_(True),
           wh.clone().requires_grad_(True), h0, c0]
    ys, hn, cn = tk.lstm_layer(*b16)
    assert ys.dtype == hn.dtype == cn.dtype == torch.bfloat16
    dxp, dwh = torch.autograd.grad(ys.float().sum(), b16[:2])
    assert dxp.dtype == torch.bfloat16 and dwh.dtype == torch.float32


def _op_inputs(mode, bidirectional, T=5, N=3, I=6, H=8, L=2, seed=0):
    d = 2 if bidirectional else 1
    rng = np.random.RandomState(seed)
    psize = trnn.rnn_param_size(L, I, H, mode, bidirectional)
    return dict(data=rng.randn(T, N, I).astype(np.float32) * 0.5,
                params=rng.randn(psize).astype(np.float32) * 0.3,
                state=rng.randn(L * d, N, H).astype(np.float32) * 0.1,
                cell=rng.randn(L * d, N, H).astype(np.float32) * 0.1,
                wy=rng.randn(T, N, d * H).astype(np.float32), H=H, L=L)


def _op_loss(outs, wy):
    out, *states = outs
    loss = (out * wy).sum()
    for s in states:
        loss = loss + (s * s).sum()
    return loss


@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
def test_rnn_op_matches_jax(mode, bidirectional, monkeypatch):
    """Outputs, states and the gradients of a scalar loss (data, flat
    parameters, states) against the JAX op and ``jax.grad``; the LSTM and
    GRU also through ``MXTPU_RNN_IMPL=pallas``, the port's kernel path
    (its plain versions on the CPU)."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.ops import rnn as jrnn

    a = _op_inputs(mode, bidirectional)
    kw = dict(state_size=a["H"], num_layers=a["L"], mode=mode,
              bidirectional=bidirectional)
    lstm = mode == "lstm"
    names = ["data", "params", "state"] + (["cell"] if lstm else [])

    def jfn(*args):
        return jrnn._k_rnn(*args, **kw)

    jargs = [jnp.asarray(a[k]) for k in names]
    jouts = jfn(*jargs)
    jgrads = jax.grad(lambda *x: _op_loss(jfn(*x), a["wy"]),
                      argnums=tuple(range(len(names))))(*jargs)
    for impl in ("auto", "pallas") if mode in ("lstm", "gru") else ("auto",):
        monkeypatch.setenv("MXTPU_RNN_IMPL", impl)
        targs = [torch.from_numpy(a[k]).requires_grad_(True) for k in names]
        touts = trnn._k_rnn(*targs, **kw)
        assert len(touts) == len(jouts)
        for t, j in zip(touts, jouts):
            np.testing.assert_allclose(_np(t), np.asarray(j), err_msg=impl,
                                       **FWD_TOL)
        tgrads = torch.autograd.grad(
            _op_loss(touts, torch.from_numpy(a["wy"])), targs)
        for name, t, j in zip(names, tgrads, jgrads):
            np.testing.assert_allclose(_np(t), np.asarray(j),
                                       err_msg=f"{impl} {name}", **GRAD_TOL)


def test_scan_impl_sends_every_call_to_the_loop(monkeypatch):
    """``scan`` never reaches the kernel entries; ``pallas`` does, once per
    layer and direction; the two agree."""
    calls = []
    real = tk.lstm_layer
    monkeypatch.setattr(tk, "lstm_layer",
                        lambda *x: calls.append(1) or real(*x))
    a = _op_inputs("lstm", True)
    args = [torch.from_numpy(a[k]) for k in ("data", "params", "state",
                                              "cell")]
    kw = dict(state_size=a["H"], num_layers=a["L"], bidirectional=True)
    outs = {}
    for impl in ("scan", "pallas"):
        monkeypatch.setenv("MXTPU_RNN_IMPL", impl)
        outs[impl] = trnn._k_rnn(*args, **kw)
        assert len(calls) == (0 if impl == "scan" else 4)
    for s, p in zip(outs["scan"], outs["pallas"]):
        np.testing.assert_allclose(_np(s), _np(p), **FWD_TOL)
    monkeypatch.setenv("MXTPU_RNN_IMPL", "bogus")
    with pytest.raises(MXNetError, match="MXTPU_RNN_IMPL"):
        trnn._k_rnn(*args, **kw)


@pytest.mark.parametrize("kw", [dict(projection_size=4),
                                dict(lstm_state_clip_min=-1.0),
                                dict(lstm_state_clip_max=1.0),
                                dict(use_sequence_length=True)])
def test_keywords_the_jax_op_ignores_raise(kw):
    a = _op_inputs("lstm", False)
    args = [torch.from_numpy(a[k]) for k in ("data", "params", "state",
                                              "cell")]
    with pytest.raises(MXNetError, match=next(iter(kw))):
        trnn._k_rnn(*args, state_size=a["H"], num_layers=a["L"], **kw)


def test_inter_layer_dropout_only_in_training_and_below_the_last_layer():
    a = _op_inputs("gru", False, L=2)
    args = [torch.from_numpy(a[k]) for k in ("data", "params", "state")]
    kw = dict(state_size=a["H"], num_layers=2, mode="gru")
    base = trnn._k_rnn(*args, **kw)
    evald = trnn._k_rnn(*args, p=0.5, _train=False, **kw)
    tmx.random.seed(3)
    train = trnn._k_rnn(*args, p=0.5, _train=True, **kw)
    tmx.random.seed(3)
    again = trnn._k_rnn(*args, p=0.5, _train=True, **kw)
    assert all(torch.equal(x, y) for x, y in zip(base, evald))
    assert not torch.allclose(base[0], train[0])
    assert all(torch.equal(x, y) for x, y in zip(train, again))
    # one layer: nothing below the last layer to drop
    a1 = _op_inputs("gru", False, L=1)
    args1 = [torch.from_numpy(a1[k]) for k in ("data", "params", "state")]
    one = dict(state_size=a1["H"], num_layers=1, mode="gru")
    assert all(torch.equal(x, y) for x, y in zip(
        trnn._k_rnn(*args1, **one),
        trnn._k_rnn(*args1, p=0.5, _train=True, **one)))


def test_rnn_param_size_and_gate_equal_jax():
    from mxnet_tpu.ops import rnn as jrnn

    for mode in ("lstm", "gru", "rnn_tanh", "rnn_relu"):
        for L, I, H, bi in ((1, 3, 8, False), (2, 6, 40, True),
                            (3, 200, 200, False)):
            assert trnn.rnn_param_size(L, I, H, mode, bi) == \
                jrnn.rnn_param_size(L, I, H, mode, bi)
    for G in (3, 4):
        for N in (1, 8, 32, 100, 1600, 2500):
            for H in (8, 40, 128, 200, 512, 559, 560, 640, 700):
                assert trnn._lstm_kernel_fits(N, H, G) == \
                    jrnn._pallas_lstm_fits(N, H, G), (N, H, G)


def test_cpu_pallas_routes_follow_the_jax_rule(monkeypatch):
    """On the CPU, ``pallas`` routes as the JAX package does: the kernel
    entry where its size rule takes the size, the loop where it does not."""
    calls = []
    real = tk.lstm_layer
    monkeypatch.setattr(tk, "lstm_layer",
                        lambda *x: calls.append(1) or real(*x))
    monkeypatch.setenv("MXTPU_RNN_IMPL", "pallas")
    for H, launched in ((700, 0), (8, 1)):
        assert trnn._lstm_kernel_fits(1, H) == bool(launched)
        a = _op_inputs("lstm", False, T=2, N=1, I=3, H=H, L=1)
        args = [torch.from_numpy(a[k]) for k in ("data", "params", "state",
                                                  "cell")]
        before = len(calls)
        out = trnn._k_rnn(*args, state_size=H, num_layers=1)
        assert len(calls) - before == launched
        assert out[0].shape == (2, 1, H)


def _wrapper_args(name):
    """Valid CPU arguments of one wrapper, from a seed."""
    G = 4 if name.startswith("lstm") else 3
    t = {k: torch.from_numpy(v) for k, v in _inputs(3, 2, 4, G, 5).items()}
    if name == "lstm_fwd":
        return [t["xp"], t["wh"], t["h0"], t["c0"]]
    if name == "gru_fwd":
        return [t["xp"], t["wh"], t["bh"], t["h0"]]
    if name == "lstm_bwd":
        ys, _, _, gates, cs = tk.lstm_fwd_plain(t["xp"], t["wh"], t["h0"],
                                                t["c0"])
        return [t["wh"], t["h0"], t["c0"], ys, gates, cs, t["dys"], t["dhn"],
                t["dcn"]]
    ys, _, gates, hn_lin = tk.gru_fwd_plain(t["xp"], t["wh"], t["bh"],
                                            t["h0"])
    return [t["wh"], t["h0"], ys, gates, hn_lin, t["dys"], t["dhn"]]


_WRAPPER_ARITY = {"lstm_fwd": 4, "lstm_bwd": 9, "gru_fwd": 4, "gru_bwd": 7}


@pytest.mark.parametrize("fault", ["shape", "device"])
@pytest.mark.parametrize("name,arg", [(n, i) for n, k in _WRAPPER_ARITY.items()
                                      for i in range(k)])
def test_wrappers_reject_mismatched_inputs(name, arg, fault):
    """Every input of every wrapper is checked before the dispatch: one
    with its last dimension cut by one, or on another device (``meta``
    here), raises instead of reaching a kernel or its plain version."""
    args = _wrapper_args(name)
    fn = getattr(tk, name)
    fn(*args)  # the valid call runs
    args[arg] = args[arg][..., :-1] if fault == "shape" else \
        args[arg].to("meta")
    with pytest.raises(MXNetError, match=name):
        fn(*args)


def _carry(jnet, tnet):
    tmx.load_numpy_params(tnet, {
        k: p.data().asnumpy() for k, p in
        jnet._collect_params_with_prefix().items()})


@pytest.mark.parametrize("with_states", [False, True])
@pytest.mark.parametrize("layout", ["TNC", "NTC"])
@pytest.mark.parametrize("cls", ["LSTM", "GRU"])
def test_gluon_layers_match_jax(cls, layout, with_states):
    import mxnet_tpu as jmx

    T, N, I, H = 6, 2, 5, 8
    rng = np.random.RandomState(4)
    x = rng.randn(*((T, N, I) if layout == "TNC" else (N, T, I))) \
        .astype(np.float32)
    jlayer = getattr(jmx.gluon.rnn, cls)(H, num_layers=2, layout=layout)
    jlayer.initialize()
    tlayer = getattr(tmx.gluon.rnn, cls)(H, num_layers=2, layout=layout)
    tlayer.initialize(ctx=tmx.cpu())
    nstate = 2 if cls == "LSTM" else 1
    states = [rng.randn(2, N, H).astype(np.float32) * 0.1
              for _ in range(nstate)]
    if with_states:
        jout, jst = jlayer(jmx.nd.array(x), [jmx.nd.array(s)
                                             for s in states])
    else:
        jout = jlayer(jmx.nd.array(x))
    _carry(jlayer, tlayer)
    tx = tmx.nd.array(x, ctx=tmx.cpu())
    if with_states:
        tout, tst = tlayer(tx, [tmx.nd.array(s, ctx=tmx.cpu())
                                for s in states])
        assert len(tst) == len(jst) == nstate
        for t, j in zip(tst, jst):
            np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), **FWD_TOL)
    else:
        tout = tlayer(tx)
    assert isinstance(tout, tmx.nd.NDArray)
    np.testing.assert_allclose(tout.asnumpy(), jout.asnumpy(), **FWD_TOL)


def test_begin_state_follows_the_input_device():
    layer = tmx.gluon.rnn.LSTM(4, num_layers=2, bidirectional=True)
    layer.initialize(ctx=tmx.cpu())
    states = layer.begin_state(3, ctx=tmx.cpu())
    assert [s.shape for s in states] == [(4, 3, 4), (4, 3, 4)]
    assert all(s.context == tmx.cpu() for s in states)
    # no context set and no card: the default raises, the layer's own
    # states follow its input instead
    out = layer(torch.zeros(5, 3, 2))
    assert out.shape == (5, 3, 8) and out.device.type == "cpu"
    with pytest.raises(MXNetError, match="layout"):
        tmx.gluon.rnn.GRU(4, layout="CNT")


@pytest.mark.parametrize("T,N,I,GH", [(5, 4, 6, 32), (3, 1, 40, 160),
                                       (0, 2, 8, 24)])
def test_input_projection_matches_matmul_plus_bias(T, N, I, GH):
    """The recurrences' input projection, one GEMM call with the bias,
    equals ``x @ Wi.T + b`` with its gradients, empty sequences included."""
    rng = np.random.default_rng(T + N + I)
    ins = [torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                        requires_grad=True)
           for s in ((T, N, I), (GH, I), (GH,))]
    got = tk.input_projection(*ins)
    want = torch.matmul(ins[0], ins[1].T) + ins[2]
    assert got.shape == want.shape == (T, N, GH)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=1e-6, atol=1e-6)
    cot = torch.tensor(rng.standard_normal((T, N, GH)), dtype=torch.float32)
    for g, r in zip(torch.autograd.grad(got, ins, cot),
                    torch.autograd.grad(want, ins, cot)):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-5,
                                   atol=1e-5)


# -- on the card ----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernels have no CPU "
                    "mode); run on the GPU machine with -m gpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


# kernel vs plain on the card: fp32 sums in other orders over up to 96
# steps; bf16 ys/hn/cn are rounded to bf16 (2^-8 relative), and each
# step's h_prev of the backward is the rounded ys; fp16 ys/hn/cn within
# two fp16 ulps of values below 1 (1e-3)
CARD_TOL = {"float32": (2e-5, 1e-4), "bfloat16": (2e-2, 2e-2),
            "float16": (1e-3, 1e-3)}
CARD_DTYPES = ("float32", "bfloat16", "float16")
# (T, N, H): DeepAR training and predict (16 and 32 series), one unit tile
# with few rows,
# the GRU phase's width and the large-H LSTM (units split over blocks);
# then the routes' edges: N=1 at the register route's widest H, N=17 at
# the first H past it, the cluster route's widest H (one cluster), and the
# tensor-core route's fewest rows at its widest H
CARD_SHAPES = [(96, 32, 40), (7, 1600, 40), (96, 3200, 40), (9, 3, 17),
               (35, 32, 200), (12, 32, 512), (5, 70, 130), (6, 1, 96),
               (5, 17, 97), (3, 1, 417), (5, 896, 64)]


def _card(T, N, H, G, dtype, dev, seed=0):
    """Inputs on the card; Wh at 1/sqrt(H), as Xavier gives it (larger
    weights make a wide recurrence chaotic, and any rounding grows)."""
    a = _inputs(T, N, H, G, seed, wscale=H ** -0.5)
    dt = getattr(torch, dtype)
    t = {k: torch.from_numpy(v).to(dev) for k, v in a.items()}
    t["xp"] = t["xp"].to(dt)
    return t


def _close_card(got, ref, dtype, name):
    atol, rtol = CARD_TOL[dtype]
    scale = max(1.0, ref.float().abs().max().item())
    torch.testing.assert_close(got.float(), ref.float(), atol=atol * scale,
                               rtol=rtol, msg=lambda m: f"{name}: {m}")


def _route_counts(counts):
    return {r: getattr(counts, f"{r}_launches") for r in tk.ROUTES
            if hasattr(counts, f"{r}_launches")}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", CARD_DTYPES)
@pytest.mark.parametrize("T,N,H", CARD_SHAPES)
def test_lstm_kernels_match_plain_on_card(T, N, H, dtype, cuda_device):
    t = _card(T, N, H, 4, dtype, cuda_device)
    route = tk.plan(4, False, N, H, cuda_device)[0]
    broute = tk.plan(4, True, N, H, cuda_device)[0]
    before = (tk.lstm_fwd_counts.launches, tk.lstm_bwd_counts.launches,
              tk.lstm_fwd_counts.float16_launches,
              tk.lstm_bwd_counts.float16_launches)
    by_route = _route_counts(tk.lstm_fwd_counts)
    bby_route = _route_counts(tk.lstm_bwd_counts)
    fwd = tk.lstm_fwd(t["xp"], t["wh"], t["h0"], t["c0"])
    ref = tk.lstm_fwd_plain(t["xp"], t["wh"], t["h0"], t["c0"])
    for name, g, r in zip(("ys", "hn", "cn", "gates", "cs"), fwd, ref):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        _close_card(g, r, dtype, name)
    args = (t["wh"], t["h0"], t["c0"], *ref[0:1], *ref[3:5], t["dys"],
            t["dhn"], t["dcn"])
    bwd = tk.lstm_bwd(*args)
    bref = tk.lstm_bwd_plain(*args)
    torch.cuda.synchronize()
    f16 = dtype == "float16"
    assert (tk.lstm_fwd_counts.launches, tk.lstm_bwd_counts.launches,
            tk.lstm_fwd_counts.float16_launches,
            tk.lstm_bwd_counts.float16_launches) == \
        (before[0] + 1, before[1] + 1, before[2] + f16, before[3] + f16)
    by_route[route] += 1
    assert _route_counts(tk.lstm_fwd_counts) == by_route
    for name, g, r in zip(("dxp", "dwh", "dh0", "dc0"), bwd, bref):
        _close_card(g, r, "float32", name)
    again = tk.lstm_bwd(*args)  # no atomics: bit-identical
    assert all(torch.equal(x, y) for x, y in zip(bwd, again))
    bby_route[broute] += 2
    assert _route_counts(tk.lstm_bwd_counts) == bby_route
    fagain = tk.lstm_fwd(t["xp"], t["wh"], t["h0"], t["c0"])
    assert all(torch.equal(x, y) for x, y in zip(fwd, fagain))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", CARD_DTYPES)
@pytest.mark.parametrize("T,N,H", CARD_SHAPES)
def test_gru_kernels_match_plain_on_card(T, N, H, dtype, cuda_device):
    t = _card(T, N, H, 3, dtype, cuda_device, seed=1)
    froute = tk.plan(3, False, N, H, cuda_device)[0]
    fby_route = _route_counts(tk.gru_fwd_counts)
    fwd = tk.gru_fwd(t["xp"], t["wh"], t["bh"], t["h0"])
    ref = tk.gru_fwd_plain(t["xp"], t["wh"], t["bh"], t["h0"])
    for name, g, r in zip(("ys", "hn", "gates", "hn_lin"), fwd, ref):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        _close_card(g, r, dtype, name)
    fagain = tk.gru_fwd(t["xp"], t["wh"], t["bh"], t["h0"])
    assert all(torch.equal(x, y) for x, y in zip(fwd, fagain))
    fby_route[froute] += 2
    assert _route_counts(tk.gru_fwd_counts) == fby_route
    args = (t["wh"], t["h0"], ref[0], ref[2], ref[3], t["dys"], t["dhn"])
    route = tk.plan(3, True, N, H, cuda_device)[0]
    by_route = _route_counts(tk.gru_bwd_counts)
    bwd = tk.gru_bwd(*args)
    bref = tk.gru_bwd_plain(*args)
    torch.cuda.synchronize()
    for name, g, r in zip(("dxp", "dwh", "dbh", "dh0"), bwd, bref):
        _close_card(g, r, "float32", name)
    again = tk.gru_bwd(*args)
    assert all(torch.equal(x, y) for x, y in zip(bwd, again))
    by_route[route] += 2
    assert _route_counts(tk.gru_bwd_counts) == by_route


def _same_again(call, first, name):
    """A second call of ``call`` returns ``first`` bit for bit."""
    again = call()
    assert all(torch.equal(x, y) for x, y in zip(first, again)), name


# the main paths' shapes, then shapes that pad in registers (H = 17, 18
# past a multiple of 8) or in a cluster's last block (H = 97, 417) or rows
# (the forward's 3 rows a cluster at N=17, H=417)
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", CARD_DTYPES)
@pytest.mark.parametrize("T,N,H", [(96, 32, 40), (35, 32, 200), (7, 19, 40),
                                   (9, 3, 18), (9, 3, 17), (5, 17, 97),
                                   (3, 1, 417), (4, 17, 417)])
def test_new_routes_match_the_split_route_on_card(T, N, H, dtype,
                                                  cuda_device):
    """The register and tensor-core routes (LSTM forward, at any N: H <=
    96, and even H <= 64), the register route of the LSTM backward (H <=
    96) and the cluster routes (GRU forward and backward; at H=200
    clusters of 4, 8 and 16 blocks) against the split route on the same
    inputs, each rerun bit for bit."""
    if H <= 96:
        t = _card(T, N, H, 4, dtype, cuda_device, seed=2)
        args = (t["xp"], t["wh"], t["h0"], t["c0"])
        split = tk._lstm_fwd(*args, route="split")
        for route in ("reg", "mma") if H <= 64 and H % 2 == 0 else ("reg",):
            got = tk._lstm_fwd(*args, route=route)
            for name, g, r in zip(("ys", "hn", "cn", "gates", "cs"), got,
                                  split):
                _close_card(g, r, dtype, f"{route} {name}")
            _same_again(lambda: tk._lstm_fwd(*args, route=route), got,
                        route)
        bargs = (t["wh"], t["h0"], t["c0"], split[0], split[3], split[4],
                 t["dys"], t["dhn"], t["dcn"])
        bsplit = tk._lstm_bwd(*bargs, route="split")
        got = tk._lstm_bwd(*bargs, route="reg")
        for name, g, r in zip(("dxp", "dwh", "dh0", "dc0"), got, bsplit):
            _close_card(g, r, "float32", f"reg {name}")
        _same_again(lambda: tk._lstm_bwd(*bargs, route="reg"), got, "reg")
    g3 = _card(T, N, H, 3, dtype, cuda_device, seed=3)
    fargs = (g3["xp"], g3["wh"], g3["bh"], g3["h0"])
    fsplit = tk._gru_fwd(*fargs, route="split")
    ys, _, gates, hl = tk.gru_fwd_plain(*fargs)
    bargs = (g3["wh"], g3["h0"], ys, gates, hl, g3["dys"], g3["dhn"])
    bsplit = tk._gru_bwd(*bargs, route="split")
    for back, call, split, names, tol in (
            (False, tk._gru_fwd, fsplit, ("ys", "hn", "gates", "hn_lin"),
             dtype),
            (True, tk._gru_bwd, bsplit, ("dxp", "dwh", "dbh", "dh0"),
             "float32")):
        ins = bargs if back else fargs
        if (back, N, H) == (True, 17, 417):  # no cluster plan (above)
            continue
        plans = [tk.plan(3, back, N, H, cuda_device, "cluster")]
        if H == 200:  # clusters of 4, 8 and 16 blocks
            plans += [("cluster", 1, 50), ("cluster", 2, 25),
                      ("cluster", 4, 13)]
        for pl in plans:
            got = call(*ins, route=pl)
            for name, g, r in zip(names, got, split):
                _close_card(g, r, tol, f"{pl} {name}")
            _same_again(lambda: call(*ins, route=pl), got, str(pl))


@pytest.mark.gpu
def test_functions_on_card_match_autograd_of_plain(cuda_device):
    for G, layer, plain, keys in (
            (4, tk.lstm_layer, tk.lstm_layer_plain, ("xp", "wh", "h0", "c0")),
            (3, tk.gru_layer, tk.gru_layer_plain, ("xp", "wh", "bh", "h0"))):
        for H in (40, 200):
            t = _card(20, 8, H, G, "float32", cuda_device, seed=H)
            grads = []
            for fn in (layer, plain):
                ins = [t[k].clone().requires_grad_(True) for k in keys]
                outs = fn(*ins)
                loss = (outs[0] * t["dys"]).sum() + (outs[1] ** 2).sum()
                grads.append(torch.autograd.grad(loss, ins))
            for name, g, r in zip(keys, *grads):
                _close_card(g, r, "float32", name)


@pytest.mark.gpu
def test_kernels_reject_what_they_do_not_take(cuda_device):
    t = _card(4, 2, 8, 4, "float32", cuda_device)
    with pytest.raises(MXNetError, match="float32, bfloat16 or float16"):
        tk.lstm_fwd(t["xp"].double(), t["wh"], t["h0"], t["c0"])
    with pytest.raises(MXNetError, match="x_proj"):
        tk.lstm_fwd(t["xp"][..., :-1], t["wh"], t["h0"], t["c0"])
    with pytest.raises(MXNetError, match="is on"):
        tk.lstm_fwd(t["xp"], t["wh"], t["h0"].cpu(), t["c0"])
    with pytest.raises(MXNetError, match="shape"):
        tk.lstm_fwd(t["xp"], t["wh"], t["h0"][:1], t["c0"])


@pytest.mark.gpu
def test_every_gated_shape_has_a_kernel_plan(cuda_device):
    """Every (N, H) the JAX package's rule takes, and DeepAR predict at
    GluonTS's default batch past it, gets a plan on the card: the register
    route (one row a block, H <= 96) for the LSTM backward and forward or,
    from 896 rows at even H <= 64, the tensor-core route (16 rows a block)
    for the LSTM forward, the cluster route (at most 16 blocks a cluster)
    for the GRU backward, and for the GRU forward from H=64, where it
    fits, the split route otherwise, where with
    the units split there is at most one block per SM, so every block of
    the cooperative launch is resident.  A width no plan fits raises."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for G in (3, 4):
        for backward in (False, True):
            for H in list(range(1, 130, 7)) + list(range(130, 760, 23)):
                for N in (1, 2, 7, 32, 100, 333, 1000, 1600, 2200):
                    if not trnn._lstm_kernel_fits(N, H, G):
                        continue
                    route, NB, JB = tk.plan(G, backward, N, H, cuda_device)
                    assert 1 <= NB <= N and 1 <= JB <= H
                    if route == "reg":
                        assert (G, NB, JB) == (4, 1, H) and H <= 96
                        assert backward or N < 896 or H > 64 or H % 2
                    elif route == "mma":
                        assert (G, backward, NB, JB) == (4, False, 16, H)
                        assert N >= 896 and H <= 64 and H % 2 == 0
                    elif route == "cluster":
                        assert G == 3 and (backward or H >= 64)
                        assert -(-H // JB) <= 16 and NB * JB <= 512
                        assert -(-N // NB) * -(-H // JB) <= 2 * sms
                    else:
                        assert route == "split", route
                        assert not (G == 4 and H <= 96)
                        if JB < H:
                            assert -(-N // NB) * -(-H // JB) <= sms, (N, H, G)
            with pytest.raises(MXNetError, match="no plan"):
                tk.plan(G, backward, 32, 4096, cuda_device)
    # DeepAR train and predict (16 and 32 series x 100 samples)
    assert tk.plan(4, False, 32, 40, cuda_device) == ("reg", 1, 40)
    for N in (1600, 3200):
        assert tk.plan(4, False, N, 40, cuda_device) == ("mma", 16, 40)
    assert tk.plan(4, True, 32, 40, cuda_device) == ("reg", 1, 40)
    assert tk.plan(4, True, 3200, 40, cuda_device) == ("reg", 1, 40)
    assert tk.plan(4, True, 32, 97, cuda_device)[0] == "split"
    assert tk.plan(4, False, 895, 64, cuda_device)[0] == "reg"
    assert tk.plan(4, False, 896, 64, cuda_device)[0] == "mma"
    for H in (41, 66):
        assert tk.plan(4, False, 1600, H, cuda_device)[0] == "reg"
    assert tk.plan(4, False, 32, 97, cuda_device)[0] == "split"
    for backward in (True, False):  # the GRU phase
        route, NB, JB = tk.plan(3, backward, 32, 200, cuda_device)
        assert route == "cluster" and -(-200 // JB) <= 16
        assert tk.plan(3, backward, 1, 417, cuda_device)[0] == "cluster"
        assert tk.plan(3, backward, 32, 512, cuda_device)[0] == "split"
    assert tk.plan(3, True, 1, 418, cuda_device)[0] == "split"
    # 17 clusters of 16 blocks at H=417 do not fit the card at once: the
    # backward's blocks hold one row each, the forward's (less shared
    # memory a block) three, in 6 clusters
    assert tk.plan(3, True, 17, 417, cuda_device)[0] == "split"
    assert tk.plan(3, False, 17, 417, cuda_device)[:2] == ("cluster", 3)
    for H, route in ((40, "split"), (63, "split"), (64, "cluster"),
                     (96, "cluster")):  # the crossover, kClusterFwdMinH
        assert tk.plan(3, False, 32, H, cuda_device)[0] == route
    assert tk.plan(4, True, 32, 512, cuda_device)[2] < 512
    with pytest.raises(MXNetError, match="no reg plan"):
        tk.plan(4, False, 32, 97, cuda_device, "reg")
    with pytest.raises(MXNetError, match="no mma plan"):
        tk.plan(4, False, 32, 41, cuda_device, "mma")
    with pytest.raises(MXNetError, match="no cluster plan"):
        tk.plan(4, True, 32, 40, cuda_device, "cluster")
    with pytest.raises(MXNetError, match="no reg plan"):
        tk.plan(4, True, 32, 97, cuda_device, "reg")
    with pytest.raises(MXNetError, match="no reg plan"):
        tk.plan(3, False, 32, 40, cuda_device, "reg")


@pytest.mark.gpu
def test_sizes_past_the_jax_rule_launch_on_card(cuda_device, monkeypatch):
    """The JAX package's size rule does not gate the card: DeepAR predict
    at GluonTS's default batch (32 series x 100 samples: N=3200, H=40) and
    widths past the rule launch the kernels, with no plain calls."""
    monkeypatch.setenv("MXTPU_RNN_IMPL", "auto")
    for mode, counts, N, H in (("lstm", tk.lstm_fwd_counts, 3200, 40),
                               ("lstm", tk.lstm_fwd_counts, 4, 700),
                               ("gru", tk.gru_fwd_counts, 4, 800)):
        assert not trnn._lstm_kernel_fits(N, H, trnn._GATES[mode])
        a = _op_inputs(mode, False, T=3, N=N, I=4, H=H, L=1)
        args = [torch.from_numpy(a[k]).to(cuda_device) for k in
                ("data", "params", "state", "cell")][:4 if mode == "lstm"
                                                       else 3]
        before = (counts.launches, counts.plain_calls_on_cuda)
        trnn._k_rnn(*args, state_size=H, num_layers=1, mode=mode)
        assert (counts.launches, counts.plain_calls_on_cuda) == \
            (before[0] + 1, before[1])
