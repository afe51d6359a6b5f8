"""Fused multi-layer RNN op: vanilla, LSTM and GRU, optionally
bidirectional (ref: ``mxnet_tpu/ops/rnn.py``).

Parameter layout, as the JAX package's (the reference's packed cuDNN
canonical layout): a flat vector holding, for each layer and direction,
``i2h_weight (G*H, in)`` then ``h2h_weight (G*H, H)``; after all weights,
for each layer and direction, ``i2h_bias (G*H)`` then ``h2h_bias (G*H)``.
Gate order: LSTM ``i, f, g, o``; GRU ``r, z, n``.

Each layer and direction is either the plain time loop (:func:`_scan_dir`,
every mode; the CPU path and the oracle) or, for the LSTM and GRU, the
input projection ``x @ Wi.T + b`` as one GEMM call and the
recurrence in the kernels of :mod:`.kernels.rnn`.  ``MXTPU_RNN_IMPL``
picks: ``scan`` the loop always; ``pallas`` the kernel path; ``auto`` (the
default) the kernel path on CUDA tensors and the loop elsewhere, as the
JAX package takes its Pallas kernels on the TPU only.  There is no compile
probe and no size gate on the card: a CUDA tensor launches the kernels, and
a size that no kernel plan fits raises.  The JAX package's size rule
(:func:`_lstm_kernel_fits`) routes only CPU calls under ``pallas``, as the
JAX package routes its own: the kernels' plain versions where it takes the
size, the loop where it does not.
"""
from __future__ import annotations

import torch

from .. import autograd
from .. import random as _random
from ..base import MXNetError, getenv
from .kernels import rnn as _krnn
from .registry import register

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def rnn_param_size(num_layers, input_size, state_size, mode,
                   bidirectional=False, projection_size=None):
    """Total length of the flat parameter vector (ref: ops/rnn.py:28)."""
    g = _GATES[mode]
    d = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * d
        size += d * g * state_size * (in_sz + state_size)
    return size + num_layers * d * 2 * g * state_size


def _unpack(params, num_layers, input_size, state_size, mode, d):
    """``[layer][direction] -> [wi, wh, bi, bh]``, views of ``params``
    (ref: ops/rnn.py:42)."""
    g = _GATES[mode]
    ws, off = [], 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * d
        per_dir = []
        for _ in range(d):
            n_wi, n_wh = g * state_size * in_sz, g * state_size * state_size
            wi = params[off:off + n_wi].reshape(g * state_size, in_sz)
            wh = params[off + n_wi:off + n_wi + n_wh].reshape(
                g * state_size, state_size)
            off += n_wi + n_wh
            per_dir.append([wi, wh])
        ws.append(per_dir)
    for layer in range(num_layers):
        for dd in range(d):
            bi = params[off:off + g * state_size]
            bh = params[off + g * state_size:off + 2 * g * state_size]
            off += 2 * g * state_size
            ws[layer][dd] += [bi, bh]
    return ws


def _step_fn(mode):
    """One time step of ``mode``: ``step(carry, x_t, wi, wh, bi, bh) ->
    (carry, y_t)`` (ref: ops/rnn.py:67)."""
    if mode == "lstm":
        def step(carry, x_t, wi, wh, bi, bh):
            h, c = carry
            gates = x_t @ wi.T + bi + h @ wh.T + bh
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            return (h, c), h
        return step
    if mode == "gru":
        def step(carry, x_t, wi, wh, bi, bh):
            (h,) = carry
            ir, iz, inn = (x_t @ wi.T + bi).chunk(3, dim=-1)
            hr, hz, hn = (h @ wh.T + bh).chunk(3, dim=-1)
            r = torch.sigmoid(ir + hr)
            z = torch.sigmoid(iz + hz)
            n = torch.tanh(inn + r * hn)
            h = (1 - z) * n + z * h
            return (h,), h
        return step
    act = torch.relu if mode == "rnn_relu" else torch.tanh

    def step(carry, x_t, wi, wh, bi, bh):
        (h,) = carry
        h = act(x_t @ wi.T + bi + h @ wh.T + bh)
        return (h,), h
    return step


def _scan_dir(step, xs, init, wi, wh, bi, bh, reverse):
    """The plain time loop over ``xs (T, N, I)``: ``(carry, ys)``, ``ys``
    in time order whichever way the loop ran (ref: ops/rnn.py:99)."""
    carry, ys = init, [None] * xs.shape[0]
    steps = range(xs.shape[0] - 1, -1, -1) if reverse else range(xs.shape[0])
    for t in steps:
        carry, ys[t] = step(carry, xs[t], wi, wh, bi, bh)
    if not ys:
        return carry, xs.new_empty((0, xs.shape[1], init[0].shape[-1]))
    return carry, torch.stack(ys)


def _impl():
    impl = getenv("RNN_IMPL", "auto").lower()
    if impl not in ("auto", "pallas", "scan"):
        raise MXNetError(f"MXTPU_RNN_IMPL must be auto, pallas or scan, not "
                         f"{impl!r}")
    return impl


def _use_kernel(x):
    """The kernel path for the LSTM and GRU (ref: ``_use_pallas_lstm``/
    ``_use_pallas_gru``, ops/rnn.py:107,158): ``scan`` never, ``pallas``
    always, ``auto`` on CUDA tensors."""
    impl = _impl()
    return impl == "pallas" or (impl == "auto" and x.is_cuda)


def _lstm_kernel_fits(N, H, G=4):
    """The JAX package's size rule for its recurrence kernels (ref:
    ``_pallas_lstm_fits``, ops/rnn.py:147): its TPU kernel held Wh, an
    x_proj block, the gates and the states, double buffered, in 12 MiB of
    VMEM.  The CUDA kernels split rows and units over blocks and have no
    such limit, so it routes CPU calls only."""
    est = 4 * (G * H * H + 3 * N * G * H + 6 * N * H)
    return 2 * est < 12 * 1024 * 1024


def _kernel_lstm_dir(xs, init, wi, wh, bi, bh, reverse):
    """The input GEMM with both biases folded, then the LSTM kernel; the
    reverse direction is flip, forward, flip (ref: ops/rnn.py:210)."""
    if reverse:
        xs = xs.flip(0)
    x_proj = _krnn.input_projection(xs, wi, bi + bh)
    ys, hn, cn = _krnn.lstm_layer(x_proj, wh, *init)
    return (hn, cn), (ys.flip(0) if reverse else ys)


def _kernel_gru_dir(xs, init, wi, wh, bi, bh, reverse):
    """As :func:`_kernel_lstm_dir`; ``bh`` stays a kernel input, because
    the reset gate multiplies its n slot (ref: ops/rnn.py:195)."""
    if reverse:
        xs = xs.flip(0)
    x_proj = _krnn.input_projection(xs, wi, bi)
    ys, hn = _krnn.gru_layer(x_proj, wh, bh, init[0])
    return (hn,), (ys.flip(0) if reverse else ys)


def _k_rnn(data, parameters, state, state_cell=None, *, state_size,
           num_layers, mode="lstm", bidirectional=False, p=0.0,
           state_outputs=False, projection_size=None,
           lstm_state_clip_min=None, lstm_state_clip_max=None,
           use_sequence_length=False, _train=None):
    """``data (T, N, I)`` [TNC] -> ``(out, h_n)``, with ``c_n`` for the
    LSTM (ref: ``_k_rnn``, ops/rnn.py:225).  Dropout of rate ``p`` applies
    in training to the output of every layer but the last, drawn from the
    device's generator; ``_train`` defaults to the autograd scope's flag.

    ``projection_size``, ``lstm_state_clip_min``/``max`` and
    ``use_sequence_length`` are not implemented: the JAX op accepts and
    ignores them, the port raises for any value but the default."""
    for name, value, default in (
            ("projection_size", projection_size, None),
            ("lstm_state_clip_min", lstm_state_clip_min, None),
            ("lstm_state_clip_max", lstm_state_clip_max, None),
            ("use_sequence_length", use_sequence_length, False)):
        if value != default:
            raise MXNetError(f"RNN: {name}={value!r} is not implemented "
                             f"(only the default {default!r})")
    if mode not in _GATES:
        raise MXNetError(f"RNN: unknown mode {mode!r}")
    if _train is None:
        _train = autograd.is_training()
    d = 2 if bidirectional else 1
    T, N, I = data.shape
    H = state_size
    ws = _unpack(parameters, num_layers, I, H, mode, d)
    step = _step_fn(mode)
    is_lstm = mode == "lstm"
    kernel = mode in ("lstm", "gru") and _use_kernel(data) and (
        data.is_cuda or _lstm_kernel_fits(N, H, G=_GATES[mode]))
    x = data
    h_states, c_states = [], []
    for layer in range(num_layers):
        outs = []
        for dd in range(d):
            wi, wh, bi, bh = ws[layer][dd]
            idx = layer * d + dd
            init = (state[idx], state_cell[idx]) if is_lstm else (state[idx],)
            if kernel:
                run = _kernel_lstm_dir if is_lstm else _kernel_gru_dir
                carry, ys = run(x, init, wi, wh, bi, bh, reverse=dd == 1)
            else:
                carry, ys = _scan_dir(step, x, init, wi, wh, bi, bh,
                                      reverse=dd == 1)
            outs.append(ys)
            h_states.append(carry[0])
            if is_lstm:
                c_states.append(carry[1])
        x = outs[0] if d == 1 else torch.cat(outs, dim=-1)
        if p > 0 and _train and layer < num_layers - 1:
            mask = torch.empty_like(x).bernoulli_(
                1 - p, generator=_random.generator(x.device))
            x = x * mask / (1 - p)
    h_n = torch.stack(h_states, dim=0)
    if is_lstm:
        return x, h_n, torch.stack(c_states, dim=0)
    return x, h_n


register("RNN", _k_rnn, aliases=("rnn",))
