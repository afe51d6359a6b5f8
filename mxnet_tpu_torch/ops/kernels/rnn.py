"""LSTM and GRU recurrences: the Hopper kernels, their plain versions,
their wrappers and autograd Functions.

Replaces ``_lstm_fwd_kernel``, ``_lstm_bwd_kernel``, ``_gru_fwd_kernel``
and ``_gru_bwd_kernel`` of ``mxnet_tpu/ops/pallas/rnn.py`` with
``csrc/rnn.cu``.  The source's header says how the kernels split the work,
what bounds them on an H100 and how they are built.

- :func:`lstm_fwd_plain`, :func:`lstm_bwd_plain`, :func:`gru_fwd_plain`
  and :func:`gru_bwd_plain` are the same functions in plain PyTorch, step
  by step with the same saved tensors: the CPU path, and what the kernels
  are held against on the card.
- :func:`lstm_fwd`, :func:`lstm_bwd`, :func:`gru_fwd` and :func:`gru_bwd`
  are the wrappers.  They raise for mismatched shapes or devices, then
  dispatch on the tensor's device alone: a CPU tensor takes the plain
  version, a CUDA tensor launches the kernel or raises (a dtype other
  than float32, bfloat16 or float16, a size that no plan of :func:`plan`
  fits, a failed launch).  :func:`plan` picks the kernel's route before the
  launch: for the LSTM forward ``"mma"`` (3xTF32 tensor-core tiles of 16
  rows) at N >= 896 and even H <= 64, else ``"reg"`` (Wh in registers) at
  H <= 96; ``"reg"`` for the LSTM backward at H <= 96 (a column of Wh in
  registers); ``"cluster"`` for the GRU backward, and for the GRU forward
  at H >= 64, where the blocks of a cluster hold Wh's columns (rows) and
  the card holds all the clusters at once; else ``"split"`` (Wh in shared
  memory, units split over the blocks of a cooperative launch where it
  does not fit one).
  Each count adds one per launch under ``<route>_launches`` beside
  ``launches``, and a float16 launch under ``float16_launches`` too.
- :func:`input_projection` is the layers' input GEMM, outside the
  recurrence: one call with the bias.
- :func:`lstm_layer` and :func:`gru_layer` are the differentiable entries
  (ref: the ``jax.custom_vjp`` functions of the same names, :243 and
  :457): forward and backward through the wrappers, missing cotangents
  taken as zeros, ``dxp`` in ``ys``'s dtype, ``dwh`` and ``dbh`` in
  ``wh``'s, ``dh0`` and ``dc0`` in their states'.

Layouts are the JAX package's: ``x_proj (T, N, G*H)`` gate-major (LSTM
``i, f, g, o``; GRU ``r, z, n``), ``wh (G*H, H)``, states ``(N, H)``; the
saved gates ``(T, N, G, H)`` and cell states or ``hn_lin`` ``(T, N, H)``
are fp32.  ``ys``, ``hn`` and ``cn`` come out in ``x_proj``'s dtype.  The
kernels keep ``wh`` in fp32: the wrappers widen a bfloat16 or float16
``wh`` (exactly) and the autograd Functions round ``dwh`` and ``dbh`` back
to its dtype.
"""
from __future__ import annotations

import ctypes

import torch

from ...base import MXNetError
from .build import KernelCounts, KernelLibrary

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_NO_PLAN = 9  # cudaErrorInvalidConfiguration, from mxtt_rnn_plan
# ROUTE_SPLIT, ROUTE_REG, ROUTE_CLUSTER and ROUTE_MMA in the source
ROUTES = {"split": 0, "reg": 1, "cluster": 2, "mma": 3}
_ROUTE_NAMES = {v: k for k, v in ROUTES.items()}

lstm_fwd_counts = KernelCounts("split_launches", "reg_launches",
                               "mma_launches", "float16_launches")
lstm_bwd_counts = KernelCounts("split_launches", "reg_launches",
                               "float16_launches")
gru_fwd_counts = KernelCounts("split_launches", "cluster_launches",
                              "float16_launches")
gru_bwd_counts = KernelCounts("split_launches", "cluster_launches",
                              "float16_launches")
library = KernelLibrary("rnn.cu")


# -- plain versions -------------------------------------------------------------


def _stack(seq, empty_shape, like, dtype):
    return torch.stack(seq) if seq else like.new_empty(empty_shape,
                                                       dtype=dtype)


def lstm_fwd_plain(x_proj, wh, h0, c0):
    """``(ys, hn, cn, gates, cs)``: per step ``gp_g = xp[t, :, g] + h @
    Wh[g].T``, ``i, f, o`` sigmoid and ``g`` tanh, ``c' = f*c + i*g``,
    ``h' = o*tanh(c')``, h and c carried in fp32 (ref: ``_lstm_fwd_kernel``)."""
    T, N, _ = x_proj.shape
    H = wh.shape[1]
    xp = x_proj.float().reshape(T, N, 4, H)
    w = wh.float().reshape(4, H, H)
    h, c = h0.float(), c0.float()
    ys, gates, cs = [], [], []
    for t in range(T):
        gp = [xp[t, :, g] + h @ w[g].T for g in range(4)]
        i, f = torch.sigmoid(gp[0]), torch.sigmoid(gp[1])
        g, o = torch.tanh(gp[2]), torch.sigmoid(gp[3])
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys.append(h)
        gates.append(torch.stack((i, f, g, o), dim=1))
        cs.append(c)
    dt = x_proj.dtype
    return (_stack(ys, (0, N, H), x_proj, torch.float32).to(dt), h.to(dt),
            c.to(dt), _stack(gates, (0, N, 4, H), x_proj, torch.float32),
            _stack(cs, (0, N, H), x_proj, torch.float32))


def _prev(first, seq):
    """``[first; seq[:-1]]`` in fp32: the state entering each step."""
    return torch.cat([first[None].float(), seq[:-1].float()], 0)


def lstm_bwd_plain(wh, h0, c0, ys, gates, cs, dys, dhn, dcn):
    """``(dxp (T, N, 4H), dwh (4H, H), dh0, dc0)``, all fp32, over the
    reversed steps (ref: ``_lstm_bwd_kernel``); ``h_prev`` is ``ys`` as
    stored, upcast."""
    T, N = gates.shape[:2]
    H = wh.shape[1]
    w = wh.float().reshape(4, H, H)
    h_prev, c_prev = _prev(h0, ys), _prev(c0, cs)
    dh_c, dc_c = dhn.float(), dcn.float()
    dwh = torch.zeros(4, H, H, device=wh.device)
    dxp = torch.zeros(T, N, 4, H, device=wh.device)
    for t in reversed(range(T)):
        dh = dh_c + dys[t].float()
        i, f, g, o = gates[t].unbind(1)
        tc = torch.tanh(cs[t])
        do = dh * tc
        dc = dh * o * (1.0 - tc * tc) + dc_c
        dgp = ((dc * g) * i * (1.0 - i), (dc * c_prev[t]) * f * (1.0 - f),
               (dc * i) * (1.0 - g * g), do * o * (1.0 - o))
        dh_new = None
        for gi in range(4):
            dwh[gi] += dgp[gi].T @ h_prev[t]
            contrib = dgp[gi] @ w[gi]
            dh_new = contrib if dh_new is None else dh_new + contrib
            dxp[t, :, gi] = dgp[gi]
        dh_c, dc_c = dh_new, dc * f
    return dxp.reshape(T, N, 4 * H), dwh.reshape(4 * H, H), dh_c, dc_c


def gru_fwd_plain(x_proj, wh, bh, h0):
    """``(ys, hn, gates, hn_lin)``: per step ``gh_g = h @ Wh[g].T + bh[g]``,
    ``r, z = sigmoid(xp_{r,z} + gh_{r,z})``, ``n = tanh(xp_n + r*gh_n)``,
    ``h' = (1-z)*n + z*h``; saves ``(r, z, n)`` and ``hn_lin = gh_n``
    (ref: ``_gru_fwd_kernel``)."""
    T, N, _ = x_proj.shape
    H = wh.shape[1]
    xp = x_proj.float().reshape(T, N, 3, H)
    w = wh.float().reshape(3, H, H)
    b = bh.float().reshape(3, H)
    h = h0.float()
    ys, gates, hn_lin = [], [], []
    for t in range(T):
        gh = [h @ w[g].T + b[g] for g in range(3)]
        r = torch.sigmoid(xp[t, :, 0] + gh[0])
        z = torch.sigmoid(xp[t, :, 1] + gh[1])
        n = torch.tanh(xp[t, :, 2] + r * gh[2])
        h = (1.0 - z) * n + z * h
        ys.append(h)
        gates.append(torch.stack((r, z, n), dim=1))
        hn_lin.append(gh[2])
    dt = x_proj.dtype
    return (_stack(ys, (0, N, H), x_proj, torch.float32).to(dt), h.to(dt),
            _stack(gates, (0, N, 3, H), x_proj, torch.float32),
            _stack(hn_lin, (0, N, H), x_proj, torch.float32))


def gru_bwd_plain(wh, h0, ys, gates, hn_lin, dys, dhn):
    """``(dxp (T, N, 3H), dwh (3H, H), dbh (3H), dh0)``, all fp32 (ref:
    ``_gru_bwd_kernel``): ``dxp``'s n slot takes ``dg_n``, the recurrent
    weights ``dg_n * r``."""
    T, N = gates.shape[:2]
    H = wh.shape[1]
    w = wh.float().reshape(3, H, H)
    h_prev = _prev(h0, ys)
    dh_c = dhn.float()
    dwh = torch.zeros(3, H, H, device=wh.device)
    dbh = torch.zeros(3, H, device=wh.device)
    dxp = torch.zeros(T, N, 3, H, device=wh.device)
    for t in reversed(range(T)):
        dh = dh_c + dys[t].float()
        r, z, n = gates[t].unbind(1)
        hp = h_prev[t]
        dn = dh * (1.0 - z)
        dz = dh * (hp - n)
        dgn = dn * (1.0 - n * n)
        dr = dgn * hn_lin[t]
        dhnlin = dgn * r
        dgr = dr * r * (1.0 - r)
        dgz = dz * z * (1.0 - z)
        dh_new = dh * z
        for gi, dg in ((0, dgr), (1, dgz), (2, dhnlin)):
            dwh[gi] += dg.T @ hp
            dbh[gi] += dg.sum(0)
            dh_new = dh_new + dg @ w[gi]
            dxp[t, :, gi] = dg if gi != 2 else dgn
        dh_c = dh_new
    return (dxp.reshape(T, N, 3 * H), dwh.reshape(3 * H, H),
            dbh.reshape(3 * H), dh_c)


def lstm_layer_plain(x_proj, wh, h0, c0):
    """``(ys, hn, cn)`` of :func:`lstm_fwd_plain`, differentiable through
    torch's autograd (the reference for :func:`lstm_layer`'s gradients)."""
    return lstm_fwd_plain(x_proj, wh, h0, c0)[:3]


def gru_layer_plain(x_proj, wh, bh, h0):
    """``(ys, hn)`` of :func:`gru_fwd_plain`, differentiable through
    torch's autograd."""
    return gru_fwd_plain(x_proj, wh, bh, h0)[:2]


def input_projection(xs, wi, b):
    """``xs @ wi.T + b``, ``(T, N, G*H)`` from ``xs (T, N, I)``, ``wi (G*H,
    I)`` and ``b (G*H)``: one call, the product with the bias added in its
    epilogue (less host time than a transpose, a product and an add)."""
    return torch.nn.functional.linear(xs, wi, b)


# -- the kernels' plan ---------------------------------------------------------


_plans = {}


def plan(G, backward, N, H, dev, route=None):
    """``(route, NB, JB)``: the route (a key of :data:`ROUTES`), batch rows
    per block (per cluster, on the cluster route) and hidden units per
    block of a recurrence kernel (``G`` 4 the LSTM, 3 the GRU; forward or
    backward) on the CUDA device ``dev``.  ``mxtt_rnn_plan`` in
    ``csrc/rnn.cu`` makes it from the kernels' own shared-memory layouts
    and the device's SMs; ``route`` asks for one route, else the kernel
    takes its own (the module's docstring gives the rule): ``"reg"`` takes
    the LSTM's two directions, ``"mma"`` its forward, ``"cluster"`` the
    GRU's two directions, ``"split"`` all four.  Cached per (G, backward,
    N, H, device, route); a size that no plan fits raises
    :class:`MXNetError`."""
    key = (G, bool(backward), N, H, dev, route)
    got = _plans.get(key)
    if got is not None:
        return got
    dev = torch.device(dev)
    if dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
        key = (G, bool(backward), N, H, dev, route)
    fn = library.load().mxtt_rnn_plan
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 3
        fn.restype = ctypes.c_int
    rt, nb, jb = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    want = -1 if route is None else ROUTES[route]
    with torch.cuda.device(dev):
        err = fn(G, int(backward), N, H, want, ctypes.byref(rt),
                 ctypes.byref(nb), ctypes.byref(jb))
    if err == _NO_PLAN:
        cell = "lstm" if G == 4 else "gru"
        raise MXNetError(f"{cell}_{'bwd' if backward else 'fwd'} kernel: no "
                         f"{route + ' ' if route else ''}plan fits N={N}, "
                         f"H={H} on {dev}")
    library.raise_on_error(err, "rnn plan")
    got = _plans[key] = (_ROUTE_NAMES[rt.value], nb.value, jb.value)
    return got


def _sms(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


def dw_slabs(M, R, KC, sms):
    """Row slabs of the weight-gradient product: about two blocks per SM
    over its 64x64 output tiles, with at least 256 rows a slab."""
    tiles = -(-R // 64) * -(-KC // 64)
    return max(1, min(-(-2 * sms // tiles), -(-M // 256), 65535))


# -- wrappers ------------------------------------------------------------------


def _bind(lib, name, nargs_ptr, nargs_int):
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * nargs_ptr
                       + [ctypes.c_int] * nargs_int + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_dtype(name, t):
    if t.is_cuda and t.dtype not in _DTYPE_CODES:
        raise MXNetError(f"{name} kernel takes float32, bfloat16 or float16, "
                         f"not {t.dtype}")


def _count(counts, route, dtype):
    """One launch on ``route`` in ``counts`` (and in its float16 count)."""
    counts.add("launches", f"{route}_launches",
               *(("float16_launches",) if dtype == torch.float16 else ()))


def _check_inputs(name, like, want):
    """Every ``(tensor, shape)`` of ``want`` has that shape and lies on
    ``like``'s device."""
    for t, shape in want:
        if t.device != like.device:
            raise MXNetError(f"{name} kernel: an input is on {t.device}, "
                             f"where {like.device} is expected")
        if tuple(t.shape) != shape:
            raise MXNetError(f"{name} kernel: an input of shape "
                             f"{tuple(t.shape)} where {shape} is expected")


def _check(name, x_proj, G, wh, states, bias=None):
    """Validate a forward's inputs; returns (T, N, H)."""
    _check_dtype(name, x_proj)
    if x_proj.dim() != 3 or wh.dim() != 2 or \
            x_proj.shape[2] != G * wh.shape[1] or wh.shape[0] != G * wh.shape[1]:
        raise MXNetError(f"{name} kernel takes x_proj (T, N, {G}H) and wh "
                         f"({G}H, H), got {tuple(x_proj.shape)} and "
                         f"{tuple(wh.shape)}")
    T, N, _ = x_proj.shape
    H = wh.shape[1]
    want = [(wh, (G * H, H))] + [(t, (N, H)) for t in states]
    if bias is not None:
        want.append((bias, (G * H,)))
    _check_inputs(name, x_proj, want)
    return T, N, H


def _check_bwd(name, ys, G, wh, gates, seqs, states):
    """Validate a backward's inputs: ``ys (T, N, H)``, ``wh (G*H, H)``,
    ``gates (T, N, G, H)``, each of ``seqs`` ``(T, N, H)`` and each of
    ``states`` ``(N, H)``; returns (T, N, H)."""
    _check_dtype(name, ys)
    if ys.dim() != 3:
        raise MXNetError(f"{name} kernel takes ys (T, N, H), got "
                         f"{tuple(ys.shape)}")
    T, N, H = ys.shape
    _check_inputs(name, ys, [(wh, (G * H, H)), (gates, (T, N, G, H))]
                  + [(t, (T, N, H)) for t in seqs]
                  + [(t, (N, H)) for t in states])
    return T, N, H


def _f32(*ts):
    """Each of ``ts`` as contiguous fp32, itself where it already is."""
    return [t if t.dtype is torch.float32 and t.is_contiguous()
            else t.float().contiguous() for t in ts]


def _launch(fn, name, ptrs, ints, dev):
    """``fn(*pointers, *ints, stream)`` on ``dev``'s current stream; a
    ``None`` pointer passes null."""
    args = [0 if p is None else p.data_ptr() for p in ptrs]
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    if torch._C._cuda_getDevice() == dev.index:
        err = fn(*args, *ints, stream)
    else:
        with torch.cuda.device(dev):
            err = fn(*args, *ints, stream)
    library.raise_on_error(err, name)


def _split_scratch(route, shape, dev):
    """The split route's exchange buffer (``shape`` fp32, None for no
    buffer) and zeroed barrier word; neither on the other routes."""
    if route != "split":
        return None, None
    hbuf = torch.empty(shape, device=dev) if shape else None
    return hbuf, torch.zeros(1, dtype=torch.int32, device=dev)


def lstm_fwd(x_proj, wh, h0, c0):
    """``(ys, hn, cn, gates, cs)`` as :func:`lstm_fwd_plain`: the plain
    version on the CPU, one launch of the forward kernel on CUDA, on the
    route of :func:`plan`."""
    return _lstm_fwd(x_proj, wh, h0, c0)


def _lstm_fwd(x_proj, wh, h0, c0, route=None):
    """:func:`lstm_fwd`; ``route`` pins a route (a key of :data:`ROUTES`,
    with its plan from :func:`plan`)."""
    T, N, H = _check("lstm_fwd", x_proj, 4, wh, (h0, c0))
    if not x_proj.is_cuda:
        return lstm_fwd_plain(x_proj, wh, h0, c0)
    dev, dt = x_proj.device, x_proj.dtype
    rt, NB, JB = plan(4, False, N, H, dev, route)
    xp = x_proj.contiguous()
    if rt == "mma" and xp.data_ptr() % 16:  # the ring's bulk copies
        xp = xp.clone()
    w, h0f, c0f = _f32(wh, h0, c0)
    ys = torch.empty(T, N, H, dtype=dt, device=dev)
    hn = torch.empty(N, H, dtype=dt, device=dev)
    cn = torch.empty(N, H, dtype=dt, device=dev)
    gates = torch.empty(T, N, 4, H, device=dev)
    cs = torch.empty(T, N, H, device=dev)
    hbuf, bar = _split_scratch(rt, (2, N, H), dev)
    fn = _bind(library.load(), "mxtt_lstm_fwd", 11, 7)
    _launch(fn, "lstm_fwd",
            (xp, w, h0f, c0f, ys, hn, cn, gates, cs, hbuf, bar),
            (T, N, H, ROUTES[rt], NB, JB, _DTYPE_CODES[dt]), dev)
    _count(lstm_fwd_counts, rt, dt)
    return ys, hn, cn, gates, cs


def lstm_bwd(wh, h0, c0, ys, gates, cs, dys, dhn, dcn):
    """``(dxp, dwh, dh0, dc0)`` fp32 as :func:`lstm_bwd_plain`: the plain
    version on the CPU; on CUDA the backward kernel on the route of
    :func:`plan`, then the weight-gradient product and its fixed-order sum
    (one wrapper call)."""
    return _lstm_bwd(wh, h0, c0, ys, gates, cs, dys, dhn, dcn)


def _lstm_bwd(wh, h0, c0, ys, gates, cs, dys, dhn, dcn, route=None):
    """:func:`lstm_bwd`; ``route`` pins a route (with its plan from
    :func:`plan`)."""
    T, N, H = _check_bwd("lstm_bwd", ys, 4, wh, gates, (cs, dys),
                         (h0, c0, dhn, dcn))
    if not ys.is_cuda:
        return lstm_bwd_plain(wh, h0, c0, ys, gates, cs, dys, dhn, dcn)
    dev = ys.device
    rt, NB, JB = plan(4, True, N, H, dev, route)
    ins = _f32(dys, gates, cs, h0, c0, wh, dhn, dcn)
    dxp = torch.empty(T, N, 4 * H, device=dev)
    dwh = torch.empty(4 * H, H, device=dev)
    dh0 = torch.empty(N, H, device=dev)
    dc0 = torch.empty(N, H, device=dev)
    P = dw_slabs(T * N, 4 * H, H, _sms(dev))
    part = torch.empty(P, 4 * H, H, device=dev)
    _, bar = _split_scratch(rt, None, dev)
    fn = _bind(library.load(), "mxtt_lstm_bwd", 15, 8)
    _launch(fn, "lstm_bwd",
            (*ins[:5], ys.contiguous(), *ins[5:], dxp, dwh, dh0, dc0, part,
             bar), (T, N, H, ROUTES[rt], NB, JB, P, _DTYPE_CODES[ys.dtype]),
            dev)
    _count(lstm_bwd_counts, rt, ys.dtype)
    return dxp, dwh, dh0, dc0


def gru_fwd(x_proj, wh, bh, h0):
    """``(ys, hn, gates, hn_lin)`` as :func:`gru_fwd_plain`: the plain
    version on the CPU, one launch of the forward kernel on CUDA, on the
    route of :func:`plan`."""
    return _gru_fwd(x_proj, wh, bh, h0)


def _gru_fwd(x_proj, wh, bh, h0, route=None):
    """:func:`gru_fwd`; ``route`` pins a route or a whole plan, as
    :func:`_gru_bwd`'s."""
    T, N, H = _check("gru_fwd", x_proj, 3, wh, (h0,), bh)
    if not x_proj.is_cuda:
        return gru_fwd_plain(x_proj, wh, bh, h0)
    dev, dt = x_proj.device, x_proj.dtype
    rt, NB, JB = route if isinstance(route, tuple) else \
        plan(3, False, N, H, dev, route)
    xp = x_proj.contiguous()
    w, b, h0f = _f32(wh, bh, h0)
    ys = torch.empty(T, N, H, dtype=dt, device=dev)
    hn = torch.empty(N, H, dtype=dt, device=dev)
    gates = torch.empty(T, N, 3, H, device=dev)
    hn_lin = torch.empty(T, N, H, device=dev)
    hbuf, bar = _split_scratch(rt, (2, N, H), dev)
    fn = _bind(library.load(), "mxtt_gru_fwd", 10, 7)
    _launch(fn, "gru_fwd", (xp, w, b, h0f, ys, hn, gates, hn_lin, hbuf, bar),
            (T, N, H, ROUTES[rt], NB, JB, _DTYPE_CODES[dt]), dev)
    _count(gru_fwd_counts, rt, dt)
    return ys, hn, gates, hn_lin


def gru_bwd(wh, h0, ys, gates, hn_lin, dys, dhn):
    """``(dxp, dwh, dbh, dh0)`` fp32 as :func:`gru_bwd_plain`: the plain
    version on the CPU; on CUDA the backward kernel on the route of
    :func:`plan`, then the weight-gradient product (with dbh) and its
    fixed-order sum."""
    return _gru_bwd(wh, h0, ys, gates, hn_lin, dys, dhn)


def _gru_bwd(wh, h0, ys, gates, hn_lin, dys, dhn, route=None):
    """:func:`gru_bwd`; ``route`` pins a route (with its plan from
    :func:`plan`) or, as a tuple ``(route, NB, JB)``, a whole plan, which
    the kernel's entry checks: the card tests run the cluster route at
    cluster sizes other than the plan's through it."""
    T, N, H = _check_bwd("gru_bwd", ys, 3, wh, gates, (hn_lin, dys),
                         (h0, dhn))
    if not ys.is_cuda:
        return gru_bwd_plain(wh, h0, ys, gates, hn_lin, dys, dhn)
    dev = ys.device
    rt, NB, JB = route if isinstance(route, tuple) else \
        plan(3, True, N, H, dev, route)
    d, g, hl, h0f, w, dh = _f32(dys, gates, hn_lin, h0, wh, dhn)
    dxp = torch.empty(T, N, 3 * H, device=dev)
    dgh = torch.empty(T, N, 3 * H, device=dev)
    dwh = torch.empty(3 * H, H, device=dev)
    dbh = torch.empty(3 * H, device=dev)
    dh0 = torch.empty(N, H, device=dev)
    P = dw_slabs(T * N, 3 * H, H + 1, _sms(dev))
    part = torch.empty(P, 3 * H, H + 1, device=dev)
    _, bar = _split_scratch(rt, None, dev)
    fn = _bind(library.load(), "mxtt_gru_bwd", 14, 8)
    _launch(fn, "gru_bwd",
            (d, g, hl, ys.contiguous(), h0f, w, dh, dxp, dgh, dwh, dbh, dh0,
             part, bar),
            (T, N, H, ROUTES[rt], NB, JB, P, _DTYPE_CODES[ys.dtype]), dev)
    _count(gru_bwd_counts, rt, ys.dtype)
    return dxp, dwh, dbh, dh0


# -- autograd ------------------------------------------------------------------


def _cot(g, like):
    """A missing cotangent is zeros (ref: ``_is_zero``, :278)."""
    return torch.zeros_like(like) if g is None else g


class LstmFunction(torch.autograd.Function):
    """:func:`lstm_fwd` for autograd; the backward is :func:`lstm_bwd`
    (ref: ``_lstm_fwd_rule``/``_lstm_bwd_rule``, :256-275)."""

    @staticmethod
    def forward(ctx, x_proj, wh, h0, c0):
        ys, hn, cn, gates, cs = lstm_fwd(x_proj, wh, h0, c0)
        ctx.save_for_backward(wh, h0, c0, ys, gates, cs)
        return ys, hn, cn

    @staticmethod
    def backward(ctx, dys, dhn, dcn):
        wh, h0, c0, ys, gates, cs = ctx.saved_tensors
        dxp, dwh, dh0, dc0 = lstm_bwd(
            wh, h0, c0, ys, gates, cs, _cot(dys, ys).float(),
            _cot(dhn, h0), _cot(dcn, c0))
        return (dxp.to(ys.dtype), dwh.to(wh.dtype), dh0.to(h0.dtype),
                dc0.to(c0.dtype))


class GruFunction(torch.autograd.Function):
    """:func:`gru_fwd` for autograd; the backward is :func:`gru_bwd` (ref:
    ``_gru_fwd_rule``/``_gru_bwd_rule``, :469-486)."""

    @staticmethod
    def forward(ctx, x_proj, wh, bh, h0):
        ys, hn, gates, hn_lin = gru_fwd(x_proj, wh, bh, h0)
        ctx.save_for_backward(wh, h0, ys, gates, hn_lin)
        return ys, hn

    @staticmethod
    def backward(ctx, dys, dhn):
        wh, h0, ys, gates, hn_lin = ctx.saved_tensors
        dxp, dwh, dbh, dh0 = gru_bwd(wh, h0, ys, gates, hn_lin,
                                     _cot(dys, ys).float(), _cot(dhn, h0))
        return (dxp.to(ys.dtype), dwh.to(wh.dtype), dbh.to(wh.dtype),
                dh0.to(h0.dtype))


def lstm_layer(x_proj, wh, h0, c0):
    """One LSTM layer and direction over time: ``(ys, hn, cn)``,
    differentiable.  ``x_proj (T, N, 4H)`` is ``x @ Wi.T + bi + bh``;
    ``wh (4H, H)``; ``h0``, ``c0 (N, H)``."""
    return LstmFunction.apply(x_proj, wh, h0, c0)


def gru_layer(x_proj, wh, bh, h0):
    """One GRU layer and direction over time: ``(ys, hn)``,
    differentiable.  ``x_proj (T, N, 3H)`` is ``x @ Wi.T + bi``; ``wh (3H,
    H)``; ``bh (3H)`` stays inside (the reset gate multiplies its n slot);
    ``h0 (N, H)``."""
    return GruFunction.apply(x_proj, wh, bh, h0)
