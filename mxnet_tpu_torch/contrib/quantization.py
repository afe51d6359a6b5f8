"""Model quantization: calibration and the int8 gluon path (ref:
mxnet_tpu/contrib/quantization.py).

``quantize_net(net, ...)`` replaces the Dense and forward channel-first
Conv children of a gluon block, in place, by :class:`QuantizedDense` and
:class:`QuantizedConv`: HybridBlocks whose quantize -> int8 x int8 ->
int32 product -> requantize/bias -> dequantize chain runs on the ops of
``ops/quantization.py``, so a hybridized net captures it into its CUDA
graphs (``gluon.block.CachedOp``, ``CachedStepOp``).  The quantized
weight (int8), its per-output-channel scale vector, the float32 bias and
the calibrated ranges are Parameters that a graph reads in place: a
re-quantization writes them with ``copy_`` (``Parameter.set_data``) and
the next replay sees it, with no new capture.

Calibration modes: ``none`` (ranges computed per batch inside the
forward), ``naive`` (min/max over the calibration data) and ``entropy``
(KL-divergence-optimal thresholds).  Statistics accumulate on the device,
one host transfer per tensor (``_Stats``); the entropy histogram bins
``|x|`` by ``trunc(|x| * (bins / amax))`` in float32, the JAX package's
order of operations, counted with ``torch.bincount``.

``quantize_model`` rewrites a symbolic graph (``symbol/``): every
FullyConnected and Convolution node becomes quantize -> int8 op ->
[requantize] -> dequantize on weights quantized offline.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from .. import ndarray as nd
from .. import profiler
from .. import symbol as sym
from ..base import MXNetError
from ..context import current_context
from ..gluon import block as _gluon_block
from ..ndarray.ndarray import NDArray
from ..symbol.symbol import Group, Symbol, _make_op_symbol, _topo_order

_NUM_BINS = 8001


# -- window-scoped counters: the profiler's `quantize` section ----------------

_sec_lock = threading.Lock()
_sec = {"layers_quantized": 0, "calib_batches": 0, "calib_ms": 0.0,
        "requant_folds": 0, "int8_serve_batches": 0}


def _sec_bump(**deltas):
    with _sec_lock:
        for k, n in deltas.items():
            _sec[k] += n


def quantize_stats():
    """Window snapshot of the int8 counters (layers quantized,
    calibration batches and wall time, requantize folds, and int8 batches
    run through the serve tier)."""
    with _sec_lock:
        d = dict(_sec)
    d["calib_ms"] = round(d["calib_ms"], 3)
    return d


def reset_quantize_stats():
    with _sec_lock:
        for k in _sec:
            _sec[k] = 0.0 if k == "calib_ms" else 0


def note_int8_serve_batch(n=1):
    """Book ``n`` int8 batches (ModelServer batches, DecodeServer
    admission groups and token steps through a quantized net)."""
    _sec_bump(int8_serve_batches=n)


# -- calibration --------------------------------------------------------------


def _get_optimal_threshold(arr, num_bins=8001, num_quantized_bins=255):
    """KL-divergence-optimal |x| clipping threshold (ref:
    ``_get_optimal_threshold``, the TensorRT-style entropy calibration)."""
    a = np.abs(np.asarray(arr, np.float64).ravel())
    amax = float(a.max()) if a.size else 0.0
    if amax == 0.0:
        return 1e-8
    hist, edges = np.histogram(a, bins=num_bins, range=(0.0, amax))
    return _optimal_threshold_from_hist(hist, edges, num_quantized_bins)


def _optimal_threshold_from_hist(hist, edges, num_quantized_bins=255):
    """The KL search over an |x| histogram (ref: calibrate.cc keeps
    histograms, never raw samples)."""
    num_bins = len(hist)
    amax = float(edges[-1])
    if amax <= 0.0 or hist.sum() == 0:
        return 1e-8

    def smooth(d, eps=1e-4):
        # redistribute eps mass onto zero bins (ref: _smooth_distribution)
        nz = d > 0
        if not nz.any():
            return None
        out = d.astype(np.float64).copy()
        n_zero = d.size - nz.sum()
        if n_zero:
            take = eps * n_zero / nz.sum()
            out[nz] -= take * out[nz] / out[nz].max()
            out[~nz] = eps
        return out / out.sum()

    best_kl, best_t = np.inf, amax
    for i in range(num_quantized_bins, num_bins + 1,
                   max(1, num_bins // 200)):
        sliced = hist[:i].astype(np.float64)
        # P holds the clipped tail in its edge bin; Q is built without it,
        # which is what penalizes over-clipping
        p = sliced.copy()
        p[-1] += hist[i:].sum()
        if p.sum() == 0:
            continue
        nm = i // num_quantized_bins
        q = np.zeros(i, np.float64)
        for j in range(num_quantized_bins):
            lo = j * nm
            hi = i if j == num_quantized_bins - 1 else lo + nm
            seg = sliced[lo:hi]
            nz = np.count_nonzero(seg)
            if nz:
                q[lo:hi] = seg.sum() / nz
        q[sliced == 0] = 0
        pn, qn = smooth(p), smooth(q)
        if pn is None or qn is None:
            continue
        mask = pn > 0
        kl = float(np.sum(pn[mask] * np.log(pn[mask] / qn[mask])))
        if kl < best_kl:
            best_kl = kl
            best_t = float(edges[i if i < len(edges) else -1])
    return max(best_t, 1e-8)


def _k_calib_stats(x, entropy=False, bins=_NUM_BINS):
    """One batch's statistics on the device: min, max and, in entropy mode,
    the batch's |x| max and an |x| histogram over [0, batch amax]."""
    xf = x.to(torch.float32)
    mn = xf.min()
    mx = xf.max()
    if not entropy:
        return mn, mx
    ab = xf.abs().reshape(-1)
    amax = ab.max()
    # a tensor / tensor true division: ``bins / t`` would take the
    # reciprocal and multiply, one rounding away from the JAX package's
    width = torch.tensor(float(bins), device=x.device) / \
        torch.clamp(amax, min=1e-30)
    idx = torch.clamp((ab * width).to(torch.int32), 0, bins - 1)
    hist = torch.bincount(idx, minlength=bins).to(torch.float32)
    return mn, mx, amax, hist


class _Stats:
    """Running calibration statistics for one tensor: per-batch partials
    kept on the device and merged on the host by :meth:`finalize` (one
    transfer for every ``DRAIN_EVERY`` batches).  Entropy mode keeps one
    fixed-size |x| histogram, widened by bin center as the range grows."""

    NUM_BINS = _NUM_BINS
    DRAIN_EVERY = 64

    def __init__(self, mode):
        self.mode = mode
        self.mn = np.inf
        self.mx = -np.inf
        self.hist = None
        self.amax = 0.0
        self._dev = []

    def update_nd(self, arr):
        t = arr.data if isinstance(arr, NDArray) else arr
        self._dev.append(_k_calib_stats(t.detach(),
                                        entropy=self.mode == "entropy"))
        if len(self._dev) >= self.DRAIN_EVERY:
            self.finalize()

    def finalize(self):
        """Pull every device partial in one transfer and merge."""
        if not self._dev:
            return
        parts = [o.reshape(-1).to(torch.float32).cpu()
                 for outs in self._dev for o in outs]
        host = torch.cat(parts).numpy()
        pos = 0
        rows = []
        for _ in self._dev:
            row = [float(host[pos]), float(host[pos + 1])]
            pos += 2
            if self.mode == "entropy":
                amax = float(host[pos])
                pos += 1
                row += [amax, host[pos:pos + self.NUM_BINS]]
                pos += self.NUM_BINS
            rows.append(row)
        self._dev = []
        self.mn = min([self.mn] + [r[0] for r in rows])
        self.mx = max([self.mx] + [r[1] for r in rows])
        if self.mode != "entropy":
            return
        gmax = max([self.amax] + [r[2] for r in rows])
        if gmax <= 0.0:
            return
        if self.hist is not None and gmax > self.amax:
            self.hist = self._rebin(self.hist, self.amax, gmax)
        merged = self.hist.astype(np.float64) if self.hist is not None \
            else np.zeros(self.NUM_BINS, np.float64)
        for _mn, _mx, amax, hist in rows:
            if amax <= 0.0:
                continue
            merged += self._rebin(hist.astype(np.float64), amax, gmax)
        self.hist = merged
        self.amax = gmax

    @classmethod
    def _rebin(cls, hist, from_amax, to_amax):
        """Map a histogram over [0, from_amax] onto [0, to_amax] by bin
        center (one-bin blur at worst)."""
        if from_amax == to_amax:
            return hist
        centers = (np.arange(cls.NUM_BINS) + 0.5) * (from_amax
                                                     / cls.NUM_BINS)
        new_idx = np.minimum(
            (centers / to_amax * cls.NUM_BINS).astype(np.int64),
            cls.NUM_BINS - 1)
        widened = np.zeros(cls.NUM_BINS, hist.dtype)
        np.add.at(widened, new_idx, hist)
        return widened

    def update(self, a):
        """The host path: accumulate a numpy batch."""
        a = np.asarray(a)
        self.mn = min(self.mn, float(a.min()))
        self.mx = max(self.mx, float(a.max()))
        if self.mode != "entropy":
            return
        ab = np.abs(a.ravel().astype(np.float64))
        bmax = float(ab.max()) if ab.size else 0.0
        if self.hist is None:
            self.amax = max(bmax, 1e-12)
            self.hist = np.histogram(
                ab, bins=self.NUM_BINS, range=(0.0, self.amax))[0]
            return
        if bmax > self.amax:
            self.hist = self._rebin(self.hist, self.amax, bmax)
            self.amax = bmax
        self.hist = self.hist + np.histogram(
            ab, bins=self.NUM_BINS, range=(0.0, self.amax))[0]

    def range(self):
        self.finalize()
        if self.mode == "entropy" and self.hist is not None:
            edges = np.linspace(0.0, self.amax, self.NUM_BINS + 1)
            t = _optimal_threshold_from_hist(self.hist, edges)
            return -t, t
        return self.mn, self.mx


def _iter_calib_batches(calib_data, num_calib_examples=None):
    """Numpy data batches from an iterator, an NDArray, a tensor or an
    ndarray."""
    if isinstance(calib_data, (NDArray, np.ndarray, torch.Tensor)):
        yield _host(calib_data)
        return
    seen = 0
    if hasattr(calib_data, "reset"):
        calib_data.reset()
    for batch in calib_data:
        data = batch.data[0] if (hasattr(batch, "data") and not isinstance(
            batch, (np.ndarray, NDArray, torch.Tensor))) else batch
        if isinstance(data, (list, tuple)):
            data = data[0]
        arr = _host(data)
        yield arr
        seen += arr.shape[0]
        if num_calib_examples is not None and seen >= num_calib_examples:
            return


def _host(a):
    if isinstance(a, NDArray):
        return a.asnumpy()
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


# -- the symbolic path --------------------------------------------------------

_QUANTIZABLE = ("FullyConnected", "Convolution")


def _collect_layer_stats(symbol, arg_params, aux_params, targets, calib_data,
                         calib_mode, data_name, num_calib_examples, ctx):
    """Forward the calibration batches through the float32 graph, keeping
    the statistics of each target node's data input and output (ref:
    ``_collect_layer_stats``, mxnet_tpu/contrib/quantization.py:341): one
    executor over a ``Group`` of those outputs."""
    handles, keys = [], []
    for node in targets:
        src, oi = node.inputs[0]
        handles.append(Symbol(src, oi))
        keys.append((node.name, "data"))
        handles.append(Symbol(node, 0))
        keys.append((node.name, "out"))
    group = Group(handles)
    stats = {k: _Stats(calib_mode) for k in keys}
    # the batches are taken once: calib_data may be a generator, and the
    # first batch binds the executor
    batches = list(_iter_calib_batches(calib_data, num_calib_examples))
    if not batches:
        raise MXNetError("calibration data yielded no batches")
    args = dict(arg_params)
    args[data_name] = nd.array(batches[0], ctx=ctx)
    ex = group.bind(ctx, args, grad_req="null",
                    aux_states=dict(aux_params) if aux_params else None)
    t0 = time.monotonic()
    with profiler.op_scope("quantize.calibrate", cat="quantize"):
        for arr in batches:
            outs = ex.forward(is_train=False,
                              **{data_name: nd.array(arr, ctx=ctx)})
            for k, o in zip(keys, outs):
                stats[k].update_nd(o)
            _sec_bump(calib_batches=1)
        ranges = {k: s.range() for k, s in stats.items()}
    _sec_bump(calib_ms=(time.monotonic() - t0) * 1e3)
    return ranges


def _np_quantize(a):
    """Symmetric per-tensor int8 of a weight: ``(q, -r, r)`` as NDArrays on
    the current context, ``r`` the largest magnitude (ref:
    ``_np_quantize``, mxnet_tpu/contrib/quantization.py:499)."""
    r = float(np.max(np.abs(a))) or 1e-8
    q = np.clip(np.round(a * (127.0 / r)), -127, 127).astype(np.int8)
    return nd.array(q), nd.array(np.float32(-r).reshape(())), \
        nd.array(np.float32(r).reshape(()))


def _offline_quantize(name, arr, qarg_params):
    """Quantize a parameter offline into ``<name>_quantize``, ``_min`` and
    ``_max`` of ``qarg_params``; returns their variables."""
    q, qmin, qmax = _np_quantize(_host(arr))
    qarg_params[name + "_quantize"] = q
    qarg_params[name + "_min"] = qmin
    qarg_params[name + "_max"] = qmax
    return (sym.var(name + "_quantize"), sym.var(name + "_min"),
            sym.var(name + "_max"))


def quantize_model(symbol, arg_params, aux_params=None, data_names=("data",),
                   excluded_sym_names=(), calib_mode="none", calib_data=None,
                   num_calib_examples=None, quantized_dtype="int8",
                   ctx=None, logger=None):
    """Quantize a symbolic model to int8 (ref: ``quantize_model``,
    mxnet_tpu/contrib/quantization.py:396): ``(qsym, qarg_params,
    aux_params)``.

    Every FullyConnected and Convolution node whose weight is a variable
    (and whose name is not in ``excluded_sym_names``) becomes
    ``_contrib_quantize_v2`` -> ``_contrib_quantized_fully_connected`` or
    ``_contrib_quantized_conv`` on weights quantized offline (per tensor)
    -> [``_contrib_requantize`` to the calibrated output range] ->
    ``_contrib_dequantize``; everything else stays float32.  With
    ``calib_mode`` ``naive`` (min/max) or ``entropy`` (KL thresholds) the
    data and output ranges come from forwarding ``calib_data`` through the
    float32 graph on ``ctx``; with ``none`` they are computed per batch.
    Bind the result with ``Symbol.bind`` and every array given (its
    ``*_quantize``/``_min``/``_max`` inputs have no shape rule: ROADMAP
    caveat (n))."""
    if quantized_dtype not in ("int8", "auto"):
        raise MXNetError(f"unsupported quantized_dtype {quantized_dtype!r}"
                         " (the port quantizes to signed int8)")
    ctx = ctx or current_context()
    aux_params = aux_params or {}
    nodes = _topo_order([symbol._node])
    targets = [n for n in nodes if n.op in _QUANTIZABLE
               and n.name not in set(excluded_sym_names)
               and n.inputs[1][0].op is None]   # the weight is a variable

    calib_tbl = {}
    if calib_mode != "none":
        if calib_data is None:
            raise MXNetError(f"calib_mode={calib_mode!r} needs calib_data")
        calib_tbl = _collect_layer_stats(
            symbol, arg_params, aux_params, targets, calib_data, calib_mode,
            data_names[0], num_calib_examples, ctx)
        if logger:
            for k, v in calib_tbl.items():
                logger.info("calib %s: [%g, %g]", k, *v)

    qarg_params = {}
    target_ids = {id(n) for n in targets}
    rewritten = {}

    def handle(src, oi):
        return Symbol(rewritten[id(src)], oi)

    for n in nodes:
        if n.op is None:
            rewritten[id(n)] = sym.var(n.name)._node
            continue
        ins = [handle(s, oi) for s, oi in n.inputs]
        if id(n) not in target_ids:
            rewritten[id(n)] = _make_op_symbol(n.op, ins, dict(n.attrs),
                                               name=n.name)._node
            continue
        dr = calib_tbl.get((n.name, "data"))
        qattrs = {"out_type": "int8"}
        if dr is not None:
            qattrs.update(min_calib_range=dr[0], max_calib_range=dr[1])
        qd = _make_op_symbol("_contrib_quantize_v2", [ins[0]], qattrs,
                             name=n.name + "_quantize")
        wname = n.inputs[1][0].name
        qw, wmin, wmax = _offline_quantize(wname, arg_params[wname],
                                           qarg_params)
        no_bias = len(n.inputs) < 3 or bool(n.attrs.get("no_bias", False))
        if not no_bias:
            bname = n.inputs[2][0].name
            qb, bmin, bmax = _offline_quantize(bname, arg_params[bname],
                                               qarg_params)
            q_ins = [qd[0], qw, qb, qd[1], qd[2], wmin, wmax, bmin, bmax]
        else:
            q_ins = [qd[0], qw, qd[1], qd[2], wmin, wmax]
        qop = ("_contrib_quantized_fully_connected"
               if n.op == "FullyConnected" else "_contrib_quantized_conv")
        attrs = dict(n.attrs)
        for k in ("cudnn_tune", "cudnn_off", "workspace"):
            attrs.pop(k, None)
        attrs["no_bias"] = no_bias
        qnode = _make_op_symbol(qop, q_ins, attrs, name=n.name + "_int8")
        out, omin, omax = qnode[0], qnode[1], qnode[2]
        orr = calib_tbl.get((n.name, "out"))
        if orr is not None:
            rq = _make_op_symbol(
                "_contrib_requantize", [out, omin, omax],
                {"min_calib_range": orr[0], "max_calib_range": orr[1]},
                name=n.name + "_requantize")
            out, omin, omax = rq[0], rq[1], rq[2]
        deq = _make_op_symbol("_contrib_dequantize", [out, omin, omax], {},
                              name=n.name + "_dequantize")
        rewritten[id(n)] = deq._node

    qsym = Symbol(rewritten[id(symbol._node)], symbol._index)
    # the float32 parameters the rewritten graph still reads (replaced
    # weights drop out of its arguments)
    for name in qsym.list_arguments():
        if name not in qarg_params and name in arg_params:
            qarg_params[name] = arg_params[name]
    return qsym, qarg_params, dict(aux_params)


# -- the gluon path -----------------------------------------------------------


def _np_quantize_per_channel(a, per_channel=True):
    """Offline symmetric int8 weight quantization with per-output-channel
    ranges (axis 0 of Dense ``(U, I)`` and Conv ``(O, I, *k)`` weights);
    per-tensor mode returns a length-1 range vector."""
    a = np.asarray(a, np.float32)
    if per_channel and a.ndim >= 2:
        r = np.abs(a.reshape(a.shape[0], -1)).max(axis=1)
    else:
        r = np.abs(a).max().reshape(1)
    r = np.maximum(r, 1e-8).astype(np.float32)
    scale = 127.0 / r.reshape((-1,) + (1,) * (a.ndim - 1))
    q = np.clip(np.round(a * scale), -127, 127).astype(np.int8)
    return q, r


_UNCALIBRATED_INT8 = (
    "an int8 input needs calibrated ranges to interpret it: this quantized "
    "layer was built without calibration (dynamic ranges) -- quantize the "
    "whole chain with calib_data= so the boundary range is known")


def _quantize_input(F, x, in_min, in_max, calibrated):
    if x.dtype == torch.int8:
        if not calibrated:
            raise MXNetError(_UNCALIBRATED_INT8)
        return x, in_min, in_max
    if calibrated:
        return F.contrib.quantize(x, in_min, in_max)
    return F.contrib.quantize_v2(x)


def _quantized_dense_forward(F, x, qweight, wscale, bias, in_min, in_max,
                             out_min, out_max, *, units, flatten, act,
                             calibrated, out_int8):
    """quantize -> int8 x int8 -> int32 product (per-channel scales, the
    bias added in int32) -> requantize -> dequantize.  An int8 input (a
    folded upstream boundary) is read at the in_min/in_max range."""
    qx, dmn, dmx = _quantize_input(F, x, in_min, in_max, calibrated)
    if bias is None:
        acc, omn, omx = F.contrib.quantized_dense_pc(
            qx, qweight, wscale, dmn, dmx, num_hidden=units, no_bias=True,
            flatten=flatten)
    else:
        acc, omn, omx = F.contrib.quantized_dense_pc(
            qx, qweight, wscale, bias, dmn, dmx, num_hidden=units,
            flatten=flatten)
    return _finish_quantized(F, acc, omn, omx, out_min, out_max, act=act,
                             calibrated=calibrated, out_int8=out_int8)


def _quantized_conv_forward(F, x, qweight, wscale, bias, in_min, in_max,
                            out_min, out_max, *, conv_kwargs, act,
                            calibrated, out_int8):
    """The int8 Convolution chain (see ``_quantized_dense_forward``)."""
    qx, dmn, dmx = _quantize_input(F, x, in_min, in_max, calibrated)
    if bias is None:
        acc, omn, omx = F.contrib.quantized_conv_pc(
            qx, qweight, wscale, dmn, dmx, no_bias=True, **conv_kwargs)
    else:
        acc, omn, omx = F.contrib.quantized_conv_pc(
            qx, qweight, wscale, bias, dmn, dmx, **conv_kwargs)
    return _finish_quantized(F, acc, omn, omx, out_min, out_max, act=act,
                             calibrated=calibrated, out_int8=out_int8)


def _finish_quantized(F, acc, omn, omx, out_min, out_max, *, act,
                      calibrated, out_int8):
    """Calibrated relu/linear layers requantize the int32 accumulator to
    the calibrated int8 range (relu applied in int8), then hand the int8
    tensor to a folded consumer or dequantize; other activations
    dequantize first."""
    if calibrated and act in (None, "relu"):
        q8, rmn, rmx = F.contrib.requantize_v2(acc, omn, omx, out_min,
                                               out_max, act=act)
        if out_int8:
            return q8
        return F.contrib.dequantize(q8, rmn, rmx)
    out = F.contrib.dequantize(acc, omn, omx)
    if act:
        out = F.Activation(out, act_type=act)
    return out


_RANGE_NAMES = ("in_min", "in_max", "out_min", "out_max")


class _QuantizedBase:
    """Parameter creation from host arrays, the calibrated ranges, and
    re-quantization for float32 weight reloads."""

    def _adopt_params(self, layer, data_range, out_range, per_channel):
        self._per_channel = bool(per_channel)
        self._calibrated = data_range is not None
        self._out_int8 = False
        ctxs = layer.weight.list_ctx()
        w = layer.weight.data().detach().cpu().numpy()
        q, r = _np_quantize_per_channel(w, self._per_channel)
        self.qweight = self._make_param("qweight", q, ctxs)
        self.wscale = self._make_param("wscale", r, ctxs)
        self.bias = (self._make_param(
            "bias", layer.bias.data().detach().cpu().numpy(), ctxs)
            if layer.bias is not None else None)
        if self._calibrated:
            orr = out_range if out_range is not None else data_range
            self._make_ranges((data_range[0], data_range[1], orr[0], orr[1]),
                              ctxs)

    def _make_ranges(self, values, ctxs):
        """The four calibrated-range Parameters, from ``values`` (in_min,
        in_max, out_min, out_max); the layer counts as calibrated."""
        for name, v in zip(_RANGE_NAMES, values):
            setattr(self, name, self._make_param(name, np.float32(v), ctxs))
        self._calibrated = True

    def _make_param(self, name, arr, ctxs):
        arr = np.asarray(arr)
        p = self.params.get(name, shape=arr.shape, dtype=str(arr.dtype),
                            grad_req="null")
        p._place(list(ctxs), torch.from_numpy(np.array(arr)).to(
            ctxs[0].torch_device()))
        return p

    def requantize_from(self, weight, bias=None):
        """Re-quantize this layer from float32 weights against the stored
        per-channel scales, keeping the calibrated ranges: the values are
        copied into the existing Parameters, so a captured graph replays
        on them with no new capture.  Weights beyond the stored scale
        clip."""
        w = _host(weight).astype(np.float32)
        r = self.wscale.data().detach().cpu().numpy()
        scale = 127.0 / r.reshape((-1,) + (1,) * (w.ndim - 1))
        q = np.clip(np.round(w * scale), -127, 127).astype(np.int8)
        self.qweight.set_data(q)
        if self.bias is not None:
            if bias is None:
                raise MXNetError(
                    f"quantized layer {self.name!r} has a bias but the "
                    "reload supplied none")
            self.bias.set_data(_host(bias).astype(np.float32))


class QuantizedDense(_QuantizedBase, _gluon_block.HybridBlock):
    """The int8 replacement of ``nn.Dense`` (see the module docstring)."""

    def __init__(self, layer, data_range=None, out_range=None,
                 per_channel=True):
        super().__init__(prefix=layer._prefix, params=None)
        self._units = layer._units
        self._flatten = layer._flatten
        self._activation = layer._activation
        self._adopt_params(layer, data_range, out_range, per_channel)

    def hybrid_forward(self, F, x, qweight, wscale, bias=None, in_min=None,
                       in_max=None, out_min=None, out_max=None):
        return _quantized_dense_forward(
            F, x, qweight, wscale, bias, in_min, in_max, out_min, out_max,
            units=self._units, flatten=self._flatten, act=self._activation,
            calibrated=self._calibrated, out_int8=self._out_int8)


class QuantizedConv(_QuantizedBase, _gluon_block.HybridBlock):
    """The int8 replacement of a channel-first forward convolution
    (``nn.Conv2D``)."""

    def __init__(self, layer, data_range=None, out_range=None,
                 per_channel=True):
        super().__init__(prefix=layer._prefix, params=None)
        kw = dict(layer._kwargs)
        for drop in ("layout", "no_bias", "adj"):
            kw.pop(drop, None)
        self._kwargs = kw
        self._activation = layer._activation
        self._adopt_params(layer, data_range, out_range, per_channel)

    def hybrid_forward(self, F, x, qweight, wscale, bias=None, in_min=None,
                       in_max=None, out_min=None, out_max=None):
        return _quantized_conv_forward(
            F, x, qweight, wscale, bias, in_min, in_max, out_min, out_max,
            conv_kwargs=self._kwargs, act=self._activation,
            calibrated=self._calibrated, out_int8=self._out_int8)


def _quantizable(child, exclude):
    """Dense, or a channel-first forward Convolution block."""
    from ..gluon import nn as gnn
    from ..gluon.nn.conv_layers import _Conv

    if child.name in exclude:
        return False
    if isinstance(child, gnn.Dense):
        return True
    return isinstance(child, _Conv) and not child._channel_last


def _release_stale_caches(block):
    """Drop the captured float32 graphs after the rewrite; the next call
    captures through the int8 wrappers."""
    if getattr(block, "_cached_op", None) is not None:
        block._cached_op = None
    for child in block._children.values():
        _release_stale_caches(child)


def _calibrate_gluon(network, targets, calib_data, calib_mode,
                     num_calib_examples, calib_forward):
    """Forward the calibration batches through the float32 net with hooks
    on every target layer accumulating its input and output statistics
    on the device."""
    stats = {id(t[2]): (_Stats(calib_mode), _Stats(calib_mode))
             for t in targets}
    hooks = []
    for _, _, layer in targets:
        def hook(block, inputs, output, _s=stats):
            s_in, s_out = _s[id(block)]
            s_in.update_nd(inputs[0])
            out = output[0] if isinstance(output, (tuple, list)) else output
            s_out.update_nd(out)
        hooks.append(layer.register_forward_hook(hook))
    # calibration needs eager child forwards (a replayed graph would skip
    # the children's hooks): deactivate hybridized blocks, restore after
    deactivated = []

    def _deact(b):
        if getattr(b, "_active", False):
            deactivated.append(b)
            b._active = False
        for c in b._children.values():
            _deact(c)

    _deact(network)
    t0 = time.monotonic()
    try:
        with profiler.op_scope("quantize.calibrate", cat="quantize"):
            n = 0
            for arr in _iter_calib_batches(calib_data, num_calib_examples):
                x = nd.array(arr)
                if calib_forward is not None:
                    calib_forward(network, x)
                else:
                    network(x)
                n += 1
                _sec_bump(calib_batches=1)
            if n == 0:
                raise MXNetError("calibration data yielded no batches")
            ranges = {}
            uncovered = []
            for _, _, layer in targets:
                s_in, s_out = stats[id(layer)]
                r_in, r_out = s_in.range(), s_out.range()
                # a layer the forward never ran has (inf, -inf) stats
                if not np.isfinite(r_in).all() \
                        or not np.isfinite(r_out).all():
                    uncovered.append(layer.name)
                    continue
                ranges[id(layer)] = (r_in, r_out)
            if uncovered:
                how = "calib_forward" if calib_forward is not None \
                    else "network(x)"
                raise MXNetError(
                    f"calibration never exercised quantizable layer(s) "
                    f"{uncovered}: the calibration forward ({how}) must run "
                    "every layer being quantized -- cover the missing path "
                    "or list the layer in exclude_layers")
    finally:
        for h in hooks:
            h.detach()
        for b in deactivated:
            b._active = True
    _sec_bump(calib_ms=(time.monotonic() - t0) * 1e3)
    return ranges


def _fold_requantize(network):
    """For consecutive calibrated quantized layers of a (Hybrid)Sequential,
    fold the producer's requantize -> dequantize and the consumer's
    quantize into the producer's requantize: the producer emits int8 at
    its calibrated output range, which the consumer reads.  Only
    linear/relu producers fold."""
    folds = 0

    def walk(block):
        nonlocal folds
        layers = getattr(block, "_layers", None)
        if layers:
            for a, b in zip(layers, layers[1:]):
                if (isinstance(a, (QuantizedDense, QuantizedConv))
                        and isinstance(b, (QuantizedDense, QuantizedConv))
                        and a._calibrated and b._calibrated
                        and a._activation in (None, "relu")):
                    a._out_int8 = True
                    b.in_min.set_data(a.out_min.data())
                    b.in_max.set_data(a.out_max.data())
                    folds += 1
        for child in block._children.values():
            walk(child)

    walk(network)
    return folds


def quantize_net(network, calib_data=None, calib_mode="naive",
                 exclude_layers=None, num_calib_examples=None,
                 quantized_dtype="int8", per_channel=True, fold=True,
                 calib_forward=None):
    """Quantize a gluon network's Dense/Conv layers to int8 in place (ref:
    ``quantize_net``, mxnet_tpu/contrib/quantization.py:866).

    With ``calib_data`` the activation ranges are calibrated (``naive``
    min/max or ``entropy`` KL); without, they are computed per batch in
    the forward.  ``per_channel`` uses per-output-channel weight scales;
    ``fold`` keeps activations int8 across adjacent calibrated layers;
    ``calib_forward(net, batch)`` replaces ``net(batch)`` as the
    calibration forward (a decode model: ``lambda m, x: m.prefill(...)``).
    Batches are made with ``nd.array`` on the current context."""
    if quantized_dtype not in ("int8", "auto"):
        raise MXNetError(f"unsupported quantized_dtype {quantized_dtype!r}"
                         " (the port quantizes to signed int8)")
    exclude = set(exclude_layers or ())
    targets = []   # (parent, child_key, layer)

    def walk(block):
        for key, child in list(block._children.items()):
            if _quantizable(child, exclude):
                targets.append((block, key, child))
            else:
                walk(child)

    walk(network)
    ranges = {}
    if calib_data is not None and calib_mode != "none":
        ranges = _calibrate_gluon(network, targets, calib_data, calib_mode,
                                  num_calib_examples, calib_forward)

    from ..gluon import nn as gnn

    for parent, key, layer in targets:
        dr, orr = ranges.get(id(layer), (None, None))
        wrapper_cls = (QuantizedDense if isinstance(layer, gnn.Dense)
                       else QuantizedConv)
        wrapper = wrapper_cls(layer, data_range=dr, out_range=orr,
                              per_channel=per_channel)
        parent._children[key] = wrapper
        # (Hybrid)Sequential iterates _layers
        layers = getattr(parent, "_layers", None)
        if layers is not None:
            for i, lyr in enumerate(layers):
                if lyr is layer:
                    layers[i] = wrapper
    _sec_bump(layers_quantized=len(targets))

    if fold and ranges:
        _sec_bump(requant_folds=_fold_requantize(network))

    _release_stale_caches(network)
    network._int8_quantized = True
    return network


# -- serving reloads: float32 training checkpoints into a quantized net -------


def _iter_quantized(block, prefix=""):
    for name, child in block._children.items():
        p = prefix + name + "."
        if isinstance(child, (QuantizedDense, QuantizedConv)):
            yield p, child
        else:
            yield from _iter_quantized(child, p)


def apply_fp32_params(qnet, loaded):
    """Re-quantize a quantized net in place from a float32 twin's
    ``name -> array`` dict (a training checkpoint of the unquantized
    architecture): each quantized layer's weight against its stored
    per-channel scales, biases copied, calibrated ranges kept, every other
    parameter copied.  Raises on any structural mismatch."""
    loaded = dict(loaded)
    wrappers = dict(_iter_quantized(qnet))
    if not wrappers:
        raise MXNetError(
            "apply_fp32_params: network has no quantized layers -- run "
            "contrib.quantization.quantize_net first")
    for path, wrapper in wrappers.items():
        wkey = path + "weight"
        if wkey not in loaded:
            raise MXNetError(
                f"fp32 reload: checkpoint is missing {wkey!r} for "
                f"quantized layer {wrapper.name!r} -- was it saved from "
                "a different architecture?")
        w = loaded.pop(wkey)
        b = loaded.pop(path + "bias", None)
        wrapper.requantize_from(w, b)
    rest = {k: v for k, v in qnet._collect_params_with_prefix().items()
            if not any(k.startswith(p) for p in wrappers)}
    extra = sorted(set(loaded) - set(rest))
    missing = sorted(set(rest) - set(loaded))
    if extra or missing:
        raise MXNetError(
            "fp32 reload: parameter names do not line up with the "
            f"quantized net (extra in checkpoint: {extra}; missing from "
            f"checkpoint: {missing})")
    for k, v in loaded.items():
        rest[k].set_data(v)


def load_serving_params(net, loaded):
    """Reload dispatch for a quantized serving net: an int8-native dict
    (saved from the quantized net) is copied in directly; a float32 dict
    (the training twin's) is re-quantized by :func:`apply_fp32_params`.
    ``ModelServer``/``DecodeServer.reload_weights()`` come here."""
    if not loaded:
        raise MXNetError(
            "reload: checkpoint holds no parameters (saved without "
            "params=?)")
    own = net._collect_params_with_prefix()
    if any(k.endswith("qweight") for k in loaded):
        extra = sorted(set(loaded) - set(own))
        missing = sorted(set(own) - set(loaded))
        if extra or missing:
            raise MXNetError(
                "int8 reload: parameter names do not line up with the "
                f"quantized net (extra in checkpoint: {extra}; missing "
                f"from checkpoint: {missing})")
        for k, p in own.items():
            p.set_data(loaded[k])
    else:
        apply_fp32_params(net, loaded)


def adopt_ranges(net, arrays):
    """Give each uncalibrated quantized layer of ``net`` whose ranges
    ``arrays`` ({structural name: array}) holds its calibrated-range
    Parameters, so the arrays of a calibrated net (the JAX package's, or a
    saved one) load into it (``convert.load_numpy_params``).  Returns the
    layers that took ranges."""
    took = []
    for path, wrapper in _iter_quantized(net):
        names = [path + n for n in _RANGE_NAMES]
        if wrapper._calibrated or not all(n in arrays for n in names):
            continue
        wrapper._make_ranges([np.asarray(arrays[n], np.float32)
                              for n in names], wrapper.qweight.list_ctx())
        took.append(path[:-1])
    return took
