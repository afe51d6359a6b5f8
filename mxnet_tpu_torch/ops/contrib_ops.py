"""Contrib operators (ref: ``mxnet_tpu/ops/contrib_ops.py``).

Here: the CTC loss (ref: contrib_ops.py:25-107), ``_contrib_MoEFFN``
(ref: contrib_ops.py:816-830), the MoE feed-forward as a registered op,
so gluon blocks (``gluon.contrib.nn.MoEFFN``) and graphs can name it, and
the AMP helpers ``amp_cast``, ``amp_multicast``, ``all_finite`` and
``multi_all_finite`` (ref: contrib_ops.py:394-426).  The rest of the JAX
module (the detection and box ops and the other contrib layers) comes
with slice 9.
"""
from __future__ import annotations

import torch

from .registry import register

#: log(0) of the CTC recursion.  Not -inf: ``logaddexp(-inf, -inf)`` and a
#: ``where`` over it give NaN gradients, and an infeasible row's loss is
#: then about 1e30 with finite gradients, as the JAX op's.
_NEG = -1e30


class _LogAddExp(torch.autograd.Function):
    """``log(e^a + e^b)`` with ``jnp.logaddexp``'s gradient, ``g*e^(a -
    out)`` and ``g*e^(b - out)``.  (``torch.logaddexp``'s backward,
    ``g / (1 + e^(b - a))``, is the same function but where both inputs
    sit at the ``_NEG`` floor: there it gives 1/2 to each, the JAX op 1,
    and an infeasible row's gradient differs.)"""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.logaddexp(a, b)
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        return g * torch.exp(a - out), g * torch.exp(b - out)


_logaddexp = _LogAddExp.apply


def _k_ctc_loss(data, label, data_lengths=None, label_lengths=None,
                use_data_lengths=False, use_label_lengths=False,
                blank_label="first"):
    """Connectionist temporal classification: ``data (T, N, C)``
    unnormalized activations, ``label (N, L)`` padded; the loss of each
    sequence, ``(N,)`` fp32 (ref: ``_k_ctc_loss``, contrib_ops.py:28).

    ``blank_label='first'``: the blank is class 0, labels 1..C-1, padding
    0; ``'last'``: the blank is class C-1, labels 0..C-2, padding -1.
    Without ``label_lengths`` a row's length is its count of labels that
    are not padding; without ``data_lengths`` every row has T steps.

    The log-space alpha recursion over the expanded sequence (blank, l1,
    blank, ..., blank), one step of tensor ops per time step: a step past
    a row's ``data_length`` carries its alpha unchanged, a zero-length
    label scores the all-blank path, and a row that no path fits (T too
    short for its labels and the blanks between repeats) scores about
    1e30.  Lengths stay tensors, with no read on the host, so a CUDA graph
    can capture the loss (``torch.nn.functional.ctc_loss`` is not used: it
    gives ``inf`` for such a row and has its own blank and padding
    rules)."""
    T, N, C = data.shape
    L = label.shape[1]
    dev = data.device
    logp = torch.log_softmax(data.float(), dim=-1)
    lab = label.to(dev, torch.int64)
    if blank_label == "first":
        blank = 0
        pad_mask = lab > 0
    else:
        blank = C - 1
        pad_mask = lab >= 0
    if use_label_lengths and label_lengths is not None:
        lab_len = label_lengths.to(dev, torch.int64).reshape(N)
    else:
        lab_len = pad_mask.to(torch.int64).sum(dim=1)
    if use_data_lengths and data_lengths is not None:
        dat_len = data_lengths.to(dev, torch.int64).reshape(N)
    else:
        dat_len = torch.full((N,), T, dtype=torch.int64, device=dev)

    S = 2 * L + 1
    z = torch.full((N, S), blank, dtype=torch.int64, device=dev)
    z[:, 1::2] = torch.where(pad_mask, lab, torch.full_like(lab, blank))
    s_idx = torch.arange(S, device=dev)[None, :]
    s_valid = s_idx < (2 * lab_len + 1)[:, None]
    z_m2 = torch.cat([torch.full((N, 2), blank, dtype=torch.int64,
                                 device=dev), z], dim=1)[:, :S]
    can_skip = (z != blank) & (z != z_m2) & (s_idx >= 2)
    # logp[t, n, z[n, s]] for every t, (T, N, S), as a sum against the
    # one-hot of z: gather's backward adds the blank's many slots with
    # atomics on CUDA, in an order that changes from run to run
    onehot = (z[:, :, None] == torch.arange(C, device=dev)).float()
    emit = (logp[:, :, None, :] * onehot).sum(dim=-1)
    neg = torch.full((), _NEG, dtype=torch.float32, device=dev)

    alpha = torch.full((N, S), _NEG, dtype=torch.float32, device=dev)
    alpha[:, 0] = logp[0, :, blank]
    if S > 1:
        alpha[:, 1] = torch.where(lab_len > 0, emit[0, :, 1], neg)
    alpha = torch.where(s_valid, alpha, neg)
    pad2 = neg.expand(N, 2)
    for t in range(1, T):
        shifted = torch.cat([pad2, alpha], dim=1)
        a_m1 = shifted[:, 1:S + 1]
        a_m2 = shifted[:, :S]
        stay = _logaddexp(alpha, a_m1)
        merged = torch.where(can_skip, _logaddexp(stay, a_m2), stay)
        new = torch.where(s_valid, merged + emit[t], neg)
        alpha = torch.where((t < dat_len)[:, None], new, alpha)
    end = 2 * lab_len
    a_end = torch.gather(alpha, 1, end[:, None])[:, 0]
    a_end1 = torch.where(end - 1 >= 0, torch.gather(
        alpha, 1, (end - 1).clamp_min(0)[:, None])[:, 0], neg)
    return -_logaddexp(a_end, a_end1)


register("CTCLoss", _k_ctc_loss,
         arg_names=("data", "label", "data_lengths", "label_lengths"),
         aliases=("ctc_loss", "_contrib_ctc_loss", "_contrib_CTCLoss"))


def _k_moe_ffn(data, router_w, w1, b1, w2, b2, *, capacity_factor=1.25,
               top_k=1):
    """MoE FFN, top-1 (Switch) or top-2 (GShard) routing: data (S, M)
    -> (y (S, M), aux (1,)).  ``parallel.moe.moe_ffn`` is the math; with
    a rank's experts (E/ep of them) inside the ``DataParallelTrainer``'s
    step it runs the expert-parallel form over the ``ep`` group."""
    from ..parallel.moe import moe_ffn

    y, aux = moe_ffn(data, router_w, w1, b1, w2, b2, mesh=None,
                     capacity_factor=capacity_factor, top_k=int(top_k))
    return y, aux.reshape(1)


register("_contrib_MoEFFN", _k_moe_ffn,
         arg_names=("data", "router_w", "w1", "b1", "w2", "b2"),
         num_outputs=2)


# -- AMP helpers (ref: contrib_ops.py:394-426; amp_cast.cc, all_finite.cc) ----


def _k_amp_cast(data, dtype="float16"):
    """``data`` in ``dtype``."""
    from ..ndarray.ndarray import to_torch_dtype

    return data.to(to_torch_dtype(dtype))


def _k_amp_multicast(*arrays, num_outputs=0, cast_narrow=False):
    """Every input in one dtype: the widest, or with ``cast_narrow`` the
    narrowest (by item size; the first of equal ones)."""
    arrays = [a for a in arrays if a is not None]
    widths = [a.element_size() for a in arrays]
    pick = min(range(len(arrays)), key=lambda i: widths[i]) if cast_narrow \
        else max(range(len(arrays)), key=lambda i: widths[i])
    target = arrays[pick].dtype
    return tuple(a.to(target) for a in arrays)


def _k_all_finite(data, init_output=True):
    """``(1,)`` float32: 1 where every element is finite, else 0."""
    return torch.isfinite(data).all().to(torch.float32).reshape(1)


def _k_multi_all_finite(*arrays, num_arrays=0, init_output=True):
    """:func:`_k_all_finite` over every input at once."""
    ok = None
    for a in arrays:
        if a is not None:
            f = torch.isfinite(a).all()
            ok = f if ok is None else ok & f.to(ok.device)
    if ok is None:
        ok = torch.tensor(True)
    return ok.to(torch.float32).reshape(1)


register("amp_cast", _k_amp_cast, arg_names=("data",))
register("amp_multicast", _k_amp_multicast, arg_names=(), variadic=True,
         num_outputs=-1)
register("all_finite", _k_all_finite, arg_names=("data",), nondiff=True)
register("multi_all_finite", _k_multi_all_finite, arg_names=(),
         variadic=True, nondiff=True)
