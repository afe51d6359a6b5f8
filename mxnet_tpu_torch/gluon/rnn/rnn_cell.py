"""Recurrent cells (ref: ``mxnet_tpu/gluon/rnn/rnn_cell.py``, after
python/mxnet/gluon/rnn/rnn_cell.py).

Explicit per-step cells for custom unrolling, beside the fused layers of
``rnn_layer.py``.  ``cell(x, states)`` runs one step and returns
``(output, new_states)``; ``unroll`` runs the Python loop over time.  The
gate orders are the fused op's (``ops/rnn.py``): (i, f, g, o) for the
LSTM, (r, z, n) for the GRU, so a fused layer's ``l{k}_*`` weights drive
the cells unchanged.

Cells compute on tensors; NDArray inputs are the public boundary, and a
call that gets one returns NDArrays.  Default states are zeros made on the
input's device.  Layer 0's ``i2h_weight`` input width is deferred to the
first input.
"""
from __future__ import annotations

import torch

from ... import autograd
from ... import ndarray as F
from ..._imperative import _wrap
from ...base import MXNetError
from ...context import Context, current_context, replica_scope
from ...ndarray.ndarray import NDArray, as_tensor
from ..block import HybridBlock


def _boundary(*arrays):
    """The context of the first NDArray of ``arrays`` (None: none is)."""
    return next((a.context for a in arrays if isinstance(a, NDArray)), None)


def _at_boundary(ctx, fn, *args):
    """``fn(*args)``; at an NDArray boundary (``ctx`` not None) under that
    context's replica scope, its outputs wrapped on it."""
    if ctx is None:
        return fn(*args)
    with replica_scope(ctx):
        return _wrap(fn(*args), ctx)


class RecurrentCell(HybridBlock):
    """Base of the cells (ref: gluon.rnn.RecurrentCell)."""

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, ctx=None, **kwargs):
        """Zero states (NDArrays of :meth:`state_info`'s shapes) on ``ctx``
        (a Context or ``torch.device``; default :func:`current_context`);
        ``func`` is accepted and unused, as in the reference."""
        ctx = ctx or current_context()
        device = ctx.torch_device() if isinstance(ctx, Context) else ctx
        return [NDArray(t) for t in self._zeros(batch_size, device)]

    def _zeros(self, batch_size, device):
        return [torch.zeros(info["shape"], device=device)
                for info in self.state_info(batch_size)]

    def reset(self):
        """Forget what a previous unroll left (ref: RecurrentCell.reset)."""

    def __call__(self, x, states=None, **kwargs):
        """One step: ``(output, new_states)``; ``states`` default to zeros
        on ``x``'s device."""
        boundary = _boundary(x, *(states or ()))
        x = as_tensor(x)
        states = self._zeros(x.shape[0], x.device) if states is None \
            else [as_tensor(s) for s in states]
        return _at_boundary(boundary, self._step, x, states)

    def _step(self, x, states):
        """One step on tensors through the block's forward (hybridized:
        one captured graph per input signature)."""
        return super().__call__(x, *states)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """``length`` steps over ``inputs`` (ref: RecurrentCell.unroll):
        ``(outputs, states)``, the outputs stacked on the time axis unless
        ``merge_outputs`` is False (then a list of steps), and masked to
        zero past each row's ``valid_length``.  The states are those after
        the last step, as in the reference.  With ``merge_outputs=False``
        and ``valid_length``, which the reference cannot run (ROADMAP.md,
        reference caveat (h)), each step of the masked outputs."""
        if layout not in ("NTC", "TNC"):
            raise MXNetError(f"unroll: layout must be NTC or TNC, not "
                             f"{layout!r}")
        boundary = _boundary(inputs, valid_length, *(begin_state or ()))
        states = None if begin_state is None else [as_tensor(s)
                                                   for s in begin_state]
        vl = None if valid_length is None else as_tensor(valid_length)
        return _at_boundary(boundary, self._unroll, length, as_tensor(inputs),
                            states, layout, merge_outputs, vl)

    def _unroll(self, length, x, states, layout, merge_outputs, vl):
        axis = 1 if layout == "NTC" else 0
        if states is None:
            states = self._zeros(x.shape[1 - axis], x.device)
        outputs = []
        for t in range(length):
            out, states = self._step(x[:, t] if axis else x[t], states)
            outputs.append(out)
        merge = merge_outputs is None or merge_outputs
        if merge or vl is not None:
            outputs = torch.stack(outputs, dim=axis)
        if vl is not None:
            outputs = F.SequenceMask(
                outputs if axis == 0 else outputs.transpose(0, 1), vl,
                use_sequence_length=True)
            if axis:
                outputs = outputs.transpose(0, 1)
            if not merge:
                outputs = list(outputs.unbind(axis))
        return outputs, states


class _GatedCell(RecurrentCell):
    """The i2h and h2h products of ``gates`` gates of ``hidden_size``."""

    _gates = 1

    def __init__(self, hidden_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(**kwargs)
        self._hidden_size = hidden_size
        gh = self._gates * hidden_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(gh, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(gh, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(gh,), init=i2h_bias_initializer,
            allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(gh,), init=h2h_bias_initializer,
            allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size)}]

    def infer_shape(self, x, *args):
        self.i2h_weight.shape = (self._gates * self._hidden_size,
                                 x.shape[-1])

    def _products(self, F, x, h, i2h_weight, h2h_weight, i2h_bias,
                  h2h_bias):
        n = self._gates * self._hidden_size
        return (F.FullyConnected(x, i2h_weight, i2h_bias, num_hidden=n),
                F.FullyConnected(h, h2h_weight, h2h_bias, num_hidden=n))


class RNNCell(_GatedCell):
    """Elman cell, ``act(W_i x + b_i + W_h h + b_h)`` (ref: RNNCell)."""

    def __init__(self, hidden_size, activation="tanh", input_size=0,
                 **kwargs):
        super().__init__(hidden_size, input_size, **kwargs)
        self._activation = activation

    def hybrid_forward(self, F, x, h, **params):
        i2h, h2h = self._products(F, x, h, **params)
        out = F.Activation(i2h + h2h, act_type=self._activation)
        return out, [out]


class LSTMCell(_GatedCell):
    """Gate order (i, f, g, o), as the fused op's (ref: LSTMCell)."""

    _gates = 4

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size)},
                {"shape": (batch_size, self._hidden_size)}]

    def hybrid_forward(self, F, x, h, c, **params):
        i2h, h2h = self._products(F, x, h, **params)
        i, f, g, o = F.split(i2h + h2h, num_outputs=4, axis=-1)
        c_new = F.sigmoid(f) * c + F.sigmoid(i) * F.tanh(g)
        h_new = F.sigmoid(o) * F.tanh(c_new)
        return h_new, [h_new, c_new]


class GRUCell(_GatedCell):
    """Gate order (r, z, n), as the fused op's; the reset gate scales the
    h2h product with its bias (ref: GRUCell)."""

    _gates = 3

    def hybrid_forward(self, F, x, h, **params):
        gi, gh = self._products(F, x, h, **params)
        ir, iz, inn = F.split(gi, num_outputs=3, axis=-1)
        hr, hz, hn = F.split(gh, num_outputs=3, axis=-1)
        r = F.sigmoid(ir + hr)
        z = F.sigmoid(iz + hz)
        n = F.tanh(inn + r * hn)
        h_new = (1 - z) * n + z * h
        return h_new, [h_new]


class SequentialRNNCell(RecurrentCell):
    """Cells stacked, each one's output the next one's input (ref:
    SequentialRNNCell); children are named ``0``, ``1``, ..."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._cells = []

    def add(self, cell):
        self.register_child(cell, str(len(self._cells)))
        self._cells.append(cell)

    def state_info(self, batch_size=0):
        return [info for c in self._cells
                for info in c.state_info(batch_size)]

    def _step(self, x, states):
        next_states, i = [], 0
        for cell in self._cells:
            n = len(cell.state_info())
            x, cell_states = cell._step(x, states[i:i + n])
            next_states.extend(cell_states)
            i += n
        return x, next_states


class HybridSequentialRNNCell(SequentialRNNCell):
    """Stacked cells (ref: HybridSequentialRNNCell, the same stacking;
    each child's forward is captured when it is hybridized)."""


class DropoutCell(RecurrentCell):
    """Dropout on the input, no state (ref: DropoutCell)."""

    def __init__(self, rate, **kwargs):
        super().__init__(**kwargs)
        self._rate = rate

    def state_info(self, batch_size=0):
        return []

    def _step(self, x, states):
        return F.Dropout(x, p=self._rate), list(states)


class ModifierCell(RecurrentCell):
    """Base of the cells that wrap another, ``base_cell`` (ref:
    ModifierCell)."""

    def __init__(self, base_cell, **kwargs):
        super().__init__(**kwargs)
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        return self.base_cell.begin_state(batch_size, func=func, **kwargs)


class ResidualCell(ModifierCell):
    """The base cell's output plus its input (ref: ResidualCell)."""

    def _step(self, x, states):
        out, states = self.base_cell._step(x, states)
        return out + x, states


class ZoneoutCell(ModifierCell):
    """Zoneout (ref: ZoneoutCell): in training each output and state
    element keeps its previous value with probability ``zoneout_outputs``
    or ``zoneout_states``; the draws come from the device's explicit
    generator.  In predict mode the base cell's step."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0,
                 **kwargs):
        super().__init__(base_cell, **kwargs)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def reset(self):
        self._prev_output = None

    def _step(self, x, states):
        out, next_states = self.base_cell._step(x, states)
        if not autograd.is_training():
            return out, next_states

        def zone(p, new, old):
            if p == 0.0:
                return new
            mask = F.random.uniform(shape=new.shape, ctx=new.device) < p
            return torch.where(mask, old, new)

        prev = self._prev_output
        if prev is None:
            prev = torch.zeros_like(out)
        out = zone(self.zoneout_outputs, out, prev)
        self._prev_output = out
        next_states = [zone(self.zoneout_states, n, o)
                       for n, o in zip(next_states, states)]
        return out, next_states


class BidirectionalCell(RecurrentCell):
    """One cell forward and another backward over the sequence, their
    outputs concatenated per step (ref: BidirectionalCell): unroll only,
    like the reference; children ``l_cell`` and ``r_cell``."""

    def __init__(self, l_cell, r_cell, **kwargs):
        super().__init__(**kwargs)
        # a plain list keeps the cells out of attribute registration, so
        # each registers once, under the reference's names
        self._cells = [l_cell, r_cell]
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")

    def state_info(self, batch_size=0):
        return self._cells[0].state_info(batch_size) + \
            self._cells[1].state_info(batch_size)

    def _step(self, x, states):
        raise NotImplementedError(
            "BidirectionalCell cannot step one timestep at a time (the "
            "backward direction needs the full sequence); call unroll() "
            "(reference behavior)")

    def _unroll(self, length, x, states, layout, merge_outputs, vl):
        axis = 1 if layout == "NTC" else 0

        def rev(seq):
            """Time-reversed, within each row's valid length."""
            if vl is None:
                return seq.flip(axis)
            out = F.SequenceReverse(seq if axis == 0
                                      else seq.transpose(0, 1), vl,
                                      use_sequence_length=True)
            return out.transpose(0, 1) if axis else out

        left, right = self._cells
        nl = len(left.state_info())
        if states is None:
            states = self._zeros(x.shape[1 - axis], x.device)
        l_out, l_states = left._unroll(length, x, states[:nl], layout,
                                       True, vl)
        r_out, r_states = right._unroll(length, rev(x), states[nl:],
                                        layout, True, vl)
        out = torch.cat([l_out, rev(r_out)], dim=2)
        states = l_states + r_states
        if merge_outputs is False:
            return list(out.unbind(axis)), states
        return out, states
