"""Fused recurrent layers (ref: ``mxnet_tpu/gluon/rnn/rnn_layer.py``).

``RNN``, ``LSTM`` and ``GRU`` over the fused op (``ops/rnn.py``): the
parameters are per layer and direction, ``{l,r}{layer}_{i2h,h2h}_{weight,
bias}`` as in the reference, packed into the op's flat vector at every
forward.  Layer 0's input size is deferred to the first input.
"""
from __future__ import annotations

import torch

from ...base import MXNetError
from ...context import Context, current_context
from ...ndarray.ndarray import NDArray
from ..block import HybridBlock


class _RNNLayer(HybridBlock):
    def __init__(self, mode, hidden_size, num_layers, layout,
                 dropout, bidirectional, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(**kwargs)
        if layout not in ("TNC", "NTC"):
            raise MXNetError(f"layout must be TNC or NTC, not {layout!r}")
        self._mode = mode
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._gates = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4,
                       "gru": 3}[mode]
        g, h = self._gates, hidden_size
        for layer in range(num_layers):
            in_sz = input_size if layer == 0 else hidden_size * self._dir
            for sfx in ["l", "r"][:self._dir]:
                for kind, shape, init in (
                        ("i2h_weight", (g * h, in_sz), i2h_weight_initializer),
                        ("h2h_weight", (g * h, h), h2h_weight_initializer),
                        ("i2h_bias", (g * h,), i2h_bias_initializer),
                        ("h2h_bias", (g * h,), h2h_bias_initializer)):
                    name = f"{sfx}{layer}_{kind}"
                    setattr(self, name, self.params.get(
                        name, shape=shape, init=init,
                        allow_deferred_init=True))

    def infer_shape(self, x, *args):
        g, h = self._gates, self._hidden_size
        for sfx in ["l", "r"][:self._dir]:
            self._reg_params[f"{sfx}0_i2h_weight"].shape = (g * h,
                                                            x.shape[2])

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, ctx=None, **kwargs):
        """Zero states (NDArrays of :meth:`state_info`'s shapes) on ``ctx``
        (default :func:`current_context`); called without states, the
        layer makes them on its input's device."""
        device = (ctx or current_context()).torch_device()
        return [NDArray(torch.zeros(info["shape"], device=device))
                for info in self.state_info(batch_size)]

    def _flat_params(self, F, params):
        """The per-layer parameters packed into the op's flat layout."""
        weights, biases = [], []
        for layer in range(self._num_layers):
            for sfx in ["l", "r"][:self._dir]:
                weights.append(F.reshape(params[f"{sfx}{layer}_i2h_weight"],
                                         shape=(-1,)))
                weights.append(F.reshape(params[f"{sfx}{layer}_h2h_weight"],
                                         shape=(-1,)))
        for layer in range(self._num_layers):
            for sfx in ["l", "r"][:self._dir]:
                biases.append(params[f"{sfx}{layer}_i2h_bias"])
                biases.append(params[f"{sfx}{layer}_h2h_bias"])
        return F.concat(*(weights + biases), dim=0)

    def hybrid_forward(self, F, x, *states, **params):
        if self._layout == "NTC":
            x = F.swapaxes(x, dim1=0, dim2=1)
        if not states:
            raise MXNetError(
                f"{type(self).__name__} requires begin_state(); call "
                "layer(x, layer.begin_state(batch_size)) or pass states")
        out = F.RNN(x, self._flat_params(F, params), *states,
                    state_size=self._hidden_size,
                    num_layers=self._num_layers, mode=self._mode,
                    bidirectional=self._dir == 2, p=self._dropout,
                    state_outputs=True)
        output, *out_states = out
        if self._layout == "NTC":
            output = F.swapaxes(output, dim1=0, dim2=1)
        return output, out_states

    def __call__(self, x, states=None):
        """``output``, or ``(output, states)`` when ``states`` were passed
        (a list of NDArrays or tensors)."""
        skip_states = states is None
        if skip_states:
            data = x.data if isinstance(x, NDArray) else x
            bs = data.shape[0] if self._layout == "NTC" else data.shape[1]
            states = [s.data for s in self.begin_state(
                bs, ctx=Context.from_device(data.device))]
        elif isinstance(states, (NDArray, torch.Tensor)):
            states = [states]
        output, out_states = super().__call__(x, *states)
        if skip_states:
            return output
        return output, out_states


class RNN(_RNNLayer):
    """Vanilla multi-layer RNN (ref: gluon.rnn.RNN)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 input_size=0, **kwargs):
        mode = "rnn_relu" if activation == "relu" else "rnn_tanh"
        super().__init__(mode, hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size)}]


class LSTM(_RNNLayer):
    """Multi-layer LSTM (ref: gluon.rnn.LSTM)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__("lstm", hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, **kwargs)

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size,
                 self._hidden_size)
        return [{"shape": shape}, {"shape": shape}]


class GRU(_RNNLayer):
    """Multi-layer GRU (ref: gluon.rnn.GRU)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__("gru", hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size)}]
