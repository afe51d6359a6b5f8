"""gluon.rnn (ref: python/mxnet/gluon/rnn/): the fused recurrent layers
(``RNN``, ``LSTM``, ``GRU``) and the per-step cells (``RNNCell``,
``LSTMCell``, ``GRUCell``, the sequential, bidirectional, dropout,
residual and zoneout cells)."""
from .rnn_layer import GRU, LSTM, RNN  # noqa: F401
from .rnn_cell import (BidirectionalCell, DropoutCell, GRUCell,  # noqa: F401
                       HybridSequentialRNNCell, LSTMCell, ModifierCell,
                       RecurrentCell, ResidualCell, RNNCell,
                       SequentialRNNCell, ZoneoutCell)
