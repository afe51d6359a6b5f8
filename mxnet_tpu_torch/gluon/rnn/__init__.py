"""gluon.rnn: the fused recurrent layers (ref: python/mxnet/gluon/rnn/)."""
from .rnn_layer import GRU, LSTM, RNN  # noqa: F401
