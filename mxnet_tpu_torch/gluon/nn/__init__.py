"""gluon.nn layers (ref: python/mxnet/gluon/nn/)."""
from ..block import Block, HybridBlock  # noqa: F401
from .basic_layers import (Activation, BatchNorm, Dense,  # noqa: F401
                           Dropout, Embedding, Flatten, HybridSequential,
                           LayerNorm)
from .conv_layers import (AvgPool2D, Conv2D, GlobalAvgPool2D,  # noqa: F401
                          MaxPool2D)
