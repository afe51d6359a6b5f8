"""gluon.nn layers (ref: python/mxnet/gluon/nn/)."""
from ..block import Block, HybridBlock  # noqa: F401
from .basic_layers import (Dense, Dropout, Embedding,  # noqa: F401
                           HybridSequential, LayerNorm)
