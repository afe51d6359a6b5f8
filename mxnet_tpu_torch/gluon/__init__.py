"""Gluon frontend (ref: python/mxnet/gluon/)."""
from . import contrib, data, loss, model_zoo, nn, rnn, utils  # noqa: F401
from .block import Block, CachedOp, HybridBlock  # noqa: F401
from .parameter import (DeferredInitializationError, Parameter,  # noqa: F401
                        ParameterDict)
from .symbol_block import SymbolBlock  # noqa: F401
from .trainer import Trainer  # noqa: F401
