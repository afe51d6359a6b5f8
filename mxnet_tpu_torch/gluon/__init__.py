"""Gluon frontend (ref: python/mxnet/gluon/)."""
from . import loss, model_zoo, nn, rnn, utils  # noqa: F401
from .block import Block, CachedOp, HybridBlock  # noqa: F401
from .parameter import (DeferredInitializationError, Parameter,  # noqa: F401
                        ParameterDict)
from .trainer import Trainer  # noqa: F401
