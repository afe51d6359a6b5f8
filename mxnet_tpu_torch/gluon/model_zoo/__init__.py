"""gluon.model_zoo (ref: python/mxnet/gluon/model_zoo/): the ResNets."""
from . import vision  # noqa: F401
