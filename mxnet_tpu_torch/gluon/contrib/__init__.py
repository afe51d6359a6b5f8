"""gluon.contrib (ref: ``mxnet_tpu/gluon/contrib/``): the blocks of
:mod:`.nn`."""
from . import nn  # noqa: F401
