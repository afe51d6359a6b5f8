"""Utilities of the port (ref: ``mxnet_tpu/utils/``): the NDArray file
container (``serialization``)."""
from . import serialization  # noqa: F401
