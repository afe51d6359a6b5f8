"""Contrib subpackage (ref: mxnet_tpu/contrib/): the int8 tier."""
from . import quantization  # noqa: F401
