"""Operators: importing this package registers every op."""
from . import (attention, conv_fused_ops, nn, quantization,  # noqa: F401
               rnn, tensor)
from .registry import get, list_ops, register  # noqa: F401
