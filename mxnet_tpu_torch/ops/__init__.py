"""Operators: importing this package registers every op."""
from . import (attention, contrib_ops, conv_fused_ops, nn,  # noqa: F401
               optimizer_ops, quantization, random_ops, rnn, tensor)
from .registry import get, list_ops, register  # noqa: F401
