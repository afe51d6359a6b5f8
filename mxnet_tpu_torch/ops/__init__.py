"""Operators: importing this package registers every op."""
from . import attention, conv_fused_ops, nn, rnn, tensor  # noqa: F401
from .registry import get, list_ops, register  # noqa: F401
