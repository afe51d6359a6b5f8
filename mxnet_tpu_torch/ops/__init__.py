"""Operators: importing this package registers every op."""
from . import attention, nn, tensor  # noqa: F401
from .registry import get, list_ops, register  # noqa: F401
