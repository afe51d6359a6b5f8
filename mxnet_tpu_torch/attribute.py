"""Attribute scoping (ref: python/mxnet/attribute.py): ``AttrScope``'s
canonical home, also exported as ``mx.AttrScope``."""
from .symbol.symbol import AttrScope  # noqa: F401
