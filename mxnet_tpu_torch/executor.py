"""Executor namespace (ref: python/mxnet/executor.py).

The class lives with the symbolic graph (``symbol/symbol.py``), as in the
JAX package; ``mx.executor.Executor`` stays importable for ported
scripts."""
from .symbol.symbol import Executor  # noqa: F401

__all__ = ["Executor"]
