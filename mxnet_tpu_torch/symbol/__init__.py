"""Symbolic frontend (ref: python/mxnet/symbol/; ``mxnet_tpu/symbol/`` of
the JAX package): ``mx.sym.var``, the op wrappers made from the registry,
``Group``, ``load``/``fromjson``, ``Symbol.bind``/``simple_bind`` and the
:class:`Executor`.  ``contrib.X`` is the op registered as ``_contrib_X``
and ``random.X`` the one registered as ``_random_X``, as in ``mx.nd``."""
from . import export  # noqa: F401
from . import symbol as _symbol_mod
from .symbol import (AttrScope, Executor, Group, Symbol, Variable,  # noqa: F401
                     fromjson, load, var)


class _OpNamespace:
    """``mx.sym.<namespace>.X`` -> the wrapper of ``_<namespace>_X``."""

    def __init__(self, namespace):
        self._namespace = namespace

    def __getattr__(self, name):
        try:
            return getattr(_symbol_mod, f"_{self._namespace}_{name}")
        except AttributeError:
            raise AttributeError(f"{self._namespace} namespace has no "
                                 f"operator {name!r}") from None


contrib = _OpNamespace("contrib")
random = _OpNamespace("random")


def __getattr__(name):
    return getattr(_symbol_mod, name)
