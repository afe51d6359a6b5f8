"""Automatic naming of symbols (ref: python/mxnet/name.py;
``mxnet_tpu/name.py`` of the JAX package, whose names these match, so
the two packages write the same symbol JSON).

`NameManager.current()` hands out `hint0, hint1, ...` names for
anonymous symbols; `with Prefix("foo_"):` scopes a prefix onto every
auto-generated name. The symbol builder consults the active manager,
so naming is thread-local and context-scoped exactly like the
reference's `NameManager`/`Prefix` pair.
"""
from __future__ import annotations

import threading

_state = threading.local()


class NameManager:
    """Scoped counter-based namer (ref: mx.name.NameManager)."""

    def __init__(self):
        self._counter = {}

    def get(self, name, hint):
        """Return `name` if given, else a fresh `hint{i}` name."""
        if name:
            return name
        i = self._counter.get(hint, 0)
        self._counter[hint] = i + 1
        return f"{hint}{i}"

    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, *args):
        _stack().pop()

    @staticmethod
    def current():
        return _stack()[-1]


class Prefix(NameManager):
    """NameManager that prepends a fixed prefix (ref: mx.name.Prefix)."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        if name:
            return name
        return self._prefix + super().get(None, hint)


def _stack():
    if not hasattr(_state, "stack"):
        _state.stack = [NameManager()]
    return _state.stack
