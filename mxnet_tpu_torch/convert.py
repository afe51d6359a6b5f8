"""Carry weights across: load numpy arrays into a port block by structural
parameter name (``Block._collect_params_with_prefix``), the naming both
packages share, e.g. ``encoder.layers.0.attn_in_weight``."""
from __future__ import annotations

import numpy as np

from .base import MXNetError


def load_numpy_params(block, arrays):
    """Copy ``arrays`` ({structural name: np.ndarray}) into ``block``.

    Both sides must hold the same set of names, and each array the
    parameter's shape (dims still unknown under deferred init take the
    array's); any difference raises :class:`MXNetError` before anything
    is copied.  Deferred parameters are initialized on the device their
    ``initialize()`` call named."""
    params = block._collect_params_with_prefix()
    missing = sorted(set(params) - set(arrays))
    extra = sorted(set(arrays) - set(params))
    if missing or extra:
        raise MXNetError(f"parameter names differ: missing {missing}, "
                         f"unexpected {extra}")
    for name, p in params.items():
        shape = tuple(np.shape(arrays[name]))
        if p.shape is None or len(p.shape) != len(shape) or any(
                s not in (0, n) for s, n in zip(p.shape, shape)):
            raise MXNetError(f"parameter {name}: shape {p.shape} cannot take "
                             f"an array of shape {shape}")
    for name, p in params.items():
        p.set_data(np.asarray(arrays[name]))
