"""Carry weights across: load numpy arrays into a port block by structural
parameter name (``Block._collect_params_with_prefix``), the naming both
packages share, e.g. ``encoder.layers.0.attn_in_weight``; and a symbolic
model's ``arg_params``/``aux_params`` to and from numpy, so one graph runs
in both packages."""
from __future__ import annotations

import numpy as np

from .base import MXNetError


def load_numpy_params(block, arrays):
    """Copy ``arrays`` ({structural name: np.ndarray}) into ``block``.

    Both sides must hold the same set of names, and each array the
    parameter's shape (dims still unknown under deferred init take the
    array's); any difference raises :class:`MXNetError` before anything
    is copied.  Deferred parameters are initialized on the device their
    ``initialize()`` call named.  Each array is copied into its parameter
    in the parameter's dtype (``Parameter.set_data``), so a net that was
    cast first (``Block.cast``, ``amp.convert_model``) keeps its split: an
    AMP-converted JAX net's float16 weights and float32 norm parameters
    land bit for bit in an AMP-converted port net.

    A net quantized by ``contrib.quantization.quantize_net`` takes the
    arrays of a quantized net of the same architecture (``qweight`` int8,
    ``wscale``, ``bias`` and the calibrated ranges ``in_min``, ``in_max``,
    ``out_min``, ``out_max``): a layer quantized without calibration
    takes its range parameters from the arrays
    (``quantization.adopt_ranges``), so both packages run the same int8
    model."""
    if getattr(block, "_int8_quantized", False):
        from .contrib.quantization import adopt_ranges

        adopt_ranges(block, arrays)
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


def _host(v):
    return np.asarray(v.asnumpy() if hasattr(v, "asnumpy") else v)


def symbol_params_from_numpy(arg_params, aux_params=None, ctx=None):
    """A symbolic model's ``(arg_params, aux_params)`` ({name: array},
    where an array is numpy or has ``asnumpy()``, as the JAX package's
    NDArrays do) as the port's: ``{name: NDArray}`` on ``ctx`` (default
    :func:`current_context`), dtypes kept."""
    from .ndarray.ndarray import array

    def conv(d):
        return {k: array(_host(v), ctx=ctx, dtype=_host(v).dtype)
                for k, v in (d or {}).items()}

    return conv(arg_params), conv(aux_params)


def symbol_params_to_numpy(arg_params, aux_params=None):
    """The reverse of :func:`symbol_params_from_numpy`: ``{name:
    np.ndarray}`` pairs, which the JAX package's ``nd.array`` takes."""
    return ({k: _host(v) for k, v in (arg_params or {}).items()},
            {k: _host(v) for k, v in (aux_params or {}).items()})
