"""mx.nd: the ``F`` namespace ``hybrid_forward`` receives, and the NDArray
boundary.

Every registered op is an attribute here, a plain function on
``torch.Tensor``s (``F.FullyConnected``, ``F.multihead_attention``, ...),
and ``contrib.X`` is the op registered as ``_contrib_X``
(``F.contrib.conv1x1_bn_act``).
``NDArray``, ``array`` and ``zeros`` build the arrays user code hands to
blocks; ``arange`` is the op (a tensor on ``ctx``), and the NDArray form
is ``ndarray.ndarray.arange``.  ``save``/``load`` write and read the
JAX package's ``.params`` container (``utils.serialization``).
"""
from .ndarray import NDArray, array, to_torch_dtype, zeros  # noqa: F401


def save(fname, data):
    """Save a list of arrays or a dict str -> array (ref: mx.nd.save)."""
    from ..utils import serialization

    serialization.save_ndarrays(fname, data)


def load(fname):
    """Load what :func:`save` wrote: NDArrays on the CPU, in a list or a
    dict (ref: mx.nd.load)."""
    from ..utils import serialization

    return serialization.load_ndarrays(fname)


class _ContribNamespace:
    """``mx.nd.contrib.X`` -> the op registered as ``_contrib_X`` (ref:
    ``mxnet_tpu/ndarray/__init__.py:17-38``)."""

    def __getattr__(self, name):
        from .. import ops

        key = "_contrib_" + name
        if key not in ops.list_ops():
            raise AttributeError(
                f"contrib namespace has no operator {name!r}")
        return ops.get(key)


contrib = _ContribNamespace()


def __getattr__(name):
    # the ops import this package's ndarray module, so the namespace is
    # filled on first use rather than at import
    from .. import ops

    for op_name in ops.list_ops():
        globals().setdefault(op_name, ops.get(op_name))
    if name in globals():
        return globals()[name]
    raise AttributeError(f"mx.nd has no operator {name!r}")
