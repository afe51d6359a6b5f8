"""mx.nd: the ``F`` namespace ``hybrid_forward`` receives, and the NDArray
boundary.

Every registered op is an attribute here, a plain function on
``torch.Tensor``s (``F.FullyConnected``, ``F.multihead_attention``, ...),
``contrib.X`` is the op registered as ``_contrib_X``
(``F.contrib.conv1x1_bn_act``) and ``random.X`` the one registered as
``_random_X`` (``F.random.uniform``, drawn from the device's generator).
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


class _OpNamespace:
    """``mx.nd.<namespace>.X`` -> the op registered as ``_<namespace>_X``
    (ref: ``mxnet_tpu/ndarray/__init__.py:17-38``)."""

    def __init__(self, namespace):
        self._namespace = namespace

    def __getattr__(self, name):
        from .. import ops

        key = f"_{self._namespace}_{name}"
        if key not in ops.list_ops():
            raise AttributeError(
                f"{self._namespace} namespace has no operator {name!r}")
        return ops.get(key)


contrib = _OpNamespace("contrib")
random = _OpNamespace("random")


def __getattr__(name):
    # the ops import this package's ndarray module, so the namespace is
    # filled on first use rather than at import
    from .. import ops

    for op_name in ops.list_ops():
        globals().setdefault(op_name, ops.get(op_name))
    if name in globals():
        return globals()[name]
    raise AttributeError(f"mx.nd has no operator {name!r}")
