"""mx.nd: the ``F`` namespace ``hybrid_forward`` receives, and the NDArray
boundary.

Every registered op is an attribute here, a plain function on
``torch.Tensor``s (``F.FullyConnected``, ``F.multihead_attention``, ...).
``NDArray``, ``array`` and ``zeros`` build the arrays user code hands to
blocks; ``arange`` is the op (a tensor on ``ctx``), and the NDArray form
is ``ndarray.ndarray.arange``.
"""
from .ndarray import NDArray, array, to_torch_dtype, zeros  # noqa: F401


def __getattr__(name):
    # the ops import this package's ndarray module, so the namespace is
    # filled on first use rather than at import
    from .. import ops

    for op_name in ops.list_ops():
        globals().setdefault(op_name, ops.get(op_name))
    if name in globals():
        return globals()[name]
    raise AttributeError(f"mx.nd has no operator {name!r}")
