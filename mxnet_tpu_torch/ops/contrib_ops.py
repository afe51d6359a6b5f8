"""Contrib operators (ref: ``mxnet_tpu/ops/contrib_ops.py``).

Only ``_contrib_MoEFFN`` (ref: contrib_ops.py:816-830) is here: the MoE
feed-forward as a registered op, so gluon blocks (``gluon.contrib.nn.
MoEFFN``) and graphs can name it.  The rest of the JAX module (the
detection and box ops and the other contrib layers) comes with slice 9.
"""
from __future__ import annotations

from .registry import register


def _k_moe_ffn(data, router_w, w1, b1, w2, b2, *, capacity_factor=1.25,
               top_k=1):
    """MoE FFN, top-1 (Switch) or top-2 (GShard) routing: data (S, M)
    -> (y (S, M), aux (1,)).  ``parallel.moe.moe_ffn`` is the math; with
    a rank's experts (E/ep of them) inside the ``DataParallelTrainer``'s
    step it runs the expert-parallel form over the ``ep`` group."""
    from ..parallel.moe import moe_ffn

    y, aux = moe_ffn(data, router_w, w1, b1, w2, b2, mesh=None,
                     capacity_factor=capacity_factor, top_k=int(top_k))
    return y, aux.reshape(1)


register("_contrib_MoEFFN", _k_moe_ffn,
         arg_names=("data", "router_w", "w1", "b1", "w2", "b2"),
         num_outputs=2)
