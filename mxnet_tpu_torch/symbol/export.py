"""``HybridBlock.export`` (ref: gluon/block.py HybridBlock.export;
``mxnet_tpu/symbol/export.py`` of the JAX package): ``path-symbol.json``
and ``path-NNNN.params``, loadable by ``SymbolBlock.imports``,
``mx.model.load_checkpoint`` and ``Module.load``, in either package."""
from __future__ import annotations

from .. import ndarray as _nd
from ..base import MXNetError


def trace_block_to_symbol(block, num_inputs=1):
    """Run the block's forward on Symbol placeholders, every parameter a
    variable of its name (the reference's ``_get_graph`` trace)."""
    from . import symbol as sym

    inputs = [sym.var("data" if num_inputs == 1 else f"data{i}")
              for i in range(num_inputs)]
    params = block.collect_params()
    traced = []
    try:
        for p in params.values():
            p._traced_value = sym.var(p.name)
            traced.append(p)
        out = block.forward(*inputs)
    finally:
        for p in traced:
            p._traced_value = None
    if isinstance(out, (list, tuple)):
        if len(out) != 1:
            raise MXNetError("export of multi-output blocks: pick one head")
        out = out[0]
    return out, inputs


def export_block(block, path, epoch=0):
    """Write ``{path}-symbol.json`` and ``{path}-{epoch:04d}.params`` (the
    ``arg:``/``aux:`` keys of the reference's checkpoints)."""
    out_sym, _ = trace_block_to_symbol(block)
    sym_file = f"{path}-symbol.json"
    param_file = f"{path}-{epoch:04d}.params"
    out_sym.save(sym_file)
    arg_names = set(out_sym.list_arguments())
    aux_names = set(out_sym.list_auxiliary_states())
    payload = {}
    for name, p in block.collect_params().items():
        if p._data is None:
            continue
        if name in aux_names:
            payload["aux:" + name] = p.data()
        elif name in arg_names:
            payload["arg:" + name] = p.data()
    _nd.save(param_file, payload)
    return sym_file, param_file
