"""Subgraph/fusion API: pattern-match op chains and replace them with fused
ops (ref: src/operator/subgraph/subgraph_property.h, build_subgraph.cc
and the MKL-DNN fusion properties; ``mxnet_tpu/subgraph.py`` of the JAX
package).

A ``SubgraphProperty`` declares a linear op pattern and the op that
replaces it; ``build_subgraph`` (``Symbol.get_backend_symbol(backend)``)
walks the graph and replaces every match whose intermediates have no
other consumers.  The built-in property fuses FullyConnected ->
Activation into ``_sg_tpu_fully_connected_act`` under the backend name
``"TPU"``: the JAX package's names, so a fused graph's JSON loads in both
packages.
"""
from __future__ import annotations

from .base import MXNetError
from .ops import registry as _registry

_properties = {}  # backend -> [SubgraphProperty]


class SubgraphProperty:
    """One fusion rule (ref: SubgraphProperty / SgMKLDNNConvProperty).

    ``pattern``: list of op names forming a producer→consumer chain
    (each later op consumes the previous op's output as its first
    input).  ``fused_op``: the registered op that replaces the chain.
    ``attr_map(nodes)``: build the fused node's attrs from the matched
    nodes (first-to-last order).
    """

    pattern = ()
    fused_op = None

    def attr_map(self, nodes):
        merged = {}
        for n in nodes:
            merged.update(n.attrs)
        return merged

    def match_extra(self, nodes):
        """Optional extra predicate on the matched chain."""
        return True


def register_subgraph_property(backend, prop):
    _properties.setdefault(backend, []).append(prop)
    return prop


def get_subgraph_properties(backend):
    return list(_properties.get(backend, ()))


def build_subgraph(symbol, backend="TPU"):
    """Return a new Symbol with all registered fusions applied
    (ref: BuildSubgraph pass; exposed as get_backend_symbol)."""
    from .symbol.symbol import Symbol, _Node, _topo_order

    props = get_subgraph_properties(backend)
    if not props:
        return symbol
    heads = [symbol._node]
    order = _topo_order(heads)

    # consumer counts: an intermediate with >1 consumer cannot be fused
    # away (its value escapes the subgraph)
    consumers = {}
    for n in order:
        for src, _ in n.inputs:
            consumers[id(src)] = consumers.get(id(src), 0) + 1

    replaced = {}  # id(old node) -> new node

    def resolve(n):
        return replaced.get(id(n), n)

    for prop in props:
        pat = list(prop.pattern)
        if len(pat) < 2 or prop.fused_op is None:
            raise MXNetError("SubgraphProperty needs a >=2-op pattern "
                             "and a fused_op")
        for node in order:
            if node.op != pat[-1] or id(node) in replaced:
                continue
            # walk producer chain backwards through first inputs
            chain = [node]
            ok = True
            for want in reversed(pat[:-1]):
                prev = chain[0].inputs[0][0] if chain[0].inputs else None
                prev = resolve(prev) if prev is not None else None
                if (prev is None or prev.op != want
                        or id(prev) in replaced
                        or consumers.get(id(prev), 0) != 1):
                    ok = False
                    break
                chain.insert(0, prev)
            if not ok or not prop.match_extra(chain):
                continue
            # fused node: head-of-chain inputs + extra inputs of the
            # later ops (skipping the chain-internal edge)
            inputs = list(chain[0].inputs)
            for later in chain[1:]:
                inputs.extend(later.inputs[1:])
            fused = _Node(prop.fused_op, node.name + "_fused",
                          prop.attr_map(chain), inputs)
            replaced[id(node)] = fused

    if not replaced:
        return symbol

    # rebuild the graph bottom-up with replacements spliced in
    rebuilt = {}

    def rebuild(n):
        n = resolve(n)
        if id(n) in rebuilt:
            return rebuilt[id(n)]
        new = _Node(n.op, n.name, dict(n.attrs),
                    [(rebuild(src), oi) for src, oi in n.inputs])
        rebuilt[id(n)] = new
        return new

    return Symbol(rebuild(symbol._node), symbol._index)


# ---------------------------------------------------------------------------
# the built-in property (ref: the MKL-DNN property set)


def _k_fc_act(data, weight, bias=None, *, num_hidden, act_type="relu",
              no_bias=False, flatten=True):
    """FullyConnected, then the activation (ref: ``_k_fc_act``,
    mxnet_tpu/subgraph.py:129)."""
    from .ops.nn import _k_activation, _k_fully_connected

    out = _k_fully_connected(data, weight, bias, num_hidden=num_hidden,
                             no_bias=no_bias, flatten=flatten)
    return _k_activation(out, act_type=act_type)


_registry.register("_sg_tpu_fully_connected_act", _k_fc_act,
                   arg_names=("data", "weight", "bias"))


class FCActProperty(SubgraphProperty):
    """FullyConnected → Activation fusion (ref: SgMKLDNNFCProperty)."""

    pattern = ("FullyConnected", "Activation")
    fused_op = "_sg_tpu_fully_connected_act"


register_subgraph_property("TPU", FCActProperty())
