"""The subgraph API of the PyTorch port (``subgraph.py``) against the JAX
package, on the CPU.

``build_subgraph`` fuses FullyConnected -> Activation into
``_sg_tpu_fully_connected_act`` where the intermediate has no other
consumer: the fused graph's JSON equals the JAX package's, and its
outputs equal the unfused graph's (the same ops in the same order: bit
for bit in the port) and the JAX package's fused graph's within 1e-5
absolute plus 1e-5 relative.
"""
import numpy as np
import pytest

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import subgraph
from mxnet_tpu_torch.base import MXNetError

CPU = tmx.cpu()


def _jmx():
    import mxnet_tpu as jmx

    return jmx


def _mlp(S, escape=False):
    x = S.var("data")
    h = S.FullyConnected(x, num_hidden=6, name="fc1")
    a = S.Activation(h, act_type="relu", name="act1")
    out = S.FullyConnected(a, num_hidden=3, name="fc2")
    out = S.Activation(out, act_type="tanh", name="act2")
    if escape:
        # fc1's output also feeds the head: it escapes the pattern
        return S.Group([out, h])
    return out


def _args(sym):
    shapes = sym.infer_shape(data=(4, 5))[0]
    rs = np.random.RandomState(0)
    return {n: rs.randn(*s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)}


def _ops(sym):
    import json

    return [n["op"] for n in json.loads(sym.tojson())["nodes"]
            if n["op"] != "null"]


@pytest.mark.parametrize("escape", [False, True])
def test_fc_act_fusion_matches_jax(escape):
    jmx = _jmx()
    t = _mlp(tmx.sym, escape)
    fused = t.get_backend_symbol("TPU")
    jfused = jmx.sym.fromjson(t.tojson()).get_backend_symbol("TPU")
    assert fused.tojson() == jfused.tojson()
    if escape:
        assert _ops(fused) == ["FullyConnected", "Activation",
                               "_sg_tpu_fully_connected_act", "_group"]
    else:
        assert _ops(fused) == ["_sg_tpu_fully_connected_act"] * 2
    args = _args(t)
    feed = {k: tmx.nd.array(v, ctx=CPU) for k, v in args.items()}
    plain = t.eval(CPU, **feed)
    got = fused.eval(CPU, **feed)
    jgot = jfused.eval(jmx.cpu(), **{k: jmx.nd.array(v)
                                     for k, v in args.items()})
    for p, g, j in zip(plain, got, jgot):
        np.testing.assert_array_equal(g.asnumpy(), p.asnumpy())
        np.testing.assert_allclose(g.asnumpy(), j.asnumpy(), rtol=1e-5,
                                   atol=1e-5)


def test_properties_and_unknown_backends():
    t = _mlp(tmx.sym)
    assert [type(p).__name__ for p in
            subgraph.get_subgraph_properties("TPU")] == ["FCActProperty"]
    assert subgraph.build_subgraph(t, "NONE") is t

    class Bad(subgraph.SubgraphProperty):
        pattern = ("FullyConnected",)
        fused_op = None

    subgraph.register_subgraph_property("BAD", Bad())
    with pytest.raises(MXNetError, match="needs a >=2-op pattern"):
        subgraph.build_subgraph(t, "BAD")
