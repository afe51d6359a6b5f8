"""``HybridBlock.export`` and ``gluon.SymbolBlock`` of the PyTorch port
against the JAX package, on the CPU.

The exported JSON is byte-identical to the JAX package's for the same net
(node for node, attribute for attribute, the same bytes on disk), and
the ``.params`` files hold the same keys.  Outputs, gradients and the
BatchNorm statistics through a ``SymbolBlock`` are held to the gluon net
it came from and to the JAX package's ``SymbolBlock`` within 1e-5
absolute plus 1e-5 relative (float32, sums in other orders).
"""
import numpy as np
import pytest

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

CPU = tmx.cpu()
TOL = dict(rtol=1e-5, atol=1e-5)


def _jmx():
    import mxnet_tpu as jmx

    return jmx


def _close(t, j):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), **TOL)


def _net(mx):
    nn = mx.gluon.nn
    net = nn.HybridSequential(prefix="net_")
    net.add(nn.Conv2D(4, 3, padding=1, in_channels=3, prefix="c1_"),
            nn.BatchNorm(in_channels=4, prefix="bn1_"),
            nn.Activation("relu"),
            nn.MaxPool2D(2),
            nn.Flatten(),
            nn.Dense(10, in_units=64, prefix="fc_"))
    return net


def _x(seed=0, n=2):
    return np.random.RandomState(seed).randn(n, 3, 8, 8).astype(np.float32)


def _port_net(seed=1):
    with CPU:
        tmx.random.seed(seed)
        net = _net(tmx)
        net.initialize(tmx.init.Xavier(), ctx=CPU)
        # moving statistics away from 0 and 1, so predict mode reads them
        for name, p in net.collect_params().items():
            if "running" in name:
                p.set_data(np.random.RandomState(seed).rand(*p.shape)
                           .astype(np.float32) + 0.5)
    return net


def _export_both(tmp_path):
    """The same net exported by both packages (the port's weights carried
    into the JAX net)."""
    jmx = _jmx()
    tnet = _port_net()
    jnet = _net(jmx)
    jnet.initialize(jmx.init.Xavier())
    for (tn, tp), (jn, jp) in zip(sorted(tnet.collect_params().items()),
                                  sorted(jnet.collect_params().items())):
        assert tn == jn
        jp.set_data(jmx.nd.array(tp.data().detach().numpy()))
    with tmx.name.NameManager():
        tnet.export(str(tmp_path / "t"))
    with jmx.name.NameManager():
        jnet.export(str(tmp_path / "j"))
    return tnet, jnet


def test_export_json_is_byte_identical_to_jax(tmp_path):
    jmx = _jmx()
    _export_both(tmp_path)
    assert (tmp_path / "t-symbol.json").read_bytes() == \
        (tmp_path / "j-symbol.json").read_bytes()
    tp = tmx.nd.load(str(tmp_path / "t-0000.params"))
    jp = jmx.nd.load(str(tmp_path / "j-0000.params"))
    assert sorted(tp) == sorted(jp)
    assert [k for k in tp if k.startswith("aux:")] == \
        ["aux:bn1_running_mean", "aux:bn1_running_var"]
    for k in tp:
        np.testing.assert_array_equal(tp[k].asnumpy(), jp[k].asnumpy())


def test_imports_predicts_like_the_net_and_like_jax(tmp_path):
    jmx = _jmx()
    tnet, _ = _export_both(tmp_path)
    x = _x()
    with CPU:
        ref = tnet(tmx.nd.array(x)).asnumpy()
        blk = tmx.gluon.SymbolBlock.imports(str(tmp_path / "t-symbol.json"),
                                            ["data"],
                                            str(tmp_path / "t-0000.params"),
                                            ctx=CPU)
        got = blk(tmx.nd.array(x)).asnumpy()
        from_jax = tmx.gluon.SymbolBlock.imports(
            str(tmp_path / "j-symbol.json"), "data",
            str(tmp_path / "j-0000.params"), ctx=CPU)(
                tmx.nd.array(x)).asnumpy()
    jblk = jmx.gluon.SymbolBlock.imports(str(tmp_path / "t-symbol.json"),
                                         ["data"],
                                         str(tmp_path / "t-0000.params"))
    jgot = jblk(jmx.nd.array(x)).asnumpy()
    _close(got, ref)
    np.testing.assert_array_equal(got, from_jax)
    _close(got, jgot)
    assert blk.collect_params()["bn1_running_mean"].grad_req == "null"


def test_gradients_and_batchnorm_updates_through_imports(tmp_path):
    """Training through the imported block: the loss's gradients and the
    moving statistics equal the gluon net's (the same ops, recorded by
    autograd as the net's are)."""
    tnet, _ = _export_both(tmp_path)
    x = tmx.nd.array(_x(3), ctx=CPU)
    with CPU:
        blk = tmx.gluon.SymbolBlock.imports(str(tmp_path / "t-symbol.json"),
                                            ["data"],
                                            str(tmp_path / "t-0000.params"),
                                            ctx=CPU)
    grads = []
    for net in (tnet, blk):
        with tmx.autograd.record():
            out = net(x)
        out.backward()      # the head gradient ones: the sum's
        params = net.collect_params()
        grads.append({k: params[k].grad().numpy().copy()
                      for k in params if params[k].grad_req != "null"})
        grads[-1].update({k: params[k].data().detach().numpy().copy()
                          for k in params if "running" in k})
    assert sorted(grads[0]) == sorted(grads[1])
    for k in grads[0]:
        _close(grads[1][k], grads[0][k])


def test_nested_in_a_hybridized_parent_and_composed(tmp_path):
    jmx = _jmx()
    _export_both(tmp_path)
    x = _x(4)
    results = []
    for mx, ctx, tag in ((tmx, CPU, "t"), (jmx, jmx.cpu(), "t")):
        with ctx:
            blk = mx.gluon.SymbolBlock.imports(
                str(tmp_path / f"{tag}-symbol.json"), ["data"],
                str(tmp_path / f"{tag}-0000.params"), ctx=ctx)
            head = mx.gluon.nn.Dense(3, in_units=10, prefix="head_")
            head.initialize(mx.init.One(), ctx=ctx)
            parent = mx.gluon.nn.HybridSequential(prefix="parent_")
            parent.add(blk, head)
            parent.hybridize()
            out = parent(mx.nd.array(x)).asnumpy()
            # symbolic composition: the block's graph spliced into a new one
            data = mx.sym.var("data")
            composed = mx.sym.Activation(blk(data), act_type="tanh")
            args = {k: mx.nd.array(_np(p.data()))
                    for k, p in blk.collect_params().items()}
            aux_names = composed.list_auxiliary_states()
            ex = composed.bind(ctx, dict(
                {k: v for k, v in args.items() if k not in aux_names},
                data=mx.nd.array(x)),
                aux_states={k: args[k] for k in aux_names}, grad_req="null")
            feats = blk(mx.nd.array(x)).asnumpy()
            results.append((out, ex.forward()[0].asnumpy(), feats))
    _close(results[0][0], results[1][0])
    _close(results[0][1], results[1][1])
    _close(results[0][1], np.tanh(results[0][2]))


def _np(v):
    """A parameter value as numpy: a torch tensor (the port) or an NDArray
    (the JAX package)."""
    return v.asnumpy() if hasattr(v, "asnumpy") else v.detach().numpy()


def test_built_from_internals_matches_jax(tmp_path):
    """A feature extractor: ``SymbolBlock`` over an internal output of the
    exported graph, as the reference's fine-tuning recipe builds one."""
    jmx = _jmx()
    _export_both(tmp_path)
    x = _x(5)
    outs = []
    for mx, ctx in ((tmx, CPU), (jmx, jmx.cpu())):
        with ctx:
            sym = mx.sym.load(str(tmp_path / "t-symbol.json"))
            inner = [s for s in sym.get_internals()
                     if s.list_outputs()[s._index].startswith("pooling")][0]
            blk = mx.gluon.SymbolBlock(inner, mx.sym.var("data"))
            loaded = mx.nd.load(str(tmp_path / "t-0000.params"))
            for name, p in blk.collect_params().items():
                v = loaded[("aux:" if "running" in name else "arg:") + name]
                p.shape = v.shape
                p.initialize(ctx=ctx)
                p.set_data(v)
            outs.append(blk(mx.nd.array(x)).asnumpy())
    assert outs[0].shape == (2, 4, 4, 4)
    _close(outs[0], outs[1])


def test_symbol_block_errors():
    data = tmx.sym.var("data")
    out = tmx.sym.FullyConnected(data, num_hidden=2, name="fc")
    with pytest.raises(MXNetError, match="not a variable"):
        tmx.gluon.SymbolBlock(out, tmx.sym.var("nope"))
    with pytest.raises(MXNetError, match="variable symbols"):
        tmx.gluon.SymbolBlock(out, out)
    blk = tmx.gluon.SymbolBlock(out, data)
    blk.initialize(ctx=CPU)
    with pytest.raises(MXNetError, match="expects 1 inputs"):
        blk(tmx.nd.array(np.ones((1, 3)), ctx=CPU),
            tmx.nd.array(np.ones((1, 3)), ctx=CPU))
    # deferred shapes come from the graph's inference at the first call
    y = blk(tmx.nd.array(np.ones((4, 3), np.float32), ctx=CPU))
    assert y.shape == (4, 2)
    assert blk.collect_params()["fc_weight"].shape == (2, 3)
