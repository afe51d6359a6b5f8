"""The port's Mixture-of-Experts (``mxnet_tpu_torch/parallel/moe.py``, the
``_contrib_MoEFFN`` op and ``gluon.contrib.nn.MoEFFN``) against the JAX
package's (``mxnet_tpu/parallel/moe.py``), from the same numpy inputs.

- ``moe_ffn`` over top_k 1 and 2, capacity factors 0.05, 0.5, 1.25 and
  100 and 2-D and 3-D inputs: y and aux within 1e-5, the routing (each
  token's experts and which of them kept a slot) equal to the JAX
  formula's, and the gradients of x and the five parameters within 1e-5
  of ``jax.grad`` (relative to each gradient's largest magnitude);
- the registered op, the tie rule (zero router weights: the lower index
  wins), ``MoEFFN`` carried across by ``load_numpy_params`` and the
  example's LM (``examples/moe/train_moe_lm.py``, 2 layers, narrow):
  forward and 3 Adam steps against the JAX example's class (losses
  within 1e-5 relative, parameters within 1% of one step, lr);
- ``{dp:2, ep:2}`` against ``{dp:2, ep:1}`` over 4 gloo ranks in one
  launch (``tests/torch_moe_worker.py moe4``): losses within 1e-6, a
  rank's experts and their Adam states half of the whole, no parameter
  gathered, the experts' collectives counted under ``ep``.
"""
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import moe as tmoe

import torch_mesh_worker as mw
import torch_moe_worker as w

TOL = 1e-5
S, M, E, H = 32, 8, 4, 16
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(seed=0, shape=(S, M)):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(M, E).astype(np.float32),
            (rng.randn(E, M, H) * 0.3).astype(np.float32),
            (rng.randn(E, H) * 0.1).astype(np.float32),
            (rng.randn(E, H, M) * 0.3).astype(np.float32),
            (rng.randn(E, M) * 0.1).astype(np.float32))


def _jax_routing(x, router_w, cf, top_k):
    """The routing the JAX ``moe_ffn`` computes (moe.py:52-71): experts and
    kept flags by ``jax.lax.top_k`` and the first-choice-first cumsum."""
    import jax
    import jax.numpy as jnp

    x = jnp.asarray(x).reshape(-1, x.shape[-1])
    n = x.shape[0]
    C = max(1, int(cf * top_k * n / router_w.shape[1]))
    probs = jax.nn.softmax(x @ jnp.asarray(router_w), axis=-1)
    _, expert_k = jax.lax.top_k(probs, top_k)
    onehot = jax.nn.one_hot(expert_k, router_w.shape[1], dtype=jnp.int32)
    flat = onehot.transpose(1, 0, 2).reshape(top_k * n, -1)
    pos = (jnp.cumsum(flat, axis=0) * flat - 1).max(axis=-1)
    pos = pos.reshape(top_k, n).T
    return np.asarray(expert_k), np.asarray(pos < C)


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= TOL * scale, (what, err, scale)


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("cf", [0.05, 0.5, 1.25, 100.0])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_matches_jax(top_k, cf, ndim):
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.parallel.moe import moe_ffn as jmoe

    shape = (S, M) if ndim == 2 else (2, S // 2, M)
    arrs = _inputs(1, shape)

    def jloss(*a):
        y, aux = jmoe(*a, capacity_factor=cf, top_k=top_k)
        return (y * y).sum() + 0.3 * aux, (y, aux)

    (_, (jy, jaux)), jg = jax.value_and_grad(
        jloss, argnums=tuple(range(6)), has_aux=True)(
        *map(jnp.asarray, arrs))
    ts = [torch.tensor(a, requires_grad=True) for a in arrs]
    y, aux = tmoe.moe_ffn(*ts, capacity_factor=cf, top_k=top_k)
    assert tuple(y.shape) == shape and aux.dim() == 0
    _close(y.detach().numpy(), jy, "y")
    _close(aux.detach().numpy(), jaux, "aux")
    ((y * y).sum() + 0.3 * aux).backward()
    for name, t, g in zip(("x", "router_w", "w1", "b1", "w2", "b2"), ts, jg):
        _close(t.grad.numpy(), g, f"d{name}")
    r = tmoe.route(ts[0].detach().reshape(-1, M), ts[1].detach(), cf, top_k)
    je, jk = _jax_routing(arrs[0], arrs[1], cf, top_k)
    np.testing.assert_array_equal(r["expert_k"].numpy(), je)
    np.testing.assert_array_equal(r["keep_k"].numpy(), jk)
    assert r["pos_k"].dtype == torch.int32


@pytest.mark.parametrize("top_k", [1, 2])
def test_registered_op_matches_jax(top_k):
    import mxnet_tpu as jmx

    from mxnet_tpu_torch.ops import registry

    arrs = _inputs(2)
    jy, jaux = jmx.nd._contrib_MoEFFN(*[jmx.nd.array(a) for a in arrs],
                                      capacity_factor=1.25, top_k=top_k)
    with tmx.cpu():
        ty, taux = tmx.nd._contrib_MoEFFN(*[torch.from_numpy(a)
                                            for a in arrs],
                                          capacity_factor=1.25, top_k=top_k)
    assert tuple(taux.shape) == (1,) == tuple(jaux.shape)
    _close(ty.numpy(), jy.asnumpy(), "y")
    _close(taux.numpy(), jaux.asnumpy(), "aux")
    ent = registry.entry("_contrib_MoEFFN")
    assert ent.arg_names == ("data", "router_w", "w1", "b1", "w2", "b2")
    assert ent.num_outputs == 2


@pytest.mark.parametrize("top_k", [1, 2])
def test_ties_pick_the_lower_index_as_jax(top_k):
    """Zero router weights make every probability equal: both packages
    route every token to expert 0 (and 1 second)."""
    arrs = list(_inputs(3))
    arrs[1] = np.zeros_like(arrs[1])
    r = tmoe.route(torch.from_numpy(arrs[0]), torch.from_numpy(arrs[1]),
                   100.0, top_k)
    je, jk = _jax_routing(arrs[0], arrs[1], 100.0, top_k)
    np.testing.assert_array_equal(r["expert_k"].numpy(), je)
    np.testing.assert_array_equal(r["keep_k"].numpy(), jk)
    assert (je == np.arange(top_k)[None, :]).all()
    from mxnet_tpu.parallel.moe import moe_ffn as jmoe

    y, _ = tmoe.moe_ffn(*map(torch.from_numpy, arrs), capacity_factor=100.0,
                        top_k=top_k)
    jy, _ = jmoe(*arrs, capacity_factor=100.0, top_k=top_k)
    _close(y.numpy(), np.asarray(jy), "y")


def test_moeffn_block_through_load_numpy_params():
    import mxnet_tpu as jmx

    jmx.random.seed(0)
    jb = jmx.gluon.contrib.nn.MoEFFN(4, 8, 16, top_k=2)
    jb.initialize(jmx.init.Xavier())
    tb = tmx.gluon.contrib.nn.MoEFFN(4, 8, 16, top_k=2)
    tb.initialize(ctx=tmx.cpu())
    tmx.load_numpy_params(tb, {k: p.data().asnumpy() for k, p in
                               jb._collect_params_with_prefix().items()})
    assert sorted(tb._collect_params_with_prefix()) == [
        "b1", "b2", "router_weight", "w1", "w2"]
    x = np.random.RandomState(4).randn(2, 6, 8).astype(np.float32)
    jy, jaux = jb(jmx.nd.array(x))
    with tmx.autograd.record():
        ty, taux = tb(tmx.nd.array(x, ctx=tmx.cpu()))
    _close(ty.asnumpy(), jy.asnumpy(), "y")
    _close(taux.asnumpy(), jaux.asnumpy(), "aux")
    with pytest.raises(ValueError):
        tmx.gluon.contrib.nn.MoEFFN(num_experts=1, d_model=4, d_hidden=4)


def _jax_lm(top_k=1):
    import mxnet_tpu as jmx

    sys.path.insert(0, os.path.join(_ROOT, "examples"))
    sys.path.insert(0, os.path.join(_ROOT, "examples", "moe"))
    from train_moe_lm import MoETransformerLM

    jmx.random.seed(0)
    net = MoETransformerLM(w.VOCAB, d_model=w.D_MODEL, n_layers=w.LAYERS,
                           n_heads=w.HEADS, n_experts=w.EXPERTS,
                           d_hidden=w.D_HIDDEN, top_k=top_k)
    net.initialize(jmx.init.Xavier())
    net(jmx.nd.array(np.zeros((2, w.SEQ), np.float32)))
    return net


def _lm_weights(net):
    """{structural name: a numpy copy} of either package's net."""
    out = {}
    for k, p in net._collect_params_with_prefix().items():
        v = p.data()
        out[k] = (v.asnumpy() if hasattr(v, "asnumpy")
                  else v.detach().cpu().numpy()).copy()
    return out


@pytest.mark.parametrize("top_k", [1, 2])
def test_example_lm_trains_as_jax(top_k):
    """The example's LM: the forward and 3 Adam steps (lr 3e-3, the aux
    loss weighted 0.01) from the JAX net's weights, loss by loss and
    parameter by parameter."""
    import mxnet_tpu as jmx

    jnet = _jax_lm(top_k)
    tnet = w.narrow_lm(tmx, tmx.cpu(), _lm_weights(jnet), top_k=top_k)
    data = w.batches()
    x0 = data[0][0]
    jlog, jaux = jnet(jmx.nd.array(x0))
    tlog, taux = tnet(tmx.nd.array(x0, ctx=tmx.cpu()))
    _close(tlog.asnumpy(), jlog.asnumpy(), "logits")
    _close(taux.asnumpy(), jaux.asnumpy(), "aux")
    jsce = jmx.gluon.loss.SoftmaxCrossEntropyLoss(axis=-1)
    tsce = tmx.gluon.loss.SoftmaxCrossEntropyLoss(axis=-1)
    jtr = jmx.gluon.Trainer(jnet.collect_params(), "adam",
                            {"learning_rate": w.LR})
    ttr = tmx.gluon.Trainer(tnet.collect_params(), "adam",
                            {"learning_rate": w.LR})
    for x, y in data:
        with jmx.autograd.record():
            lg, a = jnet(jmx.nd.array(x))
            jl = jsce(lg, jmx.nd.array(y)).mean() + w.AUX_WEIGHT * a.sum()
        jl.backward()
        jtr.step(1)
        with tmx.autograd.record():
            lg, a = tnet(tmx.nd.array(x, ctx=tmx.cpu()))
            tl = tmx.nd.NDArray(
                tsce(lg, tmx.nd.array(y, ctx=tmx.cpu())).data.mean()
                + w.AUX_WEIGHT * a.data.sum())
        tl.backward()
        ttr.step(1)
        np.testing.assert_allclose(float(tl.asscalar()),
                                   float(jl.asscalar()), rtol=TOL)
    got = _lm_weights(tnet)
    d = w.D_MODEL
    for k, v in _lm_weights(jnet).items():
        if k.endswith("in_bias"):
            # the key projection's bias has no gradient in exact
            # arithmetic (softmax ignores a shift shared by a row's
            # scores): both packages' Adam steps move it by their own
            # rounding noise, at most lr a step
            assert np.abs(got[k][d:2 * d]).max() <= w.LR * len(data)
            got[k], v = np.delete(got[k], np.s_[d:2 * d]), \
                np.delete(v, np.s_[d:2 * d])
        # Adam's steps are +-lr where a gradient is small, whatever its
        # size: the packages' updates agree within 1% of one step
        assert np.abs(got[k] - v).max() <= 1e-2 * w.LR, k


def test_param_spec_fn_and_block_specs_match_jax():
    import jax
    from mxnet_tpu.parallel import mesh as jmesh
    from mxnet_tpu.parallel import moe as jmoe

    from mxnet_tpu_torch.parallel import mesh as M

    one = M.make_mesh()
    assert tmoe.gluon_moe_param_spec_fn(one) is None
    assert jmoe.gluon_moe_param_spec_fn(
        jmesh.make_mesh({"dp": 1}, devices=jax.devices()[:1])) is None

    class FakeMesh:   # the rule reads only the axis names and sizes
        axis_names = ("dp", "ep")
        shape = {"dp": 2, "ep": 2}

    jm = jmesh.make_mesh({"dp": 2, "ep": 2}, devices=jax.devices()[:4])
    tfn, jfn = tmoe.gluon_moe_param_spec_fn(FakeMesh()), \
        jmoe.gluon_moe_param_spec_fn(jm)
    for name, shape in (("moeffn0_w1", (4, 8, 16)), ("moeffn0_b1", (4, 16)),
                        ("moeffn0_router_weight", (8, 4)),
                        ("dense0_weight", (4, 8)), ("moeffn0_b2", (4,))):
        js = jfn(name, shape)
        assert tfn(name, shape) == (None if js is None else tuple(js))
    for fn in (tfn, jfn):
        with pytest.raises(Exception, match="does not divide"):
            fn("moeffn0_w1", (3, 8, 16))
    assert tmoe.MoEBlock.param_specs() == tuple(
        tuple(s) for s in jmoe.MoEBlock.param_specs())
    blk = tmoe.MoEBlock(4, 8, 16, seed=1, ctx=tmx.cpu())
    jblk = jmoe.MoEBlock(4, 8, 16, seed=1)
    assert [tuple(p.shape) for p in blk.params()] == \
        [tuple(p.shape) for p in jblk.params()]
    with pytest.raises(MXNetError, match=">= 2 experts"):
        tmoe.MoEBlock(1, 8, 16)
    with pytest.raises(MXNetError, match="top_k must be 1 or 2"):
        tmoe.moe_ffn(*map(torch.from_numpy, _inputs()), top_k=3)


def test_local_experts_need_an_ep_group():
    x, rw, w1, b1, w2, b2 = map(torch.from_numpy, _inputs())
    with pytest.raises(MXNetError, match="'ep' group"):
        tmoe.moe_ffn(x, rw, w1[:2], b1[:2], w2[:2], b2[:2])


# -- the expert-parallel launch -------------------------------------------------


def _prepare(out):
    tmx.random.seed(0)
    net = w.narrow_lm(tmx, tmx.cpu())
    np.savez(out / "moe-weights.npz", **_lm_weights(net))


@pytest.fixture(scope="session")
def moe4(tmp_path_factory):
    out = mw.shared_run("moe4", 4, _prepare, tmp_path_factory,
                        script=os.path.join(os.path.dirname(
                            os.path.abspath(__file__)),
                            "torch_moe_worker.py"))
    return mw.read(out, "moe4", 4)


def test_expert_parallel_matches_unsplit_over_four_ranks(moe4):
    meta0, arr0 = moe4[0]
    assert meta0["run"] == {"backend": "gloo", "size": 4}
    ep1, ep2 = meta0["ep1"], meta0["ep2"]
    np.testing.assert_allclose(ep2["losses"], ep1["losses"], rtol=1e-6)
    names = ep2["names"]
    experts = [i for i, n in enumerate(names)
               if "moeffn" in n and "router" not in n]
    assert len(experts) == 4 * w.LAYERS
    for meta, _ in moe4:
        e = meta["ep2"]
        assert e["losses"] == ep2["losses"]
        for i, (shape, full, states) in enumerate(zip(
                e["shapes"], e["full_shapes"], e["state_shapes"])):
            if i in experts:
                assert e["specs"][i][0] == "ep" and e["local"][i]
                assert shape == [full[0] // 2] + full[1:]
                assert states == [shape, shape]
            else:
                assert shape == full and not e["local"][i]
        for step in e["comm"]:   # no parameter is gathered for compute
            assert step["param"]["calls"] == 0
            assert step["ep"]["calls"] == 2 * w.LAYERS
        assert all(s["ep"]["calls"] == 0 for s in meta["ep1"]["comm"])
    for i in range(len(names)):
        _close(arr0[f"ep2/p{i}"], arr0[f"ep1/p{i}"], names[i])


# -- on the card ----------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_on_card_matches_cpu(top_k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine with -m gpu")
    arrs = _inputs(5)
    outs = {}
    for dev in ("cpu", "cuda"):
        ts = [torch.tensor(a, device=dev, requires_grad=True) for a in arrs]
        y, aux = tmoe.moe_ffn(*ts, capacity_factor=1.25, top_k=top_k)
        ((y * y).sum() + 0.3 * aux).backward()
        r = tmoe.route(ts[0].detach(), ts[1].detach(), 1.25, top_k)
        outs[dev] = ([y.detach().cpu().numpy(), aux.detach().cpu().numpy()]
                     + [t.grad.cpu().numpy() for t in ts],
                     r["expert_k"].cpu().numpy(), r["keep_k"].cpu().numpy())
    for got, want in zip(outs["cuda"][0], outs["cpu"][0]):
        _close(got, want, "card vs cpu")
    np.testing.assert_array_equal(outs["cuda"][1], outs["cpu"][1])
    np.testing.assert_array_equal(outs["cuda"][2], outs["cpu"][2])
