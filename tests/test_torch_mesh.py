"""The port's ``DataParallelTrainer`` over a mesh of 4 ranks against the
JAX class over 4 of the 8 virtual CPU devices, and the mesh rules.

One launch of 4 gloo ranks (``tests/torch_mesh_worker.py four``, through
``python -m mxnet_tpu_torch.tools.launch``, once a test session however
the tests are spread over pytest-xdist workers) runs every case; each rank
writes its results, and the tests here run the JAX side in this process
and compare:

- the mesh rules: ``make_mesh`` of ``{dp:4}``, ``{dp:2,tp:2}`` and
  ``"dp=2,mp=2"`` over the ranks, a product that is not 4 raising;
  ``shard_param_spec``, ``parse_mesh_shape`` and ``format_mesh_shape``
  against the JAX functions;
- an MLP (12 -> 16 -> 4, SGD with momentum, 3 steps) on ``{dp:4}`` and
  ``{dcn:2,dp:2}``: losses within 1e-5 relative and masters within 1e-5
  of their largest magnitude of the JAX class on the same mesh, the two
  port meshes' losses within 1e-6 of each other, every rank's masters
  bit-identical after every step;
- ``{dp:2,tp:2}`` with ``shard_params`` and ``shard_opt_states`` (Adam
  and lamb): each rank's master and state shard shapes those of the JAX
  arrays' shards on the matching device, the per-rank state bytes half of
  the unsharded, values within 1e-5; the checkpoints both ways, loaded
  bit-identical, the next step within 1e-5, and the JAX class on
  ``{dp:2}`` refusing the port's ``{dp:4}`` checkpoint;
- the narrow ResNet on ``{dp:4}`` (2 SGD steps, global batch 8 at 32^2, an input without ReLU ties),
  standard and fused (``MXTPU_CONV_EPILOGUE=pallas``; the JAX side's
  kernels in interpret mode): losses and moving statistics within 1e-5
  relative (plus 1e-5 absolute on the statistics) of the JAX class, whose
  sharded batch reduces globally; the fused run with the statistics'
  reduction switched off must miss them by more than that;
- ``SyncBatchNorm(axis_name='dp')`` and ``BatchNorm(axis_name='tp')``:
  the output, the input's gradient and the moving mean within 1e-5 of
  BatchNorm over the axis group's rows together (torch on the CPU).
"""
import types

import numpy as np
import pytest

import mxnet_tpu_torch as tmx

import torch_mesh_worker as w

N = 4
RTOL = 1e-5


def _prepare(out):
    """The JAX side's files the ranks read: the ResNet's weights and the
    JAX class's {dp:2,tp:2} checkpoint after 3 Adam steps."""
    import mxnet_tpu as jmx

    x, _ = w.resnet_data()
    jmx.random.seed(0)
    jnet = w.narrow_resnet(jmx)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(x[:2]))
    np.savez(out / "resnet-weights.npz", **{
        k: p.data().asnumpy() for k, p in
        jnet._collect_params_with_prefix().items()})
    tr = _jax_tp_trainer("adam")
    xt, yt = w.tp_data()
    for _ in range(w.STEPS):
        tr.step(xt, yt)
    tr.save_states(str(out / "jax-tp"))


@pytest.fixture(scope="session")
def four(tmp_path_factory):
    out = w.shared_run("four", N, _prepare, tmp_path_factory)
    return out, w.read(out, "four", N)


def _jax_mesh(shape):
    import jax
    from mxnet_tpu.parallel import mesh as jmesh

    n = int(np.prod(list(shape.values())))
    return jmesh.make_mesh(shape, devices=jax.devices()[:n])


def _jax_trainer(net, opt, params, shape, **kw):
    import mxnet_tpu as jmx
    from mxnet_tpu.parallel import data_parallel as jdp

    return jdp.DataParallelTrainer(
        net, jmx.gluon.loss.SoftmaxCrossEntropyLoss(), opt, dict(params),
        mesh=_jax_mesh(shape), **kw)


def _jax_tp_trainer(opt):
    import mxnet_tpu as jmx

    jmx.random.seed(3)
    return _jax_trainer(w.mlp(jmx, width=w.TP_WIDTH), opt, w.TP_OPTS[opt],
                        {"dp": 2, "tp": 2}, shard_params=True,
                        shard_opt_states=True)


def _jax_steps(tr, x, y, steps=w.STEPS):
    """The JAX class's losses and full masters after every step."""
    losses, params = [], []
    for _ in range(steps):
        losses.append(float(tr.step(x, y).asnumpy()))
        params.append([np.array(p) for p in tr._params])
    return losses, params


def _close_to_jax(ranks, case, jl, jp):
    meta0, arr0 = ranks[0]
    np.testing.assert_allclose(meta0[case]["losses"], jl, rtol=RTOL)
    for s, step in enumerate(jp):
        for i, ref in enumerate(step):
            got = arr0[f"{case}/step{s}/p{i}"]
            scale = max(float(np.abs(ref).max()), 1e-12)
            assert np.abs(got - ref).max() <= RTOL * scale, (case, s, i)
            for _, arr in ranks[1:]:  # every rank holds the same bits
                np.testing.assert_array_equal(arr[f"{case}/step{s}/p{i}"],
                                              got)


# -- the mesh rules -------------------------------------------------------------


def test_mesh_rules_over_ranks(four):
    _, ranks = four
    for r, (meta, _) in enumerate(ranks):
        got = meta["rules"]["meshes"]
        assert got["{'dp': 4}"]["shape"] == {"dp": 4}
        assert got["{'dp': 4}"]["coords"] == {"dp": r}
        assert got["{'dp': 2, 'tp': 2}"]["coords"] == {"dp": r // 2,
                                                       "tp": r % 2}
        assert got["{'dp': 2, 'tp': 2}"]["data_index"] == r // 2
        assert got["{'dp': 2, 'tp': 2}"]["data_size"] == 2
        assert got["dp=2,mp=2"]["shape"] == {"dp": 2, "mp": 2}
        assert "needs 6 devices, have 4" in got["bad"]
        assert meta["run"] == {"backend": "gloo", "size": N}
    from mxnet_tpu_torch.parallel import mesh as tmesh

    one = tmesh.make_mesh()
    assert one.shape == {"dp": 1} and one.size == 1
    assert one.data_group.size == 1 and tmesh.stats_group() is None


def test_shard_param_spec_matches_jax():
    from mxnet_tpu.parallel import mesh as jmesh
    from mxnet_tpu_torch.parallel import mesh as tmesh

    for shape in ({"dp": 2, "tp": 2}, {"dp": 4}, {"tp": 4}):
        jm = _jax_mesh(shape)
        tm = types.SimpleNamespace(axis_names=tuple(shape), shape=shape)
        for pshape in ((64, 32), (32, 64), (8,), (3, 5), (4, 6, 8),
                       (6, 6), (2, 2), (1024, 768), (30522, 768)):
            assert tmesh.shard_param_spec(pshape, tm) == tuple(
                jmesh.shard_param_spec(pshape, jm)), (shape, pshape)


def test_mesh_shape_specs_match_jax():
    from mxnet_tpu.base import MXNetError as JError
    from mxnet_tpu.parallel.spmd import mesh as jspmd
    from mxnet_tpu_torch.parallel.spmd import mesh as tspmd

    for spec in ("dp=4,mp=2", " dcn=2, dp=2 ", {"dp": 8}, "dp=1,mp=1,pp=2"):
        assert tspmd.parse_mesh_shape(spec) == jspmd.parse_mesh_shape(spec)
        d = tspmd.parse_mesh_shape(spec)
        assert tspmd.format_mesh_shape(d) == jspmd.format_mesh_shape(d)
        assert tspmd.model_axes(d) == jspmd.model_axes(d)
    for bad in ("", "dp", "xp=2", "dp=2,dp=2", "dp=0", "mp=2,dp=2",
                "dp=two"):
        with pytest.raises(JError):
            jspmd.parse_mesh_shape(bad)
        with pytest.raises(tmx.base.MXNetError):
            tspmd.parse_mesh_shape(bad)
    assert tspmd.AXIS_ORDER == jspmd.AXIS_ORDER


# -- the MLP on {dp:4} and {dcn:2, dp:2} ------------------------------------------


@pytest.mark.parametrize("case,shape", [("dp4", {"dp": 4}),
                                        ("dcn", {"dcn": 2, "dp": 2})])
def test_mlp_matches_jax(four, case, shape):
    import mxnet_tpu as jmx

    _, ranks = four
    x, y = w.mlp_data()
    jl, jp = _jax_steps(_jax_trainer(w.mlp(jmx), "sgd", w.SGD_MOM, shape),
                        x, y)
    _close_to_jax(ranks, case, jl, jp)
    assert ranks[0][0][case]["eager"] == [True, w.STEPS]


def test_dcn_matches_flat_dp(four):
    _, ranks = four
    meta = ranks[0][0]
    np.testing.assert_allclose(meta["dcn"]["losses"], meta["dp4"]["losses"],
                               rtol=1e-6)
    assert meta["dp4"]["losses"][-1] < meta["dp4"]["losses"][0]


# -- {dp:2, tp:2}: sharded parameters and ZeRO states ---------------------------


@pytest.mark.parametrize("opt", ["adam", "lamb"])
def test_tp_zero_matches_jax(four, opt):
    import jax

    _, ranks = four
    case = f"tp_{opt}"
    x, y = w.tp_data()
    tr = _jax_tp_trainer(opt)
    jl, jp = _jax_steps(tr, x, y)
    _close_to_jax(ranks, case, jl, jp)
    devs = jax.devices()[:N]
    for r, (meta, _) in enumerate(ranks):
        m = meta[case]
        want_p = [list(next(s.data.shape for s in a.addressable_shards
                            if s.device == devs[r])) for a in tr._params]
        assert m["param_shapes"] == want_p
        want_s = [None if s is None else list(next(
            sh.data.shape for sh in s[0].addressable_shards
            if sh.device == devs[r])) for s in tr._states]
        assert m["state_shapes"] == want_s
        assert m["state_bytes"] * 2 == m["unsharded_state_bytes"]
    # the dp split of a state and the tp split of its parameter on one dim
    assert ranks[0][0][case]["param_shapes"][0] == [32, 32]
    assert ranks[0][0][case]["state_shapes"][0] == [32, 32]


def test_tp_zero_checkpoints_load_both_ways(four):
    """The port's files load into the JAX class, the JAX class's into the
    port, bit-identical; the next step within 1e-5 either way."""
    import jax

    out, ranks = four
    x, y = w.tp_data()
    devs = jax.devices()[:N]

    def shard(a, r):
        return next(np.array(s.data) for s in a.addressable_shards
                    if s.device == devs[r])

    def leaves(tr):
        return [("p", i, a) for i, a in enumerate(tr._params)] + [
            ("s", f"{i}.{j}", leaf) for i, st in enumerate(tr._states)
            for j, leaf in enumerate(st or ())]

    jref = _jax_tp_trainer("adam")  # the run whose checkpoint is jax-tp
    for _ in range(w.STEPS):
        jref.step(x, y)
    jax_saved = [[shard(a, r) for _, _, a in leaves(jref)]
                 for r in range(N)]
    j_next = float(jref.step(x, y).asnumpy())
    fresh = _jax_tp_trainer("adam")
    fresh.build(x)
    fresh.load_states(str(out / "port-tp"))
    assert fresh._t == w.STEPS
    for r, (meta, arr) in enumerate(ranks):
        for (kind, i, a), jsaved in zip(leaves(fresh), jax_saved[r]):
            # the port's files in the JAX class; the JAX files in the port
            np.testing.assert_array_equal(shard(a, r),
                                          arr[f"tp_adam/local/{kind}{i}"])
            np.testing.assert_array_equal(arr[f"tp_adam/loaded/{kind}{i}"],
                                          jsaved)
        assert meta["tp_adam"]["loaded_t"] == w.STEPS
        for key in ("loaded_next_loss", "next_loss"):
            np.testing.assert_allclose(meta["tp_adam"][key], j_next,
                                       rtol=RTOL)
    np.testing.assert_allclose(float(fresh.step(x, y).asnumpy()),
                               ranks[0][0]["tp_adam"]["next_loss"], rtol=RTOL)


def test_jax_dp2_refuses_the_ports_dp4_checkpoint(four):
    import mxnet_tpu as jmx
    from mxnet_tpu.base import MXNetError as JError

    out, _ = four
    x, _ = w.mlp_data()
    tr = _jax_trainer(w.mlp(jmx), "sgd", w.SGD_MOM, {"dp": 2})
    tr.build(x)
    with pytest.raises(JError, match="checkpoint mesh"):
        tr.load_states(str(out / "port-dp4"))


# -- BatchNorm statistics over the data axes ------------------------------------


@pytest.mark.parametrize("fuse", [False, True], ids=["standard", "fused"])
def test_narrow_resnet_global_statistics_match_jax(four, fuse, monkeypatch,
                                                  interpret_pallas):
    import mxnet_tpu as jmx

    out, ranks = four
    monkeypatch.setenv("MXTPU_CONV_EPILOGUE", "pallas" if fuse else "")
    monkeypatch.setenv("MXTPU_CONV_FUSED_INTERPRET", "1")
    weights = np.load(out / "resnet-weights.npz")
    jnet = w.narrow_resnet(jmx)
    jnet.initialize()
    x, y = w.resnet_data()
    jnet(jmx.nd.array(x[:2]))
    for k, p in jnet._collect_params_with_prefix().items():
        p.set_data(jmx.nd.array(weights[k]))
    tr = _jax_trainer(jnet, "sgd", w.RESNET_SGD, {"dp": 4})
    names = {id(p): k for k, p in jnet._collect_params_with_prefix().items()}
    jl = []
    stats = []
    for _ in range(2):
        jl.append(float(tr.step(x, y).asnumpy()))
        stats.append({names[id(p)]: np.array(v) for (_, p), v in
                      zip(tr._named, tr._params)
                      if "running" in names[id(p)]})
    case = "resnet_fused" if fuse else "resnet_std"
    meta, arr = ranks[0]
    assert meta[case]["fused"] is fuse
    # 17 BatchNorm layers, each an all-reduce forward and one backward
    assert meta[case]["stats_allreduces"] == 2 * 2 * 17
    np.testing.assert_allclose(meta[case]["losses"], jl, rtol=RTOL)
    for s in range(2):
        for n, ref in stats[s].items():
            np.testing.assert_allclose(arr[f"{case}/step{s}/{n}"], ref,
                                       rtol=RTOL, atol=1e-5, err_msg=n)
            for _, other in ranks[1:]:
                np.testing.assert_array_equal(other[f"{case}/step{s}/{n}"],
                                              arr[f"{case}/step{s}/{n}"])
    if fuse:
        # the control: the same run with each rank's own statistics
        ctl = ranks[0][0]["resnet_control"]
        assert ctl["stats_allreduces"] == 0
        gaps = [np.abs(arr[f"resnet_control/step0/{n}"] - ref).max()
                / (1e-5 + RTOL * np.abs(ref).max())
                for n, ref in stats[0].items()]
        assert max(gaps) > 1.0, gaps


def test_sync_batchnorm_axis_name(four):
    import torch

    _, ranks = four
    rng = np.random.RandomState(5)
    x = rng.randn(8, 3, 4, 4).astype(np.float32)
    gy = rng.randn(8, 3, 4, 4).astype(np.float32)
    groups = {"syncbn_dp": [[0, 2], [1, 3]], "syncbn_tp": [[0, 1], [2, 3]]}
    for case, members in groups.items():
        for group in members:
            rows = np.concatenate([x[2 * r:2 * r + 2] for r in group])
            xt = torch.from_numpy(rows).requires_grad_(True)
            mean = xt.mean(dim=(0, 2, 3), keepdim=True)
            var = ((xt - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True)
            ref = (xt - mean) / torch.sqrt(var + 1e-5)
            g = np.concatenate([gy[2 * r:2 * r + 2] for r in group])
            (dx,) = torch.autograd.grad(ref, xt, torch.from_numpy(g))
            for k, r in enumerate(group):
                arr = ranks[r][1]
                sl = slice(2 * k, 2 * k + 2)
                np.testing.assert_allclose(arr[f"{case}/y"],
                                           ref.detach().numpy()[sl],
                                           rtol=RTOL, atol=1e-5)
                np.testing.assert_allclose(arr[f"{case}/dx"], dx.numpy()[sl],
                                           rtol=RTOL, atol=1e-5)
                np.testing.assert_allclose(
                    arr[f"{case}/running_mean"],
                    0.1 * mean.detach().numpy().reshape(-1), rtol=RTOL,
                    atol=1e-6)


def test_sync_batchnorm_block_matches_jax():
    """One process, no mesh: ``SyncBatchNorm`` is BatchNorm on axis 1, as
    the JAX block is outside a sharded batch."""
    import mxnet_tpu as jmx

    rng = np.random.RandomState(6)
    x = rng.randn(4, 3, 5, 5).astype(np.float32)
    outs = {}
    for name, pkg, kw in (("jax", jmx, {}), ("port", tmx,
                                             {"ctx": tmx.cpu()})):
        blk = pkg.gluon.contrib.nn.SyncBatchNorm(in_channels=3,
                                                 num_devices=2)
        blk.initialize(**kw)
        xa = pkg.nd.array(x, **kw)
        with pkg.autograd.record():
            y = blk(xa)
        outs[name] = (y.asnumpy(), blk.running_var.data().asnumpy()
                      if name == "jax" else
                      blk.running_var.data().numpy(), blk(xa).asnumpy())
    for a, b in zip(outs["port"], outs["jax"]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-5)
    nn = tmx.gluon.contrib.nn
    cat = nn.HybridConcurrent(axis=1)
    cat.add(nn.Identity(), tmx.gluon.nn.Dense(2, in_units=3, flatten=False))
    cat.initialize(ctx=tmx.cpu())
    y = cat(tmx.nd.array(np.ones((2, 3), np.float32), ctx=tmx.cpu()))
    assert y.shape == (2, 5)
    for cls in (nn.MoEFFN, nn.SparseEmbedding):
        with pytest.raises(tmx.base.MXNetError, match="not ported"):
            cls(4, 8)
