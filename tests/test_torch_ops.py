"""The PyTorch port's ops, names and import boundary, against the JAX package.

Each op of the BERT serving path gets the same numpy inputs (made from a
seed) in both packages; float32 results agree within 1e-5 absolute
unless a test says otherwise.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

REPO = Path(__file__).resolve().parents[1]


def _jop(name):
    from mxnet_tpu.ops import registry

    return registry.get(name).fn


def _close(t, j, atol=1e-5):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("flatten", [True, False])
def test_fully_connected(flatten):
    import jax.numpy as jnp

    x, w, b = _rand(2, 3, 8), _rand(5, 24 if flatten else 8, seed=1), \
        _rand(5, seed=2)
    j = _jop("FullyConnected")(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(b), num_hidden=5, flatten=flatten)
    t = tmx.nd.FullyConnected(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(b), num_hidden=5,
                              flatten=flatten)
    assert tuple(t.shape) == tuple(j.shape)
    _close(t, j)


@pytest.mark.parametrize("axis", [-1, 1])
def test_layer_norm(axis):
    import jax.numpy as jnp

    x = _rand(2, 6, 10) * 3 + 1
    c = x.shape[axis]
    g, b = _rand(c, seed=1), _rand(c, seed=2)
    j = _jop("LayerNorm")(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                          axis=axis, eps=1e-5)
    t = tmx.nd.LayerNorm(torch.from_numpy(x), torch.from_numpy(g),
                         torch.from_numpy(b), axis=axis, eps=1e-5)
    _close(t, j)


def test_gelu_flavours_match_their_jax_counterparts():
    """LeakyReLU(gelu) is the tanh approximation and Activation(gelu) the
    exact erf form, in both packages; the two differ."""
    import jax.numpy as jnp

    x = np.linspace(-4, 4, 101, dtype=np.float32)
    tl = tmx.nd.LeakyReLU(torch.from_numpy(x), act_type="gelu")
    ta = tmx.nd.Activation(torch.from_numpy(x), act_type="gelu")
    _close(tl, _jop("LeakyReLU")(jnp.asarray(x), act_type="gelu"))
    _close(ta, _jop("Activation")(jnp.asarray(x), act_type="gelu"))
    assert (tl - ta).abs().max() > 1e-4


@pytest.mark.parametrize("act", ["tanh", "relu", "sigmoid"])
def test_activation(act):
    import jax.numpy as jnp

    x = _rand(4, 7)
    _close(tmx.nd.Activation(torch.from_numpy(x), act_type=act),
           _jop("Activation")(jnp.asarray(x), act_type=act))


def test_leaky_relu_leaky():
    import jax.numpy as jnp

    x = _rand(4, 7)
    _close(tmx.nd.LeakyReLU(torch.from_numpy(x), act_type="leaky", slope=0.1),
           _jop("LeakyReLU")(jnp.asarray(x), act_type="leaky", slope=0.1))


def test_dropout_is_identity_outside_training_and_scales_inside():
    x = torch.from_numpy(_rand(64, 64))
    assert tmx.nd.Dropout(x, p=0.5) is x
    with tmx.autograd.record():
        y = tmx.nd.Dropout(x, p=0.5)
    kept = y != 0
    assert 0.3 < kept.float().mean() < 0.7
    torch.testing.assert_close(y[kept], x[kept] * 2.0)


def test_tensor_ops():
    import jax.numpy as jnp

    x = _rand(3, 4, 5)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    _close(tmx.nd.reshape(tx, (0, -1)), _jop("reshape")(jx, shape=(0, -1)))
    _close(tmx.nd.slice_axis(tx, 1, 1, 3),
           _jop("slice_axis")(jx, axis=1, begin=1, end=3))
    _close(tmx.nd.slice_axis(tx, 2, 0, None),
           _jop("slice_axis")(jx, axis=2, begin=0, end=None))
    lhs, rhs = np.arange(6, dtype=np.float32)[None, :], \
        np.array([[2.0], [5.0]], np.float32)
    _close(tmx.nd.broadcast_lesser(torch.from_numpy(lhs),
                                   torch.from_numpy(rhs)),
           _jop("broadcast_lesser")(jnp.asarray(lhs), jnp.asarray(rhs)))
    # nd.arange gives an NDArray on a Context, the tensor on a torch.device
    assert torch.equal(tmx.nd.arange(0, 5, dtype="int32", ctx=tmx.cpu()).data,
                       torch.arange(5, dtype=torch.int32))
    assert torch.equal(tmx.nd.arange(0, 5, dtype="int32",
                                     ctx=torch.device("cpu")),
                       torch.arange(5, dtype=torch.int32))
    _close(tmx.nd.reshape(tx, (-3, 5)), _jop("reshape")(jx, shape=(-3, 5)))


@pytest.mark.parametrize("mode", ["clip", "wrap"])
def test_take_modes(mode):
    """Out-of-range and float indices, as MXNet's take treats them."""
    import jax.numpy as jnp

    a = _rand(6, 3)
    idx = np.array([[0, 5, 7], [-2, 2.7, 1]], np.float32)
    _close(tmx.nd.take(torch.from_numpy(a), torch.from_numpy(idx), mode=mode),
           _jop("take")(jnp.asarray(a), jnp.asarray(idx), mode=mode))


def test_embedding():
    import jax.numpy as jnp

    w = _rand(10, 4)
    ids = np.array([[1, 9, 0], [3, 3, 2]], np.int32)
    _close(tmx.nd.Embedding(torch.from_numpy(ids), torch.from_numpy(w)),
           _jop("Embedding")(jnp.asarray(ids), jnp.asarray(w),
                             input_dim=10, output_dim=4))


@pytest.mark.parametrize("self_attention", [True, False])
def test_multihead_attention(self_attention):
    """Packed (3*units, units) projection, heads split as (b,s,h,hd) ->
    (b,h,s,hd), and the BERT key-padding mask, in both packages."""
    import jax.numpy as jnp

    b, s, m, heads = 2, 20, 32, 4
    x = _rand(b, s, m)
    kv = x if self_attention else _rand(b, s, m, seed=9)
    wi, bi = _rand(3 * m, m, seed=1) * 0.2, _rand(3 * m, seed=2)
    wo, bo = _rand(m, m, seed=3) * 0.2, _rand(m, seed=4)
    valid = np.array([20, 7], np.float32)
    mask = ((np.arange(s)[None, :] < valid[:, None]).astype(np.float32)
            .reshape(b, 1, 1, s) - 1.0) * 1e9
    jx, jkv = jnp.asarray(x), jnp.asarray(kv)
    j = _jop("multihead_attention")(
        jx, jkv, jkv, jnp.asarray(wi), jnp.asarray(bi), jnp.asarray(wo),
        jnp.asarray(bo), jnp.asarray(mask), num_heads=heads)
    tx = torch.from_numpy(x)
    tkv = tx if self_attention else torch.from_numpy(kv)
    t = tmx.nd.multihead_attention(
        tx, tkv, tkv, torch.from_numpy(wi), torch.from_numpy(bi),
        torch.from_numpy(wo), torch.from_numpy(bo), torch.from_numpy(mask),
        num_heads=heads)
    _close(t, j, atol=2e-5)


def test_structural_parameter_names_equal_across_packages():
    """Every parameter of BERT has the same structural name and shape in
    both packages, and the port's nn.Module names are those names."""
    import mxnet_tpu as jmx
    from mxnet_tpu.models.bert import bert_tiny as jbert_tiny

    jnet = jbert_tiny()
    jnet.initialize()
    ids = jmx.nd.array(np.ones((1, 8), np.int32), dtype="int32")
    jnet(ids, jmx.nd.zeros((1, 8), dtype="int32"), jmx.nd.array([8.0]))
    jshapes = {k: p.shape for k, p in
               jnet._collect_params_with_prefix().items()}

    tnet = tmx.models.bert_tiny()
    tnet.initialize(ctx=tmx.cpu())
    tnames = tnet._collect_params_with_prefix()
    assert set(tnames) == set(jshapes)
    tmx.load_numpy_params(tnet, {k: np.zeros(s, np.float32)
                                 for k, s in jshapes.items()})
    assert {k: tuple(p.shape) for k, p in tnet.named_parameters()} == \
        {k: tuple(s) for k, s in jshapes.items()}


def test_load_numpy_params_rejects_mismatches():
    net = tmx.models.bert_tiny(use_decoder=False, use_classifier=False)
    net.initialize(ctx=tmx.cpu())
    names = net._collect_params_with_prefix()
    good = {k: np.zeros([s or 64 for s in p.shape], np.float32)
            for k, p in names.items()}
    bad = dict(good)
    bad.pop("pooler.bias")
    with pytest.raises(MXNetError, match="missing"):
        tmx.load_numpy_params(net, bad)
    with pytest.raises(MXNetError, match="unexpected"):
        tmx.load_numpy_params(net, dict(good, extra=np.zeros(1)))
    with pytest.raises(MXNetError, match="shape"):
        tmx.load_numpy_params(net, dict(good, **{
            "word_embed.weight": np.zeros((999, 64), np.float32)}))


def test_contexts_default_to_the_card_and_never_fall_back(monkeypatch):
    assert tmx.xla(0) == tmx.gpu(0) and tmx.cpu() != tmx.gpu(0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(MXNetError, match="no CUDA device"):
        tmx.current_context()
    with pytest.raises(MXNetError, match="no CUDA device"):
        tmx.nd.array(np.zeros(3))
    with pytest.raises(MXNetError, match="CUDA device"):
        tmx.gpu(0).torch_device()
    with tmx.cpu():
        assert tmx.nd.array(np.zeros(3)).context == tmx.cpu()


def test_seeded_initialization_is_reproducible():
    def init():
        tmx.random.seed(42)
        net = tmx.gluon.nn.Dense(4, in_units=3)
        net.initialize(ctx=tmx.cpu())
        return net.weight.data().detach().clone()

    a, b = init(), init()
    assert torch.equal(a, b) and a.abs().max() <= 0.07 and a.abs().max() > 0


def test_ndarray_boundary():
    x = tmx.nd.array(np.arange(6, dtype=np.float64).reshape(2, 3),
                     ctx=tmx.cpu())
    assert x.dtype == np.float32 and x.shape == (2, 3)
    assert x.context == tmx.cpu()
    x.wait_to_read()
    net = tmx.gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=tmx.cpu())
    out = net(x)
    assert isinstance(out, tmx.nd.NDArray) and out.shape == (2, 2)
    assert isinstance(net(x.data), torch.Tensor)


def test_import_pulls_in_neither_jax_nor_the_jax_package():
    code = ("import sys, mxnet_tpu_torch\n"
            "import mxnet_tpu_torch.kvstore, mxnet_tpu_torch.parallel.dist\n"
            "import mxnet_tpu_torch.tools.launch\n"
            "import mxnet_tpu_torch.parallel.mesh\n"
            "import mxnet_tpu_torch.parallel.spmd\n"
            "import mxnet_tpu_torch.gluon.contrib.nn\n"
            "import mxnet_tpu_torch.checkpoint.reshard\n"
            "import mxnet_tpu_torch.engine, mxnet_tpu_torch.storage\n"
            "import mxnet_tpu_torch.pipeline, mxnet_tpu_torch.metric\n"
            "import mxnet_tpu_torch.gluon.data.vision\n"
            "import mxnet_tpu_torch.io.recordio\n"
            "import mxnet_tpu_torch.ndarray.sparse\n"
            "import mxnet_tpu_torch.utils.native_engine\n"
            "import mxnet_tpu_torch.gluon.model_zoo.vision.others\n"
            "import mxnet_tpu_torch.image, mxnet_tpu_torch.image.detection\n"
            "import mxnet_tpu_torch.utils.native, mxnet_tpu_torch.data.bert\n"
            "import mxnet_tpu_torch.tools.im2rec\n"
            "import mxnet_tpu_torch.profiler, mxnet_tpu_torch.log\n"
            "import mxnet_tpu_torch.telemetry.metrics\n"
            "import mxnet_tpu_torch.telemetry.httpd\n"
            "import mxnet_tpu_torch.telemetry.health\n"
            "import mxnet_tpu_torch.telemetry.flight\n"
            "import mxnet_tpu_torch.resilience.supervisor\n"
            "import mxnet_tpu_torch.resilience.faults\n"
            "import mxnet_tpu_torch.parallel.moe, mxnet_tpu_torch.parallel.ps\n"
            "import mxnet_tpu_torch.kvstore_server\n"
            "import mxnet_tpu_torch.ops.contrib_ops\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'mxnet_tpu' or "
            "m.startswith('mxnet_tpu.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=str(REPO), timeout=120)


def test_no_port_source_imports_jax_or_the_jax_package():
    files = sorted((REPO / "mxnet_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    names = {str(f.relative_to(REPO)) for f in files}
    for mod in ("parallel/mesh.py", "parallel/spmd/__init__.py",
                "parallel/spmd/mesh.py", "gluon/contrib/__init__.py",
                "gluon/contrib/nn.py", "checkpoint/reshard.py",
                "engine.py", "storage.py", "metric.py",
                "pipeline/stages.py", "pipeline/stats.py",
                "gluon/data/dataloader.py", "gluon/data/dataset.py",
                "gluon/data/sampler.py", "gluon/data/vision/datasets.py",
                "gluon/data/vision/transforms.py", "io/io.py",
                "io/recordio.py", "utils/libloader.py",
                "utils/native_engine.py", "ndarray/sparse.py",
                "gluon/model_zoo/vision/others.py", "image/image.py",
                "image/detection.py", "utils/native.py", "data/bert.py",
                "tools/im2rec.py", "parallel/moe.py", "parallel/ps.py",
                "kvstore_server.py", "ops/contrib_ops.py",
                "tools/launch.py"):
        assert f"mxnet_tpu_torch/{mod}" in names, mod
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in ("jax", "jaxlib", "mxnet_tpu"), \
                    f"{path.relative_to(REPO)} imports {mod}"
