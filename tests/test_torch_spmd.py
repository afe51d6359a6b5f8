"""``gluon.Trainer(mesh_shape=..., sharding_plan=...)`` in the PyTorch port
(``parallel/spmd/{plan,products,lowering}.py``) against the JAX package's
multi-axis Trainer (``mxnet_tpu/parallel/spmd``), which runs the same mesh
shape on 4 (or 8) of the conftest's virtual CPU devices.

Two launches a test session, shared across pytest-xdist workers: 4 gloo
ranks (``tests/torch_spmd_worker.py spmd4``) and, reading the first one's
checkpoints, 2 ranks (``spmd2``); each rank writes what it computed and the
tests here run the JAX side in this process.  Inputs and weights come from
numpy seeds (the worker's functions).

Tolerances, all of the reference's largest magnitude (a tensor's, or with
BERT the model's: softmax ignores a shift of every key's score, so the key
part of ``attn_in_bias`` gets a gradient of rounding noise alone, which
Adam scales up to lr-sized steps):

- the split products against the unsplit op and the JAX op: 1e-5 (the
  products add their partial sums in another order);
- the MLP after 5 steps against the JAX Trainer at the same shape and the
  JAX single-device whole step: 1e-5 (the JAX test's ``atol``, which is
  also its magnitude here);
- BERT-tiny after 3 Adam steps at model scale, and the conv + BatchNorm
  net after 3 steps (weights and moving statistics): 1e-4 and 1e-5;
- a restore across shapes, processes and packages: bit for bit; a step
  at another data split: 1e-5.

The ``gpu``-marked tests need the card and skip here; run them on the GPU
machine with ``python -m pytest -m gpu --noconftest tests/test_torch_spmd.py``.
"""
import functools
import json
import logging
import pickle
import shutil

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import trainer as ttrainer
from mxnet_tpu_torch.parallel import mesh as tmesh
from mxnet_tpu_torch.parallel import spmd as tspmd

import torch_mesh_worker as mw
import torch_spmd_worker as sw

X, Y = sw.mlp_data()
SPLIT_TOL = 1e-5
MLP_TOL = 1e-5
BERT_TOL = 1e-4
BN_TOL = 1e-5
STEP_TOL = 1e-5


def assert_close(got, want, tol, model_scale=False):
    top = max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        scale = top if model_scale else max(float(np.abs(w).max()), 1e-30)
        assert g.shape == w.shape
        assert float(np.abs(g - w).max()) <= tol * scale


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def arrays(arr, prefix):
    """The arrays ``prefix0, prefix1, ...`` of a rank's npz."""
    out, i = [], 0
    while f"{prefix}{i}" in arr.files:
        out.append(arr[f"{prefix}{i}"])
        i += 1
    return out


class StandIn:
    """A mesh of the plan's two attributes, for shapes no launch has."""

    def __init__(self, spec):
        self.shape = tspmd.parse_mesh_shape(spec)
        self.axis_names = tuple(self.shape)


# -- the JAX side -----------------------------------------------------------------


def jax_weights(net):
    return [p.data().asnumpy() for _, p in
            sorted(net._collect_params_with_prefix().items())]


def jax_states(tr):
    out = []
    for st in tr._states:
        entry = next(iter(st.values())) if st else None
        if entry is None:
            continue
        for leaf in (entry if isinstance(entry, (tuple, list)) else (entry,)):
            out.append(leaf.asnumpy())
    return out


def jax_host_blob(blob):
    from mxnet_tpu.checkpoint import manager as jmgr

    return pickle.loads(pickle.dumps(jmgr._fetch(jmgr._capture(blob))))


def jax_mlp_trainer(shape, zero=False, row=False, opt=sw.SGD_MOM):
    import mxnet_tpu as jmx

    net = sw.mlp(jmx, jmx.xla(0), row)
    name, args = opt
    kw = dict(mesh_shape=shape, zero_shard=zero) if shape else \
        dict(whole_step=True)
    return net, jmx.gluon.Trainer(net.collect_params(), name, dict(args),
                                  **kw)


@functools.lru_cache(maxsize=None)
def jax_mlp(shape, zero=False, row=False):
    """The JAX Trainer's weights after each of STEPS whole steps."""
    net, tr = jax_mlp_trainer(shape, zero, row)
    out = []
    for _ in range(sw.STEPS):
        tr.whole_step(net, sw.jax_sq_loss, X, Y)
        out.append(jax_weights(net))
    return out


def jax_bert_net(weights):
    import mxnet_tpu as jmx

    net = mw.bert_block(jmx)
    net.initialize()
    with jmx.autograd.pause():
        net(*[jmx.nd.array(a, dtype=a.dtype) for a in mw.bert_data()])
    for k, p in net._collect_params_with_prefix().items():
        p.set_data(jmx.nd.array(weights[k]))
    return net


def _prepare4(d):
    """The JAX side's files: BERT-tiny's weights (JAX-initialized), and the
    JAX Trainer's Adam MLP at dp=4,mp=2 with ZeRO after SAVE_AT steps: its
    states blob and weights, by full name."""
    import mxnet_tpu as jmx

    jmx.random.seed(9)
    jnet = mw.bert_block(jmx)
    jnet.initialize(init=jmx.init.Normal(0.02))
    with jmx.autograd.pause():
        jnet(*[jmx.nd.array(a, dtype=a.dtype) for a in mw.bert_data()])
    np.savez(d / "bert-weights.npz", **{
        k: p.data().asnumpy() for k, p in
        jnet._collect_params_with_prefix().items()})
    net, tr = jax_mlp_trainer("dp=4,mp=2", True, opt=sw.ADAM)
    for _ in range(sw.SAVE_AT):
        tr.whole_step(net, sw.jax_sq_loss, X, Y)
    with open(d / "jax-blob.pkl", "wb") as f:
        pickle.dump(jax_host_blob(tr.states_dict()), f)
    np.savez(d / "jax-params.npz", **{
        k: p.data().asnumpy() for k, p in net.collect_params().items()})
    tr.whole_step(net, sw.jax_sq_loss, X, Y)
    np.savez(d / "jax-next.npz", *jax_weights(net))


@pytest.fixture(scope="session")
def spmd4(tmp_path_factory):
    out = mw.shared_run("spmd4", 4, _prepare4, tmp_path_factory,
                        script=sw.__file__)
    return out, mw.read(out, "spmd4", 4)


@pytest.fixture(scope="session")
def spmd2(spmd4, tmp_path_factory):
    def prepare(d):
        for name in ("save-blob.pkl", "save-r0.params", "bert-weights.npz"):
            shutil.copy(spmd4[0] / name, d / name)
        shutil.copytree(spmd4[0] / "ckpt", d / "ckpt")

    out = mw.shared_run("spmd2", 2, prepare, tmp_path_factory,
                        script=sw.__file__)
    return out, mw.read(out, "spmd2", 2)


# -- the plan -----------------------------------------------------------------------


def _bert_shapes(cfg):
    """BERT's parameters with their deferred input sizes filled in (no
    weights made): each layer's second FFN Dense reads ``hidden``
    features, every other Dense ``units``."""
    units, hidden = cfg[1], cfg[2]
    net = tmx.models.BERTModel(*cfg[:5], max_length=cfg[5])
    out = []
    for layer in net.encoder.layers:
        ffn2 = {layer.ffn2.weight.name}
        for n, p in layer.collect_params().items():
            out.append((n, tuple(hidden if d == 0 and n in ffn2 else
                                 units if d == 0 else d for d in p.shape)))
    seen = {n for n, _ in out}
    for n, p in net.collect_params().items():
        if n not in seen:
            out.append((n, tuple(units if d == 0 else d for d in p.shape)))
    return out


def _resnet50_shapes():
    """ResNet-50 v1's parameters with their deferred channel counts filled
    in forward order (no weights made): a convolution reads the channels
    the previous layer gave (the image's 3 first), BatchNorm takes them,
    the classifier reads the last stage's."""
    net = tmx.gluon.model_zoo.vision.resnet50_v1()
    out, c = [], 3
    for n, p in net.collect_params().items():
        s = list(p.shape)
        if len(s) == 4:
            s[1] = s[1] or c
            c = s[0]
        elif len(s) == 1:
            s[0] = s[0] or c
        elif len(s) == 2:
            s[1] = s[1] or c
        out.append((n, tuple(s)))
    return out


MODELS = {
    "bert_base": lambda: _bert_shapes((30522, 768, 3072, 12, 12, 512)),
    "bert_tiny": lambda: _bert_shapes((1000, 64, 128, 2, 4, 128)),
    "resnet50_v1": _resnet50_shapes,
    "mlp": lambda: [(n, p.shape) for n, p in
                    sw.mlp(tmx, tmx.cpu()).collect_params().items()],
}


@pytest.mark.parametrize("shape", ["dp=4,mp=2", "dp=2,mp=2"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_sharding_plan_matches_jax_on_models(model, shape):
    """``param_spec`` and ``state_spec`` (with and without ZeRO) equal the
    JAX plan's for every parameter of the model."""
    from mxnet_tpu.parallel import spmd as jspmd

    jplan = jspmd.ShardingPlan(jspmd.make_spmd_mesh(shape))
    plan = tspmd.ShardingPlan(StandIn(shape))
    named = MODELS[model]()
    assert named and all(all(d > 0 for d in s) for _, s in named)
    split = 0
    for name, s in named:
        want = tuple(jplan.param_spec(name, s))
        assert plan.param_spec(name, s) == want, name
        split += bool(want)
        for zero in (False, True):
            assert plan.state_spec(name, s, zero=zero) == tuple(
                jplan.state_spec(name, s, zero=zero)), (name, zero)
    assert split > 0


@pytest.mark.parametrize("shape", ["dp=4,mp=2", "dp=2,mp=2"])
def test_sharding_plan_rules(shape):
    """tests/test_spmd.py's rules, on both packages' plans."""
    from jax.sharding import PartitionSpec as P
    from mxnet_tpu.parallel import spmd as jspmd

    for plan in (tspmd.ShardingPlan(StandIn(shape)),
                 jspmd.ShardingPlan(jspmd.make_spmd_mesh(shape))):
        assert tuple(plan.param_spec("dense0_weight", (16, 16))) == \
            tuple(P("mp", None))
        assert tuple(plan.param_spec("blk_out_proj_weight", (16, 16))) == \
            (None, "mp")
        assert tuple(plan.param_spec("dense0_bias", (16,))) == ("mp",)
        assert tuple(plan.param_spec("odd_weight", (3, 5))) == ()
        assert tuple(plan.state_spec("dense0_weight", (16, 16),
                                     zero=True)) == ("mp", "dp")
        assert tuple(plan.state_spec("dense0_weight", (16, 16),
                                     zero=False)) == ("mp", None)
    assert tspmd.ShardingPlan(StandIn(shape)).batch_spec() == ("dp",)
    assert tspmd.ShardingPlan(StandIn("dcn=2," + shape)).batch_spec() == \
        (("dcn", "dp"),)


@pytest.mark.parametrize("shape", ["dp=4,mp=2", "dp=2,mp=2"])
def test_sharding_plan_override(shape):
    """An override (a JAX ``PartitionSpec`` read as its tuple, or a tuple)
    wins, first match first; an unknown axis raises with the JAX message;
    ``constrain`` checks its axes and returns the value unchanged."""
    from jax.sharding import PartitionSpec as P

    mesh = StandIn(shape)
    plan = tspmd.ShardingPlan(mesh).override("*_bias", P()) \
        .override("*", ("mp",))
    assert plan.param_spec("dense0_bias", (16,)) == ()
    assert plan.param_spec("dense0_weight", (16, 16)) == ("mp",)
    assert tspmd.ShardingPlan(mesh).override("*", P(None, "mp")) \
        .param_spec("w", (4, 4)) == (None, "mp")
    with pytest.raises(MXNetError, match="mesh axis 'tp'"):
        tspmd.ShardingPlan(mesh).override("*", P("tp"))
    with pytest.raises(MXNetError, match="3 dims"):
        tspmd.ShardingPlan(mesh).override("*", (None, None, "mp")) \
            .param_spec("w", (4, 4))
    x = torch.ones(2)
    assert tspmd.ShardingPlan(mesh).constrain(x, "dp", None) is x
    with pytest.raises(MXNetError, match="mesh axis 'pp'"):
        tspmd.ShardingPlan(mesh).constrain(x, "pp")


# -- the split products -------------------------------------------------------------


def _unsplit_fc(x, w, b, flatten, gy):
    from mxnet_tpu_torch.ops.nn import _k_fully_connected

    ts = [torch.tensor(a, requires_grad=True) for a in (x, w, b)]
    y = _k_fully_connected(*ts, flatten=flatten)
    grads = torch.autograd.grad((y * torch.tensor(gy)).sum(), ts)
    return [y.detach().numpy()] + [g.numpy() for g in grads]


def _jax_fc(x, w, b, flatten, gy):
    import jax
    from mxnet_tpu.ops.nn import _k_fully_connected as jfc

    def f(x, w, b):
        return jfc(x, w, b, num_hidden=w.shape[0], flatten=flatten)

    y, vjp = jax.vjp(f, x, w, b)
    return [np.asarray(y)] + [np.asarray(g) for g in vjp(gy)]


def _unsplit_mha(x, wi, bi, wo, bo, gy, mem=None):
    from mxnet_tpu_torch.ops.attention import _k_multihead_attention

    ins = [torch.tensor(a, requires_grad=True) for a in (
        (x,) if mem is None else (x, mem))]
    ws = [torch.tensor(a, requires_grad=True) for a in (wi, bi, wo, bo)]
    kv = ins[-1]
    y = _k_multihead_attention(ins[0], kv, kv, *ws, num_heads=2)
    grads = torch.autograd.grad((y * torch.tensor(gy)).sum(), ins + ws)
    return [y.detach().numpy()] + [g.numpy() for g in grads]


def _jax_mha(x, wi, bi, wo, bo, gy, mem=None):
    import jax
    from mxnet_tpu.ops.attention import _k_multihead_attention as jmha

    if mem is None:
        def f(x, wi, bi, wo, bo):
            return jmha(x, x, x, wi, bi, wo, bo, num_heads=2)

        y, vjp = jax.vjp(f, x, wi, bi, wo, bo)
    else:
        def f(x, mem, wi, bi, wo, bo):
            return jmha(x, mem, mem, wi, bi, wo, bo, num_heads=2)

        y, vjp = jax.vjp(f, x, mem, wi, bi, wo, bo)
    return [np.asarray(y)] + [np.asarray(g) for g in vjp(gy)]


def _split_refs(name, jax_side=True):
    """The unsplit port op's (and the JAX op's) output, then the gradients
    of x and of the weights and biases, for one split case."""
    if name in sw.MHA_CASES:
        *args, mem = sw.mha_inputs()
        mem = mem if sw.MHA_CASES[name][1] else None
        return (_unsplit_mha(*args, mem),
                _jax_mha(*args, mem) if jax_side else None)
    (_, _kind, x, w, b), = [c for c in sw.split_inputs() if c[0] == name]
    flatten = name.endswith("flat")
    out_shape = (x.shape[0], w.shape[0]) if flatten else x.shape[:-1] + (
        w.shape[0],)
    gy = np.random.RandomState(9).randn(*out_shape).astype(np.float32)
    return (_unsplit_fc(x, w, b, flatten, gy),
            _jax_fc(x, w, b, flatten, gy) if jax_side else None)


SPLIT_CASES = [c[0] for c in sw.split_inputs()] + list(sw.MHA_CASES)


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_products_match_unsplit_and_jax(case, spmd2):
    """On 2 ranks, each product on its shard: the output, the input's
    gradient and the full weight and bias gradients (gathered) against the
    unsplit op and the JAX op, within 1e-5 relative; both ranks alike."""
    _, ranks = spmd2
    got = arrays(ranks[0][1], f"splits/{case}/")
    unsplit, jax_ = _split_refs(case)
    assert_close(got, unsplit, SPLIT_TOL)
    assert_close(got, jax_, SPLIT_TOL)
    assert_same(arrays(ranks[1][1], f"splits/{case}/"), got)


def test_split_products_count_their_collectives(spmd2):
    """4 FullyConnected and 3 attention calls: 2 + 2 products of the
    self-attention cases and 2 + 1 of the cross-attention case (the query
    and the memory, which is key and value, each once through the split
    in-projection): with the 2 of the column FullyConnected cases, 8
    column splits, each an all-gather forward and an all-reduce backward,
    and 3 row splits,
    each an all-reduce forward and an all-gather backward; the only
    parameters gathered are the biases of the row splits (3), and the 20
    weight and bias gradients the worker gathers to compare."""
    meta = spmd2[1][0][0]["splits"]
    assert meta["counts"] == {"column": 2 + 2 + 1 + 3, "row": 2 + 1}
    assert meta["comm"]["act"]["calls"] == 2 * 8 + 2 * 3
    assert meta["comm"]["param"]["calls"] == 3 + 20


# -- the MLP ----------------------------------------------------------------------


MLP_CASES = {"dp2mp2_zero": ("spmd4", "mlp_zero", "dp=2,mp=2", True, False),
             "mp2_row": ("spmd2", "mlp_row", "mp=2", False, True),
             "dp4": ("spmd4", "mlp_dp4", "dp=4", False, False)}


@pytest.mark.parametrize("case", sorted(MLP_CASES))
def test_mlp_mesh_matches_jax(case, request):
    """The MLP through ``Trainer(mesh_shape=...)``: every rank holds the
    same full weights after every step, within 1e-5 of the JAX Trainer at
    the same shape and of the JAX single-device whole step after each of
    5 steps; every step an spmd step, eager, none a fallback."""
    launch, key, shape, zero, row = MLP_CASES[case]
    _, ranks = request.getfixturevalue(launch)
    want = jax_mlp(shape, zero, row)
    single = jax_mlp(None, False, row)
    arr0 = ranks[0][1]
    for s in range(sw.STEPS):
        got = arrays(arr0, f"{key}/step{s}/p")
        assert_close(got, want[s], MLP_TOL)
        assert_close(got, single[s], MLP_TOL)
        for _, arr in ranks[1:]:
            assert_same(arrays(arr, f"{key}/step{s}/p"), got)
    stats = ranks[0][0][key]["stats"]
    assert stats["spmd_steps"] == stats["whole_step_eager"] == sw.STEPS
    assert stats["whole_step_fallbacks"] == 0
    assert stats["zero_steps"] == (sw.STEPS if zero else 0)
    if "mp" in shape:  # an eager step would miss the sharded parameters
        assert ranks[0][0][key]["eager_step"].startswith(
            "Trainer.step: the parameters are sharded over the mesh")


@pytest.mark.parametrize("shape", ["dp2mp2", "dp4"])
def test_unseeded_ranks_start_alike(shape, spmd4):
    """A deferred-init MLP whose 4 ranks seed their generators differently
    (so draw different initial weights): the mesh step places rank 0's
    values, and every rank holds the same weights, bit for bit, and the
    same loss after each of 3 steps."""
    _, ranks = spmd4
    key = f"unseeded_{shape}"
    losses = ranks[0][0][key]["losses"]
    assert len(losses) == 3 and np.isfinite(losses).all()
    for s in range(3):
        got = arrays(ranks[0][1], f"{key}/step{s}/p")
        assert len(got) == 6 and all(np.isfinite(a).all() for a in got)
        for meta, arr in ranks[1:]:
            assert_same(arrays(arr, f"{key}/step{s}/p"), got)
            assert meta[key]["losses"] == losses


def test_dropout_resume_continues_streams(spmd2):
    """Dropout 0.5 at dp=2: each rank saves its own generators (its data
    coordinate's stream), and a fresh trainer restored from the save
    continues bit for bit as the uninterrupted run does, on both ranks; a
    restore without the generators does not."""
    out, ranks = spmd2
    d = out / "ckpt-dropout" / "ckpt-00000002"
    streams = []
    for r in range(2):
        with open(d / f"rng-shard{r}.json") as f:
            streams.append(json.load(f).get("stream", 0))
    assert streams == [0, 1]
    for meta, arr in ranks:
        assert "rng-shard1.json" in meta["dropout"]["files"]
        assert meta["dropout_resumed"]["losses"] == \
            meta["dropout_run"]["losses"]
        for s in range(2):
            assert_same(arrays(arr, f"dropout_resumed/step{s}/p"),
                        arrays(arr, f"dropout_run/step{s}/p"))
        assert meta["dropout_no_rng"]["losses"] != \
            meta["dropout_run"]["losses"]


def test_row_route_specs_and_gathers(spmd2):
    """At mp=2 the two ``out_proj*`` weights split by rows and take the row
    route; their biases are gathered for the add after the reduce, and
    nothing else is."""
    meta = spmd2[1][0][0]["mlp_row"]
    specs = meta["specs"]
    assert specs["out_proj0_weight"] == [None, "mp"]
    assert specs["out_proj1_weight"] == [None, "mp"]
    assert specs["fc0_weight"] == ["mp", None]
    assert meta["splits"] == {"column": sw.STEPS, "row": 2 * sw.STEPS}
    assert sorted(meta["gathered"]) == ["out_proj0_bias", "out_proj1_bias"]


def test_state_bytes_and_params_at_rest(spmd4):
    """dp=2,mp=2 with ZeRO: a rank holds 1/4 of each 2-D weight's momentum
    ('mp' and 'dp') and 1/2 of each bias's (a 1-D spec has no dim left
    for 'dp'): 648 of the MLP's 2,448 bytes.  (The JAX test's bound,
    under a quarter, is at dp=4,mp=2, where the weights hold 1/8.)  Each
    rank's parameters hold half of theirs."""
    meta = spmd4[1][0][0]["mlp_zero"]
    full = meta["full_state_bytes"]
    assert full == 4 * (2 * 16 * 16 + 4 * 16 + 2 * 16 + 4)
    assert meta["state_bytes"] == 4 * (2 * 16 * 16 // 4 + 4 * 16 // 4
                                       + 2 * 16 // 2 + 4 // 2)
    assert meta["param_bytes"] * 2 == 4 * (2 * (16 * 16 + 16) + 4 * 16 + 4)
    dp4 = spmd4[1][0][0]["mlp_dp4"]
    assert dp4["param_bytes"] == 2 * meta["param_bytes"]


def test_lr_decay_places_and_resolves_nothing(spmd4):
    """4 steps under a decaying learning rate after 5: no spec resolved,
    no parameter or state sliced again (the port's counterparts of JAX's
    compiled-executable count)."""
    meta = spmd4[1][0][0]["mlp_zero"]
    assert meta["after_decay"] == meta["compiler"]
    assert meta["compiler"]["placed"] == 6
    assert meta["compiler"]["specs"] == 6


def test_batch_not_divisible_falls_back_loudly(spmd4):
    """6 rows over dp=4: each step warns, counts a fallback and runs the
    eager whole step on every rank, whose weights stay bit-identical and
    equal one process's eager steps on the 6 rows (within 1e-6)."""
    _, ranks = spmd4
    stats = ranks[0][0]["bypass"]["stats"]
    assert stats["whole_step_fallbacks"] == 2 and stats["spmd_steps"] == 0
    assert ranks[0][0]["bypass"]["warned"] == [
        "batch 6 not divisible by the data-axis product 4 of mesh dp=4"]
    net = sw.mlp(tmx, tmx.cpu())
    name, args = sw.SGD_MOM
    tr = tmx.gluon.Trainer(net.collect_params(), name, dict(args))
    for s in range(2):
        tr._eager_whole_step(net, sw.sq_loss, (X[:6],), Y[:6], 6)
        got = arrays(ranks[0][1], f"bypass/step{s}/p")
        assert_close(got, sw.weights(net), 1e-6)
        for _, arr in ranks[1:]:
            assert_same(arrays(arr, f"bypass/step{s}/p"), got)


# -- BERT-tiny and BatchNorm -----------------------------------------------------------


@pytest.mark.parametrize("case", ["bert_zero", "bert_mp2"])
def test_bert_tiny_mesh_matches_jax(case, request):
    """BERT-tiny (a loss a row) after 3 Adam steps at dp=2,mp=2 with ZeRO
    and at mp=2, against the JAX Trainer at the same shape (1e-4 of the
    model's largest value); the products of every Dense and attention
    projection on their shards (12 a forward), the embeddings and
    LayerNorms gathered, and the parameter traffic of the steps exactly
    those gathers (plus, under ZeRO, the updated slices)."""
    import mxnet_tpu as jmx

    launch = "spmd4" if case == "bert_zero" else "spmd2"
    shape, zero = ("dp=2,mp=2", True) if case == "bert_zero" else \
        ("mp=2", False)
    out, ranks = request.getfixturevalue(launch)
    weights = np.load(out / "bert-weights.npz")
    jnet = jax_bert_net(weights)
    name, args = sw.BERT_ADAM
    jtr = jmx.gluon.Trainer(jnet.collect_params(), name, dict(args),
                            mesh_shape=shape, zero_shard=zero)
    jl = [float(jtr.whole_step(jnet, sw.row_loss, mw.bert_data())
                .asnumpy()) for _ in range(3)]
    meta, arr = ranks[0]
    np.testing.assert_allclose(meta[case]["losses"], jl, rtol=BERT_TOL)
    assert_close(arrays(arr, f"{case}/step2/p"), jax_weights(jnet),
                 BERT_TOL, model_scale=True)
    for m, a in ranks[1:]:
        assert_same(arrays(a, f"{case}/step2/p"), arrays(arr,
                                                         f"{case}/step2/p"))
    m = meta[case]
    assert m["splits"]["column"] + m["splits"]["row"] == 3 * 12
    names = m["gathered"]
    assert not any(n.endswith(("attn_in_weight", "attn_out_weight"))
                   or "dense" in n for n in names)
    assert sum("embedding" in n for n in names) == 3 and sum(
        "layernorm" in n for n in names) == 2 * (1 + 2 * 2 + 1)
    gathered_bytes = m["gathered_bytes"]
    pbytes = m["comm_steps"]["param"]["bytes"]
    if zero:
        assert pbytes > 3 * gathered_bytes
    else:
        assert pbytes == 3 * gathered_bytes
    assert m["stats"]["spmd_steps"] == 3


def test_conv_batchnorm_mesh_matches_jax(spmd4):
    """Two Conv + BatchNorm layers and a Dense at dp=2,mp=2 (SGD with
    momentum, 3 steps): weights and moving statistics (the global batch's)
    within 1e-5 of the JAX Trainer at the same shape."""
    import mxnet_tpu as jmx

    x, y = mw.bn_data()
    jnet = mw.small_bn_net(jmx)
    name, args = sw.BN_SGD
    jtr = jmx.gluon.Trainer(jnet.collect_params(), name, dict(args),
                            mesh_shape="dp=2,mp=2")
    for _ in range(3):
        jtr.whole_step(jnet, sw.jax_ce_loss, x, y)
    _, ranks = spmd4
    got = arrays(ranks[0][1], "convbn/step2/p")
    assert_close(got, jax_weights(jnet), BN_TOL)
    names = sorted(jnet._collect_params_with_prefix())
    assert sum("running" in n for n in names) == 4
    meta = ranks[0][0]["convbn"]
    assert meta["comm_steps"]["stats"]["calls"] > 0
    assert meta["splits"]["row"] == 3  # the (5, 16) classifier


# -- checkpoints ------------------------------------------------------------------


def test_mesh_round_trip_bit_exact(spmd4, spmd2, tmp_path):
    """dp=2,mp=2 (ZeRO) -> dp=1,mp=2 -> one process without a mesh: the
    blob and parameter file, and the CheckpointManager directory, load
    bit-exact at dp=1,mp=2; a step there is bit-identical to a trainer
    given the same blob, and within 1e-5 of the uninterrupted dp=2,mp=2
    step; its own save restores bit-exact in one process."""
    from mxnet_tpu_torch.checkpoint import CheckpointManager

    (_, r4), (out2, r2) = spmd4, spmd2
    saved_w = arrays(r4[0][1], f"save/step{sw.SAVE_AT - 1}/p")
    saved_s = arrays(r4[0][1], "save/state")
    assert r4[0][0]["save"]["mesh_shape"] == "dp=2,mp=2"
    assert r4[0][0]["save"]["files"] == [
        "MANIFEST.json", "params-shard0.params", "rng-shard0.json",
        "rng-shard1.json", "rng-shard2.json", "rng-shard3.json",
        "trainer-shard0.states"]
    for meta, arr in r2:
        for label in ("blob", "ref", "dir"):
            assert_same(arrays(arr, f"restore_{label}/loaded/p"), saved_w)
            assert_same(arrays(arr, f"restore_{label}/loaded/state"),
                        saved_s)
        stepped = arrays(arr, "restore_blob/step0/p")
        assert_same(arrays(arr, "restore_ref/step0/p"), stepped)
        assert_same(arrays(arr, "restore_dir/step0/p"), stepped)
        assert meta["restore"]["dir_step"] == sw.SAVE_AT
        assert_close(stepped, arrays(r4[0][1], "save_next/step0/p"),
                     STEP_TOL)
    net = sw.mlp(tmx, tmx.cpu())
    name, args = sw.ADAM
    tr = tmx.gluon.Trainer(net.collect_params(), name, dict(args),
                           whole_step=True)
    meta = CheckpointManager(str(out2 / "ckpt2")).restore(params=net,
                                                          trainer=tr)
    assert meta["step"] == sw.SAVE_AT + 1
    assert_same(sw.weights(net), arrays(r2[0][1], "restore_blob/step0/p"))
    assert_same(sw.states_arrays(tr.states_dict()),
                arrays(r2[0][1], "restore_blob/saved/state"))


def test_jax_blob_loads_at_another_shape(spmd4):
    """The JAX Trainer's states blob of dp=4,mp=2 (ZeRO, Adam) loads into
    the port at dp=2,mp=2 bit for bit, and the next step is within 1e-5
    of the JAX Trainer's."""
    out, ranks = spmd4
    with open(out / "jax-blob.pkl", "rb") as f:
        blob = pickle.load(f)
    assert blob["mesh_shape"] == "dp=4,mp=2"
    want = sw.states_arrays(blob)
    nxt = np.load(out / "jax-next.npz")
    for _, arr in ranks:
        assert_same(arrays(arr, "xpkg/loaded/state"), want)
        assert_close(arrays(arr, "xpkg/p"),
                     [nxt[f"arr_{i}"] for i in range(len(nxt.files))],
                     STEP_TOL)


@pytest.mark.parametrize("how", ["blob", "directory"])
def test_port_mesh_files_load_into_jax(how, spmd4):
    """The port's dp=2,mp=2 save -- its states blob, or its
    CheckpointManager directory (one process's files, full arrays) --
    loads into the JAX Trainer at dp=4,mp=2 bit for bit."""
    import mxnet_tpu as jmx
    from mxnet_tpu.checkpoint import CheckpointManager as JMgr

    out, ranks = spmd4
    net, tr = jax_mlp_trainer("dp=4,mp=2", True, opt=sw.ADAM)
    tr._init_kvstore()
    if how == "blob":
        with open(out / "save-blob.pkl", "rb") as f:
            tr.load_states_dict(pickle.load(f))
        net.load_parameters(str(out / "save-r0.params"), ctx=jmx.xla(0))
    else:
        meta = JMgr(str(out / "ckpt")).restore(params=net, trainer=tr,
                                               restore_rng=False)
        assert meta["step"] == sw.SAVE_AT
    assert_same(jax_weights(net),
                arrays(ranks[0][1], f"save/step{sw.SAVE_AT - 1}/p"))
    assert_same(jax_states(tr), arrays(ranks[0][1], "save/state"))


def test_check_mesh_change_paths(caplog):
    """The JAX function's four paths, its return values and its warnings
    word for word."""
    from mxnet_tpu_torch.checkpoint.reshard import check_mesh_change

    with caplog.at_level(logging.INFO, logger="mxnet_tpu_torch"):
        assert check_mesh_change("dp=4,mp=2", {"dp": 2, "mp": 2}) == \
            {"dp": 2, "mp": 2}
        assert "elastic mesh reshape on restore: dp=4,mp=2 -> dp=2,mp=2" \
            in caplog.text
        caplog.clear()
        assert check_mesh_change("dp=4,mp=2", None, source="f") is None
        assert ("f: snapshot was saved on spmd mesh dp=4,mp=2 but this "
                "trainer has no mesh_shape") in caplog.text
        caplog.clear()
        assert check_mesh_change(None, None) is None
        assert check_mesh_change("dp=2", "dp=2") == {"dp": 2}
        assert not caplog.records
        assert check_mesh_change("dp=4,mp=2", "dp=2,mp=4") == \
            {"dp": 2, "mp": 4}
        assert [r.levelname for r in caplog.records] == ["WARNING"]
        assert ("restoring across a MODEL-parallelism change: saved mesh "
                "dp=4,mp=2 (mp*pp=2) -> new mesh dp=2,mp=4 (mp*pp=4)") \
            in caplog.text


# -- one process ------------------------------------------------------------------


def test_one_rank_mesh_is_the_whole_step():
    """``mesh_shape='dp=1'``: the whole step itself, bit for bit, counted
    as spmd steps; the blob records the shape and loads back."""
    net, tr = sw.mlp(tmx, tmx.cpu()), None
    ref = sw.mlp(tmx, tmx.cpu())
    name, args = sw.SGD_MOM
    tr = tmx.gluon.Trainer(net.collect_params(), name, dict(args),
                           mesh_shape="dp=1", zero_shard=True)
    rtr = tmx.gluon.Trainer(ref.collect_params(), name, dict(args),
                            whole_step=True)
    ttrainer.reset_trainer_step_stats()
    for _ in range(3):
        tr.whole_step(net, sw.sq_loss, X, Y)
        rtr.whole_step(ref, sw.sq_loss, X, Y)
    assert_same(sw.weights(net), sw.weights(ref))
    stats = ttrainer.trainer_step_stats()
    assert stats["spmd_steps"] == 3 and stats["whole_step_eager"] == 0
    assert tr.whole_step_enabled
    blob = tr.states_dict()
    assert blob["mesh_shape"] == "dp=1"
    tr.load_states_dict(blob)


def test_mesh_errors_name_their_cause(monkeypatch):
    """A plan for another mesh, a shape over more ranks than the job has
    (naming the launcher), ``sharding_plan`` without a shape, ``pp``, and
    ``MXTPU_MESH_SHAPE`` routing (the constructor's shape wins)."""
    name, args = sw.SGD_MOM
    net = sw.mlp(tmx, tmx.cpu())
    tr = tmx.gluon.Trainer(
        net.collect_params(), name, dict(args), mesh_shape="dp=1",
        sharding_plan=tspmd.ShardingPlan(StandIn("dp=4,mp=2")))
    with pytest.raises(MXNetError, match="different mesh"):
        tr.whole_step(net, sw.sq_loss, X, Y)
    tr = tmx.gluon.Trainer(net.collect_params(), name, dict(args),
                           mesh_shape="dp=2,mp=2")
    with pytest.raises(MXNetError, match="needs 4 devices, have 1 rank.*"
                       "mxnet_tpu_torch.tools.launch -n 4"):
        tr.whole_step(net, sw.sq_loss, X, Y)
    with pytest.raises(MXNetError, match="sharding_plan given but no "
                       "mesh_shape"):
        tmx.gluon.Trainer(net.collect_params(), name,
                          sharding_plan=tspmd.ShardingPlan(StandIn("dp=1")))
    with pytest.raises(MXNetError, match="PipelineTrainStep"):
        tspmd.SpmdStepCompiler.from_shape(None, "dp=2,pp=4")
    monkeypatch.setenv("MXTPU_MESH_SHAPE", "dp=1")
    tr = tmx.gluon.Trainer(net.collect_params(), name, dict(args))
    assert tr._mesh_shape == {"dp": 1} and tr.whole_step_enabled
    ttrainer.reset_trainer_step_stats()
    tr.whole_step(net, sw.sq_loss, X, Y)
    assert ttrainer.trainer_step_stats()["spmd_steps"] == 1
    assert tmx.gluon.Trainer(net.collect_params(), name,
                             mesh_shape="mp=1")._mesh_shape == {"mp": 1}


def test_later_pieces_name_themselves():
    """The ``pp`` axis came with piece 3 (``tests/test_torch_pipeline.py``
    holds it to the JAX package); the JAX tracing helpers are not ported,
    saying why, and name piece 4."""
    assert tspmd.stage_partition(7, 3) == ((0, 3), (3, 5), (5, 7))
    with pytest.raises(MXNetError, match="no 'pp' axis"):
        tspmd.PipelineTrainStep(None, StandIn("dp=4,mp=2"))
    with pytest.raises(MXNetError, match="piece 4"):
        tmesh.spmd_jit(None, None, (), ())
    with pytest.raises(MXNetError, match="shard_map .* is a JAX tracing "
                       "helper and is not ported"):
        tmesh.shard_map()


# -- on the card --------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the split products on the card); "
                    "run on the GPU machine with -m gpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _split_results(mesh, device):
    out = {}
    for name, kind, x, w, b in sw.split_inputs():
        out[name] = sw.split_grads(tmx, mesh, device, kind, x, w, b,
                                   flatten=name.endswith("flat"))
    for case in sw.MHA_CASES:
        out[case] = sw.mha_grads(tmx, mesh, device, case)
    return out


@pytest.mark.gpu
def test_split_products_on_card_one_rank(cuda_device):
    """A one-rank mesh (``mp`` of 1, the collectives of one member): the
    split products on CUDA tensors against the same on CPU tensors."""
    mesh = tmesh.make_mesh("mp=1", tmx.gpu(0))
    cpu_mesh = tmesh.make_mesh("mp=1", tmx.cpu())
    card = _split_results(mesh, cuda_device)
    cpu = _split_results(cpu_mesh, "cpu")
    for k in cpu:
        assert_close(card[k], cpu[k], SPLIT_TOL)


@pytest.mark.gpu
def test_split_products_on_card_two_ranks(cuda_device, tmp_path):
    """Two gloo ranks on the card (``cardsplits``): the split products on
    CUDA tensors against the unsplit op on CPU tensors."""
    rc, tail = mw.launch(tmp_path, "cardsplits", 2, timeout=300,
                         script=sw.__file__)
    assert rc == 0, tail
    ranks = mw.read(tmp_path, "cardsplits", 2)
    for case in SPLIT_CASES:
        got = arrays(ranks[0][1], f"splits/{case}/")
        assert_close(got, _split_refs(case, jax_side=False)[0], SPLIT_TOL)
        assert_same(arrays(ranks[1][1], f"splits/{case}/"), got)


@pytest.mark.gpu
def test_one_rank_mesh_whole_step_replays_on_card(cuda_device):
    """``Trainer(mesh_shape='dp=1')`` on gpu(0): one warm-up, one capture,
    then one replay a step, each counted as an spmd step, bit-identical to
    the plain captured whole step."""
    from mxnet_tpu_torch import _imperative

    name, args = sw.SGD_MOM
    net, ref = sw.mlp(tmx, tmx.gpu(0)), sw.mlp(tmx, tmx.gpu(0))
    tr = tmx.gluon.Trainer(net.collect_params(), name, dict(args),
                           mesh_shape="dp=1")
    rtr = tmx.gluon.Trainer(ref.collect_params(), name, dict(args),
                            whole_step=True)
    ttrainer.reset_trainer_step_stats()
    r0 = _imperative.graph_replay_count()
    for _ in range(4):
        tr.whole_step(net, sw.sq_loss, X, Y)
    assert _imperative.graph_replay_count() - r0 == 3
    for _ in range(4):
        rtr.whole_step(ref, sw.sq_loss, X, Y)
    torch.cuda.synchronize()
    assert_same(sw.weights(net), sw.weights(ref))
    assert ttrainer.trainer_step_stats()["spmd_steps"] == 4
