"""The ``pp`` and ``sp`` axes of the PyTorch port
(``parallel/spmd/schedule.py``, ``parallel/pipeline.py``,
``parallel/pipeline_lm.py``, ``parallel/ring_attention.py``,
``parallel/ulysses.py`` and ``parallel.mesh``'s ring shift and all-to-all)
against the JAX package's, which runs the same meshes on the conftest's 8
virtual CPU devices (``_causal_attention`` on its reference path there).

One launch a test session, shared across pytest-xdist workers: 8 gloo
ranks (``tests/torch_pipeline_worker.py pipe8``); each rank writes what it
computed and the tests here run the JAX side in this process.  A mesh of
fewer ranks runs in copies side by side (the worker's ``rep`` axis).
Inputs and weights come from numpy seeds (the worker's functions).

Tolerances.  The pipeline LM's gradients at the JAX test's widths sit
~1.5e-4 of their largest value from a float64 run of the same model in
either package (the attention logits are large: the JAX init draws
``wqkv`` at scale sqrt(2/3)), so the gradients are held to 1e-3 of each
leaf's largest value, the losses of 3 Adam steps to 1e-4 relative and the
weights after them to 1e-3 (Adam moves a weight by up to lr = 1e-3 a step
whatever the gradient's size, so the rounding of a near-zero gradient can
flip its step); a doubled or dropped reduction moves a gradient by 50-100%.
The first loss: 2e-4 of ``reference_lm_loss`` (the JAX test's limit) and
1e-5 relative of the JAX trainer's.  The schedule's outputs and gradients
(``pipeline_apply``, ``PipelineTrainStep``), the collectives and the
attention entries: 1e-5 (the collectives and the schedule itself move data
exactly).  Remat and a resumed checkpoint: bit for bit.

The ``gpu``-marked tests need the card and skip here; run them on the GPU
machine with ``python -m pytest -m gpu --noconftest
tests/test_torch_pipeline.py``.
"""
import functools

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import mesh as tmesh
from mxnet_tpu_torch.parallel import pipeline_lm as tplm
from mxnet_tpu_torch.parallel import spmd as tspmd
from mxnet_tpu_torch.parallel.spmd import schedule as tsched

import torch_mesh_worker as mw
import torch_pipeline_worker as pw

GRAD_TOL, LOSS_RTOL, WEIGHT_TOL = 1e-3, 1e-4, 1e-3
REF_TOL, FIRST_RTOL, EXACT_TOL = 2e-4, 1e-5, 1e-5
H = pw.LM["H"]


def close(got, want, tol):
    """``got`` within ``tol`` of ``want``'s largest magnitude."""
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1e-30), err


class StandIn:
    """A mesh of the two attributes the constructors read first."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def jax_message(fn):
    with pytest.raises(Exception) as e:
        fn()
    return str(e.value)


def same_error(port_fn, jax_fn):
    """The port raises MXNetError with the JAX package's words."""
    want = jax_message(jax_fn)
    with pytest.raises(MXNetError) as e:
        port_fn()
    assert str(e.value) == want


# -- one process ------------------------------------------------------------------


def test_stage_partition_and_microbatches_match_jax(monkeypatch):
    from mxnet_tpu.parallel.spmd import schedule as jsched

    for n_layers, n_stages in ((4, 2), (12, 2), (7, 3), (5, 5), (1, 1)):
        assert tsched.stage_partition(n_layers, n_stages) == \
            jsched.stage_partition(n_layers, n_stages)
    for n_layers, n_stages in ((4, 0), (2, 3)):
        same_error(lambda: tsched.stage_partition(n_layers, n_stages),
                   lambda: jsched.stage_partition(n_layers, n_stages))
    assert tsched.default_microbatches(4) == 4
    for knob in ("MXTPU_PP_MICROBATCHES", "MXNET_PP_MICROBATCHES"):
        monkeypatch.setenv(knob, "6")
        assert tsched.default_microbatches(4) == 6 == \
            jsched.default_microbatches(4)
        monkeypatch.delenv(knob)
    monkeypatch.setenv("MXTPU_PP_MICROBATCHES", "0")
    assert tsched.default_microbatches(3) == 3


def test_stubs_are_gone_and_the_shim_reexports():
    from mxnet_tpu_torch.parallel import pipeline as shim
    from mxnet_tpu_torch.parallel import ring_attention, ulysses  # noqa

    assert shim.pipeline_apply is tsched.pipeline_apply
    assert shim.stage_partition is tsched.stage_partition
    assert shim.stage_partition(4, 2) == ((0, 2), (2, 4))
    for name in ("stage_partition", "default_microbatches",
                 "pipeline_apply", "PipelineTrainStep"):
        assert getattr(tspmd, name) is getattr(tsched, name)


def test_validation_errors_match_jax():
    import jax

    from mxnet_tpu.parallel import mesh as jmesh
    from mxnet_tpu.parallel import pipeline_lm as jplm
    from mxnet_tpu.parallel import spmd as jspmd
    from mxnet_tpu.parallel.pipeline import pipeline_apply as japply

    def stage(params, x):
        return x

    devs = jax.devices()
    for shape in ("dp=4,mp=2", "dp=2,mp=2,pp=2"):
        same_error(
            lambda: tspmd.PipelineTrainStep(
                stage, StandIn(tspmd.parse_mesh_shape(shape))),
            lambda: jspmd.PipelineTrainStep(stage,
                                            jspmd.make_spmd_mesh(shape)))
    jstep = jspmd.PipelineTrainStep(
        stage, jspmd.make_spmd_mesh({"dp": 2, "pp": 4}, devs), n_micro=3)
    tstep = tspmd.PipelineTrainStep(stage, StandIn({"dp": 2, "pp": 4}),
                                    n_micro=3)
    jstep4 = jspmd.PipelineTrainStep(
        stage, jspmd.make_spmd_mesh({"dp": 2, "pp": 4}, devs), n_micro=2)
    tstep4 = tspmd.PipelineTrainStep(stage, StandIn({"dp": 2, "pp": 4}),
                                     n_micro=2)
    w, x = (np.zeros((4, 2, 2), np.float32),), np.zeros((8, 2))
    same_error(lambda: tstep(w, (), x, x, 0.1),
               lambda: jstep(w, (), x, x, 0.1))
    x6 = np.zeros((6, 2))
    same_error(lambda: tstep4(w, (), x6, x6, 0.1),
               lambda: jstep4(w, (), x6, x6, 0.1))
    jm4 = jmesh.make_mesh({"pp": 4}, devices=devs[:4])
    for n_micro in (3, 0):
        same_error(lambda: tsched.pipeline_apply(stage, w, x, StandIn(
                       {"pp": 4}), n_micro=n_micro),
                   lambda: japply(stage, w, x, jm4, n_micro=n_micro))
    V, D, L, F, S = (pw.LM[k] for k in "VDLFS")
    cases = [({"dp": 2, "pp": 2}, 2, H, "axis"),
             ({"dp": 1, "sp": 2, "tp": 2, "pp": 2}, 2, 2, "tp*sp"),
             ({"dp": 2, "tp": 2, "pp": 2}, 4, H, "n_stages")]
    for shape, stages, heads, _ in cases:
        n = int(np.prod(list(shape.values())))
        jparams = jplm.init_pipeline_lm(V, D, L, F, heads, S, stages)
        tparams = tplm.init_pipeline_lm(V, D, L, F, heads, S, stages,
                                        ctx=tmx.cpu())
        same_error(
            lambda: tplm.PipelineLMTrainer(tparams, StandIn(shape), heads),
            lambda: jplm.PipelineLMTrainer(
                jparams, jmesh.make_mesh(shape, devices=devs[:n]), heads))
    jtr = jplm.PipelineLMTrainer(
        pw.lm_init(jplm, 1), jmesh.make_mesh({"dp": 1, "tp": 1, "pp": 1},
                                             devices=devs[:1]), H)
    ttr = tplm.PipelineLMTrainer(pw.lm_init(tplm, 1, ctx=tmx.cpu()),
                                 tmesh.make_mesh({"dp": 1, "tp": 1,
                                                  "pp": 1}), H)
    toks, tgts = pw.lm_batch()
    same_error(lambda: ttr.step(toks[:7], tgts[:7]),
               lambda: jtr.step(toks[:7], tgts[:7]))
    assert ttr._t == 0


def test_init_and_tree_conversions_match_jax():
    from mxnet_tpu.parallel import pipeline_lm as jplm

    for stages in (1, 2, 4):
        j = pw.flat(pw.lm_init(jplm, stages))
        t = tplm.init_pipeline_lm(*(pw.LM[k] for k in "VDLFHS"), stages,
                                  ctx=tmx.cpu())
        got = pw.flat(tplm.params_to_numpy(t))
        assert sorted(got) == sorted(j)
        for k in j:
            np.testing.assert_array_equal(got[k], np.asarray(j[k]))
        tree = jplm.init_pipeline_lm(*(pw.LM[k] for k in "VDLFHS"), stages)
        back = tplm.params_to_numpy(tplm.params_from_numpy(
            {g: {k: np.asarray(v) for k, v in s.items()}
             for g, s in tree.items()}, tmx.cpu()))
        for k, v in pw.flat(back).items():
            np.testing.assert_array_equal(v, j[k])
    spec = tplm.param_specs()
    from jax.sharding import PartitionSpec

    jspec = jplm.param_specs()
    for g in spec:
        for k in spec[g]:
            assert PartitionSpec(*spec[g][k]) == jspec[g][k]


@functools.lru_cache(maxsize=None)
def jax_reference(stages):
    """JAX's ``reference_lm_loss`` and its gradient at ``stages``."""
    import jax

    from mxnet_tpu.parallel import pipeline_lm as jplm

    toks, tgts = pw.lm_batch()
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jplm.reference_lm_loss(p, toks, tgts, H)))(
        pw.lm_init(jplm, stages))
    return float(loss), {k: np.asarray(v)
                         for k, v in pw.flat(grads).items()}


def test_reference_lm_loss_and_gradients_match_jax():
    toks, tgts = pw.lm_batch()
    params = tplm.init_pipeline_lm(*(pw.LM[k] for k in "VDLFHS"), 2,
                                   ctx=tmx.cpu())
    for sub in params.values():
        for v in sub.values():
            v.requires_grad_()
    loss = tplm.reference_lm_loss(params, toks, tgts, H)
    loss.backward()
    want, grads = jax_reference(2)
    assert abs(float(loss.detach()) - want) <= FIRST_RTOL * abs(want)
    got = pw.flat({g: {k: v.grad.numpy() for k, v in s.items()}
                   for g, s in params.items()})
    for k, v in grads.items():
        close(got[k], v, GRAD_TOL)


def test_causal_attention_takes_the_reference_on_cpu():
    import jax.numpy as jnp

    from mxnet_tpu.parallel import pipeline_lm as jplm
    from mxnet_tpu_torch.ops.attention import sdpa_reference

    rng = np.random.RandomState(4)
    q, k, v = (rng.rand(2, 2, 128, 64).astype(np.float32) for _ in range(3))
    got = tplm._causal_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    want = sdpa_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=True)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    jax_out = jplm._causal_attention(*(jnp.asarray(a) for a in (q, k, v)))
    close(got.numpy(), np.asarray(jax_out), EXACT_TOL)


def test_one_rank_trainer_matches_jax_and_files_move(tmp_path):
    """``{dp:1, tp:1, pp:1}`` in this process: the first loss, 3 steps,
    the ``.npz`` keys, and remat's first loss."""
    import jax

    from mxnet_tpu.parallel import mesh as jmesh
    from mxnet_tpu.parallel import pipeline_lm as jplm

    toks, tgts = pw.lm_batch()
    shape = {"dp": 1, "tp": 1, "pp": 1}
    jtr = jplm.PipelineLMTrainer(pw.lm_init(jplm, 1), jmesh.make_mesh(
        shape, devices=jax.devices()[:1]), H, n_micro=2, lr=pw.LM_LR)
    trs = [tplm.PipelineLMTrainer(pw.lm_init(tplm, 1, ctx=tmx.cpu()),
                                  tmesh.make_mesh(shape), H, n_micro=2,
                                  lr=pw.LM_LR, remat=remat)
           for remat in (False, True)]
    want = [jtr.step(toks, tgts) for _ in range(pw.LM_STEPS)]
    got = [[tr.step(toks, tgts) for _ in range(pw.LM_STEPS)] for tr in trs]
    assert abs(got[0][0] - want[0]) <= FIRST_RTOL * want[0]
    assert got[1] == got[0]
    for a, b in zip(got[0], want):
        assert abs(a - b) <= LOSS_RTOL * b
    jtr.save_states(str(tmp_path / "jax.npz"))
    trs[0].save_states(str(tmp_path / "port.npz"))
    with np.load(tmp_path / "jax.npz") as zj, \
            np.load(tmp_path / "port.npz") as zt:
        assert sorted(zj.files) == sorted(zt.files)
        assert int(zt["__step__"]) == pw.LM_STEPS
        for k in zj.files:
            assert zt[k].shape == zj[k].shape and zt[k].dtype == zj[k].dtype


# -- the 8-rank launch --------------------------------------------------------------


def _prepare(d):
    """The JAX package's checkpoint of 3 steps on ``{dp:2, tp:2, pp:2}``."""
    from mxnet_tpu.parallel import mesh as jmesh
    from mxnet_tpu.parallel import pipeline_lm as jplm

    toks, tgts = pw.lm_batch()
    tr = jplm.PipelineLMTrainer(pw.lm_init(jplm, 2), jmesh.make_mesh(
        pw.CKPT_MESH), H, n_micro=2, lr=pw.CKPT_LR)
    for _ in range(3):
        tr.step(toks, tgts)
    tr.save_states(str(d / "jax-plm.npz"))


@pytest.fixture(scope="session")
def pipe8(tmp_path_factory):
    out = mw.shared_run("pipe8", 8, _prepare, tmp_path_factory,
                        script=pw.__file__)
    return out, mw.read(out, "pipe8", 8)


def np_a2a(xs, split, concat):
    """Every member's result of the tiled all-to-all of ``xs``."""
    n = len(xs)
    return [np.concatenate([np.split(x, n, axis=split)[me] for x in xs],
                           axis=concat) for me in range(n)]


@pytest.mark.parametrize("n", [2, 4, 8])
def test_ring_shift_and_all_to_all(pipe8, n):
    _, ranks = pipe8
    for base in range(0, pw.SIZE, n):
        group = ranks[base:base + n]
        assert [m["collectives"][f"n{n}/index"] for m, _ in group] == \
            list(range(n))
        x = [np.arange(240, dtype=np.float32).reshape(2, 8, 3, 5)
             + 1000.0 * i for i in range(n)]
        w = [np.linspace(-1.0, 1.0, 240, dtype=np.float32).reshape(
            2, 8, 3, 5) * (i + 1) for i in range(n)]
        for i, (meta, arr) in enumerate(group):
            for off in (1, -1):
                np.testing.assert_array_equal(
                    arr[f"collectives/n{n}/shift{off}"], x[(i - off) % n])
                close(arr[f"collectives/n{n}/shift{off}_grad"],
                      w[(i + off) % n], EXACT_TOL)
        for split, concat in ((1, 2), (1, 3), (3, 1)):
            if x[0].shape[split] % n:
                continue
            ys = np_a2a(x, split, concat)
            us = [np.linspace(-1.0, 1.0, y.size, dtype=np.float32).reshape(
                y.shape) * (i + 1) for i, y in enumerate(ys)]
            grads = np_a2a(us, concat, split)
            for i, (meta, arr) in enumerate(group):
                key = f"collectives/n{n}/a2a{split}{concat}"
                np.testing.assert_array_equal(arr[key], ys[i])
                close(arr[key + "_grad"], grads[i], EXACT_TOL)
        for meta, _ in group:
            stats = meta["collectives"][f"n{n}/stats"]
            assert stats["p2p"]["calls"] == 4
            assert stats["p2p"]["bytes"] == 4 * 240 * 4


@pytest.mark.parametrize("case", [c[0] for c in pw.APPLY_CASES])
def test_pipeline_apply_matches_jax(pipe8, case):
    import jax

    from mxnet_tpu.parallel import mesh as jmesh
    from mxnet_tpu.parallel.pipeline import pipeline_apply as japply

    _, P, n_micro = next(c for c in pw.APPLY_CASES if c[0] == case)

    def stage(params, xb):
        W, b = params
        return jax.nn.relu(xb @ W + b)

    Ws, bs, x = pw.apply_inputs(P)
    mesh = jmesh.make_mesh({"pp": P}, devices=jax.devices()[:P])
    out = np.asarray(japply(stage, (Ws, bs), x, mesh, n_micro=n_micro))
    gW, gb, gx = jax.grad(lambda W, b, x: (japply(
        stage, (W, b), x, mesh, n_micro=n_micro) ** 2).mean(),
        argnums=(0, 1, 2))(Ws, bs, x)
    _, ranks = pipe8
    for meta, arr in ranks:
        i = meta["apply"][f"{case}/stage"]
        close(arr[f"apply/{case}/out"], out, EXACT_TOL)
        close(arr[f"apply/{case}/gW"], np.asarray(gW)[i], EXACT_TOL)
        close(arr[f"apply/{case}/gb"], np.asarray(gb)[i], EXACT_TOL)
        close(arr[f"apply/{case}/gx"], np.asarray(gx), EXACT_TOL)


def test_pipeline_train_step_against_jax(pipe8):
    """The port's step is SGD with momentum on the gradient of the loss
    summed over the batch: at ``STEP_LR`` it equals a one-device JAX loop
    (``jax.grad`` of the four stages in sequence); at ``dp * STEP_LR`` its
    weights equal the JAX ``PipelineTrainStep``'s at ``STEP_LR``, whose
    momentum buffers hold dp times the port's (ROADMAP caveat (k))."""
    import jax
    import jax.numpy as jnp

    from mxnet_tpu.parallel import spmd as jspmd

    Ws, bs, x, y = pw.step_inputs()

    def stage(params, h):
        W, b = params
        return jnp.tanh(h @ W + b)

    def loss_fn(params):
        h = x
        for i in range(4):
            h = stage((params[0][i], params[1][i]), h)
        return ((h - y) ** 2).sum()

    _, ranks = pipe8
    lr0, lr1 = pw.STEP_LRS
    params, sts = (Ws, bs), (np.zeros_like(Ws), np.zeros_like(bs))
    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
    for s in range(pw.STEP_STEPS):
        loss, g = value_and_grad(params)
        sts = tuple(0.9 * st + gi for st, gi in zip(sts, g))
        params = tuple(p - lr0 * st for p, st in zip(params, sts))
        for meta, arr in ranks:
            assert abs(meta["train_step"][f"lr{lr0}/losses"][s]
                       - float(loss)) <= EXACT_TOL * float(loss)
            for i, want in enumerate(params + sts):
                close(arr[f"train_step/lr{lr0}/step{s}/{i}"], want,
                      EXACT_TOL)
    mesh = jspmd.make_spmd_mesh(pw.STEP_MESH, jax.devices())
    step = jspmd.PipelineTrainStep(stage, mesh, n_micro=4, momentum=0.9)
    params = (Ws, bs)
    sts = step.init_states(params)
    dp = pw.STEP_MESH["dp"]
    for s in range(pw.STEP_STEPS):
        loss, params, sts = step(params, sts, x, y, pw.STEP_LR)
        for meta, arr in ranks:
            got = meta["train_step"][f"lr{lr1}/losses"][s]
            assert abs(got - float(loss)) <= EXACT_TOL * float(loss)
            for i, want in enumerate(params):
                close(arr[f"train_step/lr{lr1}/step{s}/{i}"], want,
                      EXACT_TOL)
            for i, want in enumerate(sts):
                close(dp * arr[f"train_step/lr{lr1}/step{s}/{i + 2}"],
                      want, EXACT_TOL)
    for meta, _ in ranks:
        assert meta["train_step"][f"lr{lr0}/dispatches"] == pw.STEP_STEPS


@functools.lru_cache(maxsize=None)
def jax_trainer_run(name):
    """The JAX trainer's losses and weights after LM_STEPS steps."""
    import jax

    from mxnet_tpu.parallel import mesh as jmesh
    from mxnet_tpu.parallel import pipeline_lm as jplm

    _, shape, stages = next(c for c in pw.LM_MESHES if c[0] == name)
    n = int(np.prod(list(shape.values())))
    toks, tgts = pw.lm_batch()
    tr = jplm.PipelineLMTrainer(pw.lm_init(jplm, stages), jmesh.make_mesh(
        shape, devices=jax.devices()[:n]), H, n_micro=2, lr=pw.LM_LR)
    losses = [tr.step(toks, tgts) for _ in range(pw.LM_STEPS)]
    return losses, pw.flat(tr.params)


@pytest.mark.parametrize("name", [c[0] for c in pw.LM_MESHES])
def test_pipeline_lm_matches_jax(pipe8, name):
    """The first loss against ``reference_lm_loss`` and the JAX trainer;
    every parameter's gradient (gathered) against
    ``jax.grad(reference_lm_loss)``; 3 Adam steps' losses and weights
    against the JAX trainer; every rank the same."""
    _, ranks = pipe8
    stages = next(c for c in pw.LM_MESHES if c[0] == name)[2]
    ref, ref_grads = jax_reference(stages)
    losses, weights = jax_trainer_run(name)
    meta0, _ = ranks[0]
    m = meta0[f"lm_{name}"]
    assert abs(m["loss0"] - ref) <= REF_TOL
    assert abs(m["loss0"] - losses[0]) <= FIRST_RTOL * losses[0]
    for a, b in zip(m["losses"], losses):
        assert abs(a - b) <= LOSS_RTOL * b
    for meta, arr in ranks:
        assert meta[f"lm_{name}"] == m
        for k, v in ref_grads.items():
            close(arr[f"lm_{name}/grad/{k}"], v, GRAD_TOL)
        for k, v in weights.items():
            close(arr[f"lm_{name}/params/{k}"], np.asarray(v),
                  WEIGHT_TOL / float(np.abs(np.asarray(v)).max()))


def test_pipeline_lm_remat_is_bit_identical(pipe8):
    """remat reruns each block's forward, collectives included, in the
    backward: the same kernels on the same inputs."""
    _, ranks = pipe8
    for meta, arr in ranks:
        runs = meta["remat"]
        assert runs["True"] == runs["False"]
        assert runs["True"][-1] < runs["True"][0]
        for k in pw.flat(pw.lm_init(tplm, 2, ctx=tmx.cpu())):
            np.testing.assert_array_equal(arr[f"remat/True/{k}"],
                                          arr[f"remat/False/{k}"])


def test_checkpoints_move_between_packages(pipe8):
    """The JAX package's file loads into the port and steps as JAX does,
    and the port's file into the JAX package."""
    from mxnet_tpu.parallel import mesh as jmesh
    from mxnet_tpu.parallel import pipeline_lm as jplm

    out, ranks = pipe8
    toks, tgts = pw.lm_batch()
    tr = jplm.PipelineLMTrainer(pw.lm_init(jplm, 2, seed=9), jmesh.make_mesh(
        pw.CKPT_MESH), H, n_micro=2, lr=pw.CKPT_LR)
    tr.load_states(str(out / "jax-plm.npz"))
    jl = [tr.step(toks, tgts) for _ in range(2)]
    jw = pw.flat(tr.params)
    tr.load_states(str(out / "port-plm.npz"))
    pl = [tr.step(toks, tgts) for _ in range(2)]
    for meta, arr in ranks:
        ck = meta["ckpt"]
        for a, b in zip(ck["from_jax"], jl):
            assert abs(a - b) <= LOSS_RTOL * b
        for k, v in jw.items():
            close(arr[f"ckpt/from_jax/{k}"], np.asarray(v),
                  WEIGHT_TOL / float(np.abs(np.asarray(v)).max()))
        for a, b in zip(pl, ck["unbroken"]):
            assert abs(a - b) <= LOSS_RTOL * b


def test_checkpoint_resume_and_bad_files(pipe8):
    """A save resumed by a trainer from other weights continues the
    unbroken run bit for bit; a file with a key missing, another dtype or
    other shapes raises in the JAX words and leaves the trainer as it
    was."""
    _, ranks = pipe8
    for meta, _ in ranks:
        ck = meta["ckpt"]
        assert ck["resumed"] == ck["unbroken"]
        assert ck["resumed_params_equal"]
        err = ck["errors"]
        assert err["missing"] == "checkpoint missing v['head']['w']"
        assert err["dtype"] == ("checkpoint m['blocks']['w1'] dtype float64 "
                                "!= trainer dtype float32")
        assert err["shape"] == ("checkpoint p['blocks']['b2'] shape "
                                "(2, 2, 32) != (2, 2, 16)")
        assert err["missing_untouched"] and err["dtype_untouched"] and \
            err["shape_untouched"]


@pytest.mark.parametrize("case", [c[0] for c in pw.ATTN_CASES])
def test_ring_and_ulysses_attention_match_jax(pipe8, case):
    import jax
    import jax.numpy as jnp

    from mxnet_tpu.ops.attention import sdpa_reference
    from mxnet_tpu.parallel.ring_attention import ring_attention
    from mxnet_tpu.parallel.ulysses import ulysses_attention

    _, b, h, s, d, seed, causal = next(c for c in pw.ATTN_CASES
                                       if c[0] == case)
    fn = ring_attention if case.startswith("ring") else ulysses_attention
    q, k, v = (jnp.asarray(a) for a in pw.qkv(b, h, s, d, seed))
    out = np.asarray(fn(q, k, v, causal=causal))
    ref = np.asarray(sdpa_reference(q, k, v, causal=causal))
    grads = None
    if case.endswith("grad"):
        grads = jax.grad(lambda *a: jnp.sum(fn(*a) ** 2), argnums=(0, 1, 2))(
            q, k, v)
    _, ranks = pipe8
    for _, arr in ranks:
        got = arr[f"attention/{case}/out"]
        close(got, out, EXACT_TOL)
        close(got, ref, 1e-4)
        if grads is not None:  # of the three's largest: dq is the smallest
            top = max(float(np.abs(np.asarray(g)).max()) for g in grads)
            for label, g in zip("qkv", grads):
                g = np.asarray(g)
                close(arr[f"attention/{case}/g{label}"], g,
                      EXACT_TOL * top / float(np.abs(g).max()))


def test_ulysses_rejects_indivisible_heads():
    import jax.numpy as jnp

    from mxnet_tpu.parallel.ulysses import ulysses_attention as julysses
    from mxnet_tpu_torch.parallel.ulysses import ulysses_attention

    q, k, v = pw.qkv(1, 3, 64, 16, 0)
    same_error(lambda: ulysses_attention(*(torch.from_numpy(a) for a in
                                           (q, k, v)),
                                         mesh=StandIn({"sp": 8})),
               lambda: julysses(*(jnp.asarray(a) for a in (q, k, v))))


# -- on the card --------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the pp axis on the card); run on "
                    "the GPU machine with -m gpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_pp2_trainer_and_collectives_on_card(cuda_device, tmp_path):
    """Two gloo ranks on gpu(0) (``card``): the ring shift and the
    all-to-all on CUDA tensors equal the same calls on CPU tensors; a
    ``{pp:2}`` step's loss and gradients (weights at GPT-2's init scale,
    ``gpt2_scale``) against ``reference_lm_loss`` in this process on
    gpu(0), with the flash kernels launched 8 times each a rank (2 layers x
    4 micro-batches) and no plain call."""
    rc, tail = mw.launch(tmp_path, "card", 2, timeout=300,
                         script=pw.__file__)
    assert rc == 0, tail
    ranks = mw.read(tmp_path, "card", 2)
    c = pw.CARD_LM
    toks, tgts = pw.lm_batch(c)
    params = pw.gpt2_scale(tplm.init_pipeline_lm(
        *(c[k] for k in "VDLFHS"), 2, ctx=tmx.gpu(0)), c)
    for sub in params.values():
        for v in sub.values():
            v.requires_grad_()
    loss = tplm.reference_lm_loss(params, toks, tgts, c["H"])
    loss.backward()
    loss = float(loss.detach())
    want = pw.flat({g: {k: v.grad.cpu().numpy() for k, v in s.items()}
                    for g, s in params.items()})
    for meta, arr in ranks:
        card = meta["card"]
        assert card["collectives_equal"]
        assert card["plain_calls_on_cuda"] == 0
        assert all(n == 8 for n in card["launches"].values())
        assert len(card["launches"]) == 3
        assert abs(card["loss0"] - loss) <= 1e-4 * loss
        for k, v in want.items():
            close(arr[f"card/grad/{k}"], v, GRAD_TOL)
        assert card["losses"][-1] < card["loss0"]
