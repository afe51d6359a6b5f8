"""A rank of the port's pipeline tests (``tests/test_torch_pipeline.py``),
started by the port's launcher.

    python tests/torch_pipeline_worker.py OUT_DIR [pipe8|card]

``pipe8`` (8 gloo ranks on the CPU, one thread each): the ring shift and
the all-to-all over groups of 2, 4 and 8 ranks, with their backwards;
``pipeline_apply`` on ``{pp:2}`` and ``{pp:4}``; ``PipelineTrainStep`` on
``{dp:2, pp:4}``; ``PipelineLMTrainer`` on the JAX test's 9 meshes (the
first step's loss and gradients, then 3 Adam steps); remat against no
remat; checkpoints (the JAX package's file loaded and stepped, a save
resumed by a trainer from other weights, bad files refused); ring and
Ulysses attention over ``{sp:8}``.  ``card`` (2 gloo ranks on gpu(0)): the
ring shift and the all-to-all on CUDA tensors against the same calls on
CPU tensors, and a ``{pp:2}`` ``PipelineLMTrainer`` step.

A mesh of fewer ranks than the launch's gets an outer ``rep`` axis: its
copies run the same case side by side, each over its own groups of the
mesh's size (``PipelineLMTrainer`` and ``pipeline_apply`` replicate over
axes they do not use, as the JAX functions do).  Every rank writes
``OUT_DIR/<mode>-rank<r>.npz`` and ``.json`` (``torch_mesh_worker.Out``).
Weights and inputs come from the functions below, which the tests also
call for the JAX package's side; the tests write the JAX side's checkpoint
(``jax-plm.npz``) into ``OUT_DIR`` before the launch.
"""
import os
import sys
import traceback

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_mesh_worker as mw  # noqa: E402

LM = dict(V=64, D=32, L=4, F=64, H=4, S=16)
# the card's widths: head dim 64, which the flash kernels take
CARD_LM = dict(V=128, D=256, L=4, F=512, H=4, S=64)
LM_LR, LM_STEPS, CKPT_LR = 1e-3, 3, 3e-3
# the JAX test's 9 meshes: (name, shape, stages)
LM_MESHES = [
    ("pp2", {"dp": 1, "tp": 1, "pp": 2}, 2),
    ("tp2", {"dp": 1, "tp": 2, "pp": 1}, 1),
    ("dp2", {"dp": 2, "tp": 1, "pp": 1}, 1),
    ("pp4", {"dp": 1, "tp": 1, "pp": 4}, 4),
    ("dp2tp2pp2", {"dp": 2, "tp": 2, "pp": 2}, 2),
    ("sp2", {"dp": 1, "sp": 2, "tp": 1, "pp": 1}, 1),
    ("sp4", {"dp": 1, "sp": 4, "tp": 1, "pp": 1}, 1),
    ("sp2tp2pp2", {"dp": 1, "sp": 2, "tp": 2, "pp": 2}, 2),
    ("dp2sp2pp2", {"dp": 2, "sp": 2, "tp": 1, "pp": 2}, 2),
]
CKPT_MESH = {"dp": 2, "tp": 2, "pp": 2}
APPLY_D = 8
APPLY_CASES = [("pp4_m4", 4, 4), ("pp4_m8", 4, 8), ("pp2_m4", 2, 4)]
STEP_MESH, STEP_STEPS, STEP_LR = {"dp": 2, "pp": 4}, 10, 0.001
# the JAX step at STEP_LR moves by dp times the gradient (ROADMAP caveat
# (k)): the port runs at STEP_LR and at dp * STEP_LR
STEP_LRS = (STEP_LR, 2 * STEP_LR)
# (name, b, h, s, d, seed, causal) at the shapes of tests/test_attention.py
ATTN_CASES = [
    ("ring", 1, 2, 64, 16, 0, False),
    ("ring_causal", 1, 1, 64, 16, 3, True),
    ("ring_grad", 1, 1, 32, 16, 5, False),
    ("ulysses", 2, 8, 64, 16, 7, False),
    ("ulysses_causal", 1, 8, 64, 16, 9, True),
    ("ulysses_grad", 1, 8, 32, 16, 11, False),
]
SIZE = 8


# -- shared by both packages ----------------------------------------------------


def lm_batch(c=LM):
    """The JAX test's batch: 8 x 16 tokens and their shift by one."""
    rng = np.random.RandomState(0)
    toks = rng.randint(0, c["V"], (8, c["S"]))
    return toks, np.roll(toks, -1, axis=1)


def lm_init(pkg_plm, stages, seed=0, d=None, c=LM, **kw):
    return pkg_plm.init_pipeline_lm(c["V"], d or c["D"], c["L"], c["F"],
                                    c["H"], c["S"], n_stages=stages,
                                    seed=seed, **kw)


def gpt2_scale(params, c):
    """``init_pipeline_lm``'s block weights rescaled, in place, to GPT-2's
    published init (N(0, 0.02), the residual projections 0.02 /
    sqrt(2 L)): at the card's widths the JAX package's scales saturate
    every attention row (``chip_smoke.py``'s ``gpt2_scale`` says more)."""
    import torch

    resid = 0.02 / (2 * c["L"]) ** 0.5
    scale = {"wqkv": 0.02 / (2 / 3) ** 0.5, "wo": resid / (2 / c["D"]) ** 0.5,
             "w1": 0.02 / (2 / c["D"]) ** 0.5,
             "w2": resid / (2 / c["F"]) ** 0.5}
    with torch.no_grad():
        for k, f in scale.items():
            params["blocks"][k].mul_(f)
    return params


def apply_inputs(P):
    """``tests/test_pipeline_moe.py``'s pipeline fixture at P stages."""
    rng = np.random.RandomState(0)
    Ws = (rng.randn(P, APPLY_D, APPLY_D) * 0.3).astype(np.float32)
    bs = (rng.randn(P, APPLY_D) * 0.1).astype(np.float32)
    x = rng.randn(8, APPLY_D).astype(np.float32)
    return Ws, bs, x


def step_inputs():
    """``tests/test_spmd.py``'s pipeline-train-step inputs."""
    rng = np.random.RandomState(0)
    Ws = (rng.randn(4, 12, 12) * 0.3).astype(np.float32)
    bs = np.zeros((4, 12), np.float32)
    x = rng.rand(8, 12).astype(np.float32)
    y = rng.rand(8, 12).astype(np.float32)
    return Ws, bs, x, y


def qkv(b, h, s, d, seed):
    rng = np.random.RandomState(seed)
    return tuple((rng.rand(b, h, s, d) * 0.5).astype(np.float32)
                 for _ in range(3))


def flat(tree):
    """``{"group.name": array}`` of a ``{group: {name: array}}`` tree."""
    return {f"{g}.{k}": np.asarray(v) for g, sub in tree.items()
            for k, v in sub.items()}


# -- the port's side ------------------------------------------------------------


_meshes = {}


def mesh_of(shape):
    """The mesh of ``shape`` with an outer ``rep`` axis filling the launch,
    made once (every rank makes the same meshes in the same order)."""
    from mxnet_tpu_torch.parallel import mesh as M

    n = int(np.prod(list(shape.values())))
    full = {"rep": SIZE // n, **shape} if n < SIZE else dict(shape)
    key = tuple(full.items())
    if key not in _meshes:
        _meshes[key] = M.make_mesh(full)
    return _meshes[key]


def case_collectives(mx, out, rank):
    import torch

    from mxnet_tpu_torch.parallel import mesh as M

    for n in (2, 4, 8):
        mesh = mesh_of({"sp": n})
        g = mesh.group(("sp",))
        M.reset_comm_stats()
        x = torch.arange(2 * 8 * 3 * 5, dtype=torch.float32).reshape(
            2, 8, 3, 5) + 1000.0 * g.index
        w = torch.linspace(-1.0, 1.0, x.numel()).reshape(x.shape) \
            * (g.index + 1)
        for off in (1, -1):
            xl = x.clone().requires_grad_()
            y = M.ring_shift(xl, g, off)
            (y * w).sum().backward()
            out.put("collectives", f"n{n}/shift{off}", y.detach().numpy())
            out.put("collectives", f"n{n}/shift{off}_grad", xl.grad.numpy())
        for split, concat in ((1, 2), (1, 3), (3, 1)):
            if x.shape[split] % n:
                continue
            xl = x.clone().requires_grad_()
            y = M.all_to_all(xl, g, split, concat)
            (y * torch.linspace(-1.0, 1.0, y.numel()).reshape(y.shape)
             * (g.index + 1)).sum().backward()
            out.put("collectives", f"n{n}/a2a{split}{concat}",
                    y.detach().numpy())
            out.put("collectives", f"n{n}/a2a{split}{concat}_grad",
                    xl.grad.numpy())
        out.note("collectives", f"n{n}/index", g.index)
        out.note("collectives", f"n{n}/stats", {
            k: M.comm_stats()[k] for k in ("p2p", "a2a")})


def case_apply(mx, out, rank):
    import torch

    from mxnet_tpu_torch.parallel import mesh as M
    from mxnet_tpu_torch.parallel.pipeline import pipeline_apply

    def stage(params, xb):
        W, b = params
        return torch.relu(xb @ W + b)

    for name, P, n_micro in APPLY_CASES:
        mesh = mesh_of({"pp": P})
        Ws, bs, x = (torch.from_numpy(a) for a in apply_inputs(P))
        Ws.requires_grad_()
        bs.requires_grad_()
        xg = x.clone().requires_grad_()
        y = pipeline_apply(stage, (Ws, bs), xg, mesh, n_micro=n_micro)
        (y ** 2).mean().backward()
        idx = mesh.group(("pp",)).index
        out.put("apply", f"{name}/out", y.detach().numpy())
        out.put("apply", f"{name}/gW", Ws.grad[idx].numpy())
        out.put("apply", f"{name}/gb", bs.grad[idx].numpy())
        out.put("apply", f"{name}/gx", xg.grad.numpy())
        out.note("apply", f"{name}/stage", idx)


def case_train_step(mx, out, rank):
    import torch

    from mxnet_tpu_torch import _imperative
    from mxnet_tpu_torch.parallel import mesh as M
    from mxnet_tpu_torch.parallel import spmd

    mesh = mesh_of(STEP_MESH)

    def stage_fn(params, x):
        W, b = params
        return torch.tanh(x @ W + b)

    Ws, bs, x, y = step_inputs()
    step = spmd.PipelineTrainStep(stage_fn, mesh, n_micro=4, momentum=0.9)
    for lr in STEP_LRS:
        params = (Ws, bs)
        sts = step.init_states(params)
        d0 = _imperative.dispatch_counts()["step_dispatches"]
        losses = []
        for s in range(STEP_STEPS):
            loss, params, sts = step(params, sts, x, y, lr)
            losses.append(float(loss))
            assert params[0].shape == (1, 12, 12)
            for i, p in enumerate(step.gather(params) + step.gather(sts)):
                out.put("train_step", f"lr{lr}/step{s}/{i}", p.numpy())
        out.note("train_step", f"lr{lr}/losses", losses)
        out.note("train_step", f"lr{lr}/dispatches",
                 _imperative.dispatch_counts()["step_dispatches"] - d0)


def lm_run(mx, mesh, stages, lr, steps, n_micro=2, remat=False, seed=0):
    from mxnet_tpu_torch.parallel import pipeline_lm as plm

    params = lm_init(plm, stages, seed=seed, ctx=mx.cpu())
    return plm.PipelineLMTrainer(params, mesh, n_heads=LM["H"],
                                 n_micro=n_micro, lr=lr, remat=remat)


def case_lm(mx, out, rank):
    from mxnet_tpu_torch.parallel import mesh as M

    toks, tgts = lm_batch()
    for name, shape, stages in LM_MESHES:
        mesh = mesh_of(shape)
        tr = lm_run(mx, mesh, stages, LM_LR, LM_STEPS)
        loss, grads = tr.loss_and_grads(toks, tgts)
        for k, v in flat(tr.full_tree(grads)).items():
            out.put(f"lm_{name}", f"grad/{k}", v)
        losses = [tr.step(toks, tgts) for _ in range(LM_STEPS)]
        for k, v in flat(tr.full_params()).items():
            out.put(f"lm_{name}", f"params/{k}", v)
        out.note(f"lm_{name}", "loss0", loss)
        out.note(f"lm_{name}", "losses", losses)


def case_remat(mx, out, rank):
    from mxnet_tpu_torch.parallel import mesh as M

    toks, tgts = lm_batch()
    mesh = mesh_of(CKPT_MESH)
    for remat in (False, True):
        tr = lm_run(mx, mesh, 2, CKPT_LR, 4, remat=remat)
        out.note("remat", str(remat), [tr.step(toks, tgts)
                                       for _ in range(4)])
        for k, v in flat(tr.full_params()).items():
            out.put("remat", f"{remat}/{k}", v)


def case_ckpt(mx, out, rank):
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.parallel import dist
    from mxnet_tpu_torch.parallel import mesh as M

    toks, tgts = lm_batch()
    mesh = mesh_of(CKPT_MESH)
    # the JAX package's file, loaded into a trainer from other weights
    tr = lm_run(mx, mesh, 2, CKPT_LR, 0, seed=9)
    tr.load_states(os.path.join(OUT_DIR, "jax-plm.npz"))
    out.note("ckpt", "from_jax", [tr.step(toks, tgts) for _ in range(2)])
    for k, v in flat(tr.full_params()).items():
        out.put("ckpt", f"from_jax/{k}", v)
    # a save, resumed by a trainer from other weights
    tr = lm_run(mx, mesh, 2, CKPT_LR, 0)
    out.note("ckpt", "first", [tr.step(toks, tgts) for _ in range(3)])
    path = os.path.join(OUT_DIR, "port-plm.npz")
    tr.save_states(path)
    out.note("ckpt", "unbroken", [tr.step(toks, tgts) for _ in range(2)])
    unbroken = flat(tr.full_params())
    tr2 = lm_run(mx, mesh, 2, CKPT_LR, 0, seed=9)
    tr2.load_states(path)
    out.note("ckpt", "resumed", [tr2.step(toks, tgts) for _ in range(2)])
    out.note("ckpt", "resumed_params_equal", all(
        np.array_equal(v, unbroken[k])
        for k, v in flat(tr2.full_params()).items()))
    # bad files leave the trainer as it was
    bad = {}
    with np.load(path) as z:
        good = {k: z[k] for k in z.files}
    mine = os.path.join(OUT_DIR, f"bad-rank{rank}")
    missing = dict(good)
    del missing["v['head']['w']"]
    np.savez(mine + "-missing.npz", **missing)
    wide = dict(good)
    wide["m['blocks']['w1']"] = wide["m['blocks']['w1']"].astype(np.float64)
    np.savez(mine + "-dtype.npz", **wide)
    from mxnet_tpu_torch.parallel import pipeline_lm as plm

    small = lm_run(mx, mesh, 2, CKPT_LR, 0)

    narrow = plm.PipelineLMTrainer(
        lm_init(plm, 2, d=16, ctx=mx.cpu()), mesh, n_heads=LM["H"],
        n_micro=2, lr=CKPT_LR)
    errors = {}
    for label, trainer, file in (("missing", small, mine + "-missing.npz"),
                                 ("dtype", small, mine + "-dtype.npz"),
                                 ("shape", narrow, path)):
        before = flat(trainer.full_params())
        try:
            trainer.load_states(file)
            errors[label] = None
        except MXNetError as e:
            errors[label] = str(e)
        errors[label + "_untouched"] = trainer._t == 0 and all(
            np.array_equal(v, before[k])
            for k, v in flat(trainer.full_params()).items())
    out.note("ckpt", "errors", errors)
    dist.barrier()


def case_attention(mx, out, rank):
    import torch

    from mxnet_tpu_torch.parallel import mesh as M
    from mxnet_tpu_torch.parallel.ring_attention import ring_attention
    from mxnet_tpu_torch.parallel.ulysses import ulysses_attention

    mesh = mesh_of({"sp": SIZE})
    for name, b, h, s, d, seed, causal in ATTN_CASES:
        fn = ring_attention if name.startswith("ring") else ulysses_attention
        q, k, v = (torch.from_numpy(a).requires_grad_()
                   for a in qkv(b, h, s, d, seed))
        o = fn(q, k, v, mesh=mesh, causal=causal)
        out.put("attention", f"{name}/out", o.detach().numpy())
        if name.endswith("grad"):
            (o ** 2).sum().backward()
            for label, t in (("q", q), ("k", k), ("v", v)):
                out.put("attention", f"{name}/g{label}", t.grad.numpy())


# -- on the card ----------------------------------------------------------------


def case_card(mx, out, rank):
    """Two ranks on gpu(0): the collectives on CUDA tensors against the same
    calls on CPU tensors, and a ``{pp:2}`` trainer step."""
    import torch

    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa
    from mxnet_tpu_torch.parallel import mesh as M
    from mxnet_tpu_torch.parallel import pipeline_lm as plm

    torch.cuda.set_device(0)
    mesh = M.make_mesh({"dp": 1, "tp": 1, "pp": 2}, mx.gpu(0))
    g = mesh.group(("pp",))
    x = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8) \
        + 100.0 * g.index
    same = []
    for dev in ("cuda", "cpu"):
        xs = x.to(dev)
        same.append([M.ring_shift(xs, g, 1).cpu(), M.ring_shift(xs, g, -1)
                     .cpu(), M.all_to_all(xs, g, 1, 2).cpu(),
                     M.all_to_all(xs, g, 2, 0).cpu()])
    out.note("card", "collectives_equal", all(
        torch.equal(a, b) for a, b in zip(*same)))
    toks, tgts = lm_batch(CARD_LM)
    params = gpt2_scale(lm_init(plm, 2, c=CARD_LM, ctx=mx.gpu(0)), CARD_LM)
    tr = plm.PipelineLMTrainer(params, mesh, n_heads=CARD_LM["H"],
                               n_micro=4, lr=LM_LR)
    kernels.reset_counts()
    loss, grads = tr.loss_and_grads(toks, tgts)
    out.note("card", "launches", {
        n: c.launches for n, c in kernels.KERNEL_COUNTS.items()
        if n.startswith("flash_attention")})
    out.note("card", "plain_calls_on_cuda", fa.counts.plain_calls_on_cuda)
    out.note("card", "loss0", loss)
    for k, v in flat(tr.full_tree(grads)).items():
        out.put("card", f"grad/{k}", v)
    out.note("card", "losses", [tr.step(toks, tgts) for _ in range(2)])


CASES = {"pipe8": [case_collectives, case_apply, case_train_step, case_lm,
                   case_remat, case_ckpt, case_attention],
         "card": [case_card]}
OUT_DIR = None


def main(out_dir, mode):
    global OUT_DIR
    OUT_DIR = out_dir
    import json

    import torch

    torch.set_num_threads(1)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import dist

    dist.init()
    rank = dist.rank()
    out = mw.Out()
    out.note("run", "backend", dist.backend())
    failed = None
    for case in CASES[mode]:
        try:
            case(mx, out, rank)
        except Exception:  # noqa: BLE001 - reported, then the rank fails
            failed = traceback.format_exc()
            break
    np.savez(os.path.join(out_dir, f"{mode}-rank{rank}.npz"), **out.arrays)
    with open(os.path.join(out_dir, f"{mode}-rank{rank}.json"), "w") as f:
        json.dump(out.meta, f)
    if failed:
        print(failed, file=sys.stderr)
        return 1
    dist.barrier()
    dist.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
