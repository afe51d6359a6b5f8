"""A rank of the port's mesh tests (``tests/test_torch_mesh.py`` and
``tests/test_torch_mesh_models.py``), started by the port's launcher.

    python tests/torch_mesh_worker.py OUT_DIR [four|two]

Every rank runs the ``DataParallelTrainer`` cases of its launch over
``parallel.mesh`` meshes of the launch's ranks (gloo, one thread) and
writes ``OUT_DIR/<mode>-rank<r>.npz`` (arrays, keyed ``case/what``) and
``OUT_DIR/<mode>-rank<r>.json`` (scalars and lists).  Inputs and weights
come from numpy seeds through the functions below, which the tests also
call for the JAX package's side (``pkg`` is either package); the JAX side
writes the weights of the ResNet and BERT cases and its checkpoints into
``OUT_DIR`` before the launch.

``four`` (4 ranks): the mesh rules; an MLP on ``{dp:4}`` and on
``{dcn:2, dp:2}``; ``{dp:2, tp:2}`` with ``shard_params`` and
``shard_opt_states`` under Adam and lamb, with checkpoints both ways; the
narrow ResNet on ``{dp:4}``, standard, fused, and fused with the
statistics' reduction disabled (the control); ``SyncBatchNorm``'s
``axis_name``.  ``two`` (2 ranks): ``accum_steps=2`` with BatchNorm;
``remat`` with dropout against no ``remat``; the dropout streams;
``step_many``; an async checkpoint; BERT-tiny with ZeRO; a ``{dp:2}``
trainer refusing a ``{dp:4}`` checkpoint; the supervisor's peer-death
exit.
"""
import json
import os
import sys
import traceback

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

GLOBAL_BATCH, FEAT, HIDDEN, NCLS, STEPS = 16, 12, 16, 4, 3
SGD_MOM = {"learning_rate": 0.1, "momentum": 0.9}
# the ResNet's second loss moves with fp32 rounding of the first step's
# gradients through 17 BatchNorm layers: 0.01 keeps that under 1e-6
RESNET_SGD = {"learning_rate": 0.01, "momentum": 0.9}
TP_WIDTH = (64, 32, 8)   # the {dp:2, tp:2} MLP: 64 -> 32 -> 8
RESNET_BATCH, RESNET_IMAGE = 8, 32
BERT = dict(vocab=200, units=64, hidden=128, layers=2, heads=1, seq=32,
            batch=8)


# -- shared by both packages ----------------------------------------------------


def mlp_data():
    rng = np.random.RandomState(0)
    x = rng.rand(GLOBAL_BATCH, FEAT).astype(np.float32)
    y = rng.randint(0, NCLS, GLOBAL_BATCH).astype(np.float32)
    return x, y


def mlp(pkg, dropout=0.0, width=(FEAT, HIDDEN, NCLS)):
    """``Dense(relu) [Dropout] Dense`` with explicit prefixes (checkpoints
    key by full names) and weights from numpy seed 1."""
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="mlp_")
    net.add(nn.Dense(width[1], activation="relu", in_units=width[0],
                     prefix="fc0_"))
    if dropout:
        net.add(nn.Dropout(dropout, prefix="drop_"))
        net.add(nn.Dense(width[1], activation="relu", in_units=width[1],
                         prefix="fc1_"))
    net.add(nn.Dense(width[2], in_units=width[1], prefix="out_"))
    kw = {} if pkg.__name__ == "mxnet_tpu" else {"ctx": pkg.cpu()}
    net.initialize(**kw)
    rng = np.random.RandomState(1)
    for _, p in sorted(net.collect_params().items()):
        p.set_data(pkg.nd.array(rng.randn(*p.shape).astype(np.float32)
                                * 0.3, **kw))
    return net


def tp_data():
    rng = np.random.RandomState(4)
    x = rng.rand(GLOBAL_BATCH, TP_WIDTH[0]).astype(np.float32)
    y = rng.randint(0, TP_WIDTH[2], GLOBAL_BATCH).astype(np.float32)
    return x, y


TP_OPTS = {"adam": {"learning_rate": 0.01, "wd": 1e-4},
           "lamb": {"learning_rate": 0.01, "wd": 0.01}}


def small_bn_net(pkg):
    """tests/test_torch_resnet.py's ``_small_net``: two Conv+BatchNorm
    layers."""
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="bnnet_")
    net.add(nn.Conv2D(8, 3, padding=1, use_bias=False, layout="NHWC",
                      in_channels=3, prefix="c0_"),
            nn.BatchNorm(axis=-1, in_channels=8, prefix="bn0_"),
            nn.Activation("relu"),
            nn.Conv2D(16, 3, strides=2, padding=1, use_bias=False,
                      layout="NHWC", in_channels=8, prefix="c1_"),
            nn.BatchNorm(axis=-1, in_channels=16, prefix="bn1_"),
            nn.Activation("relu"),
            nn.GlobalAvgPool2D(layout="NHWC"), nn.Flatten(),
            nn.Dense(5, in_units=16, prefix="out_"))
    kw = {} if pkg.__name__ == "mxnet_tpu" else {"ctx": pkg.cpu()}
    net.initialize(**kw)
    rng = np.random.RandomState(2)
    for k, p in sorted(net.collect_params().items()):
        if "running" in k or "gamma" in k or "beta" in k:
            continue
        p.set_data(pkg.nd.array(rng.randn(*p.shape).astype(np.float32)
                                * 0.3, **kw))
    return net


def bn_data():
    rng = np.random.RandomState(21)
    x = rng.rand(8, 8, 8, 3).astype(np.float32)
    y = rng.randint(0, 5, 8).astype(np.float32)
    return x, y


def narrow_resnet(pkg):
    nz = pkg.gluon.model_zoo.vision.resnet
    return nz.ResNetV1(nz.BottleneckV1, [1, 1, 1, 1],
                       [64, 256, 256, 256, 256], classes=10, layout="NHWC")


def resnet_data():
    """Seed 106: no ReLU input of the step-1 forward lies within 1.8e-5 of
    zero.  Where one lies within the packages' rounding of zero, its ReLU
    opens in one and not in the other, which moves every gradient below
    it by a few percent and the second loss by ~0.4% (seed 14 at 64^2
    does); tests/test_torch_resnet.py picks its seed by the same rule."""
    rng = np.random.RandomState(106)
    x = rng.rand(RESNET_BATCH, RESNET_IMAGE, RESNET_IMAGE, 3).astype(
        np.float32)
    y = rng.randint(0, 10, RESNET_BATCH).astype(np.float32)
    return x, y


def bert_block(pkg):
    """MLM + NSP over the backbone, one loss a row (the rows' mean is the
    batch's loss whatever the batch's split across ranks)."""
    class BERTRows(pkg.gluon.HybridBlock):
        def __init__(self, model, **kwargs):
            super().__init__(**kwargs)
            self.model = model

        def hybrid_forward(self, F, inputs, token_types, mlm_targets,
                           nsp_labels, mask_weight, valid_length,
                           masked_positions):
            mlm_scores, nsp_scores = self.model(inputs, token_types,
                                                valid_length,
                                                masked_positions)
            mlm_ll = F.pick(F.log_softmax(mlm_scores), mlm_targets, axis=-1)
            mlm = -F.sum(mlm_ll * mask_weight, axis=-1) / \
                mask_weight.shape[-1]
            nsp = -F.pick(F.log_softmax(nsp_scores), nsp_labels, axis=-1)
            return mlm + nsp

    b = BERT
    return BERTRows(pkg.models.BERTModel(
        b["vocab"], b["units"], b["hidden"], b["layers"], b["heads"],
        max_length=b["seq"], dropout=0.0), prefix="bertrows_")


def bert_data():
    b = BERT
    rng = np.random.RandomState(10)
    bs, seq, K = b["batch"], b["seq"], 5
    valid = rng.randint(seq // 2, seq + 1, bs)
    tokens = rng.randint(4, b["vocab"], (bs, seq))
    tokens[np.arange(seq)[None, :] >= valid[:, None]] = 0
    types = np.zeros((bs, seq), np.int32)
    types[:, seq // 2:] = 1
    positions = np.stack([rng.choice(v, K, replace=False)
                          for v in valid]).astype(np.int32)
    targets = np.take_along_axis(tokens, positions, 1)
    inputs = tokens.copy()
    np.put_along_axis(inputs, positions, 3, 1)
    return (inputs.astype(np.int32), types, targets.astype(np.int32),
            rng.randint(0, 2, (bs,)).astype(np.int32),
            np.ones((bs, K), np.float32), valid.astype(np.float32),
            positions)


def own_loss(out, y):
    return out


# -- the launch, once a test session --------------------------------------------


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(out_dir, mode, n, timeout=120, script=None):
    """Run ``n`` ranks of ``script`` (default: this one) in ``mode``
    through the port's launcher on a free port; returns ``(returncode,
    output tail)``."""
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
    for k in list(env):  # a clean env protocol: only the launcher's
        if k.startswith(("DMLC_", "MXTPU_COORDINATOR", "MXTPU_NUM_WORKER",
                         "MXTPU_WORKER_ID", "MXTPU_CONV_EPILOGUE")):
            del env[k]
    for _ in range(3):  # another process may take the free port first
        cmd = [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n",
               str(n), "--launcher", "local", "-p", str(_free_port()),
               sys.executable, script or os.path.abspath(__file__),
               str(out_dir), mode]
        proc = subprocess.run(cmd, cwd=repo, env=env, timeout=timeout,
                              capture_output=True, text=True)
        if "address already in use" not in proc.stderr.lower():
            break
    return proc.returncode, (proc.stdout + proc.stderr)[-4000:]


def shared_run(mode, n, prepare, tmp_path_factory, script=None):
    """The directory of one run of ``mode`` (of ``script``, default this
    one) for the whole test session: under pytest-xdist the first worker to
    take the lock prepares the JAX side's files (``prepare(dir)``) and
    launches; the others wait for it and read the same files.  Raises with
    the launch's output if it failed."""
    import fcntl

    worker = os.environ.get("PYTEST_XDIST_WORKER")
    root = tmp_path_factory.getbasetemp()
    if worker is not None:
        root = root.parent
    out = root / f"mesh-{mode}"
    with open(root / f"mesh-{mode}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        status = root / f"mesh-{mode}.status"
        if not status.exists():
            out.mkdir(exist_ok=True)
            try:
                prepare(out)
                rc, tail = launch(out, mode, n, script=script)
            except Exception:  # noqa: BLE001 - written, then raised below
                rc, tail = 1, traceback.format_exc()
            status.write_text(json.dumps({"rc": rc, "tail": tail}))
        got = json.loads(status.read_text())
    if got["rc"]:
        raise AssertionError(f"the {n}-rank launch failed:\n{got['tail']}")
    return out


def read(out_dir, mode, n):
    """``[(json, npz)]`` of every rank, in rank order."""
    return [(json.loads((out_dir / f"{mode}-rank{r}.json").read_text()),
             np.load(out_dir / f"{mode}-rank{r}.npz")) for r in range(n)]


# -- the port's side ------------------------------------------------------------


class Out:
    def __init__(self):
        self.arrays, self.meta = {}, {}

    def put(self, case, what, value):
        self.arrays[f"{case}/{what}"] = np.array(value, copy=True)

    def note(self, case, what, value):
        self.meta.setdefault(case, {})[what] = value


def trainer(mx, net, loss, opt, params, mesh, **kw):
    from mxnet_tpu_torch.parallel import DataParallelTrainer

    return DataParallelTrainer(net, loss, opt, dict(params), mesh=mesh, **kw)


def full_params(tr):
    """Every master gathered (a collective: every rank calls it)."""
    return [v.detach().numpy().copy() for v in tr._full_values()]


def record_steps(out, case, tr, x, y, steps=STEPS):
    losses = []
    for s in range(steps):
        losses.append(float(tr.step(x, y).asnumpy()))
        for i, v in enumerate(full_params(tr)):
            out.put(case, f"step{s}/p{i}", v)
    out.note(case, "losses", losses)
    out.note(case, "names", [n for n, _ in tr._named])
    return losses


def mesh_rules(mx, out):
    from mxnet_tpu_torch.parallel import mesh as M

    shapes = {}
    for spec in ({"dp": 4}, {"dp": 2, "tp": 2}, "dp=2,mp=2"):
        m = M.make_mesh(spec)
        shapes[str(spec)] = {"shape": m.shape, "coords": m.coords,
                             "data_index": m.data_index,
                             "data_size": m.data_size}
    try:
        M.make_mesh({"dp": 2, "tp": 3})
        shapes["bad"] = None
    except mx.base.MXNetError as e:
        shapes["bad"] = str(e)
    out.note("rules", "meshes", shapes)


def case_mlp(mx, out):
    from mxnet_tpu_torch.parallel import mesh as M

    x, y = mlp_data()
    for case, shape in (("dp4", {"dp": 4}), ("dcn", {"dcn": 2, "dp": 2})):
        tr = trainer(mx, mlp(mx), mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                     "sgd", SGD_MOM, M.make_mesh(shape))
        record_steps(out, case, tr, x, y)
        out.note(case, "eager", [tr.eager_reason is not None,
                                 tr.stats["mesh_eager_steps"]])
        if case == "dp4":
            tr.save_states(os.path.join(OUT_DIR, "port-dp4"))


def case_tp(mx, out):
    """{dp:2, tp:2}, shard_params and shard_opt_states, Adam and lamb; for
    Adam the checkpoints both ways."""
    from mxnet_tpu_torch.parallel import mesh as M

    x, y = tp_data()
    mesh = M.make_mesh({"dp": 2, "tp": 2})
    for opt, params in TP_OPTS.items():
        case = f"tp_{opt}"
        mx.random.seed(3)
        tr = trainer(mx, mlp(mx, width=TP_WIDTH),
                     mx.gluon.loss.SoftmaxCrossEntropyLoss(), opt, params,
                     mesh, shard_params=True, shard_opt_states=True)
        record_steps(out, case, tr, x, y)
        out.note(case, "param_shapes", [list(p.shape) for p in tr._params])
        out.note(case, "state_shapes", [
            None if s is None else list(s[0].shape) for s in tr._states])
        out.note(case, "state_bytes", sum(
            t.numel() * t.element_size() for s in tr._states if s
            for t in s))
        out.note(case, "unsharded_state_bytes", sum(
            2 * int(np.prod(p.shape)) * 4 for p, tr_ in
            zip(full_params(tr), tr._trainable) if tr_))
        if opt != "adam":
            continue
        for i, p in enumerate(tr._params):
            out.put(case, f"local/p{i}", p.detach().numpy())
        for i, s in enumerate(tr._states):
            for j, leaf in enumerate(s or ()):
                out.put(case, f"local/s{i}.{j}", leaf.numpy())
        tr.save_states(os.path.join(OUT_DIR, "port-tp"))
        out.note(case, "next_loss", float(tr.step(x, y).asnumpy()))
        # the JAX class's checkpoint of the same run, into a fresh trainer
        fresh = trainer(mx, mlp(mx, width=TP_WIDTH),
                        mx.gluon.loss.SoftmaxCrossEntropyLoss(), opt, params,
                        mesh, shard_params=True, shard_opt_states=True)
        fresh.build(x)
        fresh.load_states(os.path.join(OUT_DIR, "jax-tp"))
        for i, p in enumerate(fresh._params):
            out.put(case, f"loaded/p{i}", p.detach().numpy())
        for i, s in enumerate(fresh._states):
            for j, leaf in enumerate(s or ()):
                out.put(case, f"loaded/s{i}.{j}", leaf.numpy())
        out.note(case, "loaded_t", fresh._t)
        out.note(case, "loaded_next_loss", float(fresh.step(x, y).asnumpy()))


def case_resnet(mx, out):
    """The narrow ResNet on {dp:4}, 2 SGD steps: standard, fused, and fused
    with the statistics' reduction switched off (the control)."""
    import mxnet_tpu_torch.parallel.mesh as M

    weights = dict(np.load(os.path.join(OUT_DIR, "resnet-weights.npz")))
    x, y = resnet_data()
    mesh = M.make_mesh({"dp": 4})
    real = M.stats_group
    for case, fuse, control in (("resnet_std", False, False),
                                ("resnet_fused", True, False),
                                ("resnet_control", True, True)):
        os.environ["MXTPU_CONV_EPILOGUE"] = "pallas" if fuse else ""
        net = narrow_resnet(mx)
        net.initialize(ctx=mx.cpu())
        mx.load_numpy_params(net, weights)
        if control:
            M.stats_group = lambda axis_name=None: None
        try:
            M.reset_comm_stats()
            tr = trainer(mx, net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                         "sgd", RESNET_SGD, mesh)
            losses = []
            names = {id(p): k for k, p in
                     net._collect_params_with_prefix().items()}
            for s in range(2):
                losses.append(float(tr.step(x, y).asnumpy()))
                for (_, p), v in zip(tr._named, tr._params):
                    if "running" in names[id(p)]:
                        out.put(case, f"step{s}/{names[id(p)]}",
                                v.detach().numpy())
        finally:
            M.stats_group = real
        out.note(case, "losses", losses)
        out.note(case, "fused", bool(net.features[4][0]._fuse))
        out.note(case, "stats_allreduces", M.comm_stats()["stats"]["calls"])


def case_syncbn(mx, out):
    """``SyncBatchNorm(axis_name='dp')`` and ``BatchNorm(axis_name='tp')``
    on {dp:2, tp:2}: each rank its own 2 rows, in training; the output and
    the input's gradient."""
    import torch

    from mxnet_tpu_torch.parallel import mesh as M

    m = M.make_mesh({"dp": 2, "tp": 2})
    rng = np.random.RandomState(5)
    x = rng.randn(8, 3, 4, 4).astype(np.float32)
    gy = rng.randn(8, 3, 4, 4).astype(np.float32)
    rows = slice(2 * m.rank, 2 * m.rank + 2)
    for case, axis in (("syncbn_dp", "dp"), ("syncbn_tp", "tp")):
        blk = mx.gluon.contrib.nn.SyncBatchNorm(in_channels=3,
                                                axis_name=axis) \
            if axis == "dp" else mx.gluon.nn.BatchNorm(in_channels=3)
        if axis == "tp":
            blk._kwargs["axis_name"] = "tp"
        blk.initialize(ctx=mx.cpu())
        xt = torch.from_numpy(x[rows]).requires_grad_(True)
        with mx.autograd.record():
            yt = blk(xt)
        (g,) = torch.autograd.grad(yt, xt, torch.from_numpy(gy[rows]))
        out.put(case, "y", yt.detach().numpy())
        out.put(case, "dx", g.numpy())
        out.put(case, "running_mean", blk.running_mean.data().numpy())


def case_accum(mx, out):
    from mxnet_tpu_torch.parallel import mesh as M

    x, y = bn_data()
    tr = trainer(mx, small_bn_net(mx), mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                 "sgd", SGD_MOM, M.make_mesh({"dp": 2}), accum_steps=2)
    record_steps(out, "accum", tr, x, y)


def case_remat(mx, out):
    """remat against no remat, dropout 0.3, 3 steps from the same seed; and
    the dropout streams of {dp:2} and {tp:2} meshes."""
    import torch

    from mxnet_tpu_torch import random as R
    from mxnet_tpu_torch.parallel import mesh as M

    x, y = mlp_data()
    mesh = M.make_mesh({"dp": 2})
    for case, remat in (("noremat", False), ("remat", True)):
        mx.random.seed(7)
        tr = trainer(mx, mlp(mx, dropout=0.3),
                     mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd", SGD_MOM,
                     mesh, remat=remat)
        record_steps(out, case, tr, x, y)
        out.note(case, "remat_children", getattr(tr, "_remat_count", None))
    for case, shape in (("stream_dp", {"dp": 2}), ("stream_tp", {"tp": 2})):
        mx.random.seed(11)
        tr = trainer(mx, mlp(mx, dropout=0.3),
                     mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd", SGD_MOM,
                     M.make_mesh(shape))
        tr.build(x)
        mask = torch.empty(64).bernoulli_(0.7, generator=R.generator("cpu"))
        out.put(case, "mask", mask.numpy())


def case_step_many(mx, out):
    from mxnet_tpu_torch.parallel import mesh as M

    rng = np.random.RandomState(5)
    xs = rng.rand(3, GLOBAL_BATCH, FEAT).astype(np.float32)
    ys = rng.randint(0, NCLS, (3, GLOBAL_BATCH)).astype(np.float32)
    mesh = M.make_mesh({"dp": 2})
    for case in ("steps", "many"):
        tr = trainer(mx, mlp(mx), mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                     "adam", {"learning_rate": 0.01}, mesh)
        if case == "steps":
            losses = [float(tr.step(xs[i], ys[i]).asnumpy())
                      for i in range(3)]
        else:
            losses = [float(v) for v in tr.step_many(xs, ys).asnumpy()]
        out.note(case, "losses", losses)
        for i, v in enumerate(full_params(tr)):
            out.put(case, f"p{i}", v)


def case_async(mx, out):
    """3 steps, ``save_states(async_save=True)``, 3 more while it writes;
    a fresh trainer loads it and takes the same 3."""
    from mxnet_tpu_torch.parallel import mesh as M

    x, y = mlp_data()
    mesh = M.make_mesh({"dp": 2})
    prefix = os.path.join(OUT_DIR, "port-async")

    def fresh():
        return trainer(mx, mlp(mx), mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                       "adam", {"learning_rate": 0.05}, mesh,
                       shard_opt_states=True)

    t1 = fresh()
    for _ in range(3):
        t1.step(x, y)
    fut = t1.save_states(prefix, async_save=True)
    after = [float(t1.step(x, y).asnumpy()) for _ in range(3)]
    fut.result()
    t2 = fresh()
    t2.build(x)
    t2.load_states(prefix)
    out.note("async", "t", t2._t)
    out.note("async", "after", after)
    out.note("async", "resumed", [float(t2.step(x, y).asnumpy())
                                  for _ in range(3)])
    # a {dp:2} mesh refuses the JAX class's {dp:4} checkpoint
    try:
        t2.load_states(os.path.join(OUT_DIR, "jax-dp4"))
        out.note("refuse", "message", None)
    except mx.base.MXNetError as e:
        out.note("refuse", "message", str(e))


def case_bert(mx, out):
    from mxnet_tpu_torch.parallel import mesh as M

    weights = dict(np.load(os.path.join(OUT_DIR, "bert-weights.npz")))
    net = bert_block(mx)
    net.initialize(ctx=mx.cpu())
    mx.load_numpy_params(net, weights)
    batch = bert_data()
    tr = trainer(mx, net, own_loss, "adamw",
                 {"learning_rate": 1e-3, "wd": 0.01}, M.make_mesh({"dp": 2}),
                 shard_opt_states=True)
    y = np.zeros(BERT["batch"], np.float32)
    out.note("bert", "losses", [float(tr.step(batch, y).asnumpy())
                                for _ in range(STEPS)])
    out.note("bert", "zero_states", sum(
        1 for i, s in enumerate(tr._state_specs) if s))


def _card(mx):
    """This rank's card: ``gpu(rank)`` where every rank has one, else
    ``gpu(0)`` (the backend rule's gloo)."""
    import torch

    from mxnet_tpu_torch.parallel import dist

    ctx = mx.gpu(dist.rank() if torch.cuda.device_count() >= 2 else 0)
    torch.cuda.set_device(ctx.device_id)
    return ctx


def case_card_bn(mx, out):
    import torch

    from mxnet_tpu_torch.parallel import mesh as M

    ctx = _card(mx)
    m = M.make_mesh({"dp": 2})
    rng = np.random.RandomState(5)
    x = rng.randn(4, 3, 4, 4).astype(np.float32)
    gy = rng.randn(4, 3, 4, 4).astype(np.float32)
    rows = slice(2 * m.rank, 2 * m.rank + 2)
    blk = mx.gluon.contrib.nn.SyncBatchNorm(in_channels=3, axis_name="dp")
    blk.initialize(ctx=ctx)
    xt = torch.from_numpy(x[rows]).cuda().requires_grad_(True)
    M.reset_comm_stats()
    with mx.autograd.record():
        yt = blk(xt)
    (g,) = torch.autograd.grad(yt, xt, torch.from_numpy(gy[rows]).cuda())
    out.put("card_bn", "y", yt.detach().cpu().numpy())
    out.put("card_bn", "dx", g.cpu().numpy())
    out.note("card_bn", "stats_allreduces", M.comm_stats()["stats"]["calls"])


def case_card_zero(mx, out):
    from mxnet_tpu_torch.parallel import mesh as M

    ctx = _card(mx)
    mesh = M.make_mesh({"dp": 2})
    batch = bert_data()
    y = np.zeros(BERT["batch"], np.float32)
    start = None
    for case, zero in (("plain", False), ("zero", True)):
        mx.random.seed(9)
        net = bert_block(mx)
        net.initialize(init=mx.init.Normal(0.02), ctx=ctx)
        if start is None:
            with mx.autograd.pause():
                net(*[mx.nd.array(a, ctx=ctx, dtype=a.dtype) for a in batch])
            start = {k: p.data().detach().cpu().numpy().copy() for k, p in
                     net._collect_params_with_prefix().items()}
        else:
            mx.load_numpy_params(net, start)
        tr = trainer(mx, net, own_loss, "adamw",
                     {"learning_rate": 1e-3, "wd": 0.01}, mesh,
                     shard_opt_states=zero)
        out.note("card_zero", case, [float(tr.step(batch, y).asnumpy())
                                     for _ in range(STEPS)])
        for i, v in enumerate(tr._full_values()):
            out.put("card_zero", f"{case}/p{i}", v.detach().cpu().numpy())


def case_peer_death(mx, out):
    """The supervisor's non-elastic peer-death path across the ranks
    (``elastic=False`` with no restart left, as the JAX package's test of
    it runs): a ``peer_death`` fault at the third ``dist.allreduce`` on
    every rank; each rank writes its resume marker and gets
    ``ResumeRequired`` (``tests/test_torch_resilience.py``)."""
    from mxnet_tpu_torch import engine, resilience
    from mxnet_tpu_torch.parallel import dist

    marker = os.path.join(OUT_DIR, f"resume-rank{dist.rank()}.json")
    plan = resilience.FaultPlan([{"site": "dist.allreduce",
                                  "action": "peer_death", "on_hit": 3,
                                  "dead_ranks": [1]}])
    steps = []

    def train(ctx):
        for s in range(5):
            v = dist.allreduce(mx.nd.array(
                np.ones(2, np.float32) * (dist.rank() + 1), ctx=mx.cpu()))
            steps.append(float(v.asnumpy()[0]))
            ctx.step_done(s)
        return "returned"

    with resilience.armed(plan):
        try:
            got = resilience.Supervisor(on_preemption="resume",
                                        resume_marker=marker, elastic=False,
                                        max_restarts=0).run(train)
        except resilience.ResumeRequired as e:
            got = str(e)
    out.note("peer_death", "result", got)
    out.note("peer_death", "steps", steps)
    with open(marker) as f:
        out.note("peer_death", "marker", json.load(f))
    out.note("peer_death", "fired", plan.fired())
    out.note("peer_death", "hooks_noop",
             engine.fault_point is engine._fault_noop)


CASES = {"four": (mesh_rules, case_mlp, case_tp, case_resnet, case_syncbn),
         "two": (case_accum, case_remat, case_step_many, case_async,
                 case_bert, case_peer_death),
         "card_bn": (case_card_bn,), "card_zero": (case_card_zero,)}


def main(out_dir, mode):
    global OUT_DIR
    OUT_DIR = out_dir
    import torch

    torch.set_num_threads(1)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import dist

    dist.init()
    rank = dist.rank()
    out = Out()
    out.note("run", "backend", dist.backend())
    out.note("run", "size", dist.num_workers())
    failed = None
    for case in CASES[mode]:
        try:
            case(mx, out)
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
