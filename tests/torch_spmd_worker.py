"""A rank of the port's mesh-Trainer tests (``tests/test_torch_spmd.py``),
started by the port's launcher.

    python tests/torch_spmd_worker.py OUT_DIR [spmd4|spmd2|cardsplits]

Every rank runs the cases of its launch through ``gluon.Trainer(...,
mesh_shape=...)`` (gloo, one thread a rank) on the global batch, and
writes ``OUT_DIR/<mode>-rank<r>.npz`` and ``.json``
(``torch_mesh_worker.Out``).  Weights, inputs and losses come from the
functions below, which the tests also call for the JAX package's side
(``pkg`` is either package); the tests write the JAX side's files into
``OUT_DIR`` before the launch.

``spmd4`` (4 ranks): the JAX test's MLP at ``dp=2,mp=2`` with ZeRO (5
steps, then 4 steps of a decaying learning rate) and at ``dp=4``;
BERT-tiny (a loss a row) at ``dp=2,mp=2`` with ZeRO; a 2-conv + BatchNorm
+ Dense net at ``dp=2,mp=2``; a batch ``dp=4`` does not divide (the
fallback); an Adam MLP at ``dp=2,mp=2`` with ZeRO saved after
``SAVE_AT`` steps (``states_dict``, ``save_parameters`` and a
``CheckpointManager`` directory) and stepped once more; the JAX package's
blob of ``dp=4,mp=2`` loaded at ``dp=2,mp=2``; a deferred-init MLP whose
ranks seed differently, at ``dp=2,mp=2`` and ``dp=4``.  ``spmd2`` (2
ranks): the split products against full copies (column and row,
``FullyConnected`` with and without ``flatten``, ``multihead_attention``'s
projections); the MLP at ``mp=2`` with two ``*out_proj*`` weights (the
row split); BERT-tiny at ``mp=2``; ``spmd4``'s save restored at
``dp=1,mp=2`` (a blob and the directory) and stepped, beside a trainer
given the same blob, then saved again; a dropout MLP at ``dp=2`` saved,
resumed and continued.  ``cardsplits`` (2 ranks on the card): the split
products on CUDA tensors.
"""
import os
import pickle
import sys
import traceback

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_mesh_worker as mw  # noqa: E402

STEPS, SAVE_AT, DECAY_STEPS = 5, 3, 4
SGD_MOM = ("sgd", {"learning_rate": 0.05, "momentum": 0.9})
ADAM = ("adam", {"learning_rate": 0.01, "wd": 0.01})
BERT_ADAM = ("adam", {"learning_rate": 1e-3})
BN_SGD = ("sgd", {"learning_rate": 0.05, "momentum": 0.9})
OUT_DIR = None


# -- shared by both packages ----------------------------------------------------


def mlp_data():
    """The JAX test's batch (tests/test_spmd.py: 8 x 16, 8 x 4)."""
    x = np.random.RandomState(3).rand(8, 16).astype(np.float32)
    y = np.random.RandomState(4).rand(8, 4).astype(np.float32)
    return x, y


def mlp(pkg, ctx, row=False):
    """The JAX test's MLP (16 -> 16 tanh -> 16 tanh -> 4); with ``row`` its
    second and third layers are named ``out_proj*``, so the plan splits
    their weights by rows.  Weights from numpy seed 0."""
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="smlp_")
    layers = (("fc0_", 16, "tanh"),
              ("out_proj0_" if row else "fc1_", 16, "tanh"),
              ("out_proj1_" if row else "out_", 4, None))
    for prefix, units, act in layers:
        net.add(nn.Dense(units, in_units=16, activation=act, prefix=prefix))
    net.initialize(ctx=ctx)
    rng = np.random.RandomState(0)
    for _, p in sorted(net.collect_params().items()):
        p.set_data(pkg.nd.array(rng.randn(*p.shape).astype(np.float32)
                                * 0.3, ctx=ctx))
    return net


def sq_loss(out, y):
    """Squared error on the port's tensors or NDArrays."""
    from mxnet_tpu_torch.ndarray.ndarray import as_tensor

    return (as_tensor(out) - as_tensor(y)) ** 2


def jax_sq_loss(out, y):
    return (out - y) ** 2


def row_loss(out):
    """The block's output is a loss a row."""
    return out


def ce_loss(out, y):
    """Softmax cross-entropy a row, on the port's tensors."""
    import torch

    from mxnet_tpu_torch.ndarray.ndarray import as_tensor

    logp = torch.log_softmax(as_tensor(out), dim=-1)
    return -logp.gather(-1, as_tensor(y).long().reshape(-1, 1))


def jax_ce_loss(out, y):
    import mxnet_tpu as jmx

    return -jmx.nd.pick(jmx.nd.log_softmax(out), y, axis=-1)


def weights(net):
    """Every parameter, full, as numpy in sorted-name order (a collective
    on a mesh: every rank reads)."""
    out = []
    for _, p in sorted(net._collect_params_with_prefix().items()):
        v = p.data()
        out.append(np.array(v.asnumpy() if hasattr(v, "asnumpy")
                            else v.detach().cpu().numpy()))
    return out


def states_arrays(blob):
    """The state leaves of a ``states_dict()`` blob, in order."""
    out = []
    for i in sorted(blob["states"]):
        for st in blob["states"][i].values():
            for leaf in (st if isinstance(st, (tuple, list)) else (st,)):
                out.append(np.asarray(leaf.asnumpy() if hasattr(
                    leaf, "asnumpy") else leaf))
    return out


def trainer(mx, net, opt, shape, zero=False, **kw):
    name, args = opt
    return mx.gluon.Trainer(net.collect_params(), name, dict(args),
                            mesh_shape=shape, zero_shard=zero, **kw)


def bert_net(mx, weights_npz):
    net = mw.bert_block(mx)
    net.initialize(ctx=mx.cpu())
    mx.load_numpy_params(net, dict(np.load(weights_npz)))
    return net


# -- the port's cases -----------------------------------------------------------


def _steps(out, case, tr, net, x, y=None, loss=sq_loss, steps=STEPS,
           every=True):
    """``steps`` whole steps; the losses, the weights after every step (or
    the last), and the collectives of the steps alone (before the reads
    of the last weights, which gather)."""
    from mxnet_tpu_torch.parallel import mesh as mesh_mod

    losses = []
    for s in range(steps):
        losses.append(float(tr.whole_step(net, loss, x, y).asscalar()))
        if s == steps - 1:
            out.note(case, "comm_steps", mesh_mod.comm_stats())
        if every or s == steps - 1:
            for i, w in enumerate(weights(net)):
                out.put(case, f"step{s}/p{i}", w)
    out.note(case, "losses", losses)


def _record(out, case, tr, net):
    from mxnet_tpu_torch import optimizer as O
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.gluon import trainer as trainer_mod
    from mxnet_tpu_torch.parallel import mesh as mesh_mod
    from mxnet_tpu_torch.parallel.spmd import products

    comp = tr._whole_step_compiler
    out.note(case, "stats", trainer_mod.trainer_step_stats())
    out.note(case, "comm", mesh_mod.comm_stats())
    out.note(case, "splits", products.split_counts())
    out.note(case, "compiler", dict(comp.stats))
    out.note(case, "gathered", list(comp.gathered))
    shapes = {n: p.shape for n, p in net.collect_params().items()}
    out.note(case, "gathered_bytes", sum(
        4 * int(np.prod(shapes[n])) for n in comp.gathered))
    out.note(case, "state_bytes", comp.state_bytes_per_device())
    out.note(case, "param_bytes", comp.param_bytes_per_device(net))
    if any(p._placement is not None for p in tr._params):
        try:  # the eager step cannot reach sharded parameters
            tr.step(1)
        except MXNetError as e:
            out.note(case, "eager_step", str(e))
    out.note(case, "full_state_bytes", sum(
        int(np.prod(p.shape)) * 4 * len(O._state_list(st))
        for p, st in zip(tr._params, tr._states)))


def _reset():
    from mxnet_tpu_torch.gluon import trainer as trainer_mod
    from mxnet_tpu_torch.parallel import mesh as mesh_mod
    from mxnet_tpu_torch.parallel.spmd import products

    trainer_mod.reset_trainer_step_stats()
    mesh_mod.reset_comm_stats()
    products.reset_split_counts()


def case_mlp_zero(mx, out, rank):
    x, y = mlp_data()
    net = mlp(mx, mx.cpu())
    tr = trainer(mx, net, SGD_MOM, "dp=2,mp=2", zero=True)
    _reset()
    _steps(out, "mlp_zero", tr, net, x, y)
    _record(out, "mlp_zero", tr, net)
    for i in range(DECAY_STEPS):  # a schedule: nothing placed again
        tr.set_learning_rate(0.05 * (0.9 ** i))
        tr.whole_step(net, sq_loss, x, y)
    out.note("mlp_zero", "after_decay", dict(tr._whole_step_compiler.stats))


def case_mlp_dp4(mx, out, rank):
    x, y = mlp_data()
    net = mlp(mx, mx.cpu())
    tr = trainer(mx, net, SGD_MOM, "dp=4")
    _reset()
    _steps(out, "mlp_dp4", tr, net, x, y)
    _record(out, "mlp_dp4", tr, net)


def case_bert(mx, out, shape, zero, case):
    net = bert_net(mx, os.path.join(OUT_DIR, "bert-weights.npz"))
    tr = trainer(mx, net, BERT_ADAM, shape, zero=zero)
    _reset()
    _steps(out, case, tr, net, mw.bert_data(), loss=row_loss, steps=3,
           every=False)
    _record(out, case, tr, net)


def case_convbn(mx, out, rank):
    x, y = mw.bn_data()
    net = mw.small_bn_net(mx)
    tr = trainer(mx, net, BN_SGD, "dp=2,mp=2")
    _reset()
    _steps(out, "convbn", tr, net, x, y, loss=ce_loss, steps=3,
           every=False)
    _record(out, "convbn", tr, net)


def case_bypass(mx, out, rank):
    x, y = mlp_data()
    net = mlp(mx, mx.cpu())
    tr = trainer(mx, net, SGD_MOM, "dp=4")
    _reset()
    _steps(out, "bypass", tr, net, x[:6], y[:6], steps=2)
    _record(out, "bypass", tr, net)
    out.note("bypass", "warned", sorted(tr._whole_step_compiler._warned))


def case_save(mx, out, rank):
    from mxnet_tpu_torch.checkpoint import CheckpointManager

    x, y = mlp_data()
    net = mlp(mx, mx.cpu())
    tr = trainer(mx, net, ADAM, "dp=2,mp=2", zero=True)
    _steps(out, "save", tr, net, x, y, steps=SAVE_AT, every=False)
    blob = tr.states_dict()
    net.save_parameters(os.path.join(OUT_DIR, f"save-r{rank}.params"))
    if rank == 0:
        with open(os.path.join(OUT_DIR, "save-blob.pkl"), "wb") as f:
            pickle.dump(blob, f)
    for i, a in enumerate(states_arrays(blob)):
        out.put("save", f"state{i}", a)
    CheckpointManager(os.path.join(OUT_DIR, "ckpt")).save(
        SAVE_AT, params=net, trainer=tr)
    out.note("save", "mesh_shape", blob["mesh_shape"])
    out.note("save", "files", sorted(os.listdir(os.path.join(
        OUT_DIR, "ckpt", f"ckpt-{SAVE_AT:08d}"))))
    _steps(out, "save_next", tr, net, x, y, steps=1)


def case_unseeded(mx, out, rank, shape):
    """A deferred-init MLP (no ``in_units``, gluon's default initializer)
    whose ranks seed their generators differently: the mesh step takes
    rank 0's weights, so every rank holds the same ones."""
    mx.random.seed(100 + rank)
    nn = mx.gluon.nn
    net = nn.HybridSequential(prefix="umlp_")
    for units, act in ((16, "tanh"), (16, "tanh"), (4, None)):
        net.add(nn.Dense(units, activation=act))
    net.initialize(ctx=mx.cpu())
    x, y = mlp_data()
    case = "unseeded_" + shape.replace("=", "").replace(",", "")
    _steps(out, case, trainer(mx, net, SGD_MOM, shape), net, x, y, steps=3)


def dropout_mlp(mx):
    """16 -> 16 tanh -> dropout 0.5 -> 4, weights from numpy seed 0."""
    nn = mx.gluon.nn
    net = nn.HybridSequential(prefix="dmlp_")
    net.add(nn.Dense(16, in_units=16, activation="tanh"), nn.Dropout(0.5),
            nn.Dense(4, in_units=16))
    net.initialize(ctx=mx.cpu())
    rng = np.random.RandomState(0)
    for _, p in sorted(net.collect_params().items()):
        p.set_data(mx.nd.array(rng.randn(*p.shape).astype(np.float32)
                               * 0.3, ctx=mx.cpu()))
    return net


def case_dropout_resume(mx, out, rank):
    """Dropout at dp=2: 2 steps, a CheckpointManager save, 2 more; then a
    fresh net and trainer restored from the save (each rank its own
    dropout stream) and stepped twice; and the same without the
    generators (``restore_rng=False``)."""
    from mxnet_tpu_torch.checkpoint import CheckpointManager

    x, y = mlp_data()
    d = os.path.join(OUT_DIR, "ckpt-dropout")
    for label in ("run", "resumed", "no_rng"):
        mx.random.seed(11)
        net = dropout_mlp(mx)
        tr = trainer(mx, net, ADAM, "dp=2")
        if label == "run":
            _steps(out, "dropout_run_head", tr, net, x, y, steps=2,
                   every=False)
            CheckpointManager(d).save(2, params=net, trainer=tr)
        else:
            CheckpointManager(d).restore(params=net, trainer=tr,
                                         restore_rng=label == "resumed")
        _steps(out, f"dropout_{label}", tr, net, x, y, steps=2)
    out.note("dropout", "files", sorted(os.listdir(os.path.join(
        d, "ckpt-00000002"))))


def case_xpkg(mx, out, rank):
    """The JAX package's dp=4,mp=2 blob and weights at dp=2,mp=2."""
    x, y = mlp_data()
    net = mlp(mx, mx.cpu())
    tr = trainer(mx, net, ADAM, "dp=2,mp=2", zero=True)
    jw = np.load(os.path.join(OUT_DIR, "jax-params.npz"))
    for k, p in sorted(net.collect_params().items()):
        p.set_data(jw[k])
    with open(os.path.join(OUT_DIR, "jax-blob.pkl"), "rb") as f:
        tr.load_states_dict(pickle.load(f))
    for i, a in enumerate(states_arrays(tr.states_dict())):
        out.put("xpkg", f"loaded/state{i}", a)
    tr.whole_step(net, sq_loss, x, y)  # placed, then stepped
    for i, a in enumerate(states_arrays(tr.states_dict())):
        out.put("xpkg", f"state{i}", a)
    for i, w in enumerate(weights(net)):
        out.put("xpkg", f"p{i}", w)


def split_inputs():
    """The split-product cases: ``(name, kind, x, w, b)`` with numpy
    inputs (seed 7)."""
    rng = np.random.RandomState(7)

    def r(*s):
        return (rng.randn(*s) * 0.5).astype(np.float32)

    return [("fc_col_flat", "column", r(4, 3, 8), r(6, 24), r(6)),
            ("fc_col", "column", r(4, 3, 8), r(6, 8), r(6)),
            ("fc_row_flat", "row", r(4, 3, 8), r(6, 24), r(6)),
            ("fc_row", "row", r(4, 3, 8), r(6, 8), r(6))]


def mha_inputs():
    """``multihead_attention``'s cases: x (2, 8, 16), 2 heads, the packed
    in-projection (48, 16) and the out-projection (16, 16); the output
    gradient; and a memory (2, 6, 16) that cross-attention reads as key
    and value (seed 8)."""
    rng = np.random.RandomState(8)

    def r(*s):
        return (rng.randn(*s) * 0.3).astype(np.float32)

    return (r(2, 8, 16), r(48, 16), r(48), r(16, 16), r(16), r(2, 8, 16),
            r(2, 6, 16))


#: the attention cases: ``(out-projection split, cross-attention)``
MHA_CASES = {"mha_column": ("column", False), "mha_row": ("row", False),
             "mha_cross": ("column", True)}


def split_grads(mx, mesh, device, out_kind, x, w, b, flatten, gy=None):
    """One split ``FullyConnected`` on this rank's shards: the output, and
    the gradients of ``sum(out * gy)`` for x and the full w and b."""
    import torch

    from mxnet_tpu_torch.ops.nn import _k_fully_connected
    from mxnet_tpu_torch.parallel.spmd import products

    spec = ("mp", None) if out_kind == "column" else (None, "mp")
    from mxnet_tpu_torch.parallel import mesh as M

    xt = torch.tensor(x, device=device, requires_grad=True)
    ws = torch.tensor(w[M.shard_slices(spec, w.shape, mesh)], device=device,
                      requires_grad=True)
    bs = torch.tensor(b[M.shard_slices(("mp",), b.shape, mesh)],
                      device=device, requires_grad=True)
    entries = [products.Entry("w", object(), ws, spec, w.shape),
               products.Entry("b", object(), bs, ("mp",), b.shape)]
    with products.split_scope(products.SplitScope(mesh, entries)):
        y = _k_fully_connected(xt, ws, bs, flatten=flatten)
        if gy is None:
            gy = np.random.RandomState(9).randn(*y.shape).astype(np.float32)
        gx, gw, gb = torch.autograd.grad(
            (y * torch.tensor(gy, device=device)).sum(), [xt, ws, bs])
    full_w = products.gather_full(gw, spec, w.shape, mesh)
    full_b = products.gather_full(gb, ("mp",), b.shape, mesh)
    return [t.detach().cpu().numpy() for t in (y, gx, full_w, full_b)]


def mha_grads(mx, mesh, device, case):
    """``multihead_attention`` (self-attention, or cross-attention on the
    memory) with its in-projection split by columns and its
    out-projection as ``MHA_CASES[case]`` says: the output, the gradients
    of x (and of the memory) and of the full weights and biases."""
    import torch

    from mxnet_tpu_torch.ops.attention import _k_multihead_attention
    from mxnet_tpu_torch.parallel import mesh as M
    from mxnet_tpu_torch.parallel.spmd import products

    out_kind, cross = MHA_CASES[case]
    x, wi, bi, wo, bo, gy, mem = mha_inputs()
    ospec = ("mp", None) if out_kind == "column" else (None, "mp")
    specs = [("mp", None), ("mp",), ospec, ("mp",)]
    full = [wi, bi, wo, bo]
    xt = torch.tensor(x, device=device, requires_grad=True)
    kv = torch.tensor(mem, device=device, requires_grad=True) if cross \
        else xt
    shards = [torch.tensor(a[M.shard_slices(s, a.shape, mesh)],
                           device=device, requires_grad=True)
              for a, s in zip(full, specs)]
    entries = [products.Entry(str(i), object(), t, s, a.shape)
               for i, (t, s, a) in enumerate(zip(shards, specs, full))]
    inputs = [xt, kv] if cross else [xt]
    with products.split_scope(products.SplitScope(mesh, entries)):
        y = _k_multihead_attention(xt, kv, kv, *shards, num_heads=2)
        grads = torch.autograd.grad(
            (y * torch.tensor(gy, device=device)).sum(), inputs + shards)
    n = len(inputs)
    outs = [y] + list(grads[:n]) + [
        products.gather_full(g, s, a.shape, mesh)
        for g, s, a in zip(grads[n:], specs, full)]
    return [t.detach().cpu().numpy() for t in outs]


def case_splits(mx, out, rank, device="cpu"):
    from mxnet_tpu_torch.parallel import mesh as M
    from mxnet_tpu_torch.parallel.spmd import products

    mesh = M.make_mesh("mp=2")
    products.reset_split_counts()
    M.reset_comm_stats()
    for name, kind, x, w, b in split_inputs():
        for j, a in enumerate(split_grads(mx, mesh, device, kind, x, w, b,
                                          flatten=name.endswith("flat"))):
            out.put("splits", f"{name}/{j}", a)
    for case in MHA_CASES:
        for j, a in enumerate(mha_grads(mx, mesh, device, case)):
            out.put("splits", f"{case}/{j}", a)
    out.note("splits", "counts", products.split_counts())
    out.note("splits", "comm", M.comm_stats())


def case_mlp_row(mx, out, rank):
    x, y = mlp_data()
    net = mlp(mx, mx.cpu(), row=True)
    tr = trainer(mx, net, SGD_MOM, "mp=2")
    _reset()
    _steps(out, "mlp_row", tr, net, x, y)
    _record(out, "mlp_row", tr, net)
    out.note("mlp_row", "specs", {
        n: list(s[0]) for (n, _), s in tr._whole_step_compiler._specs
        .items()})


def case_restore(mx, out, rank):
    """spmd4's save at dp=1,mp=2: the blob and its parameters; the
    directory; one step each, beside a trainer given the same blob; then
    a save of this shape for the one-process restore."""
    from mxnet_tpu_torch.checkpoint import CheckpointManager

    x, y = mlp_data()
    with open(os.path.join(OUT_DIR, "save-blob.pkl"), "rb") as f:
        blob = pickle.load(f)
    runs = {}
    for label in ("blob", "ref", "dir"):
        net = mlp(mx, mx.cpu())
        tr = trainer(mx, net, ADAM, "dp=1,mp=2", zero=True)
        if label == "dir":
            meta = CheckpointManager(os.path.join(OUT_DIR, "ckpt")).restore(
                params=net, trainer=tr)
            out.note("restore", "dir_step", meta["step"])
        else:
            net.load_parameters(os.path.join(OUT_DIR, "save-r0.params"))
            tr.load_states_dict(pickle.loads(pickle.dumps(blob)))
        for i, w in enumerate(weights(net)):
            out.put(f"restore_{label}", f"loaded/p{i}", w)
        for i, a in enumerate(states_arrays(tr.states_dict())):
            out.put(f"restore_{label}", f"loaded/state{i}", a)
        _steps(out, f"restore_{label}", tr, net, x, y, steps=1)
        runs[label] = (net, tr)
    net, tr = runs["blob"]
    CheckpointManager(os.path.join(OUT_DIR, "ckpt2")).save(
        SAVE_AT + 1, params=net, trainer=tr)
    for i, a in enumerate(states_arrays(tr.states_dict())):
        out.put("restore_blob", f"saved/state{i}", a)


def case_cardsplits(mx, out, rank):
    import torch

    torch.cuda.set_device(rank % torch.cuda.device_count())
    case_splits(mx, out, rank, device="cuda")


CASES = {
    "spmd4": (case_mlp_zero, case_mlp_dp4,
              lambda mx, out, r: case_bert(mx, out, "dp=2,mp=2", True,
                                           "bert_zero"),
              case_convbn, case_bypass, case_save, case_xpkg,
              lambda mx, out, r: case_unseeded(mx, out, r, "dp=2,mp=2"),
              lambda mx, out, r: case_unseeded(mx, out, r, "dp=4")),
    "spmd2": (case_splits, case_mlp_row,
              lambda mx, out, r: case_bert(mx, out, "mp=2", False,
                                           "bert_mp2"),
              case_restore, case_dropout_resume),
    "cardsplits": (case_cardsplits,),
}


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
    out.note("run", "size", dist.num_workers())
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
