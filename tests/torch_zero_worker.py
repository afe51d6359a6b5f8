"""A rank of the port's multi-process ZeRO tests
(``tests/test_torch_zero.py``), started by the port's launcher.

    python tests/torch_zero_worker.py OUT_DIR [zero4|zero2]

Every rank steps ``gluon.Trainer(kvstore='dist_sync',
update_on_kvstore=False, whole_step=True)`` on its own rows of the global
batch (``gluon.whole_step.WorldStep`` over gloo) and writes
``OUT_DIR/<mode>-rank<r>.npz`` and ``.json`` (``torch_mesh_worker.Out``).

``zero4`` (4 ranks) and ``zero2`` (2 ranks): the 13-unit MLP unsharded and
with ``zero_shard`` from the same weights, SGD with momentum and Adam,
``STEPS`` steps each: losses, weights after every step and the state bytes
a rank; each twice, with ``batch_size`` a rank's rows (``ROWS`` at 4 ranks)
and with it the global batch's rows (the ``*_global`` cases, the
arithmetic of one trainer over every row).  ``zero4`` also saves the sharded Adam run through
``CheckpointManager`` after ``SAVE_AT`` steps into ``OUT_DIR/ckpt`` and
goes on to ``STEPS``; ``zero2`` restores that checkpoint (copied into its
``OUT_DIR`` first) into a sharded trainer on 2 ranks and takes the
remaining steps on twice the rows a rank.

The inputs, weights and the loss come from the functions below, which the
tests also call for the other sides (``pkg`` is either package).
"""
import itertools
import os
import sys
import traceback

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

FEAT, UNITS, OUT, ROWS = 16, 13, 4, 4   # ROWS: a rank's rows at 4 ranks
STEPS, SAVE_AT = 5, 3
OPTS = {"sgd_mom": ("sgd", {"learning_rate": 0.05, "momentum": 0.9,
                            "wd": 0.01}),
        "adam": ("adam", {"learning_rate": 0.01, "wd": 0.01})}


def mlp(pkg, ctx, layers=2):
    """The JAX test's MLP (16 -> 13 -> 13 -> 4, ReLU): 13 units, so no flat
    bucket is a multiple of the world and the pad is always there; weights
    from numpy seed 0."""
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="zmlp_")
    units = FEAT
    for i in range(layers):
        net.add(nn.Dense(UNITS, in_units=units, activation="relu",
                         prefix=f"fc{i}_"))
        units = UNITS
    net.add(nn.Dense(OUT, in_units=units, prefix="out_"))
    net.initialize(ctx=ctx)
    rng = np.random.RandomState(0)
    for _, p in sorted(net.collect_params().items()):
        p.set_data(pkg.nd.array(rng.randn(*p.shape).astype(np.float32)
                                * 0.3, ctx=ctx if not isinstance(ctx, list)
                                else ctx[0]))
    return net


def data(rows=4 * ROWS):
    rng = np.random.RandomState(1)
    x = rng.rand(rows, FEAT).astype(np.float32)
    y = rng.rand(rows, OUT).astype(np.float32)
    return x, y


def port_loss(out, y):
    """Squared error on tensors or NDArrays of the port."""
    from mxnet_tpu_torch.ndarray.ndarray import as_tensor

    return (as_tensor(out) - as_tensor(y)) ** 2


def jax_loss(out, y):
    return (out - y) ** 2


def weights(net):
    """Every parameter's first copy, as numpy (copies: a CPU tensor's
    numpy aliases it)."""
    return [np.array(p.data().detach().cpu().numpy()) for _, p in
            sorted(net._collect_params_with_prefix().items())]


def _trainer(mx, net, opt, zero):
    name, args = OPTS[opt]
    return mx.gluon.Trainer(net.collect_params(), name, dict(args),
                            kvstore="dist_sync", update_on_kvstore=False,
                            whole_step=True, zero_shard=zero)


def _rows(rank, world):
    x, y = data()
    n = len(x) // world
    return x[rank * n:(rank + 1) * n], y[rank * n:(rank + 1) * n]


def _steps(out, case, tr, net, x, y, steps, after=None, batch_size=ROWS):
    losses = []
    for s in range(steps):
        losses.append(float(tr.whole_step(net, port_loss, x, y,
                                          batch_size=batch_size).asscalar()))
        for i, w in enumerate(weights(net)):
            out.put(case, f"step{s}/p{i}", w)
        if after is not None:
            after(s + 1)
    out.note(case, "losses", losses)


def case_parity(mx, out, rank, world):
    """Unsharded and sharded from the same weights, both optimizers, each
    at a rank's and at the global batch size."""
    from mxnet_tpu_torch.gluon import trainer as trainer_mod
    from mxnet_tpu_torch.parallel import mesh

    x, y = _rows(rank, world)
    for opt, zero, batch in itertools.product(OPTS, (False, True),
                                              ("", "_global")):
        case = f"{opt}_{'zero' if zero else 'full'}{batch}"
        net = mlp(mx, mx.cpu())
        tr = _trainer(mx, net, opt, zero)
        trainer_mod.reset_trainer_step_stats()
        mesh.reset_comm_stats()
        _steps(out, case, tr, net, x, y, STEPS,
               batch_size=len(data()[0]) if batch else ROWS)
        out.note(case, "state_bytes", tr.optimizer_state_bytes())
        out.note(case, "stats", trainer_mod.trainer_step_stats())
        out.note(case, "comm", mesh.comm_stats())


def case_save(mx, out, rank, world):
    """The sharded Adam run saved after SAVE_AT steps, then uninterrupted
    to STEPS."""
    from mxnet_tpu_torch.checkpoint import CheckpointManager

    x, y = _rows(rank, world)
    net = mlp(mx, mx.cpu())
    tr = _trainer(mx, net, "adam", True)
    mgr = CheckpointManager(os.path.join(OUT_DIR, "ckpt"))

    def save(step):
        if step == SAVE_AT:
            mgr.save(step, params=net, trainer=tr)
            out.note("save", "files", sorted(os.listdir(os.path.join(
                OUT_DIR, "ckpt", f"ckpt-{step:08d}"))))
    _steps(out, "save", tr, net, x, y, STEPS, after=save)


def case_restore(mx, out, rank, world):
    """The 4-rank checkpoint restored into a sharded trainer on this
    world, then the remaining steps."""
    from mxnet_tpu_torch.checkpoint import CheckpointManager

    x, y = _rows(rank, world)
    net = mlp(mx, mx.cpu())
    tr = _trainer(mx, net, "adam", True)
    meta = CheckpointManager(os.path.join(OUT_DIR, "ckpt")).restore(
        params=net, trainer=tr)
    out.note("restore", "step", meta["step"])
    _steps(out, "restore", tr, net, x, y, STEPS - SAVE_AT)
    out.note("restore", "state_bytes", tr.optimizer_state_bytes())


CASES = {"zero4": (case_parity, case_save), "zero2": (case_parity,
                                                       case_restore)}
OUT_DIR = None


def main(out_dir, mode):
    global OUT_DIR
    OUT_DIR = out_dir
    import json

    import torch

    torch.set_num_threads(1)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import dist
    from torch_mesh_worker import Out

    dist.init()
    rank, world = dist.rank(), dist.num_workers()
    out = Out()
    out.note("run", "backend", dist.backend())
    out.note("run", "size", world)
    failed = None
    for case in CASES[mode]:
        try:
            case(mx, out, rank, world)
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
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main(sys.argv[1], sys.argv[2]))
