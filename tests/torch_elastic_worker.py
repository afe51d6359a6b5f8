"""One rank of the port's elastic launch (``python -m
mxnet_tpu_torch.tools.launch -n 2 --launcher local -p PORT python
tests/torch_elastic_worker.py OUT shrink2``).

Both ranks train an MLP under ``Supervisor(elastic=True,
manager=CheckpointManager(OUT/ck))`` through ``Trainer(kvstore=
'dist_sync')``, each on its rows of the global batch, and save after step
``SAVE_AT``.  At step ``DIE_AT`` rank 1 leaves with ``os._exit`` (a real
peer death: its sockets close under rank 0).  Rank 0 classifies the
failure, the survivors' rendezvous in the checkpoint directory shrinks
the world to 1, the group re-forms, ``train_fn`` restores the checkpoint
and finishes.  Rank 0 writes ``OUT/shrink2-rank0.json`` (the losses by
step and world, the supervisor's counters, how the failure was
classified) and ``OUT/shrink2-params.npz``; rank 1 writes its record
before it leaves.  :func:`train_steps` is also the one-process
reference's loop.
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

FEAT, UNITS, OUT, BATCH = 6, 8, 3, 8
STEPS, SAVE_AT, DIE_AT = 6, 2, 4
LEAVE_CODE = 0   # the launcher ends the job when a worker exits non-zero


def mlp(mx):
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(UNITS, in_units=FEAT, activation="tanh"),
            mx.gluon.nn.Dense(OUT, in_units=UNITS))
    net.initialize(ctx=mx.cpu())
    rng = np.random.RandomState(21)
    mx.load_numpy_params(net, {
        k: rng.uniform(-0.5, 0.5, p.shape).astype(np.float32)
        for k, p in sorted(net._collect_params_with_prefix().items())})
    return net


def batch(step):
    rng = np.random.RandomState(100 + step)
    return (rng.randn(BATCH, FEAT).astype(np.float32),
            rng.randn(BATCH, OUT).astype(np.float32))


def build(mx):
    net = mlp(mx)
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 0.01},
                               kvstore="dist_sync")
    return net, trainer


def train_steps(mx, net, trainer, start, world, rank, record, ctx=None,
                before_step=None):
    """Steps ``start..STEPS`` on this rank's rows at ``world``; each
    step's loss (the mean over the rank's rows) goes to ``record``."""
    loss_fn = mx.gluon.loss.L2Loss()
    n = BATCH // world
    for step in range(start, STEPS + 1):
        if before_step is not None:
            before_step(step)
        x, y = batch(step)
        x, y = x[rank * n:(rank + 1) * n], y[rank * n:(rank + 1) * n]
        with mx.autograd.record():
            loss = loss_fn(net(mx.nd.array(x, ctx=mx.cpu())),
                           mx.nd.array(y, ctx=mx.cpu()))
        loss.backward()
        trainer.step(n)
        record.append((step, world, float(loss.asnumpy().mean())))
        if ctx is not None:
            ctx.step_done(step, save=dict(params=net, trainer=trainer,
                                          sync=True)
                          if step == SAVE_AT else None)


def params_of(net):
    return {k: p.data().detach().numpy().copy()
            for k, p in net._collect_params_with_prefix().items()}


def main(out_dir, mode):
    import torch

    torch.set_num_threads(1)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import resilience
    from mxnet_tpu_torch.parallel import dist
    from mxnet_tpu_torch.resilience import supervisor as sup_mod

    assert mode == "shrink2"
    dist.init()
    rank = dist.rank()
    classified = []
    classify = sup_mod.classify

    def recording_classify(exc):
        kind = classify(exc)
        classified.append({"kind": kind, "type": type(exc).__name__,
                           "text": str(exc)[:400], "t": time.time()})
        return kind

    sup_mod.classify = recording_classify
    record, attempts, worlds = [], [], []
    rec_path = os.path.join(out_dir, f"{mode}-rank{rank}.json")

    def leave(step):
        if rank == 1 and step == DIE_AT:
            with open(rec_path, "w") as f:
                json.dump({"rank": 1, "left_at": step, "code": LEAVE_CODE,
                           "t": time.time(), "losses": record}, f)
            os._exit(LEAVE_CODE)

    mgr = mx.checkpoint.CheckpointManager(os.path.join(out_dir, "ck"),
                                          keep_n=2)
    sup = resilience.Supervisor(mgr, on_preemption="resume", elastic=True,
                                rendezvous_timeout=4.0)

    def train(ctx):
        attempts.append(ctx.attempt)
        worlds.append(ctx.world)
        net, trainer = build(mx)
        start = 1
        if ctx.manager.latest() is not None:
            meta = ctx.manager.restore(params=net, trainer=trainer)
            start = meta["step"] + 1
        train_steps(mx, net, trainer, start, ctx.world, dist.rank(), record,
                    ctx=ctx, before_step=leave)
        return net

    net = sup.run(train)
    np.savez(os.path.join(out_dir, f"{mode}-params.npz"), **params_of(net))
    with open(rec_path, "w") as f:
        json.dump({"rank": rank, "losses": record, "attempts": attempts,
                   "worlds": worlds, "world": sup._world,
                   "resizes": sup._resizes, "dead_ranks": sup._dead_ranks,
                   "classified": classified,
                   "num_workers": dist.num_workers(),
                   "backend": dist.backend(),
                   "leases_left": os.path.isdir(os.path.join(
                       out_dir, "ck", "elastic-rendezvous", "round-0000")),
                   "stats": resilience.resilience_stats()}, f)
    dist.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
