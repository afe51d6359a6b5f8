"""A worker of the port's multi-process tests (``tests/test_torch_dist.py``),
started by a launcher with the env protocol of ``parallel.dist.init``.

    python tests/torch_dist_worker.py OUT_DIR [collectives|train|card]

``collectives``: ``dist.allreduce``, ``allgather_bytes`` and ``barrier``
checked on every rank.  ``train``: also the nightly's loop
(``tests/nightly/dist_gluon_trainer.py``: global batch 16, 12 features, 4
classes, 6 SGD steps, each rank on its half) through
``gluon.Trainer(kvstore='dist_sync')``, with ``update_on_kvstore`` True
and False; every rank writes its parameters after every step to
``OUT_DIR/rank<r>.npz``.  ``card``: the loop once (``update_on_kvstore``
True) with rank ``r`` on ``gpu(r)`` where there are 2 or more cards, else
both on ``gpu(0)``.  :func:`train` is also the single-process run
the test holds them to, over ``cpu(0)`` and ``cpu(1)``.
"""
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch.parallel import dist  # noqa: E402

GLOBAL_BATCH, FEAT, HIDDEN, NCLS, STEPS = 16, 12, 16, 4, 6


def data():
    rng = np.random.RandomState(0)
    x = rng.rand(GLOBAL_BATCH, FEAT).astype(np.float32)
    y = rng.randint(0, NCLS, GLOBAL_BATCH).astype(np.float32)
    return x, y


def weights():
    rng = np.random.RandomState(1)
    return {"0.weight": rng.randn(HIDDEN, FEAT).astype(np.float32) * 0.3,
            "0.bias": rng.randn(HIDDEN).astype(np.float32) * 0.1,
            "1.weight": rng.randn(NCLS, HIDDEN).astype(np.float32) * 0.3,
            "1.bias": rng.randn(NCLS).astype(np.float32) * 0.1}


def train(kvstore, ctxs, halves, update_on_kvstore):
    """The nightly's loop: each context of ``ctxs`` takes its slice of
    ``halves`` of the global batch; returns the global mean loss and the
    parameters (of the first context) after every step."""
    x, y = data()
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(HIDDEN, activation="relu", in_units=FEAT),
            mx.gluon.nn.Dense(NCLS, in_units=HIDDEN))
    net.initialize(ctx=ctxs)
    params = net._collect_params_with_prefix()
    for k, v in weights().items():
        params[k].set_data(v)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9},
                               kvstore=kvstore,
                               update_on_kvstore=update_on_kvstore)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    losses, after = [], []
    for _ in range(STEPS):
        with mx.autograd.record():
            ls = [loss_fn(net(mx.nd.array(x[h], ctx=c)),
                          mx.nd.array(y[h], ctx=c))
                  for c, h in zip(ctxs, halves)]
        mx.autograd.backward(ls)
        trainer.step(GLOBAL_BATCH)
        local = np.float32(sum(float(l.asnumpy().sum()) for l in ls))
        total = dist.allreduce(mx.nd.array(np.array([local]),
                                           ctx=mx.cpu()))
        losses.append(float(total.asnumpy()[0]) / GLOBAL_BATCH)
        after.append({k: p.data().detach().cpu().numpy().copy()
                      for k, p in params.items()})
    return losses, after


def check_collectives(rank, size):
    x = mx.nd.array(np.arange(5, dtype=np.float32) + rank, ctx=mx.cpu(1))
    total = dist.allreduce(x)
    want = sum(np.arange(5, dtype=np.float32) + r for r in range(size))
    assert np.array_equal(total.asnumpy(), want), total.asnumpy()
    assert total.context == mx.cpu(1)
    payloads = dist.allgather_bytes(b"rank-%d" % rank * (rank + 1))
    assert payloads == [b"rank-%d" % r * (r + 1) for r in range(size)]
    dist.barrier()


def main():
    out_dir, mode = sys.argv[1], sys.argv[2]
    dist.init()
    rank, size = dist.rank(), dist.num_workers()
    assert size == 2, f"expected 2 workers, got {size}"
    check_collectives(rank, size)
    result = {"rank": rank, "size": size, "backend": dist.backend()}
    half = slice(rank * 8, rank * 8 + 8)
    if mode in ("train", "card"):
        arrays = {}
        ctx = mx.cpu()
        if mode == "card":
            import torch

            ctx = mx.gpu(rank if torch.cuda.device_count() >= 2 else 0)
        for uok in ((True, False) if mode == "train" else (True,)):
            losses, after = train("dist_sync", [ctx], [half], uok)
            result[f"losses_uok{int(uok)}"] = losses
            for s, ps in enumerate(after):
                for k, v in ps.items():
                    arrays[f"uok{int(uok)}/{s}/{k}"] = v
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    dist.barrier()
    dist.shutdown()


if __name__ == "__main__":
    main()
