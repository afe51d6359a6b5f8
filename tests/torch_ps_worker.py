"""One worker of the port's ``dist_async`` launches (``python -m
mxnet_tpu_torch.tools.launch -n N [-s S] python tests/torch_ps_worker.py
OUT MODE``), the JAX package's nightly scripts
(``tests/nightly/dist_async_kvstore.py``, ``dist_async_conflict.py``)
written against the port, and a Trainer run:

- ``async2`` (2 workers): a push is merged at once and a pull right after
  sees it with no barrier (a file handshake orders the workers), then the
  server-side SGD applies each push;
- ``conflict3`` (3 workers): pushes in reverse rank order with the exact
  partial merge each worker sees, a storm of unsynchronised pushes summed
  exactly, and a server-side SGD round applied exactly once a push;
- ``trainer`` (2 workers): rank 0 trains a small MLP 3 SGD steps with
  momentum through ``Trainer(kvstore='dist_async')`` and writes its
  parameters; rank 1 only initializes the keys (set-if-absent) and waits
  at the final barrier.  No synchronous all-reduce may run.

Each worker prints ``worker R/N: MODE OK`` at its end.
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

TRAIN_STEPS, TRAIN_LR, TRAIN_MOMENTUM = 3, 0.1, 0.9


def mlp(mx):
    """The trainer mode's MLP on ``cpu()``, its weights from a numpy seed."""
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(8, in_units=6, activation="tanh"),
            mx.gluon.nn.Dense(3, in_units=8))
    net.initialize(ctx=mx.cpu())
    rng = np.random.RandomState(11)
    mx.load_numpy_params(net, {
        k: rng.uniform(-0.5, 0.5, p.shape).astype(np.float32)
        for k, p in sorted(net._collect_params_with_prefix().items())})
    return net


def train_batches():
    rng = np.random.RandomState(12)
    return [(rng.randn(4, 6).astype(np.float32),
             rng.randn(4, 3).astype(np.float32)) for _ in range(TRAIN_STEPS)]


def train_mlp(mx, kvstore, steps=TRAIN_STEPS):
    """The trainer mode's loop (``steps`` of it): an L2 loss, one
    ``trainer.step(1)`` a batch (the server's optimizer keeps the
    ``rescale_grad`` it was pickled with, 1, as the JAX package's does).
    Returns the net and the trainer."""
    net = mlp(mx)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": TRAIN_LR,
                                "momentum": TRAIN_MOMENTUM},
                               kvstore=kvstore)
    loss_fn = mx.gluon.loss.L2Loss()
    for x, y in train_batches()[:steps]:
        with mx.autograd.record():
            loss = loss_fn(net(mx.nd.array(x, ctx=mx.cpu())),
                           mx.nd.array(y, ctx=mx.cpu()))
        loss.backward()
        trainer.step(1)
    return net, trainer


def _ones(mx, v=1.0):
    import torch

    return mx.nd.NDArray(torch.full((4,), float(v)), mx.cpu())


def _pull(mx, kv, key):
    out = _ones(mx, 0.0)
    kv.pull(key, out=out)
    return out.asnumpy()


def mode_async2(mx, kv, out_dir):
    rank, size = kv.rank, kv.num_workers
    assert size == 2, size
    marker = os.path.join(out_dir, "async2-marker")
    kv.init("w", _ones(mx, 0.0))
    kv.barrier()  # only to put every init before any push
    if rank == 0:
        kv.push("w", [_ones(mx)])
        # no barrier: worker 1 waits on the marker, so the server holds
        # exactly this worker's push
        got = _pull(mx, kv, "w")
        assert np.allclose(got, 1.0), got
        with open(marker, "w") as f:
            f.write("go")
    else:
        for _ in range(400):
            if os.path.exists(marker):
                break
            time.sleep(0.05)
        else:
            raise AssertionError("worker 0 never wrote the marker")
        kv.push("w", [_ones(mx, 2.0)])
        got = _pull(mx, kv, "w")
        assert np.allclose(got, 3.0), got   # worker 0's push merged
    kv.barrier()
    assert np.allclose(_pull(mx, kv, "w"), 3.0)
    # the server-side optimizer applies each push at once
    kv.set_optimizer(mx.optimizer.SGD(learning_rate=1.0))
    kv.barrier()
    kv.push("w", [_ones(mx, 0.1 * (rank + 1))])
    kv.barrier()
    got = _pull(mx, kv, "w")
    assert np.allclose(got, 2.7, atol=1e-5), got   # 3 - (0.1 + 0.2)


def mode_conflict3(mx, kv, out_dir):
    rank, size = kv.rank, kv.num_workers
    assert size == 3, size

    def marker(name):
        return os.path.join(out_dir, f"conflict-{name}")

    def wait_for(name, timeout=30.0):
        deadline = time.time() + timeout
        while not os.path.exists(marker(name)):
            if time.time() > deadline:
                raise AssertionError(f"timed out waiting for {name}")
            time.sleep(0.02)

    kv.init("w", _ones(mx, 0.0))
    kv.barrier()
    vals = {0: 1.0, 1: 2.0, 2: 4.0}
    order = [2, 0, 1]                      # deliberately not rank order
    before = sum(vals[r] for r in order[:order.index(rank)])
    if order.index(rank) > 0:
        wait_for(f"phase1_{order[order.index(rank) - 1]}")
    kv.push("w", [_ones(mx, vals[rank])])
    got = _pull(mx, kv, "w")
    assert np.allclose(got, before + vals[rank]), (rank, got)
    with open(marker(f"phase1_{rank}"), "w") as f:
        f.write("go")
    kv.barrier()
    n = 50   # an unsynchronised storm: no push lost or applied twice
    for _ in range(n):
        kv.push("w", [_ones(mx)])
    kv.barrier()
    got = _pull(mx, kv, "w")
    assert np.allclose(got, 7.0 + size * n), got
    kv.set_optimizer(mx.optimizer.SGD(learning_rate=1.0))
    kv.barrier()
    kv.push("w", [_ones(mx, 10.0 ** rank)])
    kv.barrier()
    got = _pull(mx, kv, "w")
    assert np.allclose(got, 7.0 + size * n - 111.0), got


def mode_trainer(mx, kv, out_dir):
    from mxnet_tpu_torch.parallel import dist

    calls = []
    allreduce = dist.allreduce
    dist.allreduce = lambda v: calls.append(1) or allreduce(v)
    try:
        if dist.rank() == 0:
            net, trainer = train_mlp(mx, "dist_async")
            assert trainer._kvstore._is_async()
            np.savez(os.path.join(out_dir, "trainer-rank0.npz"), **{
                k: p.data().detach().numpy().copy() for k, p in
                net._collect_params_with_prefix().items()})
        else:
            net, trainer = train_mlp(mx, "dist_async", steps=0)
            trainer._init_kvstore()    # the keys, set-if-absent
    finally:
        dist.allreduce = allreduce
    assert not calls, f"{len(calls)} synchronous all-reduces ran"


def main(out_dir, mode):
    import torch

    torch.set_num_threads(1)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import dist

    kv = mx.kv.create("dist_async")
    assert kv._is_async()
    {"async2": mode_async2, "conflict3": mode_conflict3,
     "trainer": mode_trainer}[mode](mx, kv, out_dir)
    kv.barrier()
    print(f"worker {dist.rank()}/{dist.num_workers()}: {mode} OK",
          flush=True)
    if dist.rank() == 0:
        kv._ps_client().stop_server()
    dist.barrier()
    dist.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
