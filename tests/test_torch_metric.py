"""``metric`` of the PyTorch port against the JAX package: every
registered metric, ``CompositeEvalMetric``, ``CustomMetric``/``np_metric``
and ``create``, updated with the same numpy labels and predictions (as
NDArrays of each package and as torch tensors), ``get()`` equal.  Both
packages compute on the host in numpy, so values are equal to the last
bit."""
import pickle
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

CPU = tmx.cpu()


def _jmx():
    import mxnet_tpu as jmx

    return jmx


def _inputs(name, seed):
    rng = np.random.RandomState(seed)
    n, c = 16, 5
    if name in ("f1", "mcc"):
        labels = rng.randint(0, 2, n).astype(np.float32)
        preds = rng.rand(n, 2).astype(np.float32)
    elif name in ("mae", "mse", "rmse", "pearsonr"):
        labels = rng.rand(n).astype(np.float32)
        preds = rng.rand(n, 1).astype(np.float32)
    elif name == "loss":
        labels = None
        preds = rng.rand(n).astype(np.float32)
    else:
        labels = rng.randint(0, c, n).astype(np.float32)
        p = rng.rand(n, c).astype(np.float32)
        preds = p / p.sum(axis=1, keepdims=True)
    return labels, preds


METRICS = [("acc", {}), ("accuracy", {"axis": 1}), ("top_k_accuracy",
                                                      {"top_k": 3}),
           ("f1", {}), ("mcc", {}), ("mae", {}), ("mse", {}), ("rmse", {}),
           ("ce", {}), ("nll_loss", {}), ("perplexity", {"ignore_label": 2}),
           ("pearsonr", {}), ("loss", {})]


@pytest.mark.parametrize("name,kwargs", METRICS,
                         ids=[m[0] for m in METRICS])
@pytest.mark.parametrize("kind", ["ndarray", "tensor"])
def test_metric_matches_jax(name, kwargs, kind):
    jmx = _jmx()
    t = tmx.metric.create(name, **kwargs)
    j = jmx.metric.create(name, **kwargs)
    assert t.get()[0] == j.get()[0]
    for seed in range(3):
        labels, preds = _inputs(name, seed)

        def wrap(pkg, a):
            if a is None:
                return None
            if pkg is jmx:
                return jmx.nd.array(a)
            if kind == "tensor":
                return torch.from_numpy(a)
            return tmx.nd.array(a, ctx=CPU)

        t.update([wrap(tmx, labels)], [wrap(tmx, preds)])
        j.update([wrap(jmx, labels)], [wrap(jmx, preds)])
        assert t.get() == j.get() or np.allclose(
            t.get()[1], j.get()[1], rtol=0, atol=0, equal_nan=True)
        assert t.num_inst == j.num_inst
    t.reset()
    j.reset()
    assert t.get()[0] == j.get()[0]
    np.testing.assert_equal(t.get()[1], j.get()[1])


def test_composite_custom_and_create_match_jax():
    jmx = _jmx()
    labels, preds = _inputs("acc", 4)

    def feval(label, pred):
        return float((pred.argmax(axis=1) == label).sum()), label.size

    for pkg in (tmx, jmx):
        comp = pkg.metric.create(["acc", "ce", pkg.metric.TopKAccuracy(2)])
        comp.add(pkg.metric.np_metric(feval, name="mine"))
        comp.update([pkg.nd.array(labels, **({"ctx": CPU} if pkg is tmx
                                             else {}))],
                    [pkg.nd.array(preds, **({"ctx": CPU} if pkg is tmx
                                            else {}))])
        if pkg is tmx:
            got = comp.get()
        else:
            want = comp.get()
    assert got == want
    assert tmx.metric.create(feval).name == jmx.metric.create(feval).name
    with pytest.raises(MXNetError, match="unknown metric 'nope'"):
        tmx.metric.create("nope")
    assert "acc" in tmx.metric._registry and \
        tmx.metric._registry.list() == jmx.metric._registry.list()


def test_metric_is_thread_safe_and_pickles():
    m = tmx.metric.Accuracy()
    labels = np.zeros(10, np.float32)
    preds = np.zeros((10, 3), np.float32)
    preds[:, 0] = 1

    def work():
        for _ in range(200):
            m.update([labels], [preds])

    threads = [threading.Thread(target=work) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert m.num_inst == 8000 and m.get() == ("accuracy", 1.0)
    m2 = pickle.loads(pickle.dumps(m))
    m2.update([labels], [preds])
    assert m2.num_inst == 8010
