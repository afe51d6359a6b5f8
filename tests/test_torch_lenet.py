"""LeNet (``gluon.model_zoo.vision.lenet``) on MNIST files through the
port's input tier, against the JAX package.

The JAX package's initial weights are carried into the port's LeNet by
``load_numpy_params``; the forward agrees within 1e-5 (float32, two
convolutions and two dense layers summed in other orders).  Then both
packages train 3 SGD-momentum steps (lr 0.05, momentum 0.9, as
``examples/image-classification/train_mnist.py``) at batch 8 on the same
MNIST idx files the test writes, read through ``vision.MNIST`` with
``ToTensor`` and a shuffled ``DataLoader`` (numpy's global stream seeded
alike): the batches are equal, the losses, the weights after the steps and
the ``metric.Accuracy`` within 1e-5."""
import numpy as np
import pytest

import mxnet_tpu_torch as tmx

from test_torch_data import write_mnist

CPU = tmx.cpu()
TOL = 1e-5


def _jmx():
    import mxnet_tpu as jmx

    return jmx


def _nets():
    jmx = _jmx()
    jmx.random.seed(0)
    jnet = jmx.gluon.model_zoo.vision.lenet()
    jnet.initialize(jmx.init.Xavier())
    x0 = np.zeros((1, 1, 28, 28), np.float32)
    jnet(jmx.nd.array(x0))
    weights = {k: p.data().asnumpy().copy()
               for k, p in jnet._collect_params_with_prefix().items()}
    tnet = tmx.gluon.model_zoo.vision.get_model("lenet")
    tnet.initialize(tmx.init.Xavier(), ctx=CPU)
    tnet(tmx.nd.array(x0, ctx=CPU))
    tmx.load_numpy_params(tnet, weights)
    return jnet, tnet, weights


def test_lenet_forward_matches_jax():
    jmx = _jmx()
    jnet, tnet, weights = _nets()
    assert sorted(weights) == sorted(tnet._collect_params_with_prefix())
    assert weights["features.0.weight"].shape == (20, 1, 5, 5)
    assert weights["features.5.weight"].shape == (500, 800)
    x = np.random.RandomState(1).rand(4, 1, 28, 28).astype(np.float32)
    for hyb in (False, True):
        if hyb:
            jnet.hybridize()
            tnet.hybridize()
        got = tnet(tmx.nd.array(x, ctx=CPU)).asnumpy()
        want = jnet(jmx.nd.array(x)).asnumpy()
        assert got.shape == (4, 10)
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def _train(pkg, net, root, steps, **ctx):
    tv = pkg.gluon.data.vision
    to_tensor = tv.transforms.ToTensor()
    ds = tv.MNIST(root, train=True, transform=lambda d, l: (to_tensor(d), l))
    np.random.seed(7)
    loader = pkg.gluon.data.DataLoader(ds, batch_size=8, shuffle=True,
                                       num_workers=2)
    net.hybridize()
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.05, "momentum": 0.9})
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    metric = pkg.metric.Accuracy()
    losses, batches = [], []
    for x, y in loader:
        batches.append((x.asnumpy(), y.asnumpy()))
        with pkg.autograd.record():
            out = net(x)
            loss = loss_fn(out, y)
        loss.backward()
        trainer.step(x.shape[0])
        metric.update([y], [out])
        losses.append(loss.asnumpy().copy())
        if len(losses) == steps:
            break
    weights = {k: np.array(tmx.nd.NDArray(p.data().detach()).asnumpy()
                           if pkg is tmx else p.data().asnumpy())
               for k, p in net._collect_params_with_prefix().items()}
    return losses, batches, weights, metric.get()


def test_lenet_trains_on_mnist_files_as_jax(tmp_path):
    write_mnist(str(tmp_path), 64, 0)
    jnet, tnet, _ = _nets()
    got = _train(tmx, tnet, str(tmp_path), 3)
    want = _train(_jmx(), jnet, str(tmp_path), 3)
    for (tx, ty), (jx, jy) in zip(got[1], want[1]):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    assert len(got[0]) == 3
    for a, b in zip(got[0], want[0]):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    for k, w in want[2].items():
        np.testing.assert_allclose(got[2][k], w, rtol=0, atol=TOL,
                                   err_msg=k)
    assert got[3][0] == want[3][0]
    assert got[3][1] == pytest.approx(want[3][1], abs=TOL)
