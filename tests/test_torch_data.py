"""``gluon.data`` of the PyTorch port (datasets, samplers, ``DataLoader``,
``vision`` datasets and transforms) against the JAX package.

Inputs are numpy from a seed; the vision datasets read files the tests
write (idx, gz, CIFAR pickles, a .rec of PNG records, a folder of PNGs).
Random samplers and transforms draw from numpy's global stream in both
packages, so each side runs after the same ``np.random.seed``.  Batches
and samples are compared exactly; transforms within 1e-6 of the largest
magnitude of the output (float32 on both sides: a 3x3 colour product or an
image mean summed in another order moves a value in [0, 255] by an ulp of
the mean or the value, up to 1.5e-5).
"""
import gzip
import os
import pickle
import struct
import time

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import data as tdata
from mxnet_tpu_torch.gluon.data.vision import transforms as ttf

CPU = tmx.cpu()


def _jmx():
    import mxnet_tpu as jmx

    return jmx


def _np(v):
    if hasattr(v, "asnumpy"):
        return v.asnumpy()
    if isinstance(v, torch.Tensor):
        return v.numpy()
    return np.asarray(v)


def _same(a, b):
    """Exactly equal trees of arrays / scalars."""
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    np.testing.assert_array_equal(_np(a), _np(b))


def write_mnist(root, n, seed, train=True, gz=False):
    """idx files of n rows drawn as examples/image-classification/
    train_mnist.py draws its separable digits, scaled to uint8."""
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 28, 28) * 0.1
    y = rng.randint(0, 10, n)
    for k in range(10):
        x[y == k, 2 * k:2 * k + 6, :] += 0.9
    img = np.clip(np.round(x * 255), 0, 255).astype(np.uint8)
    pre = "train" if train else "t10k"
    op = gzip.open if gz else open
    sfx = ".gz" if gz else ""
    os.makedirs(root, exist_ok=True)
    with op(os.path.join(root, f"{pre}-images-idx3-ubyte{sfx}"), "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + img.tobytes())
    with op(os.path.join(root, f"{pre}-labels-idx1-ubyte{sfx}"), "wb") as f:
        f.write(struct.pack(">II", 2049, n) + y.astype(np.uint8).tobytes())
    return img, y


# -- datasets and samplers ----------------------------------------------------


def test_dataset_transforms_filter_take_match_jax():
    jmx = _jmx()
    rng = np.random.RandomState(0)
    x = rng.rand(12, 3).astype(np.float32)
    y = rng.randint(0, 5, 12).astype(np.int32)
    for pkg in (tdata, jmx.gluon.data):
        ds = pkg.ArrayDataset(x, y)
        assert len(ds) == 12
    t = tdata.ArrayDataset(x, y)
    j = jmx.gluon.data.ArrayDataset(x, y)
    for i in range(12):
        _same(t[i], j[i])
    f = lambda a, b: (a * 2, b + 1)  # noqa: E731
    for lazy in (True, False):
        tt, jj = t.transform(f, lazy), j.transform(f, lazy)
        _same([tt[i] for i in range(12)], [jj[i] for i in range(12)])
    tf = t.transform_first(lambda a: a - 1)
    jf = j.transform_first(lambda a: a - 1)
    _same([tf[i] for i in range(12)], [jf[i] for i in range(12)])
    keep = lambda s: s[1] % 2 == 0  # noqa: E731
    _same(list(t.filter(keep)._data), list(j.filter(keep)._data))
    assert len(t.take(5)) == len(j.take(5)) == 5
    s = tdata.SimpleDataset(list(range(7)))
    assert [s[i] for i in range(len(s))] == list(range(7))


def test_array_dataset_over_an_ndarray_indexes_on_the_host():
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    ds = tdata.ArrayDataset(tmx.nd.array(x, ctx=CPU), np.arange(6))
    row, lbl = ds[4]
    assert isinstance(row, tmx.nd.NDArray) and row.context == CPU
    np.testing.assert_array_equal(row.asnumpy(), x[4])
    assert lbl == 4


@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_samplers_match_jax(last_batch):
    jmx = _jmx()
    jd = jmx.gluon.data
    assert list(tdata.SequentialSampler(5, start=2)) == \
        list(jd.SequentialSampler(5, start=2))
    np.random.seed(3)
    tr = list(tdata.RandomSampler(17))
    np.random.seed(3)
    jr = list(jd.RandomSampler(17))
    assert tr == jr and sorted(tr) == list(range(17))
    tb = tdata.BatchSampler(tdata.SequentialSampler(10), 4, last_batch)
    jb = jd.BatchSampler(jd.SequentialSampler(10), 4, last_batch)
    for _ in range(3):   # epochs: the rollover remainder carries over
        assert list(tb) == list(jb)
        assert len(tb) == len(jb)
    ds = list(range(9))
    assert list(tdata.FilterSampler(lambda v: v % 3 == 0, ds)) == \
        list(jd.FilterSampler(lambda v: v % 3 == 0, ds))


@pytest.mark.parametrize("shuffle,last_batch,workers", [
    (False, "keep", 0), (True, "keep", 2), (True, "discard", 4),
    (True, "rollover", 1)])
def test_dataloader_batches_match_jax(shuffle, last_batch, workers):
    jmx = _jmx()
    rng = np.random.RandomState(1)
    x = rng.rand(23, 2, 3).astype(np.float32)
    y = rng.randint(0, 9, 23).astype(np.int32)
    out = {}
    for name, d in (("port", tdata), ("jax", jmx.gluon.data)):
        np.random.seed(5)
        dl = d.DataLoader(d.ArrayDataset(x, y), batch_size=5,
                          shuffle=shuffle, last_batch=last_batch,
                          num_workers=workers)
        out[name] = [[_np(b) for b in batch] for _ in range(2)
                     for batch in dl]
        assert len(dl) == {"keep": 5, "discard": 4, "rollover": 4}[
            last_batch]
    assert len(out["port"]) == len(out["jax"])
    _same(out["port"], out["jax"])


def test_batches_are_built_on_the_host():
    """Deliberate difference: the port's default_batchify stacks on the
    host (an NDArray on cpu()); the JAX package stacks on its default
    device.  The values are the same."""
    jmx = _jmx()
    x = np.arange(12, dtype=np.float64).reshape(4, 3)
    tb = tdata.dataloader.default_batchify_fn([r for r in x])
    jb = jmx.gluon.data.dataloader.default_batchify_fn([r for r in x])
    assert tb.context == CPU and tb.dtype == np.float32
    _same(tb, jb)
    rows = [tmx.nd.array(r, ctx=CPU) for r in x]
    sb = tdata.dataloader.default_batchify_fn(rows)
    assert sb.context == CPU and sb.shape == (4, 3)
    pair = tdata.dataloader.default_batchify_fn(
        [(r, np.int32(i)) for i, r in enumerate(x)])
    assert pair[1].context == CPU
    np.testing.assert_array_equal(pair[1].asnumpy(), np.arange(4))


def test_dataloader_timeout_names_the_stuck_batch():
    class Slow(tdata.Dataset):
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i >= 2:
                time.sleep(2.0)
            return np.float32(i)

    dl = tdata.DataLoader(Slow(), batch_size=2, timeout=0.3)
    it = iter(dl)
    next(it)
    with pytest.raises(MXNetError, match="timed out after 0.3s waiting "
                       "for batch 1"):
        next(it)


def test_a_worker_exception_reaches_the_consumer():
    class Bad(tdata.Dataset):
        def __len__(self):
            return 6

        def __getitem__(self, i):
            if i == 3:
                raise ValueError("sample 3 is corrupt")
            return np.float32(i)

    got = []
    with pytest.raises(ValueError, match="sample 3 is corrupt"):
        for b in tdata.DataLoader(Bad(), batch_size=2, num_workers=2):
            got.append(b.asnumpy())
    assert len(got) == 1


# -- vision datasets over files -------------------------------------------------


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("train", [True, False])
def test_mnist_files_match_jax(tmp_path, gz, train):
    jmx = _jmx()
    img, lbl = write_mnist(str(tmp_path), 40, 0, train=train, gz=gz)
    t = tmx.gluon.data.vision.MNIST(str(tmp_path), train=train)
    j = jmx.gluon.data.vision.MNIST(str(tmp_path), train=train)
    assert len(t) == len(j) == 40
    for i in (0, 17, 39):
        td, tl = t[i]
        jd, jl = j[i]
        assert td.context == CPU and td.shape == (28, 28, 1)
        np.testing.assert_array_equal(td.asnumpy(), jd.asnumpy())
        np.testing.assert_array_equal(td.asnumpy()[..., 0], img[i])
        assert tl == jl == lbl[i]
    f = tmx.gluon.data.vision.FashionMNIST(str(tmp_path), train=train)
    np.testing.assert_array_equal(f[3][0].asnumpy(), t[3][0].asnumpy())


def test_mnist_transform_and_missing_files(tmp_path):
    jmx = _jmx()
    write_mnist(str(tmp_path), 16, 2)
    tt, jt = ttf.ToTensor(), jmx.gluon.data.vision.transforms.ToTensor()
    t = tmx.gluon.data.vision.MNIST(str(tmp_path),
                                    transform=lambda d, l: (tt(d), l))
    j = jmx.gluon.data.vision.MNIST(str(tmp_path),
                                    transform=lambda d, l: (jt(d), l))
    for i in range(0, 16, 5):
        np.testing.assert_allclose(t[i][0].asnumpy(), j[i][0].asnumpy(),
                                   rtol=0, atol=1e-6)
    with pytest.raises(MXNetError, match="MNIST raw files not found under"):
        tmx.gluon.data.vision.MNIST(str(tmp_path / "none"))
    ts = tmx.gluon.data.vision.MNIST(str(tmp_path / "none"), train=False,
                                     synthetic=True)
    js = jmx.gluon.data.vision.MNIST(str(tmp_path / "none"), train=False,
                                     synthetic=True)
    assert len(ts) == len(js) == 256
    _same(ts[7], js[7])


def _cifar_pickles(root, n, seed, hundred=False):
    rng = np.random.RandomState(seed)
    if hundred:
        base = os.path.join(root, "cifar-100-python")
        os.makedirs(base)
        for name in ("train", "test"):
            d = {b"data": rng.randint(0, 256, (n, 3072)).astype(np.uint8),
                 b"fine_labels": rng.randint(0, 100, n).tolist(),
                 b"coarse_labels": rng.randint(0, 20, n).tolist()}
            with open(os.path.join(base, name), "wb") as f:
                pickle.dump(d, f)
        return
    base = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(base)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        d = {b"data": rng.randint(0, 256, (n, 3072)).astype(np.uint8),
             b"labels": rng.randint(0, 10, n).tolist()}
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump(d, f)


@pytest.mark.parametrize("kind", ["cifar10", "cifar100_fine",
                                  "cifar100_coarse", "synthetic"])
def test_cifar_datasets_match_jax(tmp_path, kind):
    jmx = _jmx()
    tv, jv = tmx.gluon.data.vision, jmx.gluon.data.vision
    root = str(tmp_path)
    if kind == "cifar10":
        _cifar_pickles(root, 6, 4)
        t, j = tv.CIFAR10(root), jv.CIFAR10(root)
    elif kind == "synthetic":
        t = tv.CIFAR10(root, train=False, synthetic=True)
        j = jv.CIFAR10(root, train=False, synthetic=True)
    else:
        _cifar_pickles(root, 6, 4, hundred=True)
        fine = kind.endswith("fine")
        t = tv.CIFAR100(root, fine_label=fine, train=False)
        j = jv.CIFAR100(root, fine_label=fine, train=False)
    assert len(t) == len(j)
    for i in (0, len(t) - 1):
        assert t[i][0].shape == (32, 32, 3)
        _same(t[i], j[i])
    with pytest.raises(MXNetError, match="not found under"):
        tv.CIFAR10(str(tmp_path / "none"))


def test_image_record_and_folder_datasets_match_jax(tmp_path):
    pytest.importorskip("PIL")
    from PIL import Image

    jmx = _jmx()
    rng = np.random.RandomState(6)
    imgs = rng.randint(0, 256, (5, 8, 10, 3)).astype(np.uint8)
    rec = str(tmp_path / "data.rec")
    w = tmx.io.recordio.MXIndexedRecordIO(str(tmp_path / "data.idx"), rec,
                                          "w")
    for i, im in enumerate(imgs):
        w.write_idx(i, tmx.io.recordio.pack_img((0, float(i % 3), i, 0), im,
                                                img_fmt=".png"))
    w.close()
    t = tmx.gluon.data.vision.ImageRecordDataset(rec)
    j = jmx.gluon.data.vision.ImageRecordDataset(rec)
    assert len(t) == len(j) == 5
    for i in range(5):
        _same(t[i], j[i])
        np.testing.assert_array_equal(t[i][0].asnumpy(), imgs[i])
    for c in ("a", "b"):
        os.makedirs(tmp_path / "folder" / c)
    for i, im in enumerate(imgs):
        Image.fromarray(im).save(tmp_path / "folder" / "ab"[i % 2]
                                 / f"{i}.png")
    tf = tmx.gluon.data.vision.ImageFolderDataset(str(tmp_path / "folder"))
    jf = jmx.gluon.data.vision.ImageFolderDataset(str(tmp_path / "folder"))
    assert tf.synsets == jf.synsets == ["a", "b"]
    for i in range(len(tf)):
        _same(tf[i], jf[i])


# -- transforms -----------------------------------------------------------------


IMAGENET = dict(mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225))


def _transform_pairs(tv, jv):
    return {
        "to_tensor": (tv.ToTensor(), jv.ToTensor()),
        "normalize": (tv.Compose([tv.ToTensor(), tv.Normalize(**IMAGENET)]),
                      jv.Compose([jv.ToTensor(), jv.Normalize(**IMAGENET)])),
        "cast": (tv.Cast("float32"), jv.Cast("float32")),
        "center_crop": (tv.CenterCrop(6), jv.CenterCrop(6)),
        "random_crop_pad": (tv.RandomCrop(8, pad=2), jv.RandomCrop(8, pad=2)),
        "flip_lr": (tv.RandomFlipLeftRight(), jv.RandomFlipLeftRight()),
        "flip_tb": (tv.RandomFlipTopBottom(), jv.RandomFlipTopBottom()),
        "brightness": (tv.RandomBrightness(0.4), jv.RandomBrightness(0.4)),
        "contrast": (tv.RandomContrast(0.4), jv.RandomContrast(0.4)),
        "saturation": (tv.RandomSaturation(0.4), jv.RandomSaturation(0.4)),
        "hue": (tv.RandomHue(0.3), jv.RandomHue(0.3)),
        "color_jitter": (tv.RandomColorJitter(0.3, 0.3, 0.3, 0.2),
                         jv.RandomColorJitter(0.3, 0.3, 0.3, 0.2)),
        "lighting": (tv.RandomLighting(0.1), jv.RandomLighting(0.1)),
        "resize": (tv.Resize(7), jv.Resize(7)),
        "resize_keep": (tv.Resize(9, keep_ratio=True),
                        jv.Resize(9, keep_ratio=True)),
        "random_resized_crop": (tv.RandomResizedCrop(6),
                                jv.RandomResizedCrop(6)),
    }


TRANSFORMS = [
    "to_tensor", "normalize", "cast", "center_crop", "random_crop_pad",
    "flip_lr", "flip_tb", "brightness", "contrast", "saturation", "hue",
    "color_jitter", "lighting", "resize", "resize_keep",
    "random_resized_crop"]


@pytest.mark.parametrize("name", TRANSFORMS)
def test_transforms_match_jax(name):
    jmx = _jmx()
    if name.startswith(("resize", "random_resized")):
        pytest.importorskip("PIL")
    tp, jp = _transform_pairs(ttf, jmx.gluon.data.vision.transforms)[name]
    img = np.random.RandomState(8).randint(0, 256, (10, 12, 3)) \
        .astype(np.uint8)
    for seed in range(4):
        np.random.seed(seed)
        got = tp(tmx.nd.array(img, ctx=CPU))
        np.random.seed(seed)
        want = jp(jmx.nd.array(img, dtype=np.uint8))
        assert isinstance(got, tmx.nd.NDArray) and got.context == CPU
        g, w = got.asnumpy(), want.asnumpy()
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(
            g, w, rtol=0, atol=1e-6 * max(1.0, float(np.abs(w).max())))


def test_to_tensor_batch_and_image_tier_transforms_raise():
    jmx = _jmx()
    x = np.random.RandomState(9).randint(0, 256, (2, 4, 5, 3)) \
        .astype(np.uint8)
    got = ttf.ToTensor()(tmx.nd.array(x, ctx=CPU)).asnumpy()
    want = jmx.gluon.data.vision.transforms.ToTensor()(
        jmx.nd.array(x, dtype=np.uint8)).asnumpy()
    assert got.shape == (2, 3, 4, 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the image-tier transforms run since slice 8, part 2 (their parity is
    # in test_torch_image.py); a gray conversion of a one-channel image
    # raises in both packages
    jtf = jmx.gluon.data.vision.transforms
    got = ttf.CropResize(1, 0, 3, 2, size=4)(tmx.nd.array(x[0], ctx=CPU))
    want = jtf.CropResize(1, 0, 3, 2, size=4)(jmx.nd.array(x[0]))
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    with pytest.raises(ValueError):
        ttf.RandomGray(1.0)(tmx.nd.array(x[0, :, :, :1], ctx=CPU))
    with pytest.raises(ValueError):
        jtf.RandomGray(1.0)(jmx.nd.array(x[0, :, :, :1]))
