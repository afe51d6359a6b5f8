"""``mx.image`` (decode, resize, crops, every augmenter, ``CreateAugmenter``,
``ImageIter``), the vision transforms that use it (``RandomGray``,
``CropResize``) and the detection tier (the ``Det*`` augmenters,
``CreateDetAugmenter``, ``ImageDetIter``, ``io.ImageDetRecordIter``) of the
PyTorch port against the JAX package.

The inputs are small JPEGs and PNGs the tests write (64x48), and both
packages draw their augmentations from numpy's global stream (and
``RandomOrderAug`` from Python's ``random``), so every comparison seeds
both before each package's call.  Tolerances: decode, resize, crops, flips
and casts are PIL and indexing in both packages, and the 3x3 colour
products (``HueJitterAug``, ``RandomGrayAug``) and luminance sums are numpy
in both, so they are compared exactly; the elementwise float32 arithmetic
(``src * alpha``, ``+ offset``, ``color_normalize``) runs in torch here and
in XLA there, one IEEE operation per element, and is compared exactly too.
Images and augmenter outputs are NDArrays on ``cpu()`` in the port, also
under ``with mx.gpu(0):`` (a deliberate difference: the JAX package puts
them on its default device); iterators' batches go to the context they
were built in, so the tests build them under ``with mx.cpu():``.
"""
import io
import os
import random

import numpy as np
import pytest

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

CPU = tmx.cpu()


def _jmx():
    import mxnet_tpu as jmx

    return jmx


def _image(seed, h=48, w=64):
    """A smooth RGB image with a little noise (JPEG-friendly)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(xx / (4.0 + seed % 5) + c) * 90
                     + np.cos(yy / 6.0 - c) * 30 + 128 for c in range(3)],
                    -1) + rng.randint(0, 12, (h, w, 3))
    return np.clip(base, 0, 255).astype(np.uint8)


def _jpeg(arr, fmt="JPEG"):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format=fmt, quality=95)
    return buf.getvalue()


def _both(fn_t, fn_j, seed=0):
    """Call the port's and the JAX package's form after the same seeds;
    return both results as numpy."""
    np.random.seed(seed)
    random.seed(seed)
    a = fn_t()
    np.random.seed(seed)
    random.seed(seed)
    b = fn_j()
    return a, b


def _cpu(build, *args, **kwargs):
    """``build(*args, **kwargs)`` under ``with mx.cpu():``."""
    with tmx.cpu():
        return build(*args, **kwargs)


def _arr(x):
    if isinstance(x, tuple):
        x = x[0]
    return x.asnumpy()


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """Eight JPEGs and two PNGs in two class folders, and a .lst of them."""
    from PIL import Image

    root = tmp_path_factory.mktemp("images")
    rows = []
    for i in range(10):
        cls = f"c{i % 2}"
        os.makedirs(root / cls, exist_ok=True)
        ext = "png" if i >= 8 else "jpg"
        rel = f"{cls}/img{i}.{ext}"
        Image.fromarray(_image(i)).save(root / rel, quality=95)
        rows.append(f"{i}\t{i % 2}\t{rel}\n")
    (root / "all.lst").write_text("".join(rows))
    return root


def test_imdecode_imread_imresize_match_jax(folder):
    jmx = _jmx()
    buf = _jpeg(_image(3))
    for flag in (1, 0):
        a = tmx.image.imdecode(buf, flag=flag)
        b = jmx.image.imdecode(buf, flag=flag)
        assert a.context == CPU and a.dtype == np.uint8
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    path = str(folder / "c1" / "img1.jpg")
    a, b = tmx.image.imread(path), jmx.image.imread(path)
    np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    for w, h in ((32, 24), (80, 70)):
        np.testing.assert_array_equal(
            tmx.image.imresize(a, w, h).asnumpy(),
            jmx.image.imresize(b, w, h).asnumpy())
    for size in (20, 56):
        np.testing.assert_array_equal(
            tmx.image.resize_short(a, size).asnumpy(),
            jmx.image.resize_short(b, size).asnumpy())
    gray = tmx.image.imdecode(buf, flag=0)
    np.testing.assert_array_equal(
        tmx.image.imresize(gray, 16, 12).asnumpy(),
        jmx.image.imresize(jmx.image.imdecode(buf, flag=0), 16, 12)
        .asnumpy())


@pytest.mark.parametrize("kind", ["fixed", "fixed_resized", "center",
                                  "random", "random_size", "random_size_big"])
def test_crops_match_jax(kind):
    jmx = _jmx()
    src = _image(1)
    t, j = tmx.image, jmx.image
    ts, js = tmx.nd.array(src, ctx=CPU), jmx.nd.array(src)
    calls = {
        "fixed": lambda m, s: m.fixed_crop(s, 3, 5, 20, 17),
        "fixed_resized": lambda m, s: m.fixed_crop(s, 3, 5, 20, 17,
                                                   size=(16, 16)),
        "center": lambda m, s: m.center_crop(s, (30, 20)),
        "random": lambda m, s: m.random_crop(s, (30, 20)),
        "random_size": lambda m, s: m.random_size_crop(
            s, (24, 24), (0.08, 1.0), (0.75, 1.333)),
        # an area no crop fits: ten draws, then the centre crop
        "random_size_big": lambda m, s: m.random_size_crop(
            s, (24, 24), (4.0, 5.0), (0.75, 1.333)),
    }
    for seed in range(3):
        a, b = _both(lambda: calls[kind](t, ts), lambda: calls[kind](j, js),
                     seed)
        if isinstance(a, tuple):
            assert tuple(a[1]) == tuple(b[1])
        assert (a[0] if isinstance(a, tuple) else a).context == CPU
        np.testing.assert_array_equal(_arr(a), _arr(b))


def _augmenters(m):
    """Each augmenter of ``m`` (the port's or the JAX image module), and
    whether it takes the float32 image."""
    mean = np.array([120.0, 115.0, 100.0], np.float32)
    std = np.array([58.0, 57.0, 57.5], np.float32)
    nd = m.__name__.startswith("mxnet_tpu_torch")
    arr = (lambda a: tmx.nd.array(a, ctx=CPU)) if nd else \
        (lambda a: _jmx().nd.array(a))
    return {
        "resize": (m.ResizeAug(30), False),
        "center_crop": (m.CenterCropAug((32, 24)), False),
        "random_crop": (m.RandomCropAug((32, 24)), False),
        "random_sized_crop": (m.RandomSizedCropAug((24, 24), (0.08, 1.0),
                                                   (0.75, 1.333)), False),
        "flip": (m.HorizontalFlipAug(0.5), False),
        "cast": (m.CastAug(), False),
        "brightness": (m.BrightnessJitterAug(0.4), True),
        "contrast": (m.ContrastJitterAug(0.4), True),
        "saturation": (m.SaturationJitterAug(0.4), True),
        "hue": (m.HueJitterAug(0.3), True),
        "color_jitter": (m.ColorJitterAug(0.4, 0.4, 0.4), True),
        "lighting": (m.LightingAug(0.1, m.IMAGENET_PCA_EIGVAL,
                                   m.IMAGENET_PCA_EIGVEC), True),
        "gray": (m.RandomGrayAug(0.5), True),
        "normalize": (m.ColorNormalizeAug(arr(mean), arr(std)), True),
        "normalize_uint8": (m.ColorNormalizeAug(arr(mean), arr(std)), False),
        "force_resize": (m.ForceResizeAug((40, 30)), False),
        "sequential": (m.SequentialAug([m.CastAug(),
                                        m.BrightnessJitterAug(0.3)]), False),
        "random_order": (m.RandomOrderAug([m.BrightnessJitterAug(0.3),
                                           m.ContrastJitterAug(0.3),
                                           m.SaturationJitterAug(0.3)]),
                         True),
    }


AUGMENTERS = sorted(_augmenters(tmx.image))


@pytest.mark.parametrize("name", AUGMENTERS)
def test_augmenter_matches_jax(name):
    jmx = _jmx()
    ta, as_float = _augmenters(tmx.image)[name]
    ja, _ = _augmenters(jmx.image)[name]
    src = _image(2)
    if as_float:
        src = src.astype(np.float32)
    ts, js = tmx.nd.array(src, ctx=CPU), jmx.nd.array(src)
    for seed in range(4):
        a, b = _both(lambda: ta(ts), lambda: ja(js), seed)
        assert a.context == CPU
        assert a.dtype == b.dtype, (a.dtype, b.dtype)
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())


CHAINS = {
    "default": {},
    "imagenet_train": dict(resize=40, rand_crop=True, rand_resize=True,
                           rand_mirror=True, mean=True, std=True,
                           brightness=0.4, contrast=0.4, saturation=0.4,
                           hue=0.2, pca_noise=0.1, rand_gray=0.2),
    "crop_mean_only": dict(rand_crop=True, mean=np.array([1.0, 2.0, 3.0])),
}


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_create_augmenter_chain_matches_jax(chain):
    jmx = _jmx()
    kw = CHAINS[chain]
    tl = tmx.image.CreateAugmenter((3, 24, 24), **kw)
    jl = jmx.image.CreateAugmenter((3, 24, 24), **kw)
    assert [type(a).__name__ for a in tl] == [type(a).__name__ for a in jl]
    for seed in range(3):
        src = _image(seed)

        def run(lst, x):
            for aug in lst:
                x = aug(x)
            return x

        a, b = _both(lambda: run(tl, tmx.nd.array(src, ctx=CPU)),
                     lambda: run(jl, jmx.nd.array(src)), seed)
        assert a.context == CPU and a.shape == (24, 24, 3)
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())


def test_images_stay_on_the_host_under_a_gpu_context():
    """A deliberate difference: the port's images and augmenter outputs are
    NDArrays on cpu() whatever the default context is, so a per-sample
    chain never runs on (or needs) the card."""
    buf = _jpeg(_image(4))
    with tmx.gpu(0):
        img = tmx.image.imdecode(buf)
        assert img.context == CPU
        for aug in tmx.image.CreateAugmenter(
                (3, 24, 24), rand_crop=True, rand_mirror=True, mean=True,
                std=True, brightness=0.3, hue=0.1, pca_noise=0.1,
                rand_gray=0.5):
            img = aug(img)
            assert img.context == CPU and not img.data.is_cuda


def _rec_file(path, n=12, det=False):
    """An indexed .rec of ``n`` JPEG records (detection labels with
    ``det``)."""
    rio = tmx.recordio
    rec = rio.MXIndexedRecordIO(str(path) + ".idx", str(path) + ".rec", "w")
    for i in range(n):
        if det:
            k = 1 + i % 3
            objs = [[float(j), 0.1 + 0.1 * j, 0.2, 0.5 + 0.1 * j, 0.6 + 0.1 * j]
                    for j in range(k)]
            label = np.array([2, 5] + sum(objs, []), np.float32)
        else:
            label = float(i % 4)
        rec.write_idx(i, rio.pack_img(rio.IRHeader(0, label, i, 0),
                                      _image(i), quality=95))
    rec.close()
    return str(path) + ".rec"


def _all(it):
    return [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in it]


def _same(a, b):
    assert len(a) == len(b) and len(a) > 0
    for (ad, al, ap), (bd, bl, bp) in zip(a, b):
        assert ap == bp
        np.testing.assert_array_equal(ad, bd)
        np.testing.assert_array_equal(al, bl)


def test_image_iter_rec_and_list_modes_match_jax(folder, tmp_path):
    jmx = _jmx()
    rec = _rec_file(tmp_path / "cls")
    # one decode thread: the native lane's augmentation streams are a
    # thread's, not a batch's (ROADMAP, reference caveat (l))
    kw = dict(batch_size=4, data_shape=(3, 24, 24), shuffle=True,
              rand_mirror=True, rand_crop=True, preprocess_threads=1)
    with tmx.cpu():
        t = tmx.image.ImageIter(path_imgrec=rec, **kw)
    j = jmx.image.ImageIter(path_imgrec=rec, **kw)
    for _ in range(2):
        _same(_all(t), _all(j))
        t.reset()
        j.reset()
    aug = dict(rand_crop=True, rand_mirror=True, mean=True, std=True,
               brightness=0.2)
    with tmx.cpu():
        t = tmx.image.ImageIter(
            4, (3, 24, 24), path_imglist=str(folder / "all.lst"),
            path_root=str(folder), shuffle=True,
            aug_list=tmx.image.CreateAugmenter((3, 24, 24), **aug))
    j = jmx.image.ImageIter(
        4, (3, 24, 24), path_imglist=str(folder / "all.lst"),
        path_root=str(folder), shuffle=True,
        aug_list=jmx.image.CreateAugmenter((3, 24, 24), **aug))
    for seed in range(2):
        a, b = _both(lambda: (t.reset(), _all(t))[1],
                     lambda: (j.reset(), _all(j))[1], seed)
        _same(a, b)
        assert len(a) == 2
    with pytest.raises(MXNetError, match="need path_imgrec or path_imglist"):
        tmx.image.ImageIter(4, (3, 24, 24))


def test_random_gray_and_crop_resize_match_jax():
    jmx = _jmx()
    tv = tmx.gluon.data.vision.transforms
    jv = jmx.gluon.data.vision.transforms
    src = _image(5)
    for dtype in (np.uint8, np.float32):
        x = src.astype(dtype)
        for seed in range(4):
            a, b = _both(lambda: tv.RandomGray(0.5)(tmx.nd.array(x, ctx=CPU)),
                         lambda: jv.RandomGray(0.5)(jmx.nd.array(x)), seed)
            assert a.dtype == np.dtype(dtype) == b.dtype
            assert a.context == CPU
            np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    for size in (None, 16, (20, 12)):
        a = tv.CropResize(4, 6, 30, 20, size=size)(tmx.nd.array(src, ctx=CPU))
        b = jv.CropResize(4, 6, 30, 20, size=size)(jmx.nd.array(src))
        assert a.context == CPU
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())


def _det_label(n_obj=2):
    lab = np.full((3, 5), -1.0, np.float32)
    for j in range(n_obj):
        lab[j] = [j, 0.1 + 0.2 * j, 0.15, 0.45 + 0.2 * j, 0.7]
    return lab


def _det_augmenters(m):
    return {
        "flip": m.DetHorizontalFlipAug(0.5),
        "crop": m.DetRandomCropAug(min_object_covered=0.1),
        "pad": m.DetRandomPadAug(),
        "select": m.DetRandomSelectAug([m.DetHorizontalFlipAug(1.0),
                                        m.DetRandomPadAug()],
                                       skip_prob=0.3),
        "borrow": m.DetBorrowAug(m.BrightnessJitterAug(0.4)),
    }


@pytest.mark.parametrize("name", sorted(_det_augmenters(tmx.image)))
def test_det_augmenter_matches_jax(name):
    jmx = _jmx()
    ta = _det_augmenters(tmx.image)[name]
    ja = _det_augmenters(jmx.image)[name]
    src = _image(6).astype(np.float32 if name == "borrow" else np.uint8)
    for seed in range(4):
        (ai, al), (bi, bl) = _both(
            lambda: ta(tmx.nd.array(src, ctx=CPU), _det_label()),
            lambda: ja(jmx.nd.array(src), _det_label()), seed)
        assert ai.context == CPU
        np.testing.assert_array_equal(ai.asnumpy(), bi.asnumpy())
        np.testing.assert_array_equal(al, bl)
    with pytest.raises(MXNetError, match="image Augmenter"):
        tmx.image.DetBorrowAug(lambda x: x)


def test_create_det_augmenter_chain_matches_jax():
    jmx = _jmx()
    kw = dict(rand_crop=0.5, rand_pad=0.5, rand_mirror=True, mean=True,
              std=True, brightness=0.3, hue=0.1, pca_noise=0.05,
              rand_gray=0.3)
    tl = tmx.image.CreateDetAugmenter((3, 32, 32), **kw)
    jl = jmx.image.CreateDetAugmenter((3, 32, 32), **kw)
    assert [type(a).__name__ for a in tl] == [type(a).__name__ for a in jl]

    def run(lst, x):
        lab = _det_label(3)
        for aug in lst:
            x, lab = aug(x, lab)
        return x, lab

    for seed in range(4):
        (ai, al), (bi, bl) = _both(
            lambda: run(tl, tmx.nd.array(_image(seed), ctx=CPU)),
            lambda: run(jl, jmx.nd.array(_image(seed))), seed)
        assert ai.shape == (32, 32, 3)
        np.testing.assert_array_equal(ai.asnumpy(), bi.asnumpy())
        np.testing.assert_array_equal(al, bl)


@pytest.mark.parametrize("indexed", [True, False])
def test_image_det_iter_matches_jax(tmp_path, indexed):
    jmx = _jmx()
    rec = _rec_file(tmp_path / "det", n=10, det=True)
    if not indexed:
        os.remove(str(tmp_path / "det.idx"))
    kw = dict(batch_size=4, data_shape=(3, 32, 32), path_imgrec=rec,
              shuffle=True)
    for last in ("pad", "discard", "roll_over"):
        # a shuffled iterator shuffles when it is built
        t, j = _both(lambda: _cpu(tmx.image.ImageDetIter,
                                  last_batch_handle=last, **kw),
                     lambda: jmx.image.ImageDetIter(last_batch_handle=last,
                                                    **kw), 7)
        assert t.provide_label[0].shape == (4, 3, 5)
        for seed in range(2):
            a, b = _both(lambda: (t.reset(), _all(t))[1],
                         lambda: (j.reset(), _all(j))[1], seed)
            _same(a, b)
    t, j = _both(lambda: _cpu(tmx.image.ImageDetIter, num_parts=2,
                              part_index=1, label_pad_width=6, **kw),
                 lambda: jmx.image.ImageDetIter(num_parts=2, part_index=1,
                                                label_pad_width=6, **kw), 3)
    a, b = _both(lambda: _all(t), lambda: _all(j), 3)
    _same(a, b)
    assert a[0][1].shape == (4, 6, 5)
    drawn_t = list(t.draw_next())
    drawn_j = list(j.draw_next())
    assert len(drawn_t) == 5
    for x, y in zip(drawn_t, drawn_j):
        np.testing.assert_array_equal(x, y)


def test_image_det_iter_list_mode_and_label_layout(folder, tmp_path):
    jmx = _jmx()
    rows = []
    for i in range(6):
        objs = sum([[float(j), 0.1, 0.1 + 0.1 * j, 0.6, 0.8]
                    for j in range(1 + i % 2)], [])
        rows.append("\t".join([str(i), "2", "5"] + [str(v) for v in objs]
                              + [f"c{i % 2}/img{i}.jpg"]) + "\n")
    lst = tmp_path / "det.lst"
    lst.write_text("".join(rows))
    kw = dict(batch_size=3, data_shape=(3, 24, 24), path_imglist=str(lst),
              path_root=str(folder))
    with tmx.cpu():
        t = tmx.image.ImageDetIter(**kw)
    j = jmx.image.ImageDetIter(**kw)
    a, b = _both(lambda: _all(t), lambda: _all(j))
    _same(a, b)
    assert a[0][1].shape == (3, 2, 5)
    assert (a[0][1][0, 1] == -1).all()   # one object, then the pad row
    # a header narrower than [header_w, obj_w] or objects narrower than 5
    for raw, msg in (([1, 5, 0, 0, 0, 0, 0], "header_width=1"),
                     ([2, 4, 0, 0, 0, 0], "object_width=4"),
                     ([2, 5, 0, 0, 0], "not a multiple"), ([2], "size 1")):
        with pytest.raises(MXNetError, match=msg):
            tmx.image.detection._parse_det_label(raw)
        with pytest.raises(jmx.base.MXNetError):
            jmx.image.detection._parse_det_label(raw)
    with tmx.cpu():
        with pytest.raises(MXNetError, match="label_pad_width=1"):
            tmx.image.ImageDetIter(label_pad_width=1, **kw)


def test_image_det_record_iter_matches_jax(tmp_path):
    jmx = _jmx()
    rec = _rec_file(tmp_path / "det", n=8, det=True)
    kw = dict(path_imgrec=rec, batch_size=4, data_shape=(3, 32, 32),
              shuffle=True, rand_crop_prob=0.5, rand_pad_prob=0.5,
              rand_mirror_prob=0.5, min_aspect_ratio=0.8,
              max_aspect_ratio=1.25, min_crop_scale=0.3, max_crop_scale=1.0,
              mean_r=123.0, mean_g=117.0, mean_b=104.0, std_r=58.0,
              brightness=0.2)
    t, j = _both(lambda: _cpu(tmx.io.ImageDetRecordIter, **kw),
                 lambda: jmx.io.ImageDetRecordIter(**kw), 5)
    flips = [a for a in t._aug
             if isinstance(a, tmx.image.DetHorizontalFlipAug)]
    assert len(flips) == 1 and flips[0].p == 0.5
    for seed in range(2):
        a, b = _both(lambda: (t.reset(), _all(t))[1],
                     lambda: (j.reset(), _all(j))[1], seed)
        _same(a, b)
    with pytest.raises(MXNetError, match="unsupported kwargs.*bogus"):
        tmx.io.ImageDetRecordIter(bogus=1, **kw)
    with pytest.raises(MXNetError, match="either as aug_list"):
        tmx.io.ImageDetRecordIter(
            aug_list=tmx.image.CreateDetAugmenter((3, 32, 32)), **kw)
