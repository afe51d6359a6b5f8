"""``io.ImageRecordIter`` of the PyTorch port against the JAX package, with
``recordio.NativeIndexedRecordIO``, the native library's loader and
``tools.im2rec``.

The records are small JPEGs (64x48) the tests pack.  On the Python (PIL)
lane both packages decode with PIL and augment with numpy from a seed each
batch draws when it is enqueued, so batches are compared exactly, with and
without ``random_resized_crop`` and the colour jitters, sharded with
``num_parts=2`` over the index and over a stream without one, and across a
``reset`` in mid-epoch.  The native lane is the same C++ library
(``lib/libmxtpu_io.so``) in both packages, so it is compared exactly too;
its augmentation draws come from a stream per decode thread, so a run with
random augmentations is reproducible only with one thread (ROADMAP,
reference caveat (l)): those cases pass ``preprocess_threads=1``.  The
native cases skip where the library does not load.  RecordIO files written
through the native writer, and ``im2rec``'s ``.lst``/``.rec``/``.idx``, are
byte-identical to the Python writer's and the repository tool's.  The
``gpu``-marked test needs the card: run it on the GPU machine with
``python -m pytest -m gpu --noconftest tests/test_torch_image_record_iter.py``.
"""
import importlib.util
import logging
import os
import sys

import numpy as np
import pytest

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.utils import libloader, native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = tmx.cpu()

RECIPE = dict(random_resized_crop=True, min_random_area=0.08,
              max_random_area=1.0, min_aspect_ratio=0.75,
              max_aspect_ratio=1.333, brightness=0.4, contrast=0.4,
              saturation=0.4, random_h=10.0, rand_mirror=True,
              mean_r=123.68, mean_g=116.779, mean_b=103.939, std_r=58.393,
              std_g=57.12, std_b=57.375)
AUGS = {"center": dict(mean_r=120.0, std_r=60.0),
        "crop_mirror_resize": dict(rand_crop=True, rand_mirror=True,
                                   resize=40, inter_method=9),
        "train_imagenet": RECIPE}

@pytest.fixture
def native_lib():
    """The native IO library; the test skips where it does not load."""
    if native.load() is None:
        pytest.skip(f"the native IO library does not load: "
                    f"{native.load_error()}")
    return native.load()


def _jmx():
    import mxnet_tpu as jmx

    return jmx


def _image(seed, h=48, w=64):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(xx / (4.0 + seed % 5) + c) * 90
                     + np.cos(yy / 6.0 - c) * 30 + 128 for c in range(3)],
                    -1) + rng.randint(0, 12, (h, w, 3))
    return np.clip(base, 0, 255).astype(np.uint8)


def _write(prefix, n=20, corrupt=()):
    """An indexed .rec of ``n`` JPEG records labelled ``i % 7``;
    ``corrupt`` records get a broken image (``"image"``) or a label vector
    cut short (``"label"``)."""
    rio = tmx.recordio
    rec = rio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(n):
        buf = rio.pack_img(rio.IRHeader(0, float(i % 7), i, 0), _image(i),
                           quality=95)
        if i in corrupt and corrupt[i] == "image":
            buf = buf[:rio._IR_SIZE] + b"\xff\xd8garbage" + buf[-40:]
        elif i in corrupt and corrupt[i] == "label":
            buf = rio.pack(rio.IRHeader(5, 0.0, i, 0), b"")[:rio._IR_SIZE] \
                + np.float32([1.0, 2.0]).tobytes()
        rec.write_idx(i, buf)
    rec.close()
    return prefix + ".rec"


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    return _write(str(tmp_path_factory.mktemp("rec") / "train"))


def _batches(it, n=None):
    out = []
    for b in it:
        out.append((b.data[0].asnumpy(), b.label[0].asnumpy()))
        if n is not None and len(out) == n:
            break
    return out


def _same(a, b):
    assert len(a) == len(b) and len(a) > 0
    for (ad, al), (bd, bl) in zip(a, b):
        np.testing.assert_array_equal(ad, bd)
        np.testing.assert_array_equal(al, bl)


def _pair(path, **kw):
    kw.setdefault("data_shape", (3, 24, 24))
    kw.setdefault("batch_size", 4)
    with tmx.cpu():
        t = tmx.io.ImageRecordIter(path, **kw)
    return t, _jmx().io.ImageRecordIter(path, **kw)


@pytest.mark.parametrize("aug", sorted(AUGS))
def test_python_lane_matches_jax(rec, aug):
    t, j = _pair(rec, shuffle=True, use_native=False, seed=3, **AUGS[aug])
    assert t.lane == "python" and t.lane_reason == "use_native=False"
    for _ in range(2):
        got = _batches(t)
        _same(got, _batches(j))
        assert len(got) == 5 and got[0][0].dtype == np.float32
        t.reset()
        j.reset()


@pytest.mark.parametrize("indexed", [True, False])
def test_python_lane_num_parts_matches_jax(tmp_path, indexed):
    path = _write(str(tmp_path / "p"), n=18)
    if not indexed:
        os.remove(str(tmp_path / "p.idx"))
    parts = []
    for part in range(2):
        t, j = _pair(path, use_native=False, num_parts=2, part_index=part,
                     rand_crop=True)
        got = _batches(t)
        _same(got, _batches(j))
        parts.append(np.concatenate([lab for _, lab in got]))
    # two disjoint shards: the even records, then the odd ones
    np.testing.assert_array_equal(parts[0], np.arange(0, 16, 2) % 7)
    np.testing.assert_array_equal(parts[1], np.arange(1, 17, 2) % 7)
    with pytest.raises(MXNetError, match="part_index"):
        _pair(path, num_parts=2, part_index=2)


def test_reset_mid_epoch_drains_and_matches_jax(rec):
    t, j = _pair(rec, shuffle=True, use_native=False, prefetch_buffer=3,
                 **RECIPE)
    _same(_batches(t, 1), _batches(j, 1))
    t.reset()
    j.reset()
    _same(_batches(t), _batches(j))
    assert t._prefetch and all(f is None for f in t._prefetch)


def test_corrupt_records_give_the_jax_zeros(tmp_path):
    path = _write(str(tmp_path / "bad"), n=8,
                  corrupt={2: "image", 5: "label"})
    for lane in (False, None):
        if lane is None and native.load() is None:
            continue
        t, j = _pair(path, use_native=lane, preprocess_threads=1)
        got = _batches(t)
        _same(got, _batches(j))
        data, labels = np.concatenate([d for d, _ in got]), \
            np.concatenate([lab for _, lab in got])
        assert not data[2].any() and not data[5].any()
        assert labels[2] == 2.0 and labels[5] == 0.0


@pytest.mark.parametrize("aug", sorted(AUGS))
def test_native_lane_matches_jax(rec, aug, native_lib):
    threads = 3 if aug == "center" else 1
    t, j = _pair(rec, shuffle=True, preprocess_threads=threads, seed=5,
                 **AUGS[aug])
    assert t.lane == "native" and j._native is not None
    for _ in range(2):
        got = _batches(t)
        _same(got, _batches(j))
        assert len(got) == 5
        t.reset()
        j.reset()


def test_lane_rule_and_errors(rec, monkeypatch, caplog):
    """The native lane needs the library, an index and JPEG records;
    ``use_native=True`` without it raises, a CUDA context without a card
    raises, and a decode worker's exception reaches the consumer."""
    with caplog.at_level(logging.INFO, logger="mxnet_tpu_torch.io.io"):
        t, _ = _pair(rec, use_native=False)
    assert "the python decode lane (use_native=False)" in caplog.text
    monkeypatch.setattr(native, "load", lambda: None)
    monkeypatch.setattr(native, "load_error", lambda: "jpeglib.h: missing")
    with tmx.cpu():
        t = tmx.io.ImageRecordIter(rec, (3, 24, 24), 4)
        assert t.lane == "python"
        assert t.lane_reason == ("native IO library unavailable: "
                                 "jpeglib.h: missing")
        with pytest.raises(MXNetError, match="requested but unavailable: "
                           "native IO library unavailable: jpeglib.h"):
            tmx.io.ImageRecordIter(rec, (3, 24, 24), 4, use_native=True)
        with pytest.raises(MXNetError, match="unavailable"):
            tmx.recordio.NativeIndexedRecordIO(rec + ".x.idx", rec + ".x",
                                               "w")
    monkeypatch.undo()
    stream = rec[:-4] + "-stream.rec"
    with open(rec, "rb") as src, open(stream, "wb") as dst:
        dst.write(src.read())
    with tmx.cpu():
        t = tmx.io.ImageRecordIter(stream, (3, 24, 24), 4)
        assert (t.lane, t.lane_reason) == (
            "python", "no .idx index beside the records")
        with pytest.raises(MXNetError, match="no .idx index"):
            tmx.io.ImageRecordIter(stream, (3, 24, 24), 4, use_native=True)
    if not tmx.num_gpus():
        with tmx.gpu(0):
            with pytest.raises(MXNetError, match="CUDA device"):
                tmx.io.ImageRecordIter(rec, (3, 24, 24), 4)

    class Boom(RuntimeError):
        pass

    def boom(img, rng):
        raise Boom("augment failed")

    with tmx.cpu():
        t = tmx.io.ImageRecordIter(rec, (3, 24, 24), 4, use_native=False,
                                   prefetch_buffer=1)
    t._augment = boom
    t.reset()
    with pytest.raises(Boom):
        t.next()


def test_loader_keeps_the_build_error(tmp_path, monkeypatch, caplog):
    """A library that cannot be built is unavailable, and the compiler's own
    message is kept and logged once by ``utils.native``."""
    (tmp_path / "src").mkdir()
    (tmp_path / "src" / "bad.cc").write_text(
        "#include <no_such_header_for_this_test.h>\n")
    monkeypatch.setattr(libloader, "repo_root", lambda: str(tmp_path))
    monkeypatch.setitem(libloader._SOURCES, "libbad.so", ("bad.cc", ["-lm"]))
    assert libloader.load_native_lib("libbad.so") is None
    assert "no_such_header_for_this_test.h" in libloader.load_error(
        "libbad.so")
    monkeypatch.setattr(native, "SO_NAME", "libbad.so")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    with caplog.at_level(logging.WARNING, logger="mxnet_tpu_torch.utils.native"):
        assert native.load() is None
        assert native.load() is None
    assert len(caplog.records) == 1
    assert "no_such_header" in native.load_error()


def test_native_indexed_recordio_is_byte_identical(tmp_path, native_lib):
    jmx = _jmx()
    rio = tmx.recordio
    magic = np.uint32(rio.KMAGIC).tobytes()
    payloads = [b"", b"abc", magic * 3 + b"tail", b"x" * 4096,
                rio.pack_img(rio.IRHeader(0, 1.0, 9, 0), _image(9))]
    files = {}
    for name, cls in (("py", rio.MXIndexedRecordIO),
                      ("native", rio.NativeIndexedRecordIO),
                      ("jax", jmx.recordio.NativeIndexedRecordIO)):
        w = cls(str(tmp_path / f"{name}.idx"), str(tmp_path / f"{name}.rec"),
                "w")
        for i, p in enumerate(payloads):
            w.write_idx(i, p)
        w.close()
        files[name] = [open(tmp_path / f"{name}.{ext}", "rb").read()
                       for ext in ("rec", "idx")]
    assert files["native"] == files["py"] == files["jax"]
    r = rio.MXIndexedRecordIO(str(tmp_path / "native.idx"),
                              str(tmp_path / "native.rec"), "r")
    assert [r.read_idx(i) for i in range(len(payloads))] == payloads
    with pytest.raises(MXNetError, match="write"):
        rio.NativeIndexedRecordIO(str(tmp_path / "r.idx"),
                                  str(tmp_path / "native.rec"), "r")
    w = rio.NativeIndexedRecordIO(str(tmp_path / "c.idx"),
                                  str(tmp_path / "c.rec"), "w")
    w.close()
    with pytest.raises(MXNetError, match="closed"):
        w.write_idx(0, b"x")


def _jax_im2rec():
    spec = importlib.util.spec_from_file_location(
        "_jax_im2rec", os.path.join(ROOT, "tools", "im2rec.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("mode", ["plain", "resize_gray", "pack_label",
                                  "native"])
def test_im2rec_outputs_are_byte_identical(tmp_path, monkeypatch, request,
                                           mode):
    from PIL import Image

    from mxnet_tpu_torch.tools import im2rec

    if mode == "native":
        request.getfixturevalue("native_lib")
    root = tmp_path / "images"
    for i in range(6):
        (root / f"k{i % 3}").mkdir(parents=True, exist_ok=True)
        Image.fromarray(_image(i)).save(root / f"k{i % 3}" / f"{i}.jpg")
    ref = _jax_im2rec()
    out = {}
    for name, mod in (("port", im2rec), ("jax", ref)):
        prefix = str(tmp_path / name)
        if mode == "pack_label":
            rows = [f"{i}\t2\t5\t{i % 3}\t0.1\t0.2\t0.6\t0.7\tk{i % 3}/{i}.jpg"
                    for i in range(6)]
            with open(prefix + ".lst", "w") as f:
                f.write("\n".join(rows) + "\n")
        elif name == "port":
            # the command line, as a user runs it
            monkeypatch.setattr(sys, "argv", ["im2rec", prefix, str(root),
                                              "--list", "--recursive"])
            im2rec.main()
        else:
            mod.make_list(prefix, str(root), recursive=True)
        mod.pack(prefix, str(root), quality=90,
                 resize=32 if mode == "resize_gray" else 0,
                 color=0 if mode == "resize_gray" else 1,
                 pack_label=mode == "pack_label", native=mode == "native")
        out[name] = [open(prefix + ext, "rb").read()
                     for ext in (".lst", ".rec", ".idx")]
    assert out["port"] == out["jax"]
    assert out["port"][0].count(b"\n") == 6


@pytest.mark.gpu
def test_image_record_iter_on_the_card_equals_the_host_iterator(tmp_path):
    """Batches on gpu(0) (decoded into pinned blocks, copied on the copy
    stream) equal the cpu() iterator's bit for bit, over two epochs."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine with -m gpu")
    path = _write(str(tmp_path / "g"), n=40)
    store = tmx.storage.Storage.get()
    live, hits = store.stats()["pinned_live"], store.stats()["pinned_hits"]
    kw = dict(data_shape=(3, 32, 32), batch_size=8, shuffle=True,
              preprocess_threads=1, **RECIPE)
    with tmx.gpu(0):
        g = tmx.io.ImageRecordIter(path, **kw)
    with tmx.cpu():
        c = tmx.io.ImageRecordIter(path, **kw)
    assert g.lane == c.lane
    for epoch in range(2):
        if epoch:
            g.reset()
            c.reset()
        got = [(b.data[0], b.label[0]) for b in g]
        assert all(x.context == tmx.gpu(0) and x.data.is_cuda
                   for pair in got for x in pair)
        _same([(x.asnumpy(), y.asnumpy()) for x, y in got], _batches(c))
    # at the end of an epoch nothing is in flight: every pinned block is
    # back in the pool (or waiting for its copy's event), and the second
    # epoch reused the first's
    stats = store.stats()
    assert stats["pinned_live"] == live and stats["pinned_hits"] > hits
