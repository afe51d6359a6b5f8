"""``mx.io`` of the PyTorch port (the iterators, ``recordio``) and the numpy
stream of ``mx.random`` against the JAX package.

The iterators read numpy arrays and files the tests write (idx, CSV,
libsvm); batches are compared exactly, with ``num_parts``/``part_index``
and their errors.  After the same ``mx.random.seed`` a shuffled
``NDArrayIter`` gives the same order in both packages.  RecordIO files
written by either package are byte-identical and read back by the other.
Batches of the port's iterators are NDArrays on the context that was
current where the iterator was built: the tests build them under
``with mx.cpu():``.
"""
import json
import logging
import os

import numpy as np
import pytest

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

from test_torch_data import write_mnist

CPU = tmx.cpu()


def _jmx():
    import mxnet_tpu as jmx

    return jmx


def _batches(it, n=None):
    out = []
    for b in it:
        out.append(([d.asnumpy() for d in b.data],
                    [l.asnumpy() for l in (b.label or [])], b.pad))
        if n is not None and len(out) == n:
            break
    return out


def _same_batches(a, b):
    assert len(a) == len(b)
    for (ad, al, ap), (bd, bl, bp) in zip(a, b):
        assert ap == bp
        for x, y in zip(ad + al, bd + bl):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("last", ["pad", "discard", "roll_over"])
def test_ndarray_iter_matches_jax(last):
    jmx = _jmx()
    rng = np.random.RandomState(0)
    x = rng.rand(11, 3).astype(np.float32)
    y = rng.randint(0, 4, 11).astype(np.float32)
    with tmx.cpu():
        t = tmx.io.NDArrayIter(x, y, batch_size=4, last_batch_handle=last)
        got = _batches(t)
    t.reset()
    assert t.next().data[0].context == CPU  # the context it was built in
    j = jmx.io.NDArrayIter(x, y, batch_size=4, last_batch_handle=last)
    _same_batches(got, _batches(j))
    assert [d.shape for d in t.provide_data] == \
        [d.shape for d in j.provide_data]


def test_shuffled_ndarray_iter_order_matches_jax_after_seed():
    jmx = _jmx()
    x = np.arange(40, dtype=np.float32).reshape(20, 2)
    y = np.arange(20, dtype=np.float32)
    for seed in (0, 7, 2**31 + 5):
        tmx.random.seed(seed)
        jmx.random.seed(seed)
        with tmx.cpu():
            t = tmx.io.NDArrayIter({"data": x}, {"lbl": y}, batch_size=6,
                                   shuffle=True)
            got = _batches(t)
            t.reset()
            got += _batches(t)  # the second epoch reshuffles
        j = jmx.io.NDArrayIter({"data": x}, {"lbl": y}, batch_size=6,
                               shuffle=True)
        want = _batches(j)
        j.reset()
        want += _batches(j)
        _same_batches(got, want)
        assert not np.array_equal(got[0][1][0], y[:6])


def test_np_stream_state_roundtrip_and_jax_file():
    """get_state/set_state carry the numpy stream; a JAX package's state
    restores the numpy stream (same layout) and leaves the torch
    generators as they are, with a warning (ROADMAP caveat (f))."""
    jmx = _jmx()
    tmx.random.seed(11)
    tmx.random.np_rng().rand(3)
    snap = json.loads(json.dumps(tmx.random.get_state()))
    a = tmx.random.np_rng().rand(4)
    tmx.random.seed(12)
    tmx.random.set_state(snap)
    np.testing.assert_array_equal(tmx.random.np_rng().rand(4), a)
    jmx.random.seed(13)
    jmx.random.np_rng().rand(2)
    jstate = jmx.random.get_state()
    want = jmx.random.np_rng().rand(5)
    gen = tmx.random.generator("cpu")
    before = gen.get_state().clone()
    tmx.random.set_state(jstate)
    np.testing.assert_array_equal(tmx.random.np_rng().rand(5), want)
    assert bool((gen.get_state() == before).all())
    # and the other way: the JAX package restores the port's numpy stream
    tmx.random.seed(14)
    pstate = json.loads(json.dumps(tmx.random.get_state()))
    pwant = tmx.random.np_rng().rand(3)
    jmx.random.set_state(pstate)
    np.testing.assert_array_equal(jmx.random.np_rng().rand(3), pwant)


def test_a_jax_rng_state_warns_and_says_the_numpy_stream_is_restored(
        caplog):
    jmx = _jmx()
    jmx.random.seed(3)
    with caplog.at_level(logging.WARNING, "mxnet_tpu_torch.random"):
        tmx.random.set_state(jmx.random.get_state())
    assert "JAX package RNG state" in caplog.text
    assert "numpy stream is restored" in caplog.text


@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("flat", [False, True])
def test_mnist_iter_matches_jax(tmp_path, parts, flat):
    jmx = _jmx()
    write_mnist(str(tmp_path), 50, 3, train=False)
    img = str(tmp_path / "t10k-images-idx3-ubyte")
    lbl = str(tmp_path / "t10k-labels-idx1-ubyte")
    for part in range(parts):
        kw = dict(batch_size=8, shuffle=False, flat=flat, num_parts=parts,
                  part_index=part)
        with tmx.cpu():
            got = _batches(tmx.io.MNISTIter(img, lbl, **kw))
        _same_batches(got, _batches(jmx.io.MNISTIter(img, lbl, **kw)))
    for pkg in (tmx, jmx):
        with pytest.raises(Exception, match="need 0 <= part_index < "
                           "num_parts"):
            pkg.io.MNISTIter(img, lbl, num_parts=2, part_index=2)


def test_csv_iter_matches_jax(tmp_path):
    jmx = _jmx()
    rng = np.random.RandomState(4)
    data = rng.rand(13, 6).astype(np.float32)
    label = rng.randint(0, 3, 13).astype(np.float32)
    np.savetxt(tmp_path / "d.csv", data, delimiter=",")
    np.savetxt(tmp_path / "l.csv", label, delimiter=",")
    for parts, rb in ((1, True), (2, False), (3, True)):
        for part in range(parts):
            kw = dict(data_csv=str(tmp_path / "d.csv"), data_shape=(2, 3),
                      label_csv=str(tmp_path / "l.csv"), batch_size=4,
                      round_batch=rb, num_parts=parts, part_index=part)
            with tmx.cpu():
                got = _batches(tmx.io.CSVIter(**kw))
            _same_batches(got, _batches(jmx.io.CSVIter(**kw)))


def test_libsvm_iter_matches_jax(tmp_path):
    jmx = _jmx()
    rng = np.random.RandomState(5)
    lines = []
    for r in range(9):
        cols = sorted(rng.choice(10, rng.randint(1, 4), replace=False))
        lines.append(f"{r % 2} " + " ".join(
            f"{c}:{rng.rand():.4f}" for c in cols))
    (tmp_path / "d.svm").write_text("\n".join(lines) + "\n")
    for parts in (1, 2):
        for part in range(parts):
            kw = dict(data_libsvm=str(tmp_path / "d.svm"), data_shape=(10,),
                      batch_size=4, num_parts=parts, part_index=part)
            with tmx.cpu():
                tb = list(tmx.io.LibSVMIter(**kw))
            jb = list(jmx.io.LibSVMIter(**kw))
            assert len(tb) == len(jb)
            for a, b in zip(tb, jb):
                assert a.data[0].stype == "csr" and a.pad == b.pad
                np.testing.assert_array_equal(a.data[0].asnumpy(),
                                              b.data[0].asnumpy())
                np.testing.assert_array_equal(a.label[0].asnumpy(),
                                              b.label[0].asnumpy())
    (tmp_path / "bad.svm").write_text("1 2:0.5\n")
    (tmp_path / "bad.lbl").write_text("1\n0\n")
    with pytest.raises(MXNetError, match="row mismatch"):
        tmx.io.LibSVMIter(str(tmp_path / "bad.svm"), (4,),
                          label_libsvm=str(tmp_path / "bad.lbl"))


def test_prefetching_and_resize_iters_match_jax():
    jmx = _jmx()
    x = np.arange(30, dtype=np.float32).reshape(15, 2)
    with tmx.cpu():
        t = tmx.io.PrefetchingIter(tmx.io.NDArrayIter(x, batch_size=4))
        got = _batches(t)
        t.reset()
        got += _batches(t)
        r = tmx.io.ResizeIter(tmx.io.NDArrayIter(x, batch_size=4), 7)
        got_r = _batches(r)
    j = jmx.io.PrefetchingIter(jmx.io.NDArrayIter(x, batch_size=4))
    want = _batches(j)
    j.reset()
    want += _batches(j)
    _same_batches(got, want)
    _same_batches(got_r, _batches(jmx.io.ResizeIter(
        jmx.io.NDArrayIter(x, batch_size=4), 7)))
    assert len(got_r) == 7


def test_image_record_iters_raise_naming_part_2(tmp_path):
    """Slice 8, part 2 ported the image iterators (their parity is in
    test_torch_image.py and test_torch_image_record_iter.py); what they
    refuse, they refuse with the JAX package's errors."""
    missing = str(tmp_path / "x.rec")
    with tmx.cpu():
        with pytest.raises(FileNotFoundError):
            tmx.io.ImageRecordIter(path_imgrec=missing, data_shape=(3, 8, 8),
                                   batch_size=2)
        with pytest.raises(MXNetError, match="unsupported kwargs"):
            tmx.io.ImageDetRecordIter(path_imgrec=missing, batch_size=2,
                                      data_shape=(3, 8, 8), rand_blur=1)
    with pytest.raises(MXNetError, match="packer"):
        tmx.io.recordio.NativeIndexedRecordIO(str(tmp_path / "x.idx"),
                                              missing, "r")


# -- recordio -------------------------------------------------------------------


def _records(rng):
    magic = (0xCED7230A).to_bytes(4, "little")
    recs = [b"", b"a", b"abcd" * 3, rng.bytes(37),
            magic + b"xy" + magic + b"1234" + magic,   # escaped chunks
            b"zz" + magic + b"q"]                       # unaligned: kept
    return recs


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_recordio_files_are_byte_identical_both_ways(tmp_path, writer):
    jmx = _jmx()
    rng = np.random.RandomState(6)
    recs = _records(rng)
    files = {}
    for name, rio in (("port", tmx.io.recordio), ("jax", jmx.io.recordio)):
        rec, idx = tmp_path / f"{name}.rec", tmp_path / f"{name}.idx"
        w = rio.MXIndexedRecordIO(str(idx), str(rec), "w")
        for i, r in enumerate(recs):
            w.write_idx(i, r)
        w.close()
        s = rio.MXRecordIO(str(tmp_path / f"{name}-seq.rec"), "w")
        for r in recs:
            s.write(r)
        s.close()
        files[name] = [p.read_bytes() for p in
                       (rec, idx, tmp_path / f"{name}-seq.rec")]
    assert files["port"] == files["jax"]
    reader = jmx.io.recordio if writer == "port" else tmx.io.recordio
    r = reader.MXIndexedRecordIO(str(tmp_path / f"{writer}.idx"),
                                 str(tmp_path / f"{writer}.rec"), "r")
    assert [r.read_idx(k) for k in r.keys] == recs
    r.close()
    s = reader.MXRecordIO(str(tmp_path / f"{writer}-seq.rec"), "r")
    assert [s.read() for _ in recs] == recs and s.read() is None


def test_pack_unpack_match_jax():
    jmx = _jmx()
    for header, payload in (((0, 3.0, 7, 0), b"payload"),
                            ((0, [1.0, 2.5, -3.0], 1, 2), b"xyz"),
                            ((0, np.float32(0.5), 4, 0), b"")):
        tb = tmx.io.recordio.pack(header, payload)
        assert tb == jmx.io.recordio.pack(header, payload)
        th, tp = tmx.io.recordio.unpack(tb)
        jh, jp = jmx.io.recordio.unpack(tb)
        assert tp == jp == payload
        assert th.flag == jh.flag and th.id == jh.id
        np.testing.assert_array_equal(th.label, jh.label)


def test_pack_img_matches_jax():
    pytest.importorskip("PIL")
    jmx = _jmx()
    img = np.random.RandomState(7).randint(0, 256, (6, 5, 3)) \
        .astype(np.uint8)
    for fmt in (".png", ".jpg"):
        tb = tmx.io.recordio.pack_img((0, 1.0, 2, 0), img, img_fmt=fmt)
        assert tb == jmx.io.recordio.pack_img((0, 1.0, 2, 0), img,
                                              img_fmt=fmt)
        for iscolor in (-1, 0, 1):
            th, ti = tmx.io.recordio.unpack_img(tb, iscolor)
            jh, ji = jmx.io.recordio.unpack_img(tb, iscolor)
            np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(
        tmx.io.recordio.unpack_img(
            tmx.io.recordio.pack_img((0, 1.0, 2, 0), img,
                                     img_fmt=".png"))[1], img)


def test_iterators_need_a_context_off_the_card(tmp_path):
    """Batches go to the default context: without a card and without
    ``with mx.cpu():`` the port raises instead of falling back."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    it = tmx.io.NDArrayIter(np.zeros((4, 2), np.float32), batch_size=2)
    with pytest.raises(MXNetError, match="no CUDA device is visible"):
        next(it)
    assert os.path.isdir(tmp_path)
