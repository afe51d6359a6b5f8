"""Checkpoints of the PyTorch port (``utils/serialization.py``,
``Block.save_parameters``/``load_parameters``, ``random.get_state``/
``set_state``, ``Trainer`` and ``DataParallelTrainer`` states, and
``checkpoint.CheckpointManager``), against the JAX package and against the
port's own uninterrupted runs.

Inputs are numpy from a seed.  The files of each kind move in both
directions: a ``.params`` container (byte-identical to the JAX package's
for the same arrays; bfloat16 bit for bit), a Trainer states pickle, a
``DataParallelTrainer`` npz pair and a ``CheckpointManager`` directory.

Tolerances.  A run resumed in the other package is held to that
package's uninterrupted run at 1e-6 absolute plus 1e-5 relative (float32
on both sides, the last steps' sums in other orders).  Model outputs
after a parameter file moved: the existing parity tests' limits (BERT
2e-5 absolute, ``tests/test_torch_bert_serve.py``; ResNet 1e-4 absolute
plus 1e-4 relative, ``tests/test_torch_resnet.py``).  Within the port a
resumed run is bit-identical to the uninterrupted one.

The ``gpu``-marked tests need the card (a captured step has no CPU mode)
and skip here; run them on the GPU machine with
``python -m pytest -m gpu --noconftest tests/test_torch_checkpoint.py``.
"""
import json
import logging
import os
import pickle
import signal
import struct
import time

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import checkpoint as tck
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import DataParallelTrainer
from mxnet_tpu_torch.utils import serialization as tser

CPU = tmx.cpu()
X = np.random.RandomState(1).rand(8, 16).astype(np.float32)
Y = np.random.RandomState(2).rand(8, 4).astype(np.float32)
OPTS = [("sgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 0.01}),
        ("adam", {"learning_rate": 0.01, "wd": 0.01})]
OPT_IDS = ["sgd_mom", "adam"]
ATOL, RTOL = 1e-6, 1e-5
VOCAB = 1000


def loss_fn(out, y):
    return (out - y) ** 2


def _mlp(pkg):
    net = pkg.gluon.nn.HybridSequential()
    for _ in range(2):
        net.add(pkg.gluon.nn.Dense(16, in_units=16, activation="relu"))
    net.add(pkg.gluon.nn.Dense(4, in_units=16))
    return net


def _port(opt="sgd", opt_args=None, seed=0, whole_step=False, ctx=CPU):
    """The MLP (Xavier from ``seed``) and its Trainer."""
    tmx.random.seed(seed)
    net = _mlp(tmx)
    net.initialize(tmx.init.Xavier(), ctx=ctx)
    args = dict(opt_args or OPTS[0][1])
    return net, tmx.gluon.Trainer(net.collect_params(), opt, args,
                                  whole_step=whole_step)


def _jax(opt, opt_args, seed=0):
    import mxnet_tpu as jmx

    jmx.random.seed(seed)
    net = _mlp(jmx)
    net.initialize(jmx.init.Xavier())
    return net, jmx.gluon.Trainer(net.collect_params(), opt, dict(opt_args),
                                  whole_step=True)


def _train(net, tr, n):
    return [float(tr.whole_step(net, loss_fn, X, Y).asnumpy())
            for _ in range(n)]


def _weights(net):
    out = {}
    for k, p in net._collect_params_with_prefix().items():
        v = p.data()
        out[k] = (v.detach().cpu().numpy().copy()
                  if isinstance(v, torch.Tensor) else v.asnumpy().copy())
    return out


def _assert_close(got, want, msg=""):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=RTOL,
                                   err_msg=f"{msg} {k}")


def _assert_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -- the .params container -------------------------------------------------------

DTYPES = ["float32", "float16", "int32", "int64", "uint8", "bool"]


def _arrays(dtype):
    rng = np.random.RandomState(0)
    return {"w": (rng.randn(3, 5) * 10).astype(dtype),
            "b": (rng.randn(4) * 10).astype(dtype),
            "s": np.asarray(rng.randn() * 10).astype(dtype)}


@pytest.mark.parametrize("dtype", DTYPES)
def test_params_files_are_byte_identical_and_load_in_both(dtype, tmp_path):
    """The same arrays make the same bytes in both packages (as a dict and
    as a list, from numpy arrays and from the port's NDArrays), and each
    package loads the other's file with the arrays' dtypes and values."""
    from mxnet_tpu.utils import serialization as jser

    arrays = _arrays(dtype)
    jf, tf = tmp_path / "j.params", tmp_path / "t.params"
    jser.save_ndarrays(str(jf), arrays)
    tmx.nd.save(str(tf), {k: tmx.nd.array(v, ctx=CPU)
                          for k, v in arrays.items()})
    assert jf.read_bytes() == tf.read_bytes()
    assert jser.dumps_ndarrays(list(arrays.values())) == \
        tser.dumps_ndarrays(list(arrays.values()))
    for k, v in tmx.nd.load(str(jf)).items():
        got = v.data.numpy()
        assert got.dtype == arrays[k].dtype and v.context == CPU
        np.testing.assert_array_equal(got, arrays[k])
    for k, v in jser.loads_ndarrays(tf.read_bytes()).items():
        assert v.dtype == arrays[k].dtype
        np.testing.assert_array_equal(v, arrays[k])


def test_bfloat16_moves_bit_exactly_between_packages(tmp_path):
    """JAX's bfloat16 (ml_dtypes) loads as a bfloat16 tensor with the same
    bits, and the port writes it back byte for byte, without a trip
    through float32; the port's numpy mode widens it to float32."""
    import ml_dtypes
    from mxnet_tpu.utils import serialization as jser

    words = np.random.RandomState(3).randint(
        -2**15, 2**15, size=(4, 6)).astype(np.int16)
    jf, tf = tmp_path / "j.params", tmp_path / "t.params"
    jser.save_ndarrays(str(jf), {"x": words.view(ml_dtypes.bfloat16)})
    t = tmx.nd.load(str(jf))["x"].data
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(), words)
    tser.save_ndarrays(str(tf), {"x": t})
    assert tf.read_bytes() == jf.read_bytes()
    back = jser.loads_ndarrays(tf.read_bytes())["x"]
    assert back.dtype == np.dtype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(back.view(np.int16), words)
    wide = tser.loads_ndarrays(tf.read_bytes())["x"]
    assert wide.dtype == np.float32
    np.testing.assert_array_equal(wide, t.float().numpy())


@pytest.mark.parametrize("damage,word", [("truncated", "truncated"),
                                         ("bad_magic", "bad magic"),
                                         ("newer", "newer")])
def test_damaged_params_files_raise_with_the_jax_wording(damage, word,
                                                         tmp_path):
    from mxnet_tpu.utils import serialization as jser

    good = tser.dumps_ndarrays({"a": np.ones((4, 4), np.float32)})
    if damage == "truncated":
        raw = good[:-5]
    elif damage == "bad_magic":
        raw = b"NOTMX1\n" + good[7:]
    else:
        m = json.dumps({"version": 99, "names": None,
                        "tensors": []}).encode()
        raw = tser._MAGIC + struct.pack("<Q", len(m)) + m
    f = tmp_path / "x.params"
    f.write_bytes(raw)
    with pytest.raises(MXNetError) as te:
        tser.load_ndarrays(str(f))
    with pytest.raises(Exception) as je:
        jser.load_ndarrays(str(f))
    assert str(te.value) == str(je.value)
    assert word in str(te.value)


# -- Block parameter files ---------------------------------------------------------


def _bert_inputs():
    rng = np.random.RandomState(0)
    ids = rng.randint(1, VOCAB, size=(3, 24)).astype(np.int32)
    return ids, np.zeros((3, 24), np.int32), np.array([24, 10, 1],
                                                      np.float32)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_bert_parameter_files_move_between_packages(direction, tmp_path):
    """A 2-layer, 64-unit BERT saved by one package and loaded by the
    other (other weights before the load) gives the same outputs."""
    import mxnet_tpu as jmx
    from mxnet_tpu.models.bert import bert_tiny as jbert_tiny

    kw = dict(vocab_size=VOCAB, use_decoder=False, use_classifier=False)
    jmx.random.seed(11)
    jnet = jbert_tiny(**kw)
    jnet.initialize()
    tmx.random.seed(5)
    tnet = tmx.models.bert_tiny(**kw)
    tnet.initialize(ctx=CPU)
    ids, types, valid = _bert_inputs()

    def jrun():
        return jnet(jmx.nd.array(ids, dtype="int32"),
                    jmx.nd.array(types, dtype="int32"), jmx.nd.array(valid))

    def trun():
        return tnet(tmx.nd.array(ids, ctx=CPU), tmx.nd.array(types, ctx=CPU),
                    tmx.nd.array(valid, ctx=CPU))

    # the saving side completes its deferred shapes first; the loading
    # side takes them from the file
    f = str(tmp_path / "bert.params")
    if direction == "jax_to_port":
        jrun()
        jnet.save_parameters(f)
        tnet.load_parameters(f)
    else:
        trun()
        tnet.save_parameters(f)
        jnet.load_parameters(f)
    (jseq, jpool), (tseq, tpool) = jrun(), trun()
    np.testing.assert_allclose(tseq.asnumpy(), jseq.asnumpy(), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(tpool.asnumpy(), jpool.asnumpy(), atol=2e-5,
                               rtol=0)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_resnet18_parameter_files_move_between_packages(direction,
                                                         tmp_path):
    """``resnet18_v1`` at 32^2 in predict mode: the loading side starts
    with deferred shapes, which the file completes."""
    import mxnet_tpu as jmx
    from mxnet_tpu.gluon.model_zoo.vision import resnet18_v1 as jresnet18

    x = np.random.RandomState(4).rand(2, 3, 32, 32).astype(np.float32)
    jmx.random.seed(2)
    jnet = jresnet18(classes=10)
    jnet.initialize(jmx.init.Xavier())
    tmx.random.seed(3)
    tnet = tmx.gluon.model_zoo.vision.resnet18_v1(classes=10)
    tnet.initialize(tmx.init.Xavier(), ctx=CPU)
    f = str(tmp_path / "r18.params")
    if direction == "jax_to_port":
        jnet(jmx.nd.array(x))
        jnet.save_parameters(f)
        tnet.load_parameters(f)
    else:
        tnet(tmx.nd.array(x, ctx=CPU))
        tnet.save_parameters(f)
        jnet.load_parameters(f)
    jout = jnet(jmx.nd.array(x)).asnumpy()
    tout = tnet(tmx.nd.array(x, ctx=CPU)).asnumpy()
    np.testing.assert_allclose(tout, jout, atol=1e-4, rtol=1e-4)


def test_load_parameters_raises_for_missing_extra_and_int8_files(tmp_path):
    net = tmx.gluon.nn.Dense(4, in_units=3, prefix="fc_")
    net.initialize(ctx=CPU)
    w = np.arange(12, dtype=np.float32).reshape(4, 3)
    b = np.ones(4, np.float32)
    f = str(tmp_path / "p.params")
    tmx.nd.save(f, {"weight": w})
    with pytest.raises(MXNetError, match="missing parameter bias"):
        net.load_parameters(f)
    net.load_parameters(f, allow_missing=True)
    np.testing.assert_array_equal(net.weight.data().detach().numpy(), w)
    tmx.nd.save(f, {"weight": w, "bias": b, "gamma": b})
    with pytest.raises(MXNetError, match="extra parameters"):
        net.load_parameters(f)
    net.load_parameters(f, ignore_extra=True)
    tmx.nd.save(f, {"qweight": w.astype(np.int8), "bias": b})
    with pytest.raises(MXNetError, match="INT8-quantized parameters"):
        net.load_parameters(f)
    # names with the full prefix load through the fallback
    tmx.nd.save(f, {"fc_weight": w * 2, "fc_bias": b * 3})
    net.load_parameters(f)
    np.testing.assert_array_equal(net.bias.data().detach().numpy(), b * 3)


def test_export_raises_naming_its_slice():
    net = tmx.gluon.nn.Dense(4, in_units=3)
    net.initialize(ctx=CPU)
    with pytest.raises(MXNetError, match="slice 9"):
        net.export("model")


# -- Trainer states across the packages ------------------------------------------


@pytest.mark.parametrize("opt,opt_args", OPTS, ids=OPT_IDS)
def test_jax_trainer_states_resume_in_the_port(opt, opt_args, tmp_path):
    """JAX trains 3 steps and saves its parameters and states; the port
    loads them into a net with other weights and trains 2 more: held to
    JAX's 5 uninterrupted steps."""
    jnet, jtr = _jax(opt, opt_args)
    for _ in range(3):
        jtr.whole_step(jnet, loss_fn, X, Y)
    p, s = str(tmp_path / "m.params"), str(tmp_path / "m.states")
    jnet.save_parameters(p)
    jtr.save_states(s)
    jl = [float(jtr.whole_step(jnet, loss_fn, X, Y).asnumpy())
          for _ in range(2)]
    tnet, ttr = _port(opt, opt_args, seed=7)
    tnet.load_parameters(p)
    ttr.load_states(s)
    assert ttr._optimizer.num_update == 3
    tl = _train(tnet, ttr, 2)
    np.testing.assert_allclose(tl, jl, atol=ATOL, rtol=RTOL)
    _assert_close(_weights(tnet), _weights(jnet))


@pytest.mark.parametrize("opt,opt_args", OPTS, ids=OPT_IDS)
def test_port_trainer_states_resume_in_jax(opt, opt_args, tmp_path):
    tnet, ttr = _port(opt, opt_args)
    _train(tnet, ttr, 3)
    p, s = str(tmp_path / "m.params"), str(tmp_path / "m.states")
    tnet.save_parameters(p)
    ttr.save_states(s)
    with open(s, "rb") as f:
        blob = pickle.load(f)
    assert blob["version"] == tmx.gluon.Trainer.STATES_FORMAT_VERSION
    assert all(isinstance(leaf, np.ndarray) for st in blob["states"].values()
               for v in st.values()
               for leaf in (v if isinstance(v, tuple) else (v,)))
    tl = _train(tnet, ttr, 2)
    jnet, jtr = _jax(opt, opt_args, seed=9)
    jnet.load_parameters(p)
    jtr.load_states(s)
    jl = [float(jtr.whole_step(jnet, loss_fn, X, Y).asnumpy())
          for _ in range(2)]
    np.testing.assert_allclose(jl, tl, atol=ATOL, rtol=RTOL)
    _assert_close(_weights(jnet), _weights(tnet))


def test_trainer_states_versions_and_later_slices(tmp_path):
    """The round-0 layout loads, an unrecognized or newer blob is
    rejected with the JAX wording, blobs of what the distributed slice's
    part 2 brings raise naming it, and a kvstore-side updater's blob
    raises on a Trainer that updates locally, as in the JAX package."""
    net, tr = _port()
    _train(net, tr, 1)
    tr.load_states_dict({"states": {}, "num_update": 7,
                         "index_update_count": {}})
    assert tr._optimizer.num_update == 7
    with pytest.raises(MXNetError, match="unversioned"):
        tr.load_states_dict({"weights": []})
    with pytest.raises(MXNetError, match="v99"):
        tr.load_states_dict({"version": 99, "states": {}})
    for key, match in (("zero", "distributed slice"),
                       ("kvstore", "kvstore-side updater"),
                       ("mesh_shape", "distributed slice")):
        blob = dict(tr.states_dict(), **{key: {"x": 1}})
        with pytest.raises(MXNetError, match=match):
            tr.load_states_dict(blob)
    bad = tr.states_dict()
    bad["states"][0] = {"cpu(0)": np.zeros((3, 3), np.float32)}
    before = tr.states_dict()
    with pytest.raises(MXNetError, match="shapes"):
        tr.load_states_dict(bad)
    after = tr.states_dict()
    assert after["num_update"] == before["num_update"]
    f = str(tmp_path / "t.states")
    tr.save_states(f)
    tr.save_states(f)
    assert [n for n in os.listdir(tmp_path) if ".tmp" in n] == []


# -- within the port, bit for bit --------------------------------------------------


def test_states_dict_roundtrip_across_whole_step_and_eager_restart():
    """``tests/test_whole_step.py``'s round trip: 3 whole steps, a
    snapshot, 2 eager steps from it equal 5 uninterrupted steps, and
    back."""
    opt_args = {"learning_rate": 0.01, "wd": 0.01}
    cont_net, cont_tr = _port("adam", opt_args, whole_step=True)
    _train(cont_net, cont_tr, 5)
    a_net, a_tr = _port("adam", opt_args, whole_step=True)
    _train(a_net, a_tr, 3)
    blob = a_tr.states_dict()
    b_net, b_tr = _port("adam", opt_args, seed=4, whole_step=False)
    for src, dst in zip(a_net.collect_params().values(),
                        b_net.collect_params().values()):
        dst.set_data(src.data())
    b_tr.load_states_dict(blob)
    _train(b_net, b_tr, 2)
    _assert_equal(_weights(b_net), _weights(cont_net))
    blob2 = b_tr.states_dict()
    c_net, c_tr = _port("adam", opt_args, seed=5, whole_step=True)
    for src, dst in zip(b_net.collect_params().values(),
                        c_net.collect_params().values()):
        dst.set_data(src.data())
    c_tr.load_states_dict(blob2)
    _train(c_net, c_tr, 2)
    cont2_net, cont2_tr = _port("adam", opt_args, whole_step=True)
    _train(cont2_net, cont2_tr, 7)
    _assert_equal(_weights(c_net), _weights(cont2_net))


@pytest.mark.parametrize("whole_step", [True, False])
def test_checkpoint_manager_roundtrip_across_restart(whole_step, tmp_path):
    net_a, tr_a = _port("adam", {"learning_rate": 0.01}, whole_step=True)
    _train(net_a, tr_a, 3)
    tck.CheckpointManager(str(tmp_path), keep_n=2).save(
        3, params=net_a, trainer=tr_a, sync=True)
    net_b, tr_b = _port("adam", {"learning_rate": 0.01}, seed=8,
                        whole_step=whole_step)
    meta = tck.CheckpointManager(str(tmp_path), keep_n=2).restore(
        params=net_b, trainer=tr_b)
    assert meta["step"] == 3
    _train(net_b, tr_b, 2)
    cont_net, cont_tr = _port("adam", {"learning_rate": 0.01},
                              whole_step=True)
    _train(cont_net, cont_tr, 5)
    _assert_equal(_weights(net_b), _weights(cont_net))


# -- DataParallelTrainer checkpoints ---------------------------------------------


def _dp_net(pkg):
    """Explicit prefixes: the checkpoint keys hold the full parameter
    names, which then agree between the packages."""
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="net_")
    net.add(nn.Conv2D(8, 3, padding=1, use_bias=False, layout="NHWC",
                      prefix="c0_"),
            nn.BatchNorm(axis=-1, prefix="bn0_"), nn.Activation("relu"),
            nn.GlobalAvgPool2D(layout="NHWC"), nn.Flatten(),
            nn.Dense(5, prefix="fc_"))
    return net


def _dp_data():
    rng = np.random.RandomState(21)
    return (rng.rand(8, 8, 8, 3).astype(np.float32),
            rng.randint(0, 5, 8).astype(np.float32))


DP_OPT = ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4})


def _jax_dp(x, weights=None):
    import jax
    import mxnet_tpu as jmx
    from mxnet_tpu.parallel import data_parallel as jdp
    from mxnet_tpu.parallel import mesh as jmesh

    jmx.random.seed(1)
    net = _dp_net(jmx)
    net.initialize(jmx.init.Xavier())
    net(jmx.nd.array(x[:2]))
    if weights is not None:
        for k, p in net._collect_params_with_prefix().items():
            p.set_data(jmx.nd.array(weights[k]))
    return net, jdp.DataParallelTrainer(
        net, jmx.gluon.loss.SoftmaxCrossEntropyLoss(), DP_OPT[0],
        dict(DP_OPT[1]), mesh=jmesh.make_mesh(devices=jax.devices()[:1]))


def _port_dp(weights=None, seed=1, ctx=CPU, **kw):
    tmx.random.seed(seed)
    net = _dp_net(tmx)
    net.initialize(tmx.init.Xavier(), ctx=ctx)
    if weights is not None:
        tmx.load_numpy_params(net, weights)
    return net, DataParallelTrainer(
        net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), DP_OPT[0],
        dict(DP_OPT[1]), **kw)


def test_data_parallel_checkpoints_move_between_packages(tmp_path):
    """JAX's trainer (one-device mesh) and the port's write the same keys
    and mesh metadata; each resumes the other's checkpoint after 3 steps,
    and 2 more steps are held to the writer's uninterrupted 5 (moving
    statistics included)."""
    import jax
    from mxnet_tpu.parallel import mesh as jmesh

    x, y = _dp_data()
    jnet, jtr = _jax_dp(x)
    start = {k: p.data().asnumpy().copy()
             for k, p in jnet._collect_params_with_prefix().items()}
    tnet, ttr = _port_dp(start)
    for _ in range(3):
        jtr.step(x, y)
        ttr.step(x, y)
    jp, tp = str(tmp_path / "jax"), str(tmp_path / "port")
    jtr.save_states(jp)
    assert ttr.save_states(tp, async_save=True).result() is None
    jz, tz = np.load(f"{jp}-shards-p0.npz"), np.load(f"{tp}-shards-p0.npz")
    assert sorted(jz.files) == sorted(tz.files)
    for k in jz.files:
        assert jz[k].shape == tz[k].shape and jz[k].dtype == tz[k].dtype, k
    jm, tm = np.load(f"{jp}-meta.npz"), np.load(f"{tp}-meta.npz")
    assert sorted(jm.files) == sorted(tm.files)
    mesh = jmesh.make_mesh(devices=jax.devices()[:1])
    assert list(tm["mesh_axes"]) == list(mesh.axis_names)
    assert list(tm["mesh_shape"]) == [mesh.shape[a] for a in mesh.axis_names]
    assert int(tm["t"]) == int(jm["t"]) == 3
    jl = [float(jtr.step(x, y).asnumpy()) for _ in range(2)]
    tl = [float(ttr.step(x, y).asnumpy()) for _ in range(2)]
    jtr.sync_to_block()
    ttr.sync_to_block()
    # the port resumes JAX's checkpoint, and JAX the port's
    rnet, rtr = _port_dp(seed=5)
    rtr.build(x)
    rtr.load_states(jp)
    rl = [float(rtr.step(x, y).asnumpy()) for _ in range(2)]
    rtr.sync_to_block()
    np.testing.assert_allclose(rl, jl, atol=ATOL, rtol=RTOL)
    _assert_close(_weights(rnet), _weights(jnet), "port from jax")
    qnet, qtr = _jax_dp(x)
    qtr.build(x)
    qtr.load_states(tp)
    ql = [float(qtr.step(x, y).asnumpy()) for _ in range(2)]
    qtr.sync_to_block()
    np.testing.assert_allclose(ql, tl, atol=ATOL, rtol=RTOL)
    _assert_close(_weights(qnet), _weights(tnet), "jax from port")


def test_data_parallel_restore_is_bit_identical_within_the_port(tmp_path):
    x, y = _dp_data()
    _, a = _port_dp()
    for _ in range(3):
        a.step(x, y)
    prefix = str(tmp_path / "dp")
    fut = a.save_states(prefix, async_save=True)
    cont = [a.step(x, y).asnumpy() for _ in range(3)]
    fut.result()
    _, b = _port_dp(seed=6)
    b.build(x)
    params_before = list(b._params)
    b.load_states(prefix)
    assert all(p is q for p, q in zip(b._params, params_before))
    assert b._t == 3
    resumed = [b.step(x, y).asnumpy() for _ in range(3)]
    np.testing.assert_array_equal(resumed, cont)
    for p, q in zip(a._params, b._params):
        assert torch.equal(p, q)
    with pytest.raises(MXNetError, match="missing shard"):
        _, c = _port_dp()
        c.build(x[:, :, :, :2])   # another first conv: other shapes
        c.load_states(prefix)


# -- CheckpointManager -----------------------------------------------------------


def _draw(n=3):
    return torch.rand(n, generator=tmx.random.generator("cpu")).numpy()


def _states(tr):
    return [[t.clone() for t in (s if isinstance(s, tuple) else (s,))]
            for s in tr._states]


def test_save_kill_restore_roundtrip(tmp_path):
    """Save, then a fresh net and trainer with other weights ("the killed
    run") restore: parameters, states, num_update and the next random
    draws are bit-identical, and so are the next steps."""
    net, tr = _port(seed=7)
    _train(net, tr, 3)
    mgr = tck.CheckpointManager(str(tmp_path), keep_n=3)
    mgr.save(3, params=net, trainer=tr, epoch=1, extra={"lr": 0.1})
    mgr.wait_until_finished()
    w_saved, st_saved = _weights(net), _states(tr)
    cont_losses = _train(net, tr, 2)
    cont_draw = _draw()
    net2, tr2 = _port(seed=999)
    _draw()
    meta = tck.CheckpointManager(str(tmp_path)).restore(params=net2,
                                                        trainer=tr2)
    assert meta["step"] == 3 and meta["epoch"] == 1
    assert meta["extra"] == {"lr": 0.1} and meta["params"] is None
    _assert_equal(_weights(net2), w_saved)
    assert tr2._optimizer.num_update == 3
    for a, b in zip(_states(tr2), st_saved):
        assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert _train(net2, tr2, 2) == cont_losses
    np.testing.assert_array_equal(_draw(), cont_draw)


def test_uncommitted_save_never_latest(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path), keep_n=5)
    mgr.save(4, params={"w": tmx.nd.zeros((2, 2), ctx=CPU)}, sync=True)
    os.makedirs(str(tmp_path / "ckpt-00000009.tmp"))
    os.makedirs(str(tmp_path / "ckpt-00000010"))
    assert mgr.latest() == 4 and mgr.steps() == [4]
    with pytest.raises(MXNetError, match="missing or uncommitted"):
        mgr.restore(step=10)
    assert tck.latest(str(tmp_path)) == 4
    assert tck.latest(str(tmp_path / "nope")) is None
    with pytest.raises(MXNetError, match="no committed checkpoint"):
        tck.CheckpointManager(str(tmp_path / "empty")).restore()


def test_resave_same_step_never_loses_committed_copy(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path), keep_n=3)
    mgr.save(5, params={"w": torch.ones(2)}, sync=True)
    mgr.save(5, params={"w": torch.ones(2) * 2}, sync=True)
    tgt = {"w": tmx.nd.zeros((2,), ctx=CPU)}
    mgr.restore(step=5, params=tgt)
    np.testing.assert_array_equal(tgt["w"].asnumpy(), [2.0, 2.0])
    assert not os.path.exists(str(tmp_path / "ckpt-00000005.old"))
    os.rename(str(tmp_path / "ckpt-00000005"),
              str(tmp_path / "ckpt-00000005.old"))
    assert tck.CheckpointManager(str(tmp_path)).latest() == 5


def test_keep_n_retention_and_tmp_gc(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path), keep_n=2)
    stale = tmp_path / "ckpt-00000001.tmp"
    os.makedirs(str(stale))
    for s in range(1, 6):
        mgr.save(s, params={"w": torch.ones(2) * s}, sync=True)
    assert mgr.steps() == [4, 5]
    assert not stale.exists()
    tgt = {"w": torch.zeros(2)}
    mgr.restore(params=tgt)
    assert torch.equal(tgt["w"], torch.full((2,), 5.0))


def test_async_error_surfaces_at_wait_until_finished(tmp_path, monkeypatch):
    """A failure of the writer surfaces at the barrier, never silently; a
    failed save never commits, and the next save succeeds."""
    real = tser.save_ndarrays

    def boom(fname, data):
        raise RuntimeError("boom: disk-side serialization failure")

    monkeypatch.setattr(tser, "save_ndarrays", boom)
    mgr = tck.CheckpointManager(str(tmp_path), keep_n=2)
    mgr.save(1, params={"w": torch.ones(2)})
    with pytest.raises(RuntimeError, match="boom"):
        mgr.wait_until_finished()
    assert mgr.latest() is None
    monkeypatch.setattr(tser, "save_ndarrays", real)
    mgr.save(2, params={"w": torch.ones(2)}, sync=True)
    assert mgr.latest() == 2


def test_torn_snapshot_holds_the_values_at_save(tmp_path, monkeypatch):
    """With a slowed writer, every parameter and optimizer state is
    written in place right after ``save()`` returns (as a captured step
    writes them); the committed checkpoint holds the values of the call."""
    real = tser.save_ndarrays

    def slow(fname, data):
        time.sleep(0.3)
        real(fname, data)

    net, tr = _port(seed=2)
    _train(net, tr, 2)
    want_w, want_st = _weights(net), _states(tr)
    monkeypatch.setattr(tser, "save_ndarrays", slow)
    mgr = tck.CheckpointManager(str(tmp_path))
    mgr.save(2, params=net, trainer=tr)
    with torch.no_grad():
        for p in net.collect_params().values():
            p.data().add_(1000.0)
        for st in tr._states:
            for t in (st if isinstance(st, tuple) else (st,)):
                t.mul_(-3.0)
    mgr.wait_until_finished()
    net2, tr2 = _port(seed=3)
    mgr.restore(params=net2, trainer=tr2)
    _assert_equal(_weights(net2), want_w)
    for a, b in zip(_states(tr2), want_st):
        assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_sigterm_hook_final_save_and_chain(tmp_path):
    chained = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: chained.append(s))
    try:
        mgr = tck.CheckpointManager(str(tmp_path), keep_n=2)
        mgr.install_sigterm_hook(
            lambda: {"step": 3, "params": {"w": torch.ones(2)}})
        mgr.install_sigterm_hook(
            lambda: {"step": 11, "params": {"w": torch.ones(2)}})
        os.kill(os.getpid(), signal.SIGTERM)
        assert mgr.latest() == 11
        assert chained == [signal.SIGTERM]
        mgr.uninstall_sigterm_hook()
        os.kill(os.getpid(), signal.SIGTERM)
        assert chained == [signal.SIGTERM, signal.SIGTERM]
        assert mgr.latest() == 11
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_newer_checkpoint_format_is_rejected(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path))
    mgr.save(1, params={"w": torch.ones(2)}, sync=True)
    mpath = tmp_path / "ckpt-00000001" / tck.MANIFEST
    meta = json.loads(mpath.read_text())
    meta["format_version"] = 7
    mpath.write_text(json.dumps(meta))
    with pytest.raises(MXNetError, match="v7"):
        mgr.restore(step=1)


def test_corrupt_latest_falls_back_to_the_previous_step(tmp_path, caplog):
    mgr = tck.CheckpointManager(str(tmp_path), keep_n=3)
    for s in (1, 2):
        mgr.save(s, params={"w": torch.ones(3) * s}, sync=True)
    pfile = tmp_path / "ckpt-00000002" / "params-shard0.params"
    pfile.write_bytes(pfile.read_bytes()[:-4])
    tgt = {"w": torch.zeros(3)}
    with caplog.at_level(logging.ERROR, "mxnet_tpu_torch.checkpoint"):
        meta = mgr.restore(params=tgt)
    assert meta["step"] == 1 and torch.equal(tgt["w"], torch.ones(3))
    assert "corrupt, truncated" in caplog.text
    with pytest.raises(MXNetError, match="truncated"):
        mgr.restore(step=2, params=tgt)
    (tmp_path / "ckpt-00000001" / "params-shard0.params").write_bytes(b"x")
    with pytest.raises(MXNetError, match="every step failed"):
        mgr.restore(params=tgt)


def test_what_later_slices_bring_raises_naming_them(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path))
    with pytest.raises(MXNetError, match="slice 8"):
        mgr.save(1, params={"w": torch.ones(2)}, pipeline=object())
    with pytest.raises(MXNetError, match="slice 8"):
        mgr.restore(pipeline=object())
    mgr.save(1, params={"w": torch.ones(2)}, sync=True)
    mpath = tmp_path / "ckpt-00000001" / tck.MANIFEST
    meta = json.loads(mpath.read_text())
    meta["num_processes"] = 2
    mpath.write_text(json.dumps(meta))
    for strict in (False, True):
        with pytest.raises(MXNetError, match="slice 7"):
            mgr.restore(step=1, strict_topology=strict)
    net, tr = _port()
    _train(net, tr, 1)
    mgr.save(2, params=net, trainer=tr, sync=True)
    tfile = tmp_path / "ckpt-00000002" / "trainer-shard0.states"
    blob = pickle.loads(tfile.read_bytes())
    blob["zero"] = {"world": 2, "shards": {}}
    tfile.write_bytes(pickle.dumps(blob))
    with pytest.raises(MXNetError, match="distributed slice"):
        mgr.restore(step=2, params=net, trainer=tr)


def test_rng_state_roundtrip_in_place():
    gen = tmx.random.generator("cpu")
    tmx.random.seed(42)
    _draw()
    snap = json.loads(json.dumps(tmx.random.get_state()))
    a = _draw(4)
    tmx.random.seed(1)
    tmx.random.set_state(snap)
    assert tmx.random.generator("cpu") is gen
    np.testing.assert_array_equal(_draw(4), a)


def test_a_jax_rng_file_warns_and_leaves_the_generators(caplog):
    import mxnet_tpu as jmx

    jmx.random.seed(3)
    jstate = jmx.random.get_state()
    tmx.random.seed(4)
    want = torch.rand(3, generator=torch.Generator().manual_seed(4))
    with caplog.at_level(logging.WARNING, "mxnet_tpu_torch.random"):
        tmx.random.set_state(jstate)
    assert "JAX package RNG state" in caplog.text
    np.testing.assert_array_equal(_draw(), want.numpy())


# -- CheckpointManager directories across the packages ---------------------------


@pytest.mark.parametrize("opt,opt_args", OPTS, ids=OPT_IDS)
def test_checkpoint_directories_move_between_packages(opt, opt_args,
                                                      tmp_path):
    """A JAX-written checkpoint directory restored by the port and a
    port-written one restored by JAX (``restore_rng=False``: each
    package's RNG file is its own), each then trained 2 steps and held
    to the writer's 5 uninterrupted steps."""
    from mxnet_tpu import checkpoint as jck

    jnet, jtr = _jax(opt, opt_args)
    for _ in range(3):
        jtr.whole_step(jnet, loss_fn, X, Y)
    jck.CheckpointManager(str(tmp_path / "j")).save(
        3, params=jnet, trainer=jtr, sync=True)
    jl = [float(jtr.whole_step(jnet, loss_fn, X, Y).asnumpy())
          for _ in range(2)]
    tnet, ttr = _port(opt, opt_args, seed=3)
    meta = tck.CheckpointManager(str(tmp_path / "j")).restore(
        params=tnet, trainer=ttr, restore_rng=False)
    assert meta["step"] == 3
    np.testing.assert_allclose(_train(tnet, ttr, 2), jl, atol=ATOL,
                               rtol=RTOL)
    _assert_close(_weights(tnet), _weights(jnet), "port from jax")

    pnet, ptr = _port(opt, opt_args)
    _train(pnet, ptr, 3)
    tck.CheckpointManager(str(tmp_path / "t")).save(
        3, params=pnet, trainer=ptr, sync=True)
    pl = _train(pnet, ptr, 2)
    qnet, qtr = _jax(opt, opt_args, seed=4)
    jck.CheckpointManager(str(tmp_path / "t")).restore(
        params=qnet, trainer=qtr, restore_rng=False)
    ql = [float(qtr.whole_step(qnet, loss_fn, X, Y).asnumpy())
          for _ in range(2)]
    np.testing.assert_allclose(ql, pl, atol=ATOL, rtol=RTOL)
    _assert_close(_weights(qnet), _weights(pnet), "jax from port")


# -- on the card -----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a captured step has no CPU mode); "
                    "run on the GPU machine with -m gpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _dropout_mlp(seed):
    tmx.random.seed(seed)
    net = tmx.gluon.nn.HybridSequential()
    net.add(tmx.gluon.nn.Dense(64, in_units=16, activation="relu"),
            tmx.gluon.nn.Dropout(0.3), tmx.gluon.nn.Dense(4, in_units=64))
    net.initialize(tmx.init.Xavier(), ctx=tmx.gpu(0))
    return net, tmx.gluon.Trainer(net.collect_params(), "adam",
                                  {"learning_rate": 0.01},
                                  whole_step=True)


def _gpu_weights(net):
    return [p.data().detach().clone() for p in net.collect_params().values()]


@pytest.mark.gpu
def test_captured_step_resumes_bit_identically_on_card(cuda_device,
                                                       tmp_path):
    """Dropout on the captured whole step: 3 steps, an async save, 3 more
    while it drains (the reference); a net with other weights whose step is
    already captured, restored in place (weights, states, the generators
    its graph registered), replays steps 4-6 bit for bit."""
    xs, ys = torch.from_numpy(X).cuda(), torch.from_numpy(Y).cuda()
    net, tr = _dropout_mlp(0)
    for _ in range(3):
        tr.whole_step(net, loss_fn, xs, ys)
    mgr = tck.CheckpointManager(str(tmp_path))
    gen = tmx.random.generator(cuda_device)
    mgr.save(3, params=net, trainer=tr)
    ref = [tr.whole_step(net, loss_fn, xs, ys).data.clone()
           for _ in range(3)]
    mgr.wait_until_finished()
    ref_w = _gpu_weights(net)
    net2, tr2 = _dropout_mlp(5)
    for _ in range(2):   # warm-up and capture on the other weights
        tr2.whole_step(net2, loss_fn, xs, ys)
    c0 = tmx._imperative.graph_capture_count()
    mgr.restore(params=net2, trainer=tr2)
    assert tmx.random.generator(cuda_device) is gen
    got = [tr2.whole_step(net2, loss_fn, xs, ys).data.clone()
           for _ in range(3)]
    assert tmx._imperative.graph_capture_count() == c0   # replays only
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert all(torch.equal(a, b) for a, b in zip(_gpu_weights(net2), ref_w))


@pytest.mark.gpu
def test_torn_snapshot_on_card(cuda_device, tmp_path, monkeypatch):
    """Captured steps write the weights in place right after ``save()``
    returns, while a slowed writer drains: the checkpoint holds the values
    of the call."""
    real = tser.save_ndarrays

    def slow(fname, data):
        time.sleep(0.3)
        real(fname, data)

    monkeypatch.setattr(tser, "save_ndarrays", slow)
    xs, ys = torch.from_numpy(X).cuda(), torch.from_numpy(Y).cuda()
    net, tr = _dropout_mlp(1)
    for _ in range(3):
        tr.whole_step(net, loss_fn, xs, ys)
    want = _gpu_weights(net)
    mgr = tck.CheckpointManager(str(tmp_path))
    mgr.save(3, params=net, trainer=tr)
    for _ in range(5):
        tr.whole_step(net, loss_fn, xs, ys)
    mgr.wait_until_finished()
    loaded = tmx.nd.load(str(tmp_path / "ckpt-00000003" /
                             "params-shard0.params"))
    names = list(net._collect_params_with_prefix())
    assert all(torch.equal(loaded[k].data, w.cpu())
               for k, w in zip(names, want))


@pytest.mark.gpu
def test_data_parallel_restore_is_seen_by_the_captured_step_on_card(
        cuda_device, tmp_path):
    """A captured ``DataParallelTrainer`` step that loads a checkpoint
    replays on the loaded masters, states and moving statistics: its next
    steps equal the writer's, bit for bit, with no new capture."""
    x, y = _dp_data()
    xg, yg = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    _, a = _port_dp(ctx=tmx.gpu(0))
    for _ in range(3):
        a.step(xg, yg)
    prefix = str(tmp_path / "dp")
    fut = a.save_states(prefix, async_save=True)
    ref = [a.step(xg, yg).data.clone() for _ in range(3)]
    fut.result()
    _, b = _port_dp(seed=4, ctx=tmx.gpu(0))
    for _ in range(2):   # warm-up and capture
        b.step(xg, yg)
    c0 = tmx._imperative.graph_capture_count()
    b.load_states(prefix)
    got = [b.step(xg, yg).data.clone() for _ in range(3)]
    assert tmx._imperative.graph_capture_count() == c0
    assert all(torch.equal(u, v) for u, v in zip(got, ref))
    assert all(torch.equal(p, q) for p, q in zip(a._params, b._params))
