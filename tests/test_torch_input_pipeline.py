"""The input tier of the PyTorch port (``pipeline/``, ``engine``,
``storage``, ``CheckpointManager(pipeline=...)`` and
``reshard.merge_pipeline_states``) against the JAX package.

Every stage's output sequence is compared exactly with the JAX package's
over the same numpy samples.  A pipeline resumed from its state (mid
epoch, in-flight map items and prefetched batches included) replays the
exact remainder, within the port and across the packages both ways: a
state pickled by one package loads into the other's identically built
pipeline, and ``CheckpointManager`` directories with a pipeline restore
in either package.  The ``gpu``-marked test needs the card (pinned
staging and the copy stream) and skips here; run it on the GPU machine
with ``python -m pytest -m gpu --noconftest tests/test_torch_input_pipeline.py``.
"""
import pickle
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import engine
from mxnet_tpu_torch.base import MXNetError

CPU = tmx.cpu()
FEAT = 3


def _jmx():
    import mxnet_tpu as jmx

    return jmx


def _host(tree):
    """numpy tree of a batch (NDArrays, tensors, DataBatch, scalars)."""
    if hasattr(tree, "asnumpy"):
        return tree.asnumpy()
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    if hasattr(tree, "data") and hasattr(tree, "pad"):
        return ("batch", _host(list(tree.data)), _host(list(tree.label or [])),
                tree.pad)
    if isinstance(tree, (list, tuple)):
        return [_host(v) for v in tree]
    return tree


def _same(a, b):
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        assert a == b


def _samples(n, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.rand(FEAT).astype(np.float32), np.float32(i))
            for i in range(n)]


def _varlen(n, seed=1):
    rng = np.random.RandomState(seed)
    return [(rng.rand(int(rng.randint(2, 8)), FEAT).astype(np.float32),
             np.float32(i)) for i in range(n)]


def _square(s):
    x, y = s
    return (x * x, y)


def _build(pkg, kind):
    """The same composition in either package (``pkg`` is the top module)."""
    P = pkg.pipeline.Pipeline
    cpu = pkg.cpu()
    if kind == "shuffle_map_batch":
        return P(_samples(21)).shuffle(8, seed=3).map(
            _square, inflight=3).batch(4)
    if kind == "batch_discard":
        return P(_samples(10)).batch(4, last_batch="discard")
    if kind == "batch_rollover":
        return P(_samples(10)).batch(4, last_batch="rollover")
    if kind == "shard_pad":
        return P(_samples(11)).shard(3, 2, tail="pad").batch(2)
    if kind == "shard_drop":
        return P(_samples(11)).shard(3, 1).batch(2)
    if kind == "bucket":
        spec = pkg.serve.BucketSpec(batch_sizes=(4,),
                                    example_shape=(None, FEAT),
                                    lengths=(4, 8))
        return P(_varlen(14)).batch(4, last_batch="discard",
                                    bucket_spec=spec)
    if kind == "rebatch_iter":
        x = np.arange(60, dtype=np.float32).reshape(30, 2)
        y = np.arange(30, dtype=np.float32)
        if pkg.__name__ == "mxnet_tpu_torch":
            with pkg.cpu():
                it = pkg.io.NDArrayIter(x, y, batch_size=7)
        else:
            it = pkg.io.NDArrayIter(x, y, batch_size=7)
        return it.as_pipeline().rebatch(5)
    if kind == "dataloader":
        ds = pkg.gluon.data.ArrayDataset(
            np.arange(34, dtype=np.float32).reshape(17, 2),
            np.arange(17, dtype=np.int32))
        return pkg.gluon.data.DataLoader(ds, batch_size=3, shuffle=True,
                                         num_workers=2).as_pipeline()
    if kind == "prefetch_cpu":
        return P(_samples(13)).map(_square).batch(3).prefetch_to_device(
            cpu, depth=2)
    raise ValueError(kind)


KINDS = ["shuffle_map_batch", "batch_discard", "batch_rollover",
         "shard_pad", "shard_drop", "bucket", "rebatch_iter", "dataloader",
         "prefetch_cpu"]


def _epochs(p, n=2):
    out = []
    for _ in range(n):
        out.append([_host(b) for b in p])
        p.reset()
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_stage_sequences_match_jax(kind):
    jmx = _jmx()
    np.random.seed(4)
    got = _epochs(_build(tmx, kind))
    np.random.seed(4)
    want = _epochs(_build(jmx, kind))
    assert got[0], "an empty epoch tests nothing"
    _same(got, want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("direction", ["port", "port_to_jax", "jax_to_port"])
def test_resume_replays_the_exact_remainder(kind, direction):
    """Consume 2 items, take the state, then the remainder; a freshly built
    pipeline loading that state (pickled, as a checkpoint holds it) gives
    the same remainder, in the port or in the other package."""
    jmx = _jmx()
    src, dst = {"port": (tmx, tmx), "port_to_jax": (tmx, jmx),
                "jax_to_port": (jmx, tmx)}[direction]
    np.random.seed(6)
    p = _build(src, kind)
    for _ in range(2):
        next(p)
    state = pickle.loads(pickle.dumps(p.state_dict()))
    rest = [_host(b) for b in p]
    np.random.seed(99)  # the restore must not read any global stream
    q = _build(dst, kind)
    q.load_state_dict(state)
    _same([_host(b) for b in q], rest)


def test_restore_rejects_another_composition():
    p = tmx.pipeline.Pipeline(_samples(8)).batch(2)
    q = tmx.pipeline.Pipeline(_samples(8)).shuffle(4).batch(2)
    with pytest.raises(MXNetError, match="does not match this pipeline"):
        q.load_state_dict(p.state_dict())
    with pytest.raises(MXNetError, match="unrecognized pipeline state"):
        p.load_state_dict({"version": 9, "stages": []})


def test_map_timeout_and_errors_reach_the_consumer():
    def slow(v):
        if v == 2:
            time.sleep(2.0)
        return v

    p = tmx.pipeline.Pipeline(list(range(4))).map(slow, timeout=0.3)
    assert [next(p), next(p)] == [0, 1]
    with pytest.raises(MXNetError, match="timed out after 0.3s waiting for "
                       "batch 2"):
        next(p)

    def bad(v):
        if v == 3:
            raise RuntimeError("bad sample 3")
        return v

    p = tmx.pipeline.Pipeline(list(range(6))).map(bad).prefetch_to_device(
        CPU)
    with pytest.raises(RuntimeError, match="bad sample 3"):
        list(p)


def test_prefetch_lands_ndarrays_and_counts():
    tmx.pipeline.reset_pipeline_stats()
    p = (tmx.pipeline.Pipeline(_samples(9)).batch(3)
         .prefetch_to_device(CPU, depth=2))
    out = list(p)
    assert len(out) == 3
    assert all(isinstance(v, tmx.nd.NDArray) and v.context == CPU
               for b in out for v in b)
    s = tmx.pipeline.pipeline_stats()
    assert s["batches"] == 3
    assert s["prefetch_hits"] + s["prefetch_misses"] == 3
    assert s["h2d_ms"] > 0 and s["wait_ms"] >= 0


def test_prefetch_to_the_card_without_one_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(MXNetError, match="CUDA device"):
        tmx.pipeline.Pipeline(_samples(4)).batch(2).prefetch_to_device(
            tmx.gpu(0))
    with pytest.raises(MXNetError, match="no CUDA device"):
        engine.batched_put([np.zeros(3, np.float32)], torch.device("cuda", 0))


# -- checkpoints ------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_directories_with_a_pipeline_move_both_ways(tmp_path,
                                                               writer):
    """A CheckpointManager directory saved with pipeline= by one package
    resumes the other package's identically built pipeline exactly; the
    file is the JAX package's ``pipeline-shard0.state``."""
    jmx = _jmx()
    src, dst = (tmx, jmx) if writer == "port" else (jmx, tmx)
    np.random.seed(8)
    p = _build(src, "dataloader")
    next(p)
    mgr = src.checkpoint.CheckpointManager(str(tmp_path), keep_n=2)
    mgr.save(3, pipeline=p, sync=True)
    assert (tmp_path / "ckpt-00000003" / "pipeline-shard0.state").is_file()
    rest = [_host(b) for b in p]
    q = _build(dst, "dataloader")
    meta = dst.checkpoint.CheckpointManager(str(tmp_path)).restore(
        pipeline=q, restore_rng=False)
    assert meta["step"] == 3
    _same([_host(b) for b in q], rest)
    # the port restores its own directory with the RNG, before the pipeline
    if writer == "port":
        tmx.random.seed(1)
        q2 = _build(tmx, "dataloader")
        tmx.checkpoint.CheckpointManager(str(tmp_path)).restore(pipeline=q2)
        _same([_host(b) for b in q2], rest)


def test_checkpoint_without_pipeline_state_raises(tmp_path):
    mgr = tmx.checkpoint.CheckpointManager(str(tmp_path))
    mgr.save(1, sync=True)
    with pytest.raises(MXNetError, match="no input-pipeline state"):
        mgr.restore(step=1, pipeline=_build(tmx, "batch_discard"))


def test_merge_pipeline_states_agrees_with_jax():
    from mxnet_tpu.checkpoint import reshard as jre

    from mxnet_tpu_torch.checkpoint import reshard as tre

    p = _build(tmx, "shuffle_map_batch")
    next(p)
    st = pickle.loads(pickle.dumps(p.state_dict()))
    same = [st, pickle.loads(pickle.dumps(st))]
    got, want = tre.merge_pipeline_states(same), jre.merge_pipeline_states(
        same)
    assert tre._tree_equal(got, want) and got is same[0]
    q = _build(tmx, "shuffle_map_batch")
    for _ in range(2):
        next(q)
    other = pickle.loads(pickle.dumps(q.state_dict()))
    for fn in (tre.merge_pipeline_states, jre.merge_pipeline_states):
        with pytest.raises(Exception, match="state differs between saved "
                           "rank 0 and rank 1"):
            fn([st, other], where="d")
        with pytest.raises(Exception, match="compositions differ"):
            fn([st, _build(tmx, "batch_discard").state_dict()])
        with pytest.raises(Exception, match="no pipeline shard states"):
            fn([])


# -- the engine and the staging storage ----------------------------------------


def test_engine_orders_writers_and_lanes():
    assert engine.native_engine() is not None, \
        "lib/libmxtpu_engine.so did not build or load"
    from mxnet_tpu_torch.utils import native_engine

    assert native_engine.self_test(seed=1, n_ops=500) == 0
    var = engine.new_variable()
    log = []
    futs = [engine.push(lambda i=i: (time.sleep(0.001 * (5 - i)),
                                     log.append(i)), mutable_vars=(var,))
            for i in range(5)]
    engine.wait_for_var(var)
    assert log == list(range(5)) and all(f.done() for f in futs)
    lane = engine.stream_manager().get(CPU, "io")
    seen = []
    for i in range(6):
        lane.push(seen.append, i)
    lane.wait()
    assert seen == list(range(6))
    assert engine.h2d_stream(CPU) is engine.stream_manager().get(CPU, "h2d")
    with pytest.raises(ValueError, match="unknown stream kind"):
        engine.stream_manager().get(CPU, "bogus")
    f = engine.push_host(lambda: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        f.result()
    engine.waitall()


def test_engine_naive_mode_and_concurrent_readers():
    var = engine.new_variable()
    inside, peak, mu = [0], [0], threading.Lock()

    def reader():
        with mu:
            inside[0] += 1
            peak[0] = max(peak[0], inside[0])
        time.sleep(0.02)
        with mu:
            inside[0] -= 1

    futs = [engine.push(reader, const_vars=(var,)) for _ in range(3)]
    for f in futs:
        f.result()
    assert peak[0] >= 2   # readers of one variable run together
    engine.set_engine_type("NaiveEngine")
    try:
        assert engine.is_naive()
        f = engine.push_host(lambda: threading.current_thread())
        assert f.done() and f.result() is threading.current_thread()
    finally:
        engine.set_engine_type("ThreadedEngine")


def test_flatten_helpers_match_jax():
    jmx = _jmx()
    rng = np.random.RandomState(2)
    arrs = [rng.rand(*s).astype(np.float32) for s in ((2, 3), (4,), (1, 2))]
    tflat = engine.flatten_arrays([torch.from_numpy(a) for a in arrs])
    jflat = jmx.engine.flatten_arrays([jmx.nd.array(a)._data for a in arrs])
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))
    for got, a in zip(engine.unflatten_array(tflat, [a.shape for a in arrs]),
                      arrs):
        np.testing.assert_array_equal(got.numpy(), a)
    padded = engine.flatten_pad([torch.from_numpy(a) for a in arrs], 16)
    np.testing.assert_array_equal(
        padded.numpy(), np.asarray(jmx.engine.flatten_pad(
            [jmx.nd.array(a)._data for a in arrs], 16)))
    np.testing.assert_array_equal(engine.slice_flat(tflat, 3, 5).numpy(),
                                  np.asarray(jmx.engine.slice_flat(jflat, 3,
                                                                   5)))
    out = engine.batched_put([arrs[0], torch.from_numpy(arrs[1])], CPU)
    assert out.event is None and out.wait() is out
    np.testing.assert_array_equal(out[0].numpy(), arrs[0])
    assert out[1].data_ptr() != torch.from_numpy(arrs[1]).data_ptr()


def test_storage_matches_jax_surface():
    jmx = _jmx()
    from mxnet_tpu_torch.storage import Storage

    st = Storage.get()
    jst = jmx.storage.Storage.get()
    assert st.native and jst.native
    h = st.alloc(100)
    view = h.as_numpy(np.float32)
    assert view.shape == (25,)
    view[:] = np.arange(25, dtype=np.float32)
    np.testing.assert_array_equal(h.tensor(torch.float32, (5, 5)).numpy(),
                                  np.arange(25, dtype=np.float32)
                                  .reshape(5, 5))
    used = st.stats()["used_bytes"]
    assert used > 0 and set(jst.stats()) <= set(st.stats())
    st.free(h)
    st.free(h)   # a double free is a no-op
    with pytest.raises(MXNetError, match="freed storage handle"):
        h.as_numpy()
    with pytest.raises(MXNetError, match="negative allocation size"):
        st.alloc(-1)
    if not torch.cuda.is_available():
        # pinned blocks are for a CUDA destination only: no fallback
        with pytest.raises(RuntimeError):
            st.alloc(64, ctx=tmx.gpu(0))


# -- on the card ------------------------------------------------------------------


@pytest.mark.gpu
def test_prefetched_batches_equal_the_cpu_built_ones_on_card():
    """A DataLoader pipeline prefetched to gpu(0) (pinned staging, the
    copy stream, the consumer's wait on its event) delivers batches equal
    to the same pipeline's on the CPU, bit for bit, while the consumer
    keeps the card busy; the staging blocks return to the pool."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine with -m gpu")
    from mxnet_tpu_torch.storage import Storage

    rng = np.random.RandomState(0)
    x = rng.randint(0, 256, (96, 32, 32, 3)).astype(np.uint8)
    y = rng.randint(0, 10, 96).astype(np.int32)
    ds = tmx.gluon.data.ArrayDataset(tmx.nd.array(x, ctx=CPU), y)

    def loader():
        np.random.seed(3)
        return tmx.gluon.data.DataLoader(ds, batch_size=8, shuffle=True,
                                         num_workers=4).as_pipeline()

    want = [[v.asnumpy() for v in b] for b in loader()]
    p = loader().prefetch_to_device(tmx.gpu(0), depth=3)
    busy = torch.randn(2048, 2048, device="cuda")
    got = []
    for b in p:
        for _ in range(4):   # keep the consumer's stream busy
            busy = busy @ busy * 1e-3
        assert all(v.context == tmx.gpu(0) for v in b)
        got.append([(v.data.float() * 1).cpu().numpy() for v in b])
    torch.cuda.synchronize()
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b.astype(np.float32))
    s = Storage.get().stats()
    assert s["pinned_hits"] > 0 and s["pinned_live"] == 0


@pytest.mark.gpu
def test_a_capture_runs_while_the_h2d_lane_stages_batches_on_card():
    """CUDA-graph captures of a step while another thread stages batches
    through ``engine.batched_put`` (pinned copies on the copy stream, device
    allocations, event queries and waits) succeed, and each graph replays
    the eager result bit for bit: a prefetch lane may run during the
    captured step's capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine with -m gpu")
    from mxnet_tpu_torch.gluon.whole_step import CapturedStep
    from mxnet_tpu_torch.storage import Storage

    dev = torch.device("cuda", 0)
    host = np.random.RandomState(0).rand(1 << 20).astype(np.float32)
    stop, errors, staged = threading.Event(), [], [0]

    def stage():
        try:
            while not stop.is_set():
                engine.batched_put([host, host], dev,
                                   wait=False).event.synchronize()
                Storage.get().stats()
                staged[0] += 1
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    lane = threading.Thread(target=stage)
    lane.start()
    try:
        w = torch.randn(1024, 1024, device=dev)
        for _ in range(20):
            x = torch.randn(256, 1024, device=dev)

            def body(a):
                return torch.tanh(a @ w) @ w.t()

            want = body(x)
            got = CapturedStep(body, [x.clone()], dev).replay([x])
            torch.cuda.synchronize()
            assert torch.equal(got, want)
    finally:
        stop.set()
        lane.join()
    assert not errors, errors
    assert staged[0] > 0
