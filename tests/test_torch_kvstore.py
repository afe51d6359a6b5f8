"""The port's KVStore (``mxnet_tpu_torch/kvstore.py``) against the JAX
package's, on the CPU.

Contexts are ``cpu(0..7)`` in both packages: eight virtual devices in the
JAX package (``tests/conftest.py``), eight slots of one torch device in the
port, which keeps each value's context on its NDArray.  Values come from
``np.random.RandomState``.

Tolerances: push, pull, pushpull, broadcast and 2-bit compression are
bit-identical to the JAX package (the same pairwise sums in the same slot
order, and elementwise selects), and the fused multi-key pushpull is
bit-identical to the per-key path with the same ``buckets``/``dispatches``
counts; ``set_optimizer`` updates within 1e-6 relative (the optimizers'
own arithmetic in two frameworks).  The ``gpu``-marked tests need a CUDA
device and skip here.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import kvstore as tkv
from mxnet_tpu_torch.base import MXNetError


def _vals(rng, n, shape, dtype=np.float32):
    return [rng.randn(*shape).astype(dtype) for _ in range(n)]


def _t(a, i):
    return tmx.nd.array(a, ctx=tmx.cpu(i), dtype=a.dtype)


def _j(a, i):
    import mxnet_tpu as jmx

    return jmx.nd.array(a, ctx=jmx.cpu(i), dtype=a.dtype)


def _run_api(pkg, make, kv_type, vals, init):
    """init, push, pull, pushpull and broadcast of one key over
    ``len(vals)`` contexts; every result as numpy."""
    kv = pkg.kvstore.create(kv_type)
    n = len(vals)
    kv.init("w", make(init, 0))
    kv.push("w", [make(v, i) for i, v in enumerate(vals)])
    outs = [make(np.zeros_like(init), i) for i in range(n)]
    kv.pull("w", out=outs)
    res = {"pull": [o.asnumpy() for o in outs]}
    vs = [make(v * 2 + 1, i) for i, v in enumerate(vals)]
    kv.pushpull("w", vs, out=vs)
    res["pushpull"] = [v.asnumpy() for v in vs]
    outs = [make(np.zeros_like(init), i) for i in range(n)]
    kv.broadcast("b", make(init * 3, n - 1), out=outs)
    res["broadcast"] = [o.asnumpy() for o in outs]
    res["contexts"] = [str(o.context) for o in outs]
    return res


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("kv_type", ["device", "local", "nccl"])
def test_api_bit_identical_to_jax(n, kv_type):
    import mxnet_tpu as jmx

    rng = np.random.RandomState(n)
    vals = _vals(rng, n, (4, 3))
    init = rng.randn(4, 3).astype(np.float32)
    got = _run_api(tmx, _t, kv_type, vals, init)
    want = _run_api(jmx, _j, kv_type, vals, init)
    assert got["contexts"] == want["contexts"] == [f"cpu({i})"
                                                   for i in range(n)]
    for key in ("pull", "pushpull", "broadcast"):
        for a, b in zip(got[key], want[key]):
            np.testing.assert_array_equal(a, b)


def test_reduce_sum_tree_order_matches_jax():
    """The pairwise tree, not a serial chain: values whose sum depends on
    the order (1e8 and ones) give the JAX package's bits."""
    from mxnet_tpu import kvstore as jkv
    import mxnet_tpu as jmx

    for n in (2, 3, 5, 8):
        vals = [np.full((3,), v, np.float32)
                for v in ([1e8, 1.0, -1e8, 1.0, 3.0, 1e8, -1e8, 0.5][:n])]
        got = tkv._reduce_sum([_t(v, i) for i, v in enumerate(vals)],
                              tmx.cpu(0))
        want = jkv._reduce_sum([_j(v, i) for i, v in enumerate(vals)],
                               jmx.cpu(0))
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
        assert got.context == tmx.cpu(0)


_SPECS = [((10, 4), np.float32), ((37,), np.float32), ((6, 5), np.float16),
          ((3,), np.float32), ((40,), np.float32), ((2, 2), np.float16),
          ((9,), np.float32)]


def _run_fused(pkg, make, specs, slots, fused, seed=0):
    """One multi-key pushpull (or, with ``fused`` False, a per-key one for
    each key) of keys whose slots are ``slots[k]`` contexts."""
    rng = np.random.RandomState(seed)
    kv = pkg.kvstore.create("device")
    keys = list(range(len(specs)))
    vals = []
    for k, (shape, dtype) in enumerate(specs):
        kv.init(k, make(rng.randn(*shape).astype(dtype), slots[k][0]))
        vals.append([make(rng.randn(*shape).astype(dtype), c)
                     for c in slots[k]])
    if fused:
        stats = kv.pushpull(keys, vals, out=vals)
    else:
        stats = None
        for k in keys:
            kv.pushpull(k, vals[k], out=vals[k])
    outs = [[v.asnumpy() for v in vl] for vl in vals]
    pulled = []
    for k, (shape, dtype) in enumerate(specs):
        o = make(np.zeros(shape, dtype), slots[k][0])
        kv.pull(k, out=o)
        pulled.append(o.asnumpy())
    return outs, pulled, stats


@pytest.mark.parametrize("cap_mb", ["0.0002", "32"])
def test_fused_pushpull_bit_identical_with_jax_counts(monkeypatch, cap_mb):
    """Several buckets (a ~200-byte cap) or one a dtype: the fused result
    equals the per-key one and the JAX package's, bit for bit, with the
    JAX package's buckets and dispatches.  Keys on 2, 3 and 1 contexts
    and on other context sets make separate bucket streams."""
    import mxnet_tpu as jmx

    monkeypatch.setenv("MXTPU_KVSTORE_BUCKET_MB", cap_mb)
    slots = [[0, 1], [0, 1], [0, 1], [0, 1, 2], [0, 1], [2, 3], [1]]
    got, got_pull, got_stats = _run_fused(tmx, _t, _SPECS, slots, True)
    per_key, per_key_pull, _ = _run_fused(tmx, _t, _SPECS, slots, False)
    want, want_pull, want_stats = _run_fused(jmx, _j, _SPECS, slots, True)
    assert got_stats == want_stats
    if cap_mb == "0.0002":
        assert got_stats["buckets"] >= 5
    for a, b, c in zip(got + [got_pull], per_key + [per_key_pull],
                       want + [want_pull]):
        for x, y, z in zip(a, b, c):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, z)


def _run_compression(pkg, make, n, seed=3):
    rng = np.random.RandomState(seed)
    kv = pkg.kvstore.create("device")
    kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    kv.init(0, make(np.zeros((5, 4), np.float32), 0))
    res = []
    for _ in range(3):
        vals = [make((rng.randn(5, 4) * 0.6).astype(np.float32), i)
                for i in range(n)]
        kv.pushpull(0, vals, out=vals)
        res.append([v.asnumpy() for v in vals])
    resid = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                 else np.asarray(v))
             for k, v in kv._compression._residuals.items()}
    return res, resid


@pytest.mark.parametrize("n", [1, 2, 3])
def test_two_bit_compression_bit_identical_to_jax(n):
    import mxnet_tpu as jmx

    got, got_r = _run_compression(tmx, _t, n)
    want, want_r = _run_compression(jmx, _j, n)
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert set(got_r) == set(want_r) == {(0, s) for s in range(n)}
    for k in got_r:
        np.testing.assert_array_equal(got_r[k], want_r[k])


def _run_optimizer(pkg, make, opt, args, n=2, seed=4, steps=3, kv=None):
    rng = np.random.RandomState(seed)
    if kv is None:
        kv = pkg.kvstore.create("device")
        kv.set_optimizer(pkg.optimizer.create(opt, **args))
        kv.init(0, make(rng.randn(6, 3).astype(np.float32), 0))
        kv.init(1, make(rng.randn(7).astype(np.float32), 0))
    out = []
    for _ in range(steps):
        for k, shape in ((0, (6, 3)), (1, (7,))):
            kv.push(k, [make(rng.randn(*shape).astype(np.float32), i)
                        for i in range(n)])
            o = make(np.zeros(shape, np.float32), n - 1)
            kv.pull(k, out=o)
            out.append(o.asnumpy())
    return out, kv


_OPTS = [("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
         ("adam", {"learning_rate": 0.01})]


@pytest.mark.parametrize("opt,args", _OPTS, ids=["sgd_mom", "adam"])
def test_set_optimizer_matches_jax(opt, args):
    import mxnet_tpu as jmx

    got, _ = _run_optimizer(tmx, _t, opt, args)
    want, _ = _run_optimizer(jmx, _j, opt, args)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("opt,args", _OPTS, ids=["sgd_mom", "adam"])
def test_optimizer_state_files_load_in_both_packages(tmp_path, opt, args):
    """Three pushes in one package, its ``save_optimizer_states`` file
    loaded by the other, three more pushes there: the same as six pushes
    in one package, both ways."""
    import mxnet_tpu as jmx

    pkgs = {"port": (tmx, _t), "jax": (jmx, _j)}
    for src, dst in (("port", "jax"), ("jax", "port")):
        f = str(tmp_path / f"{src}.states")
        spkg, smake = pkgs[src]
        _, kv = _run_optimizer(spkg, smake, opt, args, steps=3)
        kv.save_optimizer_states(f)
        dpkg, dmake = pkgs[dst]
        # the destination: the same initial weights, after the same 3
        # updates (taken from the source), then its states from the file
        _, ref = _run_optimizer(dpkg, dmake, opt, args, steps=3)
        ref.load_optimizer_states(f)
        rng = np.random.RandomState(99)
        cont = []
        for k, shape in ((0, (6, 3)), (1, (7,))):
            g = rng.randn(*shape).astype(np.float32)
            for pkg_kv, make in ((kv, smake), (ref, dmake)):
                pkg_kv.push(k, [make(g, 0), make(g, 1)])
                o = make(np.zeros(shape, np.float32), 0)
                pkg_kv.pull(k, out=o)
                cont.append(o.asnumpy())
        for a, b in zip(cont[0::2], cont[1::2]):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_what_later_slices_bring_raises_naming_them():
    for name in ("dist_async", "dist_device_async"):
        with pytest.raises(MXNetError, match="slice 7, part 3"):
            tkv.create(name)
    with pytest.raises(MXNetError, match="unknown kvstore"):
        tkv.create("bogus")
    kv = tkv.create("device")
    kv.init("w", _t(np.ones(2, np.float32), 0))
    with pytest.raises(MXNetError, match="slice 9"):
        kv.row_sparse_pull("w", out=_t(np.ones(2, np.float32), 0),
                           row_ids=[0])
    with pytest.raises(MXNetError, match="slice 9"):
        kv.push("w", [np.ones(2, np.float32)])
    # the traced forms (the gradient sum inside a captured step); ZeRO's
    # eager forms are ported (tests/test_torch_zero.py)
    for call in (lambda: kv.traced_pushpull([], "dp"),
                 lambda: tkv.traced_bucket_allreduce([], "dp"),
                 lambda: tkv.traced_bucket_reduce_scatter([], "dp", 2)):
        with pytest.raises(MXNetError, match="slice 7, part 2b, piece 4"):
            call()
    with pytest.raises(MXNetError, match="already initialized"):
        kv.init("w", _t(np.ones(2, np.float32), 0))
    with pytest.raises(MXNetError, match="not been initialized"):
        kv.push("x", [_t(np.ones(2, np.float32), 0)])
    with pytest.raises(MXNetError, match="compression type"):
        kv.set_gradient_compression({"type": "1bit"})
    with pytest.raises(MXNetError, match="no optimizer"):
        kv.save_optimizer_states("unused")
    from mxnet_tpu_torch.parallel import dist
    # elastic resizing comes with slice 7, part 3 (its LeaseDir is ported:
    # the control plane's registry, tests/test_torch_control_plane.py)
    for call in (dist.reinit, dist.shrink, dist._shrink_multiprocess):
        with pytest.raises(MXNetError, match="slice 7, part 3"):
            call()


def test_dist_sync_in_one_process_is_the_device_store():
    """Without the launcher's env: rank 0 of 1, the all-reduce the
    identity, the barrier a no-op (the JAX package's
    ``test_kvstore_dist_single_process_fallback``)."""
    from mxnet_tpu_torch.parallel import dist

    kv = tkv.create("dist_sync")
    assert kv.rank == 0 and kv.num_workers == 1 and kv.type == "dist_sync"
    assert not dist.is_multiprocess() and dist.backend() is None
    kv.init("w", _t(np.ones(2, np.float32), 0))
    kv.push("w", [_t(np.full(2, 3.0, np.float32), 0)])
    out = _t(np.zeros(2, np.float32), 0)
    kv.pull("w", out=out)
    np.testing.assert_array_equal(out.asnumpy(), [3.0, 3.0])
    kv.barrier()
    x = _t(np.arange(3, dtype=np.float32), 0)
    assert dist.allreduce(x) is x
    assert dist.allgather_bytes(b"abc") == [b"abc"]


def test_ndarray_keeps_its_context():
    x = tmx.nd.array(np.ones(3, np.float32), ctx=tmx.cpu(3))
    assert x.context == tmx.cpu(3)
    y = x.as_in_context(tmx.cpu(1))
    assert y.context == tmx.cpu(1) and y.data is not x.data
    assert x.as_in_context(tmx.cpu(3)) is x
    assert x.copyto(tmx.cpu(2)).context == tmx.cpu(2)
    assert tmx.nd.NDArray(torch.ones(2)).context == tmx.cpu(0)
    parts = tmx.gluon.utils.split_and_load(
        np.arange(8, dtype=np.float32).reshape(4, 2),
        [tmx.cpu(i) for i in range(4)])
    assert [p.context for p in parts] == [tmx.cpu(i) for i in range(4)]
    with pytest.raises(MXNetError, match="cannot be on"):
        tmx.nd.NDArray(torch.ones(2), tmx.gpu(0))


# -- on the card -----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kvstore on CUDA tensors); run "
                    "on the GPU machine with -m gpu")
    return tmx.gpu(0)


def _api_on(ctxs, vals, init, kv_type="device"):
    kv = tkv.create(kv_type)
    kv.init("w", tmx.nd.array(init, ctx=ctxs[0]))
    kv.push("w", [tmx.nd.array(v, ctx=c) for v, c in zip(vals, ctxs)])
    outs = [tmx.nd.array(np.zeros_like(init), ctx=c) for c in ctxs]
    kv.pull("w", out=outs)
    res = [o.asnumpy() for o in outs]
    vs = [tmx.nd.array(v * 2 + 1, ctx=c) for v, c in zip(vals, ctxs)]
    kv.pushpull("w", vs, out=vs)
    return res + [v.asnumpy() for v in vs]


@pytest.mark.gpu
@pytest.mark.parametrize("kv_type", ["device", "nccl"])
def test_api_on_cuda_tensors_bit_identical_to_cpu(cuda_device, kv_type):
    """The same calls on CUDA tensors (every slot on the cards there are,
    round robin) and on CPU tensors give the same bits."""
    n_gpu = torch.cuda.device_count()
    rng = np.random.RandomState(0)
    vals = _vals(rng, 5, (64, 33))
    init = rng.randn(64, 33).astype(np.float32)
    got = _api_on([tmx.gpu(i % n_gpu) for i in range(5)], vals, init,
                  kv_type)
    want = _api_on([tmx.cpu(i) for i in range(5)], vals, init, kv_type)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
def test_fused_pushpull_on_cuda_tensors_bit_identical_to_cpu(cuda_device,
                                                            monkeypatch):
    monkeypatch.setenv("MXTPU_KVSTORE_BUCKET_MB", "0.0002")
    slots = [[0, 1], [0, 1], [0, 1], [0, 1, 2], [0, 1], [2, 3], [1]]
    n_gpu = torch.cuda.device_count()

    def on_gpu(a, i):
        return tmx.nd.array(a, ctx=tmx.gpu(i % n_gpu), dtype=a.dtype)

    got, got_pull, _ = _run_fused(tmx, on_gpu, _SPECS, slots, True)
    want, want_pull, _ = _run_fused(tmx, _t, _SPECS, slots, True)
    for a, b in zip(got + [got_pull], want + [want_pull]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.gpu
def test_compression_and_optimizer_on_cuda_tensors(cuda_device):
    def on_gpu(a, i):
        return tmx.nd.array(a, ctx=tmx.gpu(0), dtype=a.dtype)

    got, got_r = _run_compression(tmx, on_gpu, 3)
    want, want_r = _run_compression(tmx, _t, 3)
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for k in want_r:
        np.testing.assert_array_equal(got_r[k], want_r[k])
    for opt, args in _OPTS:
        got, _ = _run_optimizer(tmx, on_gpu, opt, args)
        want, _ = _run_optimizer(tmx, _t, opt, args)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
