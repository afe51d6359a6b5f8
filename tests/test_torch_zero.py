"""ZeRO-1 in the PyTorch port's ``gluon.Trainer`` (arXiv 2004.13336): the
eager tier over several contexts, the whole step over ``dist_sync`` ranks,
the ``"zero"`` states blob, multi-process ``CheckpointManager`` manifests
and ``checkpoint/reshard.py``.

The net is ``tests/test_zero_shard.py``'s 13-unit MLP (16 -> 13 -> 13 ->
4, so no flat bucket is a multiple of the world and the pad is always
there) with weights from numpy seed 0, and the batch 16 rows from seed 1
(``tests/torch_zero_worker.py``), over the 4 contexts ``cpu(0..3)``
(``xla(0..3)`` on the JAX side).

Tolerances.  The port's sharded steps against its unsharded ones: bit for
bit (the same pairwise adds, the same elementwise rule over the same
elements).  Against the JAX package's eager ZeRO, and across the packages'
files: 1e-6 of the largest magnitude of each weight (float32 on both sides,
sums in other orders).  A checkpoint of 4 ranks resumed at 2 ranks or in
one process: 1e-5 of each weight's largest magnitude (each rank's gradient
sum covers other rows).  Resharding: byte for byte.

The multi-rank cases run in one launch of 4 gloo ranks and one of 2 a test
session (``torch_zero_worker.py zero4|zero2``, through the port's
launcher, shared across xdist workers as ``tests/torch_mesh_worker.py``'s
are); the 2-rank launch restores the 4-rank launch's checkpoint.

The ``gpu``-marked tests need the card and skip here; run them on the GPU
machine with ``python -m pytest -m gpu --noconftest tests/test_torch_zero.py``.
"""
import itertools
import json
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.checkpoint import reshard as treshard
from mxnet_tpu_torch.gluon import trainer as ttrainer

import torch_mesh_worker as mw
import torch_zero_worker as zw

N = 4
CTXS = [tmx.cpu(i) for i in range(N)]
X, Y = zw.data()
ADAM = ("adam", {"learning_rate": 0.01, "wd": 0.01})
OPTS = {"sgd": ("sgd", {"learning_rate": 0.05, "wd": 0.01}),
        "sgd_mom": zw.OPTS["sgd_mom"], "adam": ADAM}
XPKG_TOL = 1e-6
RESUME_TOL = 1e-5


def build(zero, opt=ADAM, whole_step=False, ctx=CTXS, layers=2, **tkw):
    net = zw.mlp(tmx, ctx, layers)
    name, args = opt
    tr = tmx.gluon.Trainer(net.collect_params(), name, dict(args),
                           whole_step=whole_step, zero_shard=zero, **tkw)
    return net, tr


def train(net, tr, steps, x=X, y=Y):
    for _ in range(steps):
        tr.whole_step(net, zw.port_loss, x, y)


def per_ctx(net):
    return [[np.array(p.data(c).detach().numpy()) for c in p.list_ctx()]
            for _, p in sorted(net._collect_params_with_prefix().items())]


def assert_same(a, b):
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)


def assert_close(got, want, tol):
    for g, w in zip(got, want):
        scale = max(float(np.abs(w).max()), 1e-12)
        assert float(np.abs(g - w).max()) <= tol * scale


def copy_weights(src, dst):
    for (_, a), (_, b) in zip(sorted(src._collect_params_with_prefix()
                                     .items()),
                              sorted(dst._collect_params_with_prefix()
                                     .items())):
        b.set_data(np.array(a.data().detach().numpy()))


# -- the JAX package's side ---------------------------------------------------


def jax_ctxs():
    import mxnet_tpu as jmx

    return [jmx.xla(i) for i in range(N)]


def jax_build(zero, opt=ADAM, layers=2, **tkw):
    import mxnet_tpu as jmx

    ctxs = jax_ctxs()
    net = zw.mlp(jmx, ctxs, layers)
    name, args = opt
    tr = jmx.gluon.Trainer(net.collect_params(), name, dict(args),
                           whole_step=False, zero_shard=zero, **tkw)
    return net, tr


def jax_weights(net):
    return [p.data(jax_ctxs()[0]).asnumpy() for _, p in
            sorted(net._collect_params_with_prefix().items())]


def jax_train(net, tr, steps):
    for _ in range(steps):
        tr.whole_step(net, zw.jax_loss, X, Y)


@pytest.fixture(scope="session")
def jax_zero_run(tmp_path_factory):
    """``run(opt_id)``: the JAX package's eager ZeRO, weights after every
    step, and after SAVE_AT steps its states blob (numpy leaves) and a
    CheckpointManager directory (each optimizer's run made once a
    session)."""
    runs = {}

    def run(opt_id):
        if opt_id not in runs:
            from mxnet_tpu.checkpoint import CheckpointManager as JMgr

            net, tr = jax_build(True, OPTS[opt_id])
            steps, blob = [], None
            d = tmp_path_factory.mktemp(f"jax-zero-{opt_id}")
            for s in range(zw.STEPS):
                jax_train(net, tr, 1)
                steps.append(jax_weights(net))
                if s + 1 == zw.SAVE_AT:
                    tr.save_states(str(d / "t.states"))
                    blob = pickle.loads((d / "t.states").read_bytes())
                    JMgr(str(d / "ckpt")).save(s + 1, params=net,
                                               trainer=tr, sync=True)
            runs[opt_id] = {"steps": steps, "blob": blob,
                            "ckpt": str(d / "ckpt")}
        return runs[opt_id]

    return run


# -- the eager tier -----------------------------------------------------------


@pytest.mark.parametrize("opt_id", ["sgd", "sgd_mom", "adam"])
def test_eager_zero_bit_parity_vs_eager_unsharded(opt_id):
    """Sharded == unsharded, bit for bit, on every context, through
    ``step`` (the eager whole step) and through the whole step over the
    contexts; the state held a context is ~1/4."""
    for whole in (False, True):
        net_u, tr_u = build(False, OPTS[opt_id], whole)
        net_z, tr_z = build(True, OPTS[opt_id], whole)
        ttrainer.reset_trainer_step_stats()
        for _ in range(4):
            train(net_u, tr_u, 1)
            train(net_z, tr_z, 1)
            assert_same(sum(per_ctx(net_u), []), sum(per_ctx(net_z), []))
        for copies in per_ctx(net_z):
            assert_same(copies[1:], copies[:1] * (N - 1))
        stats = ttrainer.trainer_step_stats()
        assert stats["zero_steps"] == 4 and stats["zero_fallbacks"] == 0
        assert stats["whole_step_eager"] == (8 if whole else 0)
        full = tr_u.optimizer_state_bytes()["per_replica"]
        shard = tr_z.optimizer_state_bytes()["per_replica"]
        if opt_id != "sgd":
            assert full // N <= shard <= full // N + 4 * 4 * N
        else:
            assert full == shard == 0


@pytest.mark.parametrize("opt_id", ["sgd_mom", "adam"])
def test_eager_zero_matches_the_jax_eager_zero(opt_id, jax_zero_run):
    """The port's eager ZeRO against the JAX package's
    (``whole_step=False``): weights within 1e-6 after every step, and the
    two ``"zero"`` layouts (world, chunks) equal."""
    want = jax_zero_run(opt_id)
    net, tr = build(True, OPTS[opt_id])
    for s in range(zw.STEPS):
        train(net, tr, 1)
        assert_close(zw.weights(net), want["steps"][s], XPKG_TOL)
        if s + 1 == zw.SAVE_AT:
            mine = tr.states_dict()["zero"]
    theirs = want["blob"]["zero"]
    assert mine["world"] == theirs["world"] == N
    assert mine["chunks"] == theirs["chunks"]
    assert sorted(mine["shards"]) == sorted(theirs["shards"])
    for r, chunks in theirs["shards"].items():
        for c, slots in chunks.items():
            for a, b in zip(mine["shards"][r][c], slots):
                assert a.shape == b.shape and a.dtype == b.dtype


class _SeqSGD(tmx.optimizer.Optimizer):
    """An optimizer with a sequential update and no list rule (as the JAX
    package's LAMB has no fused kernel)."""

    def update(self, index, weight, grad, state):
        self._update_count(index)
        with torch.no_grad():
            tmx.ndarray.ndarray.as_tensor(weight).sub_(
                self._get_lr(index) * self.rescale_grad
                * tmx.ndarray.ndarray.as_tensor(grad))


BYPASS = ["amp", "no_fused_kernel", "compression", "grad_add", "dist_eager",
          "sparse_grad", "sequential"]


def _bypass_setup(pkg, case):
    tkw, opt = {}, ("sgd", {"learning_rate": 0.01})
    if case == "no_fused_kernel":
        opt = ("lamb", {"learning_rate": 0.01}) \
            if pkg.__name__ == "mxnet_tpu" else \
            (_SeqSGD(learning_rate=0.01), {})
    if case == "sequential":
        opt = ("sgd", {"learning_rate": 0.01, "aggregate_num": 1})
    if case == "compression":
        tkw = dict(compression_params={"type": "2bit"})
    if case == "dist_eager":
        tkw = dict(kvstore="dist_sync", update_on_kvstore=False)
    return opt, tkw


def _bypass_mutate(net, tr, case, scaler):
    if case == "amp":
        tr._amp_loss_scaler = scaler
        tr._amp_original_scale = tr._scale
    params = [p for _, p in sorted(net.collect_params().items())]
    if case == "grad_add":
        for p in params:
            p.grad_req = "add"
    if case == "sparse_grad":
        params[0].grad_stype = "row_sparse"


@pytest.mark.parametrize("case", BYPASS)
def test_zero_bypass_matrix_falls_back_loudly(case, caplog):
    """Every configuration ZeRO cannot shard runs the unsharded step,
    counts a fallback, warns with the JAX package's reason, and trains."""
    import logging

    import mxnet_tpu as jmx

    opt, tkw = _bypass_setup(jmx, case)
    jnet, jtr = jax_build(True, opt, layers=1, **tkw)
    if case == "amp":
        from mxnet_tpu.amp import LossScaler

        jscaler = LossScaler(init_scale=2.0)
    _bypass_mutate(jnet, jtr, case, jscaler if case == "amp" else None)
    jtr._init_kvstore()
    want = jtr._zero_ineligible_reason(list(jtr._contexts))
    if want is None:
        ctx0 = jax_ctxs()[0]
        want = jtr._optimizer.whole_step_plan(
            list(range(len(jtr._params))),
            [p.data(ctx0) for p in jtr._params], [None] * len(jtr._params),
            zero_world=N)[2].replace("LAMB", "_SeqSGD")
    opt, tkw = _bypass_setup(tmx, case)
    net, tr = build(True, opt, layers=1, **tkw)
    _bypass_mutate(net, tr, case, tmx.amp.LossScaler(init_scale=2.0)
                   if case == "amp" else None)
    before = zw.weights(net)
    ttrainer.reset_trainer_step_stats()
    with caplog.at_level(logging.WARNING, "mxnet_tpu_torch.trainer"):
        train(net, tr, 1)
    stats = ttrainer.trainer_step_stats()
    assert stats["zero_steps"] == 0 and stats["zero_fallbacks"] >= 1
    assert tr._zero_warned == {want}
    assert any(want in r.message for r in caplog.records)
    assert any(not np.array_equal(a, b)
               for a, b in zip(before, zw.weights(net)))


def test_single_replica_zero_is_silent_identity():
    """One context: sharding is the identity, the whole step is captured
    as without ZeRO (eagerly on the CPU), bit-identical, nothing counted."""
    net_u, tr_u = build(False, whole_step=True, ctx=tmx.cpu())
    net_z, tr_z = build(True, whole_step=True, ctx=tmx.cpu())
    ttrainer.reset_trainer_step_stats()
    for _ in range(3):
        train(net_u, tr_u, 1)
        train(net_z, tr_z, 1)
    assert_same(zw.weights(net_u), zw.weights(net_z))
    stats = ttrainer.trainer_step_stats()
    assert stats["zero_steps"] == 0 and stats["zero_fallbacks"] == 0
    assert stats["whole_step_eager"] == 0 and stats["whole_step_steps"] == 6
    assert not tr_z._zero_states


@pytest.mark.parametrize("env,arg,want", [
    ("1", None, True), ("0", None, False), ("1", False, False),
    (None, True, True)])
def test_env_knob_precedence(monkeypatch, env, arg, want):
    """``MXTPU_ZERO_SHARD`` when the argument is None; the argument wins."""
    if env is None:
        monkeypatch.delenv("MXTPU_ZERO_SHARD", raising=False)
    else:
        monkeypatch.setenv("MXTPU_ZERO_SHARD", env)
    assert build(arg)[1]._zero_shard is want


def test_kvstore_zero_collectives_equal_the_bucket_reduce():
    """``zero_reduce_scatter`` gives each rank its slice of what the fused
    pushpull sums, bit for bit, over uneven shapes; ``zero_allgather``
    brings the slices back; an ineligible store raises."""
    kv = tmx.kv.create("device")
    shapes = [(13,), (7, 5), (3,)]
    rng = np.random.RandomState(0)
    vals = [[tmx.nd.array(rng.randn(*s).astype(np.float32), ctx=c)
             for c in CTXS] for s in shapes]
    total = sum(int(np.prod(s)) for s in shapes)
    padded = tmx.kvstore.zero_padded_size(total, N)
    assert padded == 52 and padded % N == 0
    stats = {"buckets": 0, "dispatches": 0}
    shards = kv.zero_reduce_scatter(vals, padded, CTXS, stats)
    outs = kv.zero_allgather(shards, shapes, CTXS, stats)
    for k in range(len(shapes)):
        kv.init(k, vals[k][0])
    ref = [[tmx.nd.array(v.asnumpy(), ctx=v.context) for v in vl]
           for vl in vals]
    kv.pushpull(list(range(len(shapes))), ref, out=ref)
    for r in range(N):
        for got, want in zip(outs[r], ref):
            np.testing.assert_array_equal(got.numpy(), want[r].asnumpy())
    assert stats["buckets"] == 1
    for kind in ("dist_sync", "compressed"):
        bad = tmx.kv.create("dist_sync" if kind == "dist_sync" else "device")
        if kind == "compressed":
            bad.set_gradient_compression({"type": "2bit"})
        with pytest.raises(MXNetError, match="ineligible"):
            bad.zero_reduce_scatter(vals, padded, CTXS, stats)


# -- the states blob ----------------------------------------------------------


def test_states_dict_roundtrip_zero_to_unsharded_and_back():
    """3 sharded steps, the snapshot into an unsharded trainer, 2 steps:
    the uninterrupted sharded run, bit for bit; and that unsharded
    snapshot resumed sharded for 2 more."""
    cont_net, cont_tr = build(True)
    train(cont_net, cont_tr, 7)
    a_net, a_tr = build(True)
    train(a_net, a_tr, 3)
    blob = a_tr.states_dict()
    assert blob["zero"]["world"] == N
    assert all(v == {} for v in blob["states"].values())
    b_net, b_tr = build(False)
    copy_weights(a_net, b_net)
    b_tr.load_states_dict(blob)
    train(b_net, b_tr, 2)
    blob2 = b_tr.states_dict()
    assert "zero" not in blob2
    c_net, c_tr = build(True)
    copy_weights(b_net, c_net)
    c_tr.load_states_dict(blob2)
    train(c_net, c_tr, 2)
    assert_same(zw.weights(c_net), zw.weights(cont_net))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_zero_blobs_move_between_the_packages(direction, tmp_path,
                                              jax_zero_run):
    """A JAX-written ``"zero"`` blob resumes in the port (unsharded, then
    back to sharded), and a port-written one in the JAX package, each
    within 1e-6 of the uninterrupted JAX run."""
    want = jax_zero_run("adam")
    if direction == "jax_to_port":
        net, tr = build(False)
        for (_, p), w in zip(sorted(net._collect_params_with_prefix()
                                    .items()), want["steps"][2]):
            p.set_data(w)
        tr.load_states_dict(want["blob"])
        train(net, tr, 1)
        assert_close(zw.weights(net), want["steps"][3], XPKG_TOL)
        net2, tr2 = build(True)
        copy_weights(net, net2)
        tr2.load_states_dict(tr.states_dict())
        train(net2, tr2, 1)
        assert_close(zw.weights(net2), want["steps"][4], XPKG_TOL)
        return
    net, tr = build(True)
    train(net, tr, zw.SAVE_AT)
    f = str(tmp_path / "port.states")
    tr.save_states(f)
    jnet, jtr = jax_build(False)
    for (_, p), w in zip(sorted(jnet._collect_params_with_prefix().items()),
                         zw.weights(net)):
        p.set_data(w)
    jtr.load_states(f)
    jax_train(jnet, jtr, 2)
    assert_close(jax_weights(jnet), want["steps"][4], XPKG_TOL)


def test_partial_shard_blob_raises_actionable_error():
    net, tr = build(True)
    train(net, tr, 2)
    blob = tr.states_dict()
    blob["zero"]["shards"] = {0: blob["zero"]["shards"][0]}
    net2, tr2 = build(False)
    before = tr2.states_dict()
    with pytest.raises(MXNetError, match="CheckpointManager"):
        tr2.load_states_dict(blob)
    assert tr2.states_dict()["num_update"] == before["num_update"]


def test_unsharded_snapshot_supersedes_live_shards():
    """An unsharded blob loaded into a trainer with live shards drops them:
    the loaded states drive the next steps."""
    src_net, src_tr = build(False)
    train(src_net, src_tr, 1)
    blob = src_tr.states_dict()
    tgt_net, tgt_tr = build(True)
    train(tgt_net, tgt_tr, 3)
    assert tgt_tr._zero_states
    copy_weights(src_net, tgt_net)
    tgt_tr.load_states_dict(blob)
    assert not tgt_tr._zero_states
    train(tgt_net, tgt_tr, 2)
    ref_net, ref_tr = build(False)
    train(ref_net, ref_tr, 3)
    assert_same(zw.weights(ref_net), zw.weights(tgt_net))


def test_unsharded_fallback_after_sharded_steps_unshards_state():
    """An unsharded step after sharded ones gathers the shards back into
    per-parameter states first: the same trajectory, bit for bit."""
    net_z, tr_z = build(True)
    net_u, tr_u = build(False)
    train(net_z, tr_z, 3)
    train(net_u, tr_u, 3)
    assert tr_z._zero_states
    tr_z._zero_shard = False
    train(net_z, tr_z, 2)
    train(net_u, tr_u, 2)
    assert not tr_z._zero_states
    assert_same(zw.weights(net_u), zw.weights(net_z))


# -- CheckpointManager --------------------------------------------------------


def test_checkpoint_manager_roundtrips_sharded_and_unsharded(tmp_path):
    from mxnet_tpu_torch.checkpoint import CheckpointManager

    cont_net, cont_tr = build(True)
    train(cont_net, cont_tr, 5)
    for save_zero, load_zero in ((True, False), (False, True)):
        d = str(tmp_path / f"{save_zero}")
        net, tr = build(save_zero)
        train(net, tr, 3)
        CheckpointManager(d).save(3, params=net, trainer=tr, sync=True)
        meta = json.loads(open(os.path.join(d, "ckpt-00000003",
                                            "MANIFEST.json")).read())
        assert meta["num_processes"] == 1
        net2, tr2 = build(load_zero)
        assert CheckpointManager(d).restore(params=net2,
                                            trainer=tr2)["step"] == 3
        train(net2, tr2, 2)
        assert_same(zw.weights(net2), zw.weights(cont_net))


def test_checkpoint_gathers_shards_across_rank_files(tmp_path):
    """ZeRO shards split over ``trainer-shard0/1.states`` (the
    multi-process layout) are gathered before the load."""
    from mxnet_tpu_torch.checkpoint import CheckpointManager

    net, tr = build(True)
    train(net, tr, 3)
    d = str(tmp_path)
    CheckpointManager(d).save(3, params=net, trainer=tr, sync=True)
    ckpt = os.path.join(d, "ckpt-00000003")
    tfile = os.path.join(ckpt, "trainer-shard0.states")
    with open(tfile, "rb") as f:
        blob = pickle.load(f)
    shards = blob["zero"]["shards"]
    blob["zero"]["shards"] = {r: v for r, v in shards.items() if r < 2}
    with open(tfile, "wb") as f:
        pickle.dump(blob, f)
    peer = dict(blob, zero=dict(blob["zero"], shards={
        r: v for r, v in shards.items() if r >= 2}))
    with open(os.path.join(ckpt, "trainer-shard1.states"), "wb") as f:
        pickle.dump(peer, f)
    net2, tr2 = build(False)
    CheckpointManager(d).restore(params=net2, trainer=tr2)
    train(net2, tr2, 2)
    cont_net, cont_tr = build(True)
    train(cont_net, cont_tr, 5)
    assert_same(zw.weights(net2), zw.weights(cont_net))
    os.remove(os.path.join(ckpt, "trainer-shard1.states"))
    with pytest.raises(MXNetError, match=r"rank\(s\) \[2, 3\] of 4"):
        CheckpointManager(d).restore(step=3, params=net2, trainer=tr2)


def test_world_size_mismatch_strict_topology_names_sizes(tmp_path):
    """A checkpoint of another world size reshards by default (rank 0
    reads saved shard 0); ``strict_topology=True`` refuses it naming both
    sizes, in the JAX package's words."""
    from mxnet_tpu_torch.checkpoint import CheckpointManager

    net, tr = build(True)
    train(net, tr, 1)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, params=net, trainer=tr, sync=True)
    mpath = tmp_path / "ckpt-00000001" / "MANIFEST.json"
    manifest = json.loads(mpath.read_text())
    manifest["num_processes"] = 16
    mpath.write_text(json.dumps(manifest))
    net2, tr2 = build(True)
    with pytest.raises(MXNetError) as ei:
        mgr.restore(step=1, params=net2, trainer=tr2, strict_topology=True)
    msg = str(ei.value)
    assert "by a 16-process job" in msg and "runs 1 process" in msg
    assert "strict_topology" in msg
    assert mgr.restore(step=1, params=net2, trainer=tr2)["step"] == 1
    assert_same(zw.weights(net), zw.weights(net2))


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_checkpoint_directories_move_between_packages(direction, tmp_path,
                                                      jax_zero_run):
    """A sharded CheckpointManager directory of one package restores into
    an unsharded trainer of the other (``restore_rng=False``: the RNG files
    are package-specific) and resumes within 1e-6 of the JAX run."""
    want = jax_zero_run("adam")
    if direction == "jax_to_port":
        from mxnet_tpu_torch.checkpoint import CheckpointManager

        net, tr = build(False)
        CheckpointManager(want["ckpt"]).restore(params=net, trainer=tr,
                                                restore_rng=False)
        train(net, tr, 2)
        assert_close(zw.weights(net), want["steps"][4], XPKG_TOL)
        return
    from mxnet_tpu.checkpoint import CheckpointManager as JMgr
    from mxnet_tpu_torch.checkpoint import CheckpointManager

    net, tr = build(True)
    train(net, tr, zw.SAVE_AT)
    CheckpointManager(str(tmp_path)).save(zw.SAVE_AT, params=net, trainer=tr,
                                          sync=True)
    jnet, jtr = jax_build(False)
    JMgr(str(tmp_path)).restore(params=jnet, trainer=jtr, restore_rng=False)
    jax_train(jnet, jtr, 2)
    assert_close(jax_weights(jnet), want["steps"][4], XPKG_TOL)


# -- resharding ---------------------------------------------------------------


@pytest.mark.parametrize("new_world", [1, 2, 3, 8])
def test_reshard_matches_jax_and_round_trips(new_world):
    """``reshard_zero_snapshot`` N -> M equals the JAX package's, array for
    array, and N -> M -> N gives back the same bytes; ``source_rank`` and
    ``reshard_states_blob`` as the JAX functions."""
    from mxnet_tpu.checkpoint import reshard as jreshard

    net, tr = build(True)
    train(net, tr, 2)
    blob = tr.states_dict()
    zero = blob["zero"]
    got = treshard.reshard_zero_snapshot(zero, new_world)
    want = jreshard.reshard_zero_snapshot(zero, new_world)
    assert got["world"] == want["world"] == new_world
    assert got["chunks"] == want["chunks"]
    for r in range(new_world):
        for c, slots in want["shards"][r].items():
            for a, b in zip(got["shards"][r][c], slots):
                np.testing.assert_array_equal(a, b)
    back = treshard.reshard_zero_snapshot(got, N)
    assert back["chunks"] == zero["chunks"]
    for r, chunks in zero["shards"].items():
        for c, slots in chunks.items():
            for a, b in zip(back["shards"][r][c], slots):
                assert a.tobytes() == b.tobytes()
    assert [treshard.source_rank(r, new_world) for r in range(10)] == \
        [jreshard.source_rank(r, new_world) for r in range(10)]
    assert treshard.reshard_states_blob(blob, new_world)["zero"]["world"] \
        == new_world
    # the pipeline leg came with slice 8, part 1
    with pytest.raises(MXNetError, match="unrecognized pipeline state"):
        treshard.merge_pipeline_states([{}])


# -- several ranks (gloo) -----------------------------------------------------


@pytest.fixture(scope="session")
def zero4(tmp_path_factory):
    out = mw.shared_run("zero4", 4, lambda d: None, tmp_path_factory,
                        script=zw.__file__)
    return out, mw.read(out, "zero4", 4)


@pytest.fixture(scope="session")
def zero2(zero4, tmp_path_factory):
    def prepare(d):
        shutil.copytree(zero4[0] / "ckpt", d / "ckpt")

    out = mw.shared_run("zero2", 2, prepare, tmp_path_factory,
                        script=zw.__file__)
    return out, mw.read(out, "zero2", 2)


@pytest.mark.parametrize("world", [2, 4])
def test_dist_sync_whole_step_zero_matches_unsharded(world, zero4, zero2,
                                                     jax_zero_run):
    """The world step over ``world`` gloo ranks: ZeRO bit-identical to the
    unsharded step after every step, every rank the same bits, and each
    rank's state about 1/world of the unsharded state.  With ``batch_size``
    the global batch's rows, both are held after every step within 1e-6 of
    the JAX package's eager ZeRO over 4 contexts on the same 16 rows (the
    gradients' scale and their sum over the ranks)."""
    _, ranks = zero4 if world == 4 else zero2
    for meta, arr in ranks:
        assert meta["run"] == {"backend": "gloo", "size": world}
    meta0, arr0 = ranks[0]
    for opt, batch in itertools.product(zw.OPTS, ("", "_global")):
        full, zero = f"{opt}_full{batch}", f"{opt}_zero{batch}"
        assert meta0[full]["losses"] == meta0[zero]["losses"]
        for k in arr0.files:
            if k.startswith(zero + "/"):
                np.testing.assert_array_equal(
                    arr0[k], arr0[full + k[len(zero):]])
                for _, arr in ranks[1:]:
                    np.testing.assert_array_equal(arr[k], arr0[k])
        stats = meta0[zero]["stats"]
        assert stats["zero_steps"] == stats["whole_step_eager"] == zw.STEPS
        assert stats["zero_fallbacks"] == stats["whole_step_fallbacks"] == 0
        assert meta0[zero]["comm"]["param"]["calls"] == zw.STEPS
        per_full = meta0[full]["state_bytes"]["per_replica"]
        per_zero = meta0[zero]["state_bytes"]["per_replica"]
        assert per_full // world <= per_zero <= per_full // world + 64
        if batch:
            want = jax_zero_run(opt)["steps"]
            for case in (full, zero):
                for s in range(zw.STEPS):
                    assert_close([arr0[f"{case}/step{s}/p{i}"]
                                  for i in range(6)], want[s], XPKG_TOL)


def test_four_rank_checkpoint_resumes_at_two_ranks(zero4, zero2):
    """The 4-rank sharded checkpoint (a manifest of 4 processes, each rank's
    shards in its own file) restored at 2 ranks resumes within 1e-5 of the
    uninterrupted 4-rank run."""
    (_, r4), (_, r2) = zero4, zero2
    files = r4[0][0]["save"]["files"]
    assert [f for f in files if f.startswith("trainer-shard")] == [
        f"trainer-shard{r}.states" for r in range(4)]
    for meta, arr in r2:
        assert meta["restore"]["step"] == zw.SAVE_AT
        for s in range(zw.STEPS - zw.SAVE_AT):
            assert_close([arr[f"restore/step{s}/p{i}"] for i in range(6)],
                         [r4[0][1][f"save/step{s + zw.SAVE_AT}/p{i}"]
                          for i in range(6)], RESUME_TOL)


def test_four_rank_checkpoint_resumes_in_one_process(zero4):
    """The same checkpoint restored unsharded in this process (one context,
    every rank's rows): the manifest's 4 processes reshard onto 1, the
    shards gathered from the 4 files."""
    from mxnet_tpu_torch.checkpoint import CheckpointManager

    out, r4 = zero4
    net, tr = build(False, ctx=tmx.cpu(), whole_step=True)
    meta = CheckpointManager(str(out / "ckpt")).restore(params=net,
                                                        trainer=tr)
    assert meta["step"] == zw.SAVE_AT
    for s in range(zw.STEPS - zw.SAVE_AT):
        tr.whole_step(net, zw.port_loss, X, Y, batch_size=zw.ROWS)
        assert_close(zw.weights(net),
                     [r4[0][1][f"save/step{s + zw.SAVE_AT}/p{i}"]
                      for i in range(6)], RESUME_TOL)


# -- on the card --------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the update on the card); run on "
                    "the GPU machine with -m gpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_zero_fused_update_on_card_matches_cpu(cuda_device):
    """The fused ZeRO update (Adam, a 4-rank plan of the MLP's chunk) on
    CUDA shards equals the same plan run on CPU copies, bit for bit."""
    net, tr = build(True, ctx=tmx.cpu())
    opt = tr._optimizer
    ws = [p.data() for p in tr._params]
    plan, svals, _ = opt.whole_step_plan(list(range(len(ws))), ws,
                                         [None] * len(ws), zero_world=N)
    rng = np.random.RandomState(3)
    outs = {}
    for dev in ("cpu", cuda_device):
        w, g, states = [], [], []
        for chunk in plan:
            n = chunk[7] // N
            w.append(torch.tensor(rng.randn(n).astype(np.float32),
                                  device=dev))
            g.append(torch.tensor(rng.randn(n).astype(np.float32),
                                  device=dev))
            states.append(tuple(torch.tensor(rng.rand(n).astype(np.float32),
                                             device=dev)
                                for _ in range(chunk[2])))
        rng = np.random.RandomState(3)
        opt.zero_fused_update(plan, svals, w, g, states)
        outs[str(dev)] = [t.cpu().numpy() for t in w] + [
            t.cpu().numpy() for st in states for t in st]
    assert_same(outs["cpu"], outs[str(cuda_device)])


@pytest.mark.gpu
def test_one_context_zero_whole_step_on_card_is_a_silent_identity(
        cuda_device):
    """One context on gpu(0): ZeRO is the identity, the whole step is
    captured and replayed as without it, bit-identical to the unsharded
    trainer, with no ZeRO step or fallback counted."""
    from mxnet_tpu_torch import _imperative

    net_u, tr_u = build(False, whole_step=True, ctx=tmx.gpu(0))
    net_z, tr_z = build(True, whole_step=True, ctx=tmx.gpu(0))
    ttrainer.reset_trainer_step_stats()
    r0 = _imperative.graph_replay_count()
    for _ in range(4):
        train(net_u, tr_u, 1)
        train(net_z, tr_z, 1)
    torch.cuda.synchronize()
    assert_same(zw.weights(net_u), zw.weights(net_z))
    stats = ttrainer.trainer_step_stats()
    assert stats["zero_steps"] == 0 and stats["zero_fallbacks"] == 0
    assert stats["whole_step_eager"] == 0
    assert _imperative.graph_replay_count() - r0 == 2 * 3
    assert not tr_z._zero_states
