"""The port's resilience tier (``mxnet_tpu_torch/resilience/``: fault
plans, the retry policy, classification and the ``Supervisor``) against
the JAX package's (``mxnet_tpu/resilience/``), and the fault sites the
port arms.

Inputs are numpy from a seed.  The supervised harness is the JAX
package's own (``tests/test_resilience.py``'s Dense-8 MLP, a
``dist_sync`` kvstore with a local update, a shuffled pipeline, a
checkpoint a step), run in both packages from the same weights with the
same fault plans: in each package the chaos run is bit-identical to its
own clean run, the plans fire the same (site, action, hit) sequence, the
``resilience`` sections book the same recoveries, and the two packages'
final parameters agree within 1e-6 relative (float32 sums of 4-8 terms
in other orders over 8 SGD steps).  ``RetryPolicy`` delays and a
``FaultPlan``'s replay are equal bit for bit.

The non-elastic peer-death path across processes runs in the test
session's shared 2-rank gloo launch (``tests/torch_mesh_worker.py two``,
``case_peer_death``).
"""
import json
import os
import signal
import time
import weakref

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import engine as tengine
from mxnet_tpu_torch import resilience as tres
from mxnet_tpu_torch.base import MXNetError

FEAT, BS, N = 4, 4, 32
CROSS_RTOL = 1e-6


def _jmx():
    import mxnet_tpu as jmx

    return jmx


# -- the supervised harness, in either package --------------------------------


def _data():
    rng = np.random.RandomState(0)
    return [(rng.rand(FEAT).astype(np.float32), np.float32(i % 2))
            for i in range(N)]


def _start_weights():
    rng = np.random.RandomState(7)
    return {"0.weight": rng.uniform(-0.5, 0.5, (8, FEAT)).astype(np.float32),
            "0.bias": rng.uniform(-0.1, 0.1, (8,)).astype(np.float32),
            "1.weight": rng.uniform(-0.5, 0.5, (1, 8)).astype(np.float32),
            "1.bias": np.zeros((1,), np.float32)}


def _host(pkg, value):
    if pkg is tmx:
        return value.detach().cpu().numpy().copy()
    return value.asnumpy()


def _build_model(pkg):
    ctx = pkg.cpu()
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(8, in_units=FEAT, activation="relu"),
            pkg.gluon.nn.Dense(1, in_units=8))
    net.initialize(ctx=ctx)
    for k, p in net._collect_params_with_prefix().items():
        p.set_data(pkg.nd.array(_start_weights()[k], ctx=ctx))
    net.hybridize()
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.05},
                                kvstore="dist_sync", update_on_kvstore=False)
    return net, trainer


def _supervised_run(pkg, ckdir, faults=None, **sup_kwargs):
    """One supervised job of the harness; returns (final parameters, batch
    log, the plan's fired list, the resilience section)."""
    res = pkg.resilience
    res.reset_resilience_stats()
    plan = None
    if faults is not None:
        plan = res.FaultPlan(faults, seed=3)
        res.install_plan(plan)
    loss_fn = pkg.gluon.loss.L2Loss()
    data = _data()
    batches = {}
    try:
        mgr = pkg.checkpoint.CheckpointManager(str(ckdir), keep_n=3)
        sup_kwargs.setdefault("retry", res.RetryPolicy(max_retries=3,
                                                       base_delay=0.001))
        sup_kwargs.setdefault("max_restarts", 4)
        sup = res.Supervisor(mgr, on_preemption="resume", **sup_kwargs)

        def train(ctx):
            net, trainer = _build_model(pkg)
            pipe = (pkg.pipeline.Pipeline(data).shuffle(8, seed=5)
                    .batch(BS, last_batch="discard"))
            start = 0
            if ctx.manager.latest() is not None:
                meta = ctx.manager.restore(params=net, trainer=trainer,
                                           pipeline=pipe)
                start = meta["step"] + 1
            cur = {"step": start - 1}
            ctx.set_preemption_state(lambda: dict(
                step=cur["step"], params=net, trainer=trainer,
                pipeline=pipe))
            step = start
            for x, y in pipe:
                with pkg.autograd.record():
                    loss = loss_fn(net(x), y)
                loss.backward()
                trainer.step(BS)
                batches[step] = x.asnumpy().tobytes()
                cur["step"] = step
                ctx.step_done(step, save=dict(params=net, trainer=trainer,
                                              pipeline=pipe, sync=True))
                step += 1
            return {k: _host(pkg, p.data())
                    for k, p in net._collect_params_with_prefix().items()}

        if pkg is tmx:
            with tmx.cpu():
                params = sup.run(train)
        else:
            params = sup.run(train)
    finally:
        if plan is not None:
            res.clear_plan()
    fired = plan.fired() if plan is not None else []
    return params, batches, fired, res.resilience_stats()


_CLEAN = {}


def _clean_run(pkg, tmp_path_factory):
    key = pkg.__name__
    if key not in _CLEAN:
        _CLEAN[key] = _supervised_run(pkg, tmp_path_factory.mktemp("clean"))
    return _CLEAN[key]


SCENARIOS = {
    "transient": ([{"site": "kvstore.pushpull", "action": "raise",
                    "on_hit": 3}], {}, {"transient": 1}, 0),
    "kill_at_step_3": ([{"site": "train.step", "action": "kill",
                         "match": {"step": 3}}], {}, {"preemption": 1}, 0),
    "truncate_then_fallback": (
        [{"site": "checkpoint.commit", "action": "truncate",
          "match": {"step": 5}},
         {"site": "train.step", "action": "raise", "match": {"step": 6}}],
        {}, {"transient": 1}, 1),
    "watchdog": ([{"site": "train.step", "action": "stall",
                   "match": {"step": 2}, "delay_s": 5.0}],
                 {"watchdog_sec": 0.5}, {"watchdog": 1}, 0),
}


def _replay_key(fired):
    return [(f["site"], f["action"], f["hit"], f["ctx"].get("step"))
            for f in fired]


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_chaos_run_matches_its_clean_run_and_the_jax_package(
        scenario, tmp_path, tmp_path_factory):
    faults, sup_kwargs, retries, fallbacks = SCENARIOS[scenario]
    jmx = _jmx()
    got = {}
    for pkg in (tmx, jmx):
        ref_p, ref_b, _, _ = _clean_run(pkg, tmp_path_factory)
        params, batches, fired, stats = _supervised_run(
            pkg, tmp_path / pkg.__name__, faults, **sup_kwargs)
        assert batches == ref_b, f"{pkg.__name__}: the batch log parted"
        for k in ref_p:
            assert np.array_equal(params[k], ref_p[k]), \
                f"{pkg.__name__}: {k} parted from the clean run"
        assert stats["restarts"] == 1
        assert stats["retries"] == retries
        assert stats["fallback_restores"] == fallbacks
        assert stats["time_lost_ms"] > 0
        got[pkg.__name__] = (params, _replay_key(fired))
    (tp, tfired), (jp, jfired) = got["mxnet_tpu_torch"], got["mxnet_tpu"]
    assert tfired == jfired and len(tfired) == len(faults)
    for k in jp:
        err = np.abs(tp[k] - jp[k]).max() / np.abs(jp[k]).max()
        assert err <= CROSS_RTOL, (k, err)


@pytest.mark.parametrize("pkg_name", ["mxnet_tpu_torch", "mxnet_tpu"])
def test_transient_budget_exhausts_in_both_packages(pkg_name, tmp_path):
    pkg = tmx if pkg_name == "mxnet_tpu_torch" else _jmx()
    with pytest.raises(Exception, match="persisted through") as ei:
        _supervised_run(pkg, tmp_path, [{"site": "kvstore.pushpull",
                                         "action": "raise", "times": None}],
                        retry=pkg.resilience.RetryPolicy(max_retries=2,
                                                         base_delay=0.001))
    assert "RetryPolicy.max_retries=2" in str(ei.value)
    assert tengine.fault_point is tengine._fault_noop


# -- the leaves against the JAX package ---------------------------------------


def test_retry_policy_delays_match_the_jax_class_bit_for_bit():
    jres = _jmx().resilience
    kw = dict(max_retries=9, base_delay=0.05, max_delay=2.0, multiplier=2.0,
              jitter=0.3, seed=11)
    t, j = tres.RetryPolicy(**kw), jres.RetryPolicy(**kw)
    assert [t.delay_for(a) for a in range(1, 12)] == \
        [j.delay_for(a) for a in range(1, 12)]
    assert [t.should_retry(a) for a in range(12)] == \
        [j.should_retry(a) for a in range(12)]
    for bad in (dict(max_retries=-1), dict(jitter=1.0), dict(multiplier=0.5)):
        with pytest.raises(MXNetError):
            tres.RetryPolicy(**bad)


def _replay_plan(res):
    return res.FaultPlan([
        {"site": "a", "action": "delay", "delay_s": 0.0, "prob": 0.5,
         "times": None},
        {"site": "b", "action": "delay", "delay_s": 0.0, "on_hit": 3},
        {"site": "c", "action": "delay", "delay_s": 0.0,
         "match": {"step": 4}, "times": 2},
        {"site": "a", "action": "stall", "delay_s": 0.0, "prob": 0.25,
         "times": 3},
    ], seed=21)


def _fire_sequence(plan):
    rng = np.random.RandomState(5)
    for i in range(60):
        site = "abc"[rng.randint(3)]
        plan.fire(site, step=int(rng.randint(6)), i=i)
    return plan.fired(), plan.hits()


def test_fault_plan_replays_as_the_jax_plan_does():
    jres = _jmx().resilience
    tplan, jplan = _replay_plan(tres), _replay_plan(jres)
    t_fired, t_hits = _fire_sequence(tplan)
    j_fired, j_hits = _fire_sequence(jplan)
    assert t_fired == j_fired and t_hits == j_hits and len(t_fired) > 5
    tplan.reset()
    assert _fire_sequence(tplan)[0] == t_fired   # the determinism contract


def test_parse_plan_and_spec_errors_match_the_jax_package():
    jres = _jmx().resilience
    text = json.dumps({"seed": 7, "faults": [
        {"site": "train.step", "action": "kill", "match": {"step": 3}},
        {"site": "kvstore.pushpull", "action": "raise", "on_hit": 6}]})
    t, j = tres.parse_plan(text), jres.parse_plan(text)
    assert [(s.site, s.action, s.on_hit, s.match) for s in t._specs] == \
        [(s.site, s.action, s.on_hit, s.match) for s in j._specs]
    for bad in ("not json", json.dumps({"faults": 3}),
                json.dumps({"faults": [{"site": "x", "action": "boom"}]})):
        with pytest.raises(MXNetError):
            tres.parse_plan(bad)
        with pytest.raises(Exception):
            jres.parse_plan(bad)
    with pytest.raises(MXNetError, match="dead_ranks"):
        tres.FaultSpec("dist.allreduce", "peer_death")


def _classified_errors(pkg):
    res = pkg.resilience
    err = pkg.base.MXNetError
    batcher = __import__(pkg.__name__ + ".serve.batcher", fromlist=["x"])
    return [
        res.TransientFault("injected transient fault at 'x'"),
        res.Preempted("SIGTERM"), res.WatchdogTimeout("stuck"),
        res.faults.PeerDeathFault("rank(s) [1] likely dead or partitioned",
                                  dead_ranks=[1]),
        err("allreduce timed out: a peer process is likely dead or "
            "partitioned"),
        err("no retained checkpoint under /x is loadable — every step "
            "failed: step 2: corrupt or truncated NDArray file"),
        err("/x/params-shard0.params: corrupt or truncated NDArray file"),
        err("request rejected: queue full"), err("deadline exceeded"),
        err("connection reset by peer"), ConnectionResetError("reset"),
        BrokenPipeError("pipe"), err("UNAVAILABLE: try again later"),
        err("RESOURCE_EXHAUSTED while staging"), err("collective aborted"),
        batcher.ServerOverloadedError("queue full"),
        batcher.DeadlineExceededError("deadline passed while queued"),
        ValueError("a real bug"), KeyError("x"),
    ]


def test_classify_matches_the_jax_package_on_every_fault_class():
    jmx = _jmx()
    t = [tres.classify(e) for e in _classified_errors(tmx)]
    j = [jmx.resilience.classify(e) for e in _classified_errors(jmx)]
    assert t == j
    assert set(t) == {"transient", "preemption", "watchdog", "peer_death",
                      "fatal", "corrupt_checkpoint", "overloaded",
                      "deadline", "network"}


CUDA_TEXTS = [
    "CUDA error: an illegal memory access was encountered",
    "CUDA error: unspecified launch failure",
    "CUDA error: misaligned address",
    "CUDA error: an illegal instruction was encountered",
    "CUDA error: device-side assert triggered",
    "CUDA error: operation not permitted when stream is capturing",
    "cudaErrorStreamCaptureInvalidated: operation failed due to a previous "
    "error during capture",
    "CUDA error: capture sequence has been invalidated",
    # a kernel wrapper's own re-raise (ops/kernels/build.py)
    "gru_fwd kernel launch failed: operation failed due to a previous "
    "error during capture (cudaError 901)",
]


@pytest.mark.parametrize("text", CUDA_TEXTS)
def test_sticky_cuda_errors_classify_fatal_never_transient(text):
    jres = _jmx().resilience
    assert tres.classify(RuntimeError(text)) == "fatal"
    # a wrapper's re-raise as MXNetError, with a transient-looking word
    wrapped = MXNetError(f"flash attention launch aborted: {text}")
    assert jres.classify(
        _jmx().base.MXNetError(f"launch aborted: {text}")) == "transient"
    assert tres.classify(wrapped) == "fatal"
    try:
        try:
            raise RuntimeError(text)
        except RuntimeError as e:
            raise MXNetError("the whole step failed; try again") from e
    except MXNetError as chained:
        assert tres.classify(chained) == "fatal"


# -- the port's own contracts -------------------------------------------------


def test_fault_point_is_the_noop_until_a_plan_is_armed():
    assert tengine.fault_point is tengine._fault_noop
    plan = tres.FaultPlan([{"site": "x", "action": "delay",
                            "delay_s": 0.0}])
    with tres.armed(plan):
        assert tengine.fault_points_armed()
        assert getattr(tengine.fault_point, "__self__", None) is plan
        tengine.fault_point("x")
    assert tengine.fault_point is tengine._fault_noop
    assert [f["site"] for f in plan.fired()] == ["x"]
    tres.install_plan(plan)
    tres.clear_plan()
    assert tengine.fault_point is tengine._fault_noop


def test_install_from_env_arms_the_plan_once(monkeypatch):
    from mxnet_tpu_torch.resilience import faults

    monkeypatch.setattr(faults, "_env_installed", False)
    monkeypatch.setenv("MXTPU_FAULT_PLAN", json.dumps(
        {"faults": [{"site": "y", "action": "delay", "delay_s": 0.0}]}))
    try:
        faults.install_from_env()
        plan = tengine.fault_point.__self__
        faults.install_from_env()   # idempotent: the same plan
        assert tengine.fault_point.__self__ is plan
        tengine.fault_point("y")
        assert plan.hits("y") == 1
    finally:
        tres.clear_plan()
    assert tengine.fault_point is tengine._fault_noop


def _commit_step(tmp_path, mgr_dir, w):
    mgr = tmx.checkpoint.CheckpointManager(str(mgr_dir))
    mgr.save(1, params={"w": w}, sync=True)
    return mgr


def test_every_fault_site_of_the_port_fires(tmp_path):
    from mxnet_tpu_torch.parallel import dist

    sites = ["engine.h2d", "engine.d2h", "checkpoint.commit",
             "checkpoint.reshard", "kvstore.pushpull", "dist.allreduce",
             "dist.barrier", "train.step", "pipeline.map"]
    plan = tres.FaultPlan([{"site": s, "action": "delay", "delay_s": 0.0,
                            "times": None} for s in sites])
    with tres.armed(plan), tmx.cpu():
        tengine.batched_put([np.ones(3, np.float32)], torch.device("cpu"))
        w = tmx.nd.array(np.arange(4, dtype=np.float32))
        mgr = _commit_step(tmp_path, tmp_path / "ck", w)
        # a one-process job restoring a two-process checkpoint reshards
        d = tmp_path / "ck" / "ckpt-00000001"
        manifest = json.loads((d / "MANIFEST.json").read_text())
        manifest["num_processes"] = 2
        (d / "MANIFEST.json").write_text(json.dumps(manifest))
        for name in ("params-shard0.params", "rng-shard0.json"):
            (d / name.replace("0", "1")).write_bytes((d / name).read_bytes())
        mgr.restore(params={"w": tmx.nd.zeros((4,))})
        kv = tmx.kv.create("local")
        kv.init(0, w)
        kv.pushpull(0, w, out=w)
        dist.allreduce(w)
        dist.barrier("test")
        sup = tres.Supervisor(on_preemption="resume")
        sup.run(lambda ctx: ctx.step_done(0))
        list(tmx.pipeline.Pipeline([1, 2, 3]).map(lambda v: v * 2))
    hits = plan.hits()
    assert {s for s in sites if hits.get(s, 0) == 0} == set()
    assert tengine.fault_point is tengine._fault_noop


def test_supervisor_restores_sigterm_and_writes_the_resume_marker(tmp_path):
    before = signal.getsignal(signal.SIGTERM)
    mgr = tmx.checkpoint.CheckpointManager(str(tmp_path), keep_n=2)
    sup = tres.Supervisor(mgr, on_preemption="exit")
    with tmx.cpu():
        w = tmx.nd.array(np.ones((2, 2), np.float32))

    def train(ctx):
        ctx.set_preemption_state(lambda: dict(step=7, params={"w": w}))
        ctx.step_done(7)
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(5)
        raise AssertionError("SIGTERM was swallowed")

    with pytest.raises(tres.ResumeRequired, match="resume marker"):
        sup.run(train)
    assert mgr.latest() == 7
    marker = json.loads(open(sup.resume_marker).read())
    assert marker["reason"] == "preemption"
    assert marker["latest_checkpoint"] == 7
    assert signal.getsignal(signal.SIGTERM) == before


def test_peer_death_restarts_in_one_process_and_exits_across_processes(
        tmp_path, monkeypatch):
    from mxnet_tpu_torch.parallel import dist

    calls = []
    plan = tres.FaultPlan([{"site": "dist.allreduce", "action": "peer_death",
                            "on_hit": 2, "dead_ranks": [1]}])

    def train(ctx):
        calls.append(ctx.attempt)
        for s in range(3):
            dist.allreduce(torch.ones(2))
            ctx.step_done(s)
        return "done"

    with tres.armed(plan):
        assert tres.Supervisor(on_preemption="resume").run(train) == "done"
    assert calls == [0, 1]
    assert tres.resilience_stats()["retries"].get("peer_death", 0) >= 1
    # across processes the port cannot re-form the group (slice 7, part 3);
    # the fault fires at the first all-reduce, before any collective
    monkeypatch.setattr(dist, "is_multiprocess", lambda: True)
    plan = tres.FaultPlan([{"site": "dist.allreduce", "action": "peer_death",
                            "on_hit": 1, "dead_ranks": [1]}])
    marker = tmp_path / "RESUME.json"
    with tres.armed(plan):
        with pytest.raises(tres.ResumeRequired, match="resume marker"):
            tres.Supervisor(resume_marker=str(marker), world=2).run(train)
    got = json.loads(marker.read_text())
    assert got["reason"] == "peer_death"
    assert got["topology"] == {"world": 1, "dead_ranks": [1], "resizes": 0}
    with pytest.raises(MXNetError, match="slice 7, part 3"):
        tres.Supervisor(elastic=True)


def test_a_failed_attempt_is_freed_before_the_next_one(tmp_path):
    refs = []

    class Model:
        pass

    def train(ctx):
        if refs:
            assert refs[0]() is None, "the failed attempt is still alive"
            return "done"
        model = Model()
        refs.append(weakref.ref(model))
        model.cycle = model   # a reference cycle, as blocks and graphs make
        raise tres.TransientFault("injected transient fault at 'x'")

    sup = tres.Supervisor(on_preemption="resume",
                          retry=tres.RetryPolicy(base_delay=0.0))
    assert sup.run(train) == "done"


def test_watchdog_names_the_open_scope(tmp_path):
    from mxnet_tpu_torch import profiler

    tres.reset_resilience_stats()
    sup = tres.Supervisor(watchdog_sec=0.4, max_restarts=0)

    def train(ctx):
        ctx.step_done(0)
        with profiler.op_scope("dist.allreduce", cat="operator"):
            time.sleep(30)
        raise AssertionError("the watchdog never fired")

    with pytest.raises(tres.WatchdogTimeout) as ei:
        sup.run(train)
    assert "dist.allreduce" in str(ei.value)
    assert "last completed step: 0" in str(ei.value)
    assert tres.resilience_stats()["watchdog_fires"] == 1
    assert profiler.active_scopes() == {}


# -- across processes: the shared 2-rank gloo launch --------------------------


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    import torch_mesh_worker as w
    from test_torch_mesh_models import _prepare

    out = w.shared_run("two", 2, _prepare, tmp_path_factory)
    return w.read(out, "two", 2)


def test_peer_death_across_gloo_ranks_writes_the_marker_and_exits(two):
    for r, (meta, _) in enumerate(two):
        got = meta["peer_death"]
        assert "resume marker" in got["result"], got["result"]
        assert got["steps"] == [3.0, 3.0]   # two all-reduces of 1 + 2
        assert got["marker"]["reason"] == "peer_death"
        assert got["marker"]["topology"]["world"] == 1
        assert [(f["site"], f["action"], f["hit"]) for f in got["fired"]] \
            == [("dist.allreduce", "peer_death", 3)]
        assert got["hooks_noop"]


# -- on the card --------------------------------------------------------------


def _card_run(ckdir, faults=None):
    """A supervised MLP through the captured whole step on gpu(0), fed by a
    pipeline prefetched to the card; returns (parameters, batch log,
    captures by attempt, the resilience section)."""
    from mxnet_tpu_torch import _imperative

    gpu = tmx.gpu(0)
    rng = np.random.RandomState(2)
    data = [(rng.rand(16, FEAT).astype(np.float32),
             rng.rand(16, 1).astype(np.float32)) for _ in range(8)]
    loss_fn = tmx.gluon.loss.L2Loss()
    tres.reset_resilience_stats()
    plan = tres.FaultPlan(faults or [], seed=1)
    mgr = tmx.checkpoint.CheckpointManager(str(ckdir), keep_n=2)
    batches, captures = {}, []

    def train(ctx):
        captures.append(_imperative.graph_capture_count())
        tmx.random.seed(0)
        net = tmx.gluon.nn.HybridSequential()
        net.add(tmx.gluon.nn.Dense(8, in_units=FEAT, activation="relu"),
                tmx.gluon.nn.Dense(1, in_units=8))
        net.initialize(tmx.init.Xavier(), ctx=gpu)
        trainer = tmx.gluon.Trainer(net.collect_params(), "adam",
                                    {"learning_rate": 0.01}, whole_step=True)
        pipe = tmx.pipeline.Pipeline(data).prefetch_to_device(gpu, 2)
        start = 0
        if ctx.manager.latest() is not None:
            start = ctx.manager.restore(params=net, trainer=trainer,
                                        pipeline=pipe)["step"] + 1
        cur = {"step": start - 1}
        ctx.set_preemption_state(lambda: dict(
            step=cur["step"], params=net, trainer=trainer, pipeline=pipe))
        for step, (x, y) in enumerate(pipe, start):
            trainer.whole_step(net, loss_fn, x, y).asscalar()
            batches[step] = x.asnumpy().tobytes()
            cur["step"] = step
            ctx.step_done(step, save=dict(params=net, trainer=trainer,
                                          pipeline=pipe, sync=True)
                          if step % 2 else None)
        return [p.data().detach().cpu().clone()
                for p in net.collect_params().values()]

    with tres.armed(plan):
        params = tres.Supervisor(mgr, on_preemption="resume").run(train)
    captures.append(_imperative.graph_capture_count())
    return (params, batches, [b - a for a, b in zip(captures, captures[1:])],
            tres.resilience_stats())


@pytest.mark.gpu
def test_supervised_captured_steps_resume_bit_identically_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a captured step has no CPU mode); "
                    "run on the GPU machine with -m gpu")
    ref, ref_b, ref_caps, _ = _card_run(tmp_path / "clean")
    got, got_b, caps, stats = _card_run(tmp_path / "chaos", [
        {"site": "train.step", "action": "kill", "match": {"step": 3}},
        {"site": "train.step", "action": "raise", "match": {"step": 6}}])
    assert got_b == ref_b
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert ref_caps == [1] and caps == [1, 1, 1]
    assert stats["retries"] == {"preemption": 1, "transient": 1}
    assert tengine.fault_point is tengine._fault_noop
