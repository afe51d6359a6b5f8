"""The port's profiler (``mxnet_tpu_torch/profiler.py``: op events, op
scopes, the counter sections) against the JAX package's
(``mxnet_tpu/profiler.py``), and the scopes and spans wired into the
port's trainer, whole step, checkpoints, input pipeline and server at the
JAX package's sites.

The section registry, the keys of each section the port has and the
``resilience`` table equal the JAX package's.  The wiring is checked on
the CPU (eager: a hybridized block's capture scope,
``cached_op.compile.*``, opens only on the card); each scope reaches the
tracer, and the step scopes reach an armed health monitor.
"""
import json
import threading

import numpy as np
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import profiler as tprof
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.telemetry import health as thealth

CPU = tmx.cpu()


def _jprof():
    import mxnet_tpu.profiler as jprof

    return jprof


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _scopes(events, ph="X"):
    return [(e["name"], e.get("cat")) for e in events if e.get("ph") == ph]


# -- against the JAX package --------------------------------------------------


def test_section_registry_and_keys_match_the_jax_profiler():
    import mxnet_tpu.gluon.trainer  # noqa: F401 (loads JAX trainerStep)
    import mxnet_tpu.pipeline  # noqa: F401
    import mxnet_tpu.resilience  # noqa: F401

    jprof = _jprof()
    assert tprof.section_names() == jprof.section_names()
    for health in (thealth, _jhealth()):
        with health.HealthMonitor(tick_sec=0):   # the health section appears
            pass
    got, want = tprof.sections(), jprof.sections()
    for name in ("cachedGraph", "dataPipeline", "resilience", "health",
                 "telemetry"):
        assert set(got[name]) == set(want[name]), name
    # the port also counts the whole steps that run eagerly over contexts
    # or ranks (gluon/whole_step.py)
    assert set(got["trainerStep"]) - set(want["trainerStep"]) == \
        {"whole_step_eager"}
    assert set(want["trainerStep"]) <= set(got["trainerStep"])
    # the decode, int8 and tuner tiers, where both packages have them
    # loaded, hold the same counters
    for name in ("decodeServe", "quantize", "tune"):
        if name in got and name in want:
            assert set(got[name]) == set(want[name]), name
    # the router and the control plane (slice 5, part 2), loaded in both
    import mxnet_tpu.serve.control_plane  # noqa: F401
    import mxnet_tpu_torch.serve.control_plane  # noqa: F401
    got, want = tprof.sections(), jprof.sections()
    for name in ("router", "ctrl"):
        assert set(got[name]) == set(want[name]), name


def _jhealth():
    import mxnet_tpu.telemetry.health as jhealth

    return jhealth


def test_resilience_table_matches_the_jax_table():
    from mxnet_tpu_torch.resilience import stats as rstats

    stats = {"restarts": 2, "retries": {"transient": 1, "preemption": 1},
             "fallback_restores": 1, "watchdog_fires": 0,
             "time_lost_ms": 12.5, "resizes": 0, "ranks_lost": 0,
             "reshard_ms": 0.0}
    assert tprof._resilience_table(stats) == \
        _jprof()._resilience_table(stats)
    rstats.reset_resilience_stats()
    rstats.add("restarts")
    rstats.add_retry("watchdog")
    tprof.set_config(aggregate_stats=True)
    try:
        table = tprof.dumps(reset=True, format="table")
        assert "Resilience (supervisor):" in table
        assert "retries[watchdog]" in table
        assert tprof.sections()["resilience"]["retries"] == {}
    finally:
        tprof.set_config(aggregate_stats=False)


# -- the profiler itself ------------------------------------------------------


def test_record_op_and_op_scope_while_the_profiler_runs():
    tprof.reset()
    tprof.set_config(profile_memory=True)
    tprof.set_state("run")
    try:
        net = tmx.gluon.nn.Dense(3, in_units=4)
        net.initialize(ctx=CPU)
        net(tmx.nd.array(np.ones((2, 4), np.float32), ctx=CPU))
        with tprof.op_scope("my.scope", cat="trainer"):
            pass
    finally:
        tprof.set_state("stop")
        tprof.set_config(profile_memory=False)
    data = json.loads(tprof.dumps(reset=True))
    names = [e["name"] for e in data["traceEvents"] if e["ph"] == "X"]
    assert net.name in names and "my.scope" in names
    assert "memoryPeaks" not in data   # profile_memory off at the dump
    assert json.loads(tprof.dumps())["traceEvents"] == []


def test_memory_peaks_are_kept_under_a_lock_across_threads():
    tprof.reset()

    def sample():
        for _ in range(200):
            tprof._memory_sample()

    threads = [threading.Thread(target=sample) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert set(tprof._mem_peak) == {"device_bytes_in_use", "pool_used_bytes"}
    assert all(v >= 0 for v in tprof._mem_peak.values())


def test_open_scopes_are_tracked_only_while_armed():
    with tprof.op_scope("before"):
        assert tprof.active_scopes() == {}
    tprof.track_scopes(True)
    try:
        with tprof.op_scope("outer"):
            with tprof.op_scope("inner"):
                scopes = tprof.active_scopes()
        assert list(scopes.values()) == [["outer", "inner"]]
        assert tprof.active_scopes() == {}
    finally:
        tprof.track_scopes(False)


def test_device_trace_dir_writes_a_torch_profiler_trace(tmp_path):
    tprof.set_config(xla_trace_dir=str(tmp_path))
    try:
        tprof.start()
        torch.ones(8) @ torch.ones(8)
        tprof.stop()
    finally:
        tprof.set_config(xla_trace_dir=None)
    files = list(tmp_path.glob("device-*.json"))
    assert len(files) == 1 and "traceEvents" in json.loads(files[0].read_text())


# -- the scopes wired into the port -------------------------------------------


def _mlp(ctx=CPU):
    tmx.random.seed(0)
    net = tmx.gluon.nn.HybridSequential()
    net.add(tmx.gluon.nn.Dense(8, in_units=4, activation="relu"),
            tmx.gluon.nn.Dense(2, in_units=8))
    net.initialize(ctx=ctx)
    return net


L2 = tmx.gluon.loss.L2Loss()


def test_trainer_scopes_reach_the_tracer_and_the_health_monitor(tmp_path):
    path = tmp_path / "trainer.json"
    x = tmx.nd.array(np.random.RandomState(0).rand(4, 4).astype(np.float32),
                     ctx=CPU)
    y = tmx.nd.array(np.zeros((4, 2), np.float32), ctx=CPU)
    thealth.reset_health_stats()
    thealth._reset_learned_flops()
    with ttel.trace(str(path)), thealth.HealthMonitor(tick_sec=0) as mon:
        net = _mlp()
        tr = tmx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1})
        with tmx.autograd.record():
            loss = L2(net(x), y)
        loss.backward()
        tr.step(4)
        ws = _mlp()
        wtr = tmx.gluon.Trainer(ws.collect_params(), "adam",
                                {"learning_rate": 0.1}, whole_step=True)
        for _ in range(3):
            wtr.whole_step(ws, L2, x, y)
        window = mon.tick()
        # over two contexts: the kvstore's all-reduce and the broadcast
        two = _mlp(ctx=[tmx.cpu(0), tmx.cpu(1)])
        ttr = tmx.gluon.Trainer(two.collect_params(), "sgd",
                                {"learning_rate": 0.1})
        xs = tmx.gluon.utils.split_and_load(x, [tmx.cpu(0), tmx.cpu(1)])
        ys = tmx.gluon.utils.split_and_load(y, [tmx.cpu(0), tmx.cpu(1)])
        with tmx.autograd.record():
            ls = [L2(two(a), b) for a, b in zip(xs, ys)]
        tmx.autograd.backward(ls)
        ttr.step(4)
    scopes = _scopes(_events(path))
    for want in (("trainer.step", "trainer"), ("fused_update", "trainer"),
                 ("whole_step", "trainer"), ("allreduce", "trainer"),
                 ("broadcast", "trainer")):
        assert want in scopes, want
    assert window["steps"] == 4   # one trainer.step and three whole steps
    params = sum(int(np.prod(p.shape)) for p in ws.collect_params().values())
    assert window["flops_per_step"] == 6 * params * 4
    assert window["flops_source"] == "analytic"


def test_checkpoint_scopes_and_the_fallback_restore_count(tmp_path):
    from mxnet_tpu_torch import resilience

    resilience.reset_resilience_stats()
    path = tmp_path / "ckpt.json"
    mgr = tmx.checkpoint.CheckpointManager(str(tmp_path / "ck"), keep_n=3)
    with tmx.cpu():
        w = tmx.nd.array(np.arange(4, dtype=np.float32))
    plan = resilience.FaultPlan([{"site": "checkpoint.commit",
                                  "action": "truncate", "match": {"step": 2}}])
    with ttel.trace(str(path)):
        mgr.save(1, params={"w": w}, sync=True)
        with resilience.armed(plan):
            mgr.save(2, params={"w": w}, sync=True)
        meta = mgr.restore()
    assert meta["step"] == 1
    assert resilience.resilience_stats()["fallback_restores"] == 1
    names = {n for n, c in _scopes(_events(path)) if c == "checkpoint"}
    assert {"checkpoint.save.capture", "checkpoint.save.readback",
            "checkpoint.save.commit", "checkpoint.restore"} <= names


def test_pipeline_spans_and_map_scopes(tmp_path):
    path = tmp_path / "pipe.json"
    with ttel.trace(str(path)), tmx.cpu():
        pipe = (tmx.pipeline.Pipeline(list(range(8))).shuffle(4, seed=1)
                .map(lambda v: v * 2).batch(2))
        assert len(list(pipe)) == 4
    scopes = _scopes(_events(path))
    assert ("pipeline.shuffle.fill", "dataPipeline") in scopes
    assert ("pipeline.map", "dataPipeline") in scopes


class _Echo(tmx.gluon.HybridBlock):
    def hybrid_forward(self, F, x):
        return x * 2


def test_serve_request_spans_scopes_and_metrics_export(tmp_path):
    from mxnet_tpu_torch.telemetry import metrics

    path = tmp_path / "serve.json"
    spec = tmx.serve.BucketSpec(batch_sizes=(1, 2), example_shape=(None,),
                                lengths=(8,), dtype="float32")
    reqs = [np.arange(n, dtype=np.float32) for n in (3, 5, 8)]
    with ttel.trace(str(path)):
        srv = tmx.serve.ModelServer(_Echo(), spec, ctx=CPU).start()
        answers = [f.result(60) for f in [srv.submit(r) for r in reqs]]
        text = metrics.default_registry().render()
        srv.shutdown()
    for a, r in zip(answers, reqs):
        np.testing.assert_array_equal(a, r * 2)
    events = _events(path)
    begins = [e for e in events if e["ph"] == "b"
              and e["name"] == "serve.request"]
    ends = [e for e in events if e["ph"] == "e"
            and e["name"] == "serve.request"]
    assert len(begins) == len(ends) == len(reqs)
    assert {e["args"]["outcome"] for e in ends} == {"served"}
    names = {n for n, _ in _scopes(events)}
    assert {"serve.warmup", "serve.pad", "serve.split"} <= names
    assert any(n.startswith("serve.batch.") for n in names)
    assert "mxtpu_serve_served{server=" in text


def test_cached_graph_section_counts_signatures():
    from mxnet_tpu_torch.gluon import block

    block.reset_cached_graph_stats()
    net = _mlp()
    net.hybridize()
    for n in (2, 2, 3):
        net(tmx.nd.array(np.ones((n, 4), np.float32), ctx=CPU))
    assert tprof.sections()["cachedGraph"] == {"compiles": 2, "reuses": 1}
