"""The port's replica pool (``mxnet_tpu_torch/serve/router.py``) against
the JAX package's (``mxnet_tpu/serve/router.py``), on the CPU.

Both packages serve the same Dense model (the control-plane worker's
``model`` kind, the JAX weights carried across with
``load_numpy_params``) through a 3-replica ``Router`` under the same
seeded ``FaultPlan``: the outputs agree within 1e-6, each request tries
the same replicas in the same order, the same replica is evicted and the
same counters move.  A replica's EWMA service time is wall-clock, so the
parity episode scores replicas by their queue alone (in both packages);
``test_least_loaded_pick_weighs_the_ewma_service_time`` holds the EWMA
rule itself.  Then the port's own contracts, after the JAX package's
tests: deadline budgets, overload spill and shed, hedging, quotas,
eviction with a warm spare and no post-warm-up compile, rolling reload
serving old xor new, a decode pool token for token equal to the JAX
``DecodeServer``, the two capture repairs (launches booked per capturing
thread, a counted collector guard) and, on the card, a spare captured
while a peer replays under traffic.
"""
import gc
import json
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import _imperative, serve
from mxnet_tpu_torch.checkpoint import CheckpointManager
from mxnet_tpu_torch.gluon import nn, whole_step
from mxnet_tpu_torch.ops.kernels import build as kbuild
from mxnet_tpu_torch.resilience import RetryPolicy, faults
from mxnet_tpu_torch.resilience.supervisor import classify
from mxnet_tpu_torch.serve import router as trouter
from mxnet_tpu_torch.serve.batcher import (DeadlineExceededError,
                                           ServerOverloadedError)

FEAT = 6
CPU = tmx.cpu()
VOCAB = 64
TIMEOUT = 60


def _jax_net(seed=3):
    import mxnet_tpu as jmx
    from mxnet_tpu.gluon import nn as jnn

    jmx.random.seed(seed)
    net = jnn.HybridSequential()
    net.add(jnn.Dense(8, flatten=False, in_units=FEAT, activation="relu"),
            jnn.Dense(5, flatten=False, in_units=8))
    net.initialize(jmx.init.Xavier())
    return net


def _host_params(block):
    return {k: np.array(p.data().asnumpy())
            for k, p in block._collect_params_with_prefix().items()}


def _port_net(seed=3, weights=None):
    """The worker's ``model`` kind; with ``weights``, those values."""
    tmx.random.seed(seed)
    net = nn.HybridSequential()
    net.add(nn.Dense(8, flatten=False, in_units=FEAT, activation="relu"),
            nn.Dense(5, flatten=False, in_units=8))
    net.initialize(tmx.init.Xavier(), ctx=CPU)
    if weights is not None:
        tmx.load_numpy_params(net, weights)
    return net


def _spec(mod=serve, batches=(1, 2, 4), lengths=(4, 8)):
    return mod.BucketSpec(batch_sizes=batches, example_shape=(None, FEAT),
                          lengths=lengths)


def _factory(seed=3, checkpoint=None, servers=None, **kw):
    kw.setdefault("max_queue", 64)
    kw.setdefault("linger_ms", 0.5)

    def factory(rid):
        srv = serve.ModelServer(_port_net(seed=seed), _spec(),
                                checkpoint=checkpoint, ctx=CPU, **kw)
        if servers is not None:
            servers.append(srv)
        return srv
    return factory


def _router(n=3, seed=3, health_sec=0.0, **kw):
    return serve.Router(_factory(seed=seed), n, health_sec=health_sec, **kw)


def _requests(n, rng, lengths=(2, 3, 4, 7, 8)):
    return [rng.rand(int(rng.choice(lengths)), FEAT).astype(np.float32)
            for _ in range(n)]


def _ref(net, x):
    return net(tmx.nd.array(x[None], ctx=CPU)).asnumpy()[0]


def _wait(pred, timeout=TIMEOUT):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


# -- against the JAX package --------------------------------------------------


#: replica 1 fails every dispatch; evict_after=2 trips it at its 2nd
CHAOS_PLAN = [{"site": "serve.replica.submit", "action": "raise",
               "match": {"replica": 1}, "times": None}]


def _parity_episode(pkg, make_server, resilience, reqs):
    """``reqs`` one at a time through a 3-replica pool of ``pkg.serve``
    under CHAOS_PLAN.  Returns the outputs, the replica each served
    request reached, the plan's record, the router's window counters and
    its stats."""
    served_on = []

    def factory(rid):
        srv = make_server()
        submit = srv.submit

        def spy(example, deadline_ms=None, **kw):
            served_on.append(rid)
            return submit(example, deadline_ms=deadline_ms, **kw)
        srv.submit = spy
        return srv

    rt_mod = pkg.serve.router
    rt_mod.reset_router_stats()
    router = pkg.serve.Router(
        factory, 3, health_sec=0.0, evict_after=2,
        retry=resilience.RetryPolicy(max_retries=3, base_delay=0.0,
                                     max_delay=0.0))
    router.start()
    plan = resilience.faults.FaultPlan(CHAOS_PLAN, seed=7)
    outs = []
    try:
        with resilience.faults.armed(plan):
            for x in reqs:
                outs.append(router.submit(x).result(timeout=TIMEOUT))
                # the warm spare joins before the next request: the
                # dispatch order is then the policy's alone
                assert _wait(lambda: router.stats()["replacements"]
                             == router.stats()["evictions"])
        stats = router.stats()
    finally:
        router.shutdown(drain=False)
    return outs, served_on, plan.fired(), rt_mod.router_stats(), stats


def _stats_view(s):
    keep = [*trouter.ROUTER_COUNTERS, "requests_lost", "pool_size",
            "healthy", "queue_depth", "in_flight"]
    out = {k: s[k] for k in keep}
    out["replicas"] = {i: {k: v for k, v in r.items() if k != "ewma_ms"}
                       for i, r in s["replicas"].items()}
    return out


def test_pool_under_a_fault_plan_matches_jax(monkeypatch):
    """Sequential requests through 3 replicas while replica 1 fails every
    dispatch: in both packages the same outputs (1e-6), the same replicas
    tried, the same eviction and warm spare, the same counters."""
    import mxnet_tpu as jmx
    from mxnet_tpu import resilience as jres
    from mxnet_tpu.serve import router as jrouter

    from mxnet_tpu_torch import resilience as tres

    for mod in (trouter, jrouter):
        monkeypatch.setattr(mod.Replica, "score",
                            lambda self: float(self.server.pending() + 1))
    jnet = _jax_net()
    weights = _host_params(jnet)

    def jax_server():
        net = _jax_net()
        return jmx.serve.ModelServer(net, _spec(jmx.serve), max_queue=64,
                                     linger_ms=0.5)

    def port_server():
        return serve.ModelServer(_port_net(weights=weights), _spec(),
                                 max_queue=64, linger_ms=0.5, ctx=CPU)

    reqs = _requests(12, np.random.RandomState(0))
    want = _parity_episode(jmx, jax_server, jres, reqs)
    got = _parity_episode(tmx, port_server, tres, reqs)
    for g, w in zip(got[0], want[0]):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    assert got[1] == want[1]
    assert 1 not in got[1] and 3 in got[1]      # evicted, spare admitted
    assert got[2] == want[2]
    assert [f["ctx"]["replica"] for f in got[2]] == [1, 1]
    assert got[3] == want[3]
    assert _stats_view(got[4]) == _stats_view(want[4])
    assert got[4]["evictions"] == got[4]["replacements"] == 1
    assert got[4]["requests_lost"] == 0 and got[4]["served"] == len(reqs)


def test_least_loaded_pick_weighs_the_ewma_service_time():
    router = _router(3)
    router.start()
    try:
        a, b, c = router.replicas
        a.ewma_ms = b.ewma_ms = c.ewma_ms = 10.0
        b.server.pending = lambda: 5
        c.server.pending = lambda: 2
        a.server.pending = lambda: 0
        assert router._pick(frozenset()) is a
        assert router._pick({a.id}) is c
        a.ewma_ms = 1000.0   # idle but very slow loses to a short queue
        assert router._pick(frozenset()) is c
    finally:
        router.shutdown(drain=False)


def test_decode_pool_matches_the_jax_decode_server():
    """A Router over 2 port DecodeServer replicas (JAX weights carried
    across): every request's tokens equal the JAX DecodeServer's, through
    submit and submit_stream, with one-token health probes."""
    import mxnet_tpu as jmx
    from mxnet_tpu import serve as jserve

    jmx.random.seed(4)
    jmodel = jserve.TinyDecoder(vocab=VOCAB, embed=16)
    jmodel.initialize(jmx.init.Xavier())
    weights = _host_params(jmodel)

    def dspec(mod):
        return mod.BucketSpec(batch_sizes=(1, 2), example_shape=(None,),
                              lengths=(4, 8), dtype="int32")

    def factory(rid):
        tmx.random.seed(4)
        m = serve.TinyDecoder(vocab=VOCAB, embed=16)
        m.initialize(tmx.init.Xavier(), ctx=CPU)
        tmx.load_numpy_params(m, weights)
        return serve.DecodeServer(m, dspec(serve), max_slots=2, max_len=24,
                                  ctx=CPU)

    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, VOCAB, size=int(rng.randint(2, 8)))
               .astype(np.int32) for _ in range(8)]
    jsrv = jserve.DecodeServer(jmodel, dspec(jserve), max_slots=2,
                               max_len=24)
    jsrv.start()
    try:
        want = [np.asarray(jsrv.generate(p, max_new_tokens=6,
                                         timeout=TIMEOUT)) for p in prompts]
    finally:
        jsrv.shutdown()
    router = serve.Router(factory, 2, health_sec=0.05)
    router.start()
    try:
        assert router._probe_kwargs == {"max_new_tokens": 1}
        futs = [router.submit(p, max_new_tokens=6) for p in prompts[:4]]
        streams = [router.submit_stream(p, max_new_tokens=6)
                   for p in prompts[4:]]
        got = [f.result(timeout=TIMEOUT) for f in futs]
        got += [np.asarray(list(h), np.int32) for h in streams]
        assert _wait(lambda: router.stats()["probes"] >= 2)
    finally:
        router.shutdown()
    assert len({tuple(w) for w in want}) > 2   # the prompts decode apart
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    s = router.stats()
    assert s["served"] == 8 and s["requests_lost"] == 0
    for rep in router.replicas:
        assert rep.server.stats()["graph"]["post_warmup_compiles"] == 0


# -- the port's contracts -----------------------------------------------------


def test_deadline_budget_propagates_to_the_retry():
    """The retry replica sees the caller's budget less the failed first
    dispatch and its 150 ms backoff, not the original figure."""
    seen = []
    router = _router(2, retry=RetryPolicy(max_retries=2, base_delay=0.15,
                                          max_delay=0.15))
    router.start()
    try:
        for rep in router.replicas:
            orig = rep.server.submit

            def spy(example, _orig=orig, deadline_ms=None, **kw):
                seen.append(deadline_ms)
                return _orig(example, deadline_ms=deadline_ms, **kw)
            rep.server.submit = spy
        plan = faults.FaultPlan([{"site": "serve.replica.submit",
                                  "action": "raise", "on_hit": 1}])
        with faults.armed(plan):
            out = router.submit(np.zeros((4, FEAT), np.float32),
                                deadline_ms=2000).result(timeout=TIMEOUT)
        assert out.shape == (4, 5)
        assert len(seen) == 1 and 0 < seen[0] <= 2000 - 140
        s = router.stats()
        assert s["retries"] == 1 and s["served"] == 1
        assert s["requests_lost"] == 0
    finally:
        router.shutdown()


def test_retries_exhaust_and_expired_budgets_fail_classified():
    router = _router(2, retry=RetryPolicy(max_retries=1, base_delay=0.0))
    router.start()
    try:
        plan = faults.FaultPlan([{"site": "serve.replica.submit",
                                  "action": "raise", "times": None}])
        with faults.armed(plan):
            fut = router.submit(np.zeros((4, FEAT), np.float32))
            with pytest.raises(tmx.MXNetError, match="retry budget"):
                fut.result(timeout=TIMEOUT)
        fut = router.submit(np.zeros((4, FEAT), np.float32),
                            deadline_ms=-1.0)
        with pytest.raises(DeadlineExceededError, match="budget"):
            fut.result(timeout=TIMEOUT)
        s = router.stats()
        assert s["failed"] == 1 and s["expired_deadline"] == 1
        assert s["requests_lost"] == 0
    finally:
        router.shutdown()


def test_overload_spills_then_sheds_without_retries():
    router = _router(2)
    router.start()
    try:
        tried = []
        for rep in router.replicas:
            def full(example, deadline_ms=None, _id=rep.id, **kw):
                tried.append(_id)
                raise ServerOverloadedError("request queue full (0)")
            rep.server.submit = full
        fut = router.submit(np.zeros((4, FEAT), np.float32))
        with pytest.raises(serve.NoHealthyReplicaError) as ei:
            fut.result(timeout=TIMEOUT)
        assert classify(ei.value) == "overloaded"
        assert sorted(tried) == [0, 1]          # spilled across the pool
        s = router.stats()
        assert s["rejected_overload"] == 1 and s["retries"] == 0
        assert s["requests_lost"] == 0
    finally:
        router.shutdown(drain=False)


def test_tenant_quota_admission_control():
    router = _router(2, tenant_quota=2)
    router.start()
    try:
        for rep in router.replicas:
            rep.server.submit = \
                lambda example, deadline_ms=None, **kw: Future()
        x = np.zeros((4, FEAT), np.float32)
        f1 = router.submit(x, tenant="a")
        f2 = router.submit(x, tenant="a")
        with pytest.raises(serve.TenantQuotaExceededError) as ei:
            router.submit(x, tenant="a")
        assert classify(ei.value) == "overloaded"
        f3 = router.submit(x, tenant="b")   # other tenants unaffected
        f4 = router.submit(x)               # untenanted: no quota
        f1.cancel()                          # a resolution frees the slot
        f5 = router.submit(x, tenant="a")
        s = router.stats()
        assert s["rejected_quota"] == 1 and s["submitted"] == 5
    finally:
        router.shutdown(drain=False)
    for f in (f2, f3, f4, f5):
        assert f.done()
    assert router.stats()["requests_lost"] == 0


def test_hedge_near_deadline_runs_two_and_cancels_the_loser():
    """A request with less budget than hedge_ms runs on two replicas: the
    first (wedged) never answers, the hedge on the second wins, and the
    wedged dispatch is cancelled."""
    ref_net = _port_net(seed=3)
    router = _router(2, hedge_ms=60_000)
    router.start()
    try:
        wedged = Future()
        router.replicas[0].server.submit = \
            lambda example, deadline_ms=None, **kw: wedged
        x = np.random.RandomState(1).rand(4, FEAT).astype(np.float32)
        out = router.submit(x, deadline_ms=30_000).result(timeout=TIMEOUT)
        np.testing.assert_allclose(out, _ref(ref_net, x), rtol=1e-6,
                                   atol=1e-6)
        assert wedged.cancelled()
        s = router.stats()
        assert s["hedges"] == 1 and s["hedge_wins"] == 1
        assert s["dispatched"] == 2 and s["served"] == 1
        assert s["requests_lost"] == 0
    finally:
        router.shutdown(drain=False)


def test_chaos_evicts_warms_a_spare_and_loses_nothing():
    """Replica 1 fails every dispatch and one health probe stalls: every
    request is served, replica 1 is evicted, a warm spare joins, and no
    replica (the spare included) compiles after its warm-up."""
    ref_net = _port_net(seed=3)
    servers = []
    router = serve.Router(
        _factory(servers=servers), 3, health_sec=0.1, evict_after=2,
        retry=RetryPolicy(max_retries=3, base_delay=0.01, max_delay=0.05))
    router.start()
    try:
        plan = faults.FaultPlan([
            {"site": "serve.replica.submit", "action": "raise",
             "match": {"replica": 1}, "times": None},
            {"site": "serve.replica.health", "action": "stall",
             "on_hit": 2, "delay_s": 0.02, "times": 1}], seed=7)
        reqs = _requests(40, np.random.RandomState(0))
        with faults.armed(plan):
            futs = [router.submit(x, deadline_ms=30_000) for x in reqs]
            outs = [f.result(timeout=TIMEOUT) for f in futs]
            assert _wait(lambda: router.stats()["healthy"] == 3
                         and router.stats()["replacements"] >= 1
                         and router.stats()["probes"] >= 4)
        for x, out in zip(reqs, outs):
            np.testing.assert_allclose(out, _ref(ref_net, x), rtol=1e-6,
                                       atol=1e-6)
        s = router.stats()
        assert s["served"] == 40 and s["requests_lost"] == 0
        assert s["evictions"] == 1 and s["replacements"] == 1
        assert s["healthy"] == s["pool_size"] == 3
        assert s["last_recovery_ms"] is not None
        assert 1 not in {r.id for r in router.replicas}
        assert any(f["site"] == "serve.replica.health" for f in plan.fired())
        for rep in router.replicas:
            assert rep.server.stats()["graph"]["post_warmup_compiles"] == 0
        assert len(servers) == 4
        router.drain(timeout=TIMEOUT)
    finally:
        router.shutdown(drain=False)


def test_rolling_reload_under_load_serves_old_xor_new(tmp_path):
    trained = _port_net(seed=11)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, params=trained, sync=True)
    mgr.wait_until_finished()
    serving_ref = _port_net(seed=99)
    router = serve.Router(_factory(seed=99, checkpoint=mgr), 3,
                          health_sec=0.0)
    router.start()
    try:
        rng = np.random.RandomState(2)
        reqs = _requests(60, rng)
        futs = [None] * len(reqs)

        def submitter():
            for i, x in enumerate(reqs):
                futs[i] = router.submit(x, deadline_ms=60_000)
                time.sleep(0.002)

        th = threading.Thread(target=submitter)
        th.start()
        time.sleep(0.04)
        metas = router.rolling_reload(timeout=TIMEOUT)
        th.join(timeout=TIMEOUT)
        extras = _requests(3, rng)
        reqs += extras
        futs += [router.submit(x, deadline_ms=60_000) for x in extras]
        outs = [f.result(timeout=TIMEOUT) for f in futs]
        assert [m["step"] for m in metas] == [7, 7, 7]
        n_new = 0
        for x, out in zip(reqs, outs):
            is_old = np.allclose(out, _ref(serving_ref, x), rtol=1e-6,
                                 atol=1e-6)
            is_new = np.allclose(out, _ref(trained, x), rtol=1e-6,
                                 atol=1e-6)
            assert is_old != is_new
            n_new += is_new
        assert n_new >= 3
        s = router.stats()
        assert s["served"] == 63 and s["requests_lost"] == 0
        assert s["reloads"] == 3
        router.drain(timeout=TIMEOUT)
        for rep in router.replicas:
            st = rep.server.stats()
            assert st["graph"]["post_warmup_compiles"] == 0
            assert st["reloads"] == 1
    finally:
        router.shutdown(drain=False)


def test_admit_and_retire_grow_and_drain_the_pool():
    router = _router(1)
    router.start()
    try:
        with pytest.raises(tmx.MXNetError, match="last healthy"):
            router.retire()
        rep = router.admit()
        assert rep.id == 1 and router.stats()["healthy"] == 2
        futs = [router.submit(np.zeros((4, FEAT), np.float32))
                for _ in range(6)]
        assert router.retire(timeout=TIMEOUT) in (0, 1)
        for f in futs:
            assert f.result(timeout=TIMEOUT).shape == (4, 5)
        s = router.stats()
        assert s["pool_size"] == 1 and s["requests_lost"] == 0
    finally:
        router.shutdown()


def test_router_section_metrics_and_request_spans(tmp_path):
    from mxnet_tpu_torch import profiler, telemetry
    from mxnet_tpu_torch.telemetry import metrics

    profiler.dumps(reset=True)
    reg = metrics.Registry()
    router = _router(2)
    router.start()
    trace_path = str(tmp_path / "router.trace.json")
    try:
        metrics.register_router(router, registry=reg)
        plan = faults.FaultPlan([{"site": "serve.replica.submit",
                                  "action": "raise", "on_hit": 1}])
        with telemetry.trace(trace_path):
            with faults.armed(plan):
                router.submit(np.zeros((4, FEAT), np.float32),
                              deadline_ms=30_000).result(timeout=TIMEOUT)
        page = reg.render()
    finally:
        router.shutdown()
    assert 'mxtpu_router_served{router="' in page
    assert 'mxtpu_router_replica_healthy{replica="0",router="' in page
    assert "mxtpu_router_latency_ms_bucket" in page
    d = json.loads(profiler.dumps(reset=True))
    assert d["router"]["dispatched"] == 1 and d["router"]["retries"] == 1
    assert json.loads(profiler.dumps())["router"]["dispatched"] == 0
    events = json.load(open(trace_path))["traceEvents"]
    ends = [e for e in events if e["ph"] == "e"
            and e["name"] == "serve.router.request"]
    hops = [e for e in events if e["ph"] == "n"
            and e["name"] == "serve.router.dispatch"]
    assert len(ends) == 1 and ends[0]["args"]["attempts"] == 2
    assert len(hops) == 1 and 0 < hops[0]["args"]["remaining_ms"] <= 30_000


def test_health_monitor_watches_a_router_as_the_jax_monitor_does():
    """Both packages' HealthMonitor watching the same port Router through
    ``watch("router", router)``: the same signals resolve and the same
    rules fire."""
    from mxnet_tpu.telemetry import health as jhealth

    from mxnet_tpu_torch.telemetry import health as thealth

    router = _router(2)
    router.start()
    try:
        for _ in range(3):
            router.submit(np.zeros((4, FEAT), np.float32)).result(
                timeout=TIMEOUT)
        verdicts = []
        for health in (thealth, jhealth):
            rules = [health.SLORule("lost", "router.requests_lost",
                                    above=0),
                     health.SLORule("served", "router.served", below=5),
                     health.SLORule("p99", "router.latency.p99_ms",
                                    above=1e9),
                     health.SLORule("absent", "router.no_such_key",
                                    above=0)]
            with health.HealthMonitor(tick_sec=0, rules=rules) as mon:
                mon.watch("router", router)
                mon.tick()
                verdicts.append(mon.status())
    finally:
        router.shutdown()
    assert verdicts[0] == verdicts[1] == ("degraded", ["served"])


def test_stats_reads_the_replicas_gauges_outside_the_pool_lock():
    """A remote replica's ``pending()`` is a round trip: ``stats()`` must
    not hold the pool lock (which dispatch and admission take) across
    it."""
    router = _router(2)
    router.start()
    in_gauge, release = threading.Event(), threading.Event()

    def slow_pending():
        in_gauge.set()
        assert release.wait(TIMEOUT)
        return 0

    try:
        router.replicas[0].server.pending = slow_pending
        reader = threading.Thread(target=router.stats)
        reader.start()
        assert in_gauge.wait(TIMEOUT)
        got = router._lock.acquire(timeout=5)
        if got:
            router._lock.release()
        release.set()
        reader.join(timeout=TIMEOUT)
        assert got
    finally:
        release.set()
        router.shutdown(drain=False)


def test_abrupt_shutdown_resolves_everything():
    router = _router(2)
    router.start()
    for rep in router.replicas:
        rep.server.submit = lambda example, deadline_ms=None, **kw: Future()
    futs = [router.submit(np.zeros((4, FEAT), np.float32))
            for _ in range(3)]
    router.shutdown(drain=False)
    for f in futs:
        with pytest.raises(serve.ServerClosedError):
            f.result(timeout=0)
    assert router.stats()["requests_lost"] == 0
    with pytest.raises(serve.ServerClosedError):
        router.submit(np.zeros((4, FEAT), np.float32))


# -- the capture repairs ------------------------------------------------------


def test_launches_during_a_capture_are_booked_to_the_capture(monkeypatch):
    """A capture while other threads launch: the capture's delta holds the
    launches on the capture stream (its thread's, and the autograd
    engine's device thread running the captured backward), and the
    counters every launch and replay of the other thread."""
    on_capture_stream = set()
    monkeypatch.setattr(kbuild, "launch_is_captured",
                        lambda: threading.current_thread()
                        in on_capture_stream)
    counts = kbuild.KernelCounts("reg_launches")
    earlier = kbuild.CapturedLaunches()
    on_capture_stream.add(threading.current_thread())
    counts.add("launches")
    on_capture_stream.clear()
    earlier.finish()
    capturing, others_done = threading.Event(), threading.Event()
    result = {}

    def capture():
        on_capture_stream.add(threading.current_thread())
        rec = kbuild.CapturedLaunches()
        capturing.set()
        for _ in range(3):
            counts.add("launches", "reg_launches")
        assert others_done.wait(TIMEOUT)
        counts.add("plain_calls_on_cuda")
        result["delta"] = rec.finish().delta

    def backward():            # the autograd engine's device thread
        on_capture_stream.add(threading.current_thread())
        assert capturing.wait(TIMEOUT)
        counts.add("launches")
        counts.add("launches")

    def other():
        assert capturing.wait(TIMEOUT)
        for _ in range(5):
            counts.add("launches")
        for _ in range(2):
            earlier.replay()

    helpers = [threading.Thread(target=backward),
               threading.Thread(target=other)]
    main = threading.Thread(target=capture)
    main.start()
    for t in helpers:
        t.start()
    for t in helpers:
        t.join(timeout=TIMEOUT)
    others_done.set()
    main.join(timeout=TIMEOUT)
    assert result["delta"] == [(counts, {"launches": 5, "reg_launches": 3,
                                         "plain_calls_on_cuda": 1})]
    assert counts.snapshot() == {"launches": 7, "plain_calls_on_cuda": 0,
                                 "reg_launches": 0}
    for got, gain in result["delta"]:   # one replay of the capture
        got.shift(gain)
    assert counts.snapshot() == {"launches": 12, "plain_calls_on_cuda": 1,
                                 "reg_launches": 3}
    assert kbuild._open_book is None


def test_overlapping_captures_keep_the_collector_off_until_both_end():
    was = gc.isenabled()
    gc.enable()
    first_in, second_in = threading.Event(), threading.Event()
    first_out = threading.Event()
    seen = {}

    def first():
        with whole_step.collector_off():
            first_in.set()
            assert second_in.wait(TIMEOUT)
        seen["after_first"] = gc.isenabled()
        first_out.set()

    def second():
        assert first_in.wait(TIMEOUT)
        with whole_step.collector_off():
            second_in.set()
            assert first_out.wait(TIMEOUT)
            seen["inside_second"] = gc.isenabled()
        seen["after_both"] = gc.isenabled()

    try:
        threads = [threading.Thread(target=first),
                   threading.Thread(target=second)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert seen == {"after_first": False, "inside_second": False,
                        "after_both": True}
        gc.disable()          # off before the first: stays off after
        with whole_step.collector_off():
            pass
        assert not gc.isenabled()
    finally:
        (gc.enable if was else gc.disable)()


def test_initialization_waits_for_a_capture_on_another_thread():
    """A capture registers its device's generators, and torch fails a draw
    made outside it on one it holds: a parameter initialization on another
    thread (a spare's deferred shapes beside a scale-up's capture) waits
    for the capture to end."""
    order, capturing = [], threading.Event()

    def capture():
        with tmx.random.capture_lock:
            capturing.set()
            time.sleep(0.2)
            order.append("capture ended")

    t = threading.Thread(target=capture)
    t.start()
    assert capturing.wait(TIMEOUT)
    tmx.init.Normal(0.02)("dense0_weight", torch.empty(4, 4))
    order.append("initialized")
    t.join(timeout=TIMEOUT)
    assert order == ["capture ended", "initialized"]


# -- on the card --------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs and the flash kernel "
                    "have no CPU mode); run on the GPU machine with -m gpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


class _BertServing(tmx.gluon.HybridBlock):
    def __init__(self, bert, **kwargs):
        super().__init__(**kwargs)
        self.bert = bert

    def hybrid_forward(self, F, ids):
        valid = (ids != 0).sum(dim=1).to(torch.float32)
        return self.bert(ids, torch.zeros_like(ids), valid)


@pytest.mark.gpu
def test_spares_capture_while_a_peer_replays_under_traffic(cuda_device):
    """A 2-layer BERT (heads of 64: the flash kernel) on the card: two
    replicas are admitted at once from two threads (a warm spare and a
    scale-up), each capturing its 4 buckets, while traffic replays on
    their peer.  The captures take turns and none is invalidated, flash
    launches are exactly 2 x the forwards of every server (the captured
    backward's thread aside, a capture books only its own stream's
    launches), and no server compiles after its warm-up."""
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa

    servers = []
    spec = serve.BucketSpec(batch_sizes=(1, 2), example_shape=(None,),
                            lengths=(64, 128), dtype="int32")

    def factory(rid):
        tmx.random.seed(5)
        bert = tmx.models.BERTModel(30522, 128, 256, 2, 2, max_length=128,
                                    use_decoder=False, use_classifier=False)
        bert.initialize(init=tmx.init.Normal(0.02), ctx=tmx.gpu(0))
        srv = serve.ModelServer(_BertServing(bert), spec, ctx=tmx.gpu(0))
        servers.append(srv)
        return srv

    kernels.reset_counts()
    router = serve.Router(factory, 1, health_sec=0.0)
    router.start()
    rng = np.random.RandomState(1)
    reqs = [rng.randint(1, 30522, size=int(n)).astype(np.int32)
            for n in rng.randint(8, 129, size=64)]
    stop = threading.Event()
    outs = []

    def traffic():              # until both spares have joined
        while not stop.is_set():
            for x in reqs:
                outs.append(router.submit(x).result(timeout=TIMEOUT))

    spares = [factory(None) for _ in range(2)]
    th = threading.Thread(target=traffic)
    th.start()
    c0 = _imperative.graph_capture_count()
    admitted = []
    admits = [threading.Thread(
        target=lambda srv=srv: admitted.append(router.admit(srv)))
        for srv in spares]
    for t in admits:
        t.start()
    for t in admits:
        t.join(timeout=300)
    spare_captures = _imperative.graph_capture_count() - c0
    stop.set()
    th.join(timeout=300)
    router.shutdown()
    assert not th.is_alive() and len(outs) >= len(reqs)
    assert len(admitted) == 2 and spare_captures == 8
    assert {r.server for r in admitted} == set(servers[1:])
    forwards = sum(s.stats()["batches"] + 2 * s.stats()["warmup_batches"]
                   for s in servers)
    assert fa.counts.launches == 2 * forwards
    assert fa.counts.plain_calls_on_cuda == 0
    for s in servers:
        assert s.stats()["graph"]["post_warmup_compiles"] == 0
    assert all(np.isfinite(o[1]).all() for o in outs)
