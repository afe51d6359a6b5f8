"""The port's telemetry (``mxnet_tpu_torch/telemetry/``: the span tracer,
the flight recorder, the health monitor, the metrics registry and the
``/metrics`` endpoint) against the JAX package's (``mxnet_tpu/telemetry/``).

For the same calls: the tracer's event list is the JAX tracer's up to
``ts``, ``dur``, ``tid``, ``pid`` and the request ids' base (the process's
own counters), the flight dump carries the same keys, a registry renders
the same Prometheus text byte for byte, and the health monitor gives the
same windows, SLO verdicts, goodput and status from one synthetic scope
feed on a fake clock (no wall-clock ratios).  The health monitor's peak
on the card is the H100's datasheet figure, checked here by naming the
device.
"""
import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import pytest
import torch

from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.telemetry import flight as tflight
from mxnet_tpu_torch.telemetry import health as thealth
from mxnet_tpu_torch.telemetry import metrics as tmetrics
from mxnet_tpu_torch.telemetry import tracer as ttracer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACER_HOOKS = ("span_begin", "span_end", "instant", "request_begin",
                "request_instant", "request_end")
HEALTH_HOOKS = ("scope_end", "note_whole_step", "note_whole_step_compiled")


def _jtel():
    import mxnet_tpu.telemetry as jtel

    return jtel


def test_disarmed_hooks_are_the_noop_itself():
    for name in TRACER_HOOKS:
        assert getattr(ttracer, name) is ttracer._noop, name
    for name in HEALTH_HOOKS:
        assert getattr(thealth, name) is thealth._noop, name
    assert not ttracer.armed() and not thealth.armed()
    tflight.enable(8)
    try:
        assert ttracer.armed() and ttracer.span_begin is ttracer._span_begin
    finally:
        tflight.disable()
    assert ttracer.span_begin is ttracer._noop
    assert ttracer.request_begin("x") is None


# -- the tracer ---------------------------------------------------------------


def _trace_calls(tel, path):
    tr = tel.tracer
    tel.start_trace(str(path))
    try:
        tr.span_begin("outer", "trainer")
        tr.span_begin("inner", "op")
        tr.instant("mark", cat="resilience", kind="transient", n=3,
                   ok=True, obj=(1, 2))
        tr.span_end("inner", "op", bucket="8x128")
        rid = tr.request_begin("serve.request", cat="serve", length=12)
        tr.request_instant("serve.dequeue", rid, cat="serve")
        tr.request_end("serve.request", rid, cat="serve", outcome="served",
                       queue_ms=0.5)
        tr.span_end("never-begun", "op")
        tr.span_end("outer", "trainer")
        events = tr.export_events()
        with pytest.raises(Exception, match="already armed"):
            tel.start_trace(str(path) + ".2")
    finally:
        tel.stop_trace()
    with open(path) as f:
        assert json.load(f)["displayTimeUnit"] == "ms"
    return events


def _normal(events):
    out, ids = [], {}
    for ev in events:
        if ev["ph"] == "M":   # process and thread names: the process's own
            continue
        ev = {k: v for k, v in ev.items()
              if k not in ("ts", "dur", "tid", "pid")}
        if "id" in ev:
            ev["id"] = ids.setdefault(ev["id"], len(ids))
        out.append(ev)
    return out


def test_tracer_events_match_the_jax_tracer(tmp_path):
    got = _normal(_trace_calls(ttel, tmp_path / "t.json"))
    want = _normal(_trace_calls(_jtel(), tmp_path / "j.json"))
    assert got == want
    assert [e["name"] for e in got] == [
        "outer", "inner", "mark", "serve.request", "serve.dequeue",
        "serve.request"]
    assert {e["ph"] for e in got} == {"X", "i", "b", "n", "e"}
    assert ttracer.span_begin is ttracer._noop


def test_trace_context_manager_and_telemetry_counters(tmp_path):
    from mxnet_tpu_torch import profiler

    ttracer.reset_telemetry_stats()
    path = tmp_path / "ctx.json"
    with ttel.trace(str(path)):
        assert ttel.tracing()
        with profiler.op_scope("checkpoint.save.commit", cat="checkpoint"):
            pass
        ttracer.instant("resilience.retry", cat="resilience", kind="x")
    assert not ttel.tracing()
    names = [e["name"] for e in json.loads(path.read_text())["traceEvents"]]
    assert "checkpoint.save.commit" in names and "resilience.retry" in names
    stats = ttel.sections()["telemetry"]
    assert stats["spans"] == 1 and stats["instants"] == 1
    agg = ttel.aggregate()
    assert agg["world_size"] == 1 and agg["rank"] == 0
    assert "telemetry" in agg["ranks"][0]
    assert ttracer.telemetry_stats()["aggregations"] == 1
    with pytest.raises(MXNetError):
        ttel.start_trace("")


# -- the flight recorder ------------------------------------------------------


def _dump(tel, directory):
    fl = tel.flight
    fl.enable(size=4, directory=str(directory))
    try:
        for i in range(6):
            tel.tracer.instant(f"e{i}", cat="op")
        path = fl.dump("test", extra={"why": "a test"})
        path2 = fl.dump_if_enabled("again")
    finally:
        fl.disable()
    assert fl.dump_if_enabled("off") is None
    assert path2 != path and os.path.exists(path2)
    with open(path) as f:
        return json.load(f)


def test_flight_dump_carries_the_jax_keys(tmp_path):
    got = _dump(ttel, tmp_path / "t")
    want = _dump(_jtel(), tmp_path / "j")
    assert set(got) == set(want)
    for k in ("reason", "rank", "ring_size", "extra", "displayTimeUnit"):
        assert got[k] == want[k], k
    assert [e["name"] for e in got["traceEvents"]] == \
        [e["name"] for e in want["traceEvents"]] == ["e2", "e3", "e4", "e5"]
    assert {"resilience", "telemetry"} <= set(got["counters"])


def test_flight_env_setting_and_auto_enable(monkeypatch, tmp_path):
    monkeypatch.setenv("MXTPU_FLIGHT_RECORDER", "off")
    assert tflight._env_setting() == 0
    assert tflight.auto_enable(tmp_path) is None
    monkeypatch.setenv("MXTPU_FLIGHT_RECORDER", "32")
    assert tflight._env_setting() == 32
    token = tflight.auto_enable(tmp_path)
    try:
        assert token == "armed" and tflight.tracer.flight_ring().maxlen == 32
        assert tflight.auto_enable(tmp_path) == "riding"
    finally:
        tflight.auto_disable(token)
    assert not tflight.enabled()


# -- the metrics registry and the endpoint ------------------------------------


def _registry_text(metrics):
    reg = metrics.Registry()
    c = reg.counter("mxtpu_test_requests_total", "requests")
    c.inc()
    c.inc(2, route="a")
    g = reg.gauge("mxtpu_test_depth", 'queue "depth"\nnow')
    g.set(3.5)
    g.set(7, shard='x"y')
    g.inc(0.25)
    h = reg.histogram("mxtpu_test_latency_ms", "latency", buckets=(1, 5, 10))
    for v in (0.5, 2, 7, 12, 3):
        h.observe(v, route="b")
    reg.register_collector(lambda: [
        ("mxtpu_test_collected", "gauge", "c",
         [({"k": "v"}, 1.25), ({"k": "w"}, 2.0)])])
    return reg.render()


def test_prometheus_text_matches_the_jax_registry_byte_for_byte():
    got = _registry_text(tmetrics)
    assert got == _registry_text(_jtel().metrics)
    assert 'mxtpu_test_latency_ms_bucket{le="+Inf",route="b"} 5' in got
    reg = tmetrics.Registry()
    with pytest.raises(MXNetError):
        reg.counter("mxtpu_c").inc(-1)
    with pytest.raises(MXNetError):
        reg.counter("bad name")
    with pytest.raises(MXNetError):
        reg.gauge("mxtpu_c")


class _FakeServer:
    def stats(self):
        return {"submitted": 5, "served": 4, "failed": 1, "queue_depth": 1,
                "in_flight": 0, "batch_fill_ratio": 0.5,
                "bucket_hits": {(4, 128): 2, (1, 128): 1},
                "bucket_fill_ratio": {(4, 128): 0.75},
                "latency": {"histogram": {
                    "buckets": [(1.0, 1), (10.0, 3), (float("inf"), 4)],
                    "sum_ms": 9.5, "count": 4}},
                "graph": {"compiles": 2, "reuses": 3}}


def _server_text(metrics, server):
    import re

    reg = metrics.Registry()
    metrics.register_server(server, registry=reg)
    return re.sub(r'server="\d+"', 'server="N"', reg.render())


def test_register_server_exports_the_jax_gauges():
    server = _FakeServer()
    got = _server_text(tmetrics, server)
    assert got == _server_text(_jtel().metrics, server)
    assert 'mxtpu_serve_served{server="N"} 4' in got
    # the router's export (slice 5, part 2) is the JAX package's
    router = _FakeRouter()
    got = _router_text(tmetrics, router)
    assert got == _router_text(_jtel().metrics, router)
    assert 'mxtpu_router_served{router="N"} 7' in got
    assert 'mxtpu_router_replica_healthy{replica="3",router="N"} 1' in got
    # the decode server's export (slice 5, part 1) is the JAX package's
    decode = _FakeDecodeServer()
    got = _decode_text(tmetrics, decode)
    assert got == _decode_text(_jtel().metrics, decode)
    assert 'mxtpu_decode_tokens{server="N"} 9' in got
    assert 'mxtpu_decode_spec_accept_rate{server="N"} 0.5' in got


class _FakeRouter:
    def stats(self):
        hist = {"buckets": [(1.0, 2), (float("inf"), 7)], "sum_ms": 40.0,
                "count": 7}
        return {"submitted": 9, "served": 7, "failed": 1,
                "rejected_quota": 1, "dispatched": 11, "retries": 2,
                "evictions": 1, "replacements": 1, "requests_lost": 0,
                "pool_size": 2, "healthy": 2, "queue_depth": 1,
                "in_flight": 1, "last_recovery_ms": 812.5,
                "latency": {"histogram": hist},
                "replicas": {0: {"state": "healthy", "pending": 1,
                                 "ewma_ms": 3.25},
                             3: {"state": "healthy", "pending": 0,
                                 "ewma_ms": 4.0}}}


def _router_text(metrics, router):
    import re

    reg = metrics.Registry()
    metrics.register_router(router, registry=reg)
    return re.sub(r'router="\d+"', 'router="N"', reg.render())


class _FakeDecodeServer:
    def stats(self):
        hist = {"buckets": [(1.0, 1), (float("inf"), 2)], "sum_ms": 3.0,
                "count": 2}
        return {"submitted": 3, "served": 2, "tokens": 9,
                "decode_steps": 5, "queue_depth": 1,
                "slots": {"live": 1, "occupancy": 0.25},
                "ttft": {"histogram": hist},
                "graph": {"compiles": 4, "reuses": 7,
                          "post_warmup_compiles": 0},
                "pages": {"in_flight": 3, "free": 5, "committed": 4,
                          "deferred": 0, "hbm_bytes": 4096},
                "spec": {"proposed": 4, "accepted": 2,
                         "accept_rate": 0.5}}


def _decode_text(metrics, server):
    import re

    reg = metrics.Registry()
    metrics.register_decode_server(server, registry=reg)
    return re.sub(r'server="\d+"', 'server="N"', reg.render())


def test_metrics_endpoint_serves_metrics_and_healthz_over_loopback():
    from mxnet_tpu_torch.resilience import stats as rstats

    rstats.reset_resilience_stats()
    rstats.add("restarts")
    srv = ttel.MetricsServer(port=0, host="127.0.0.1").start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        text = urllib.request.urlopen(base + "/metrics", timeout=30).read()
        text = text.decode()
        assert "mxtpu_resilience_restarts 1" in text
        assert "mxtpu_metrics_scrapes_total" in text
        hz = json.loads(urllib.request.urlopen(base + "/healthz",
                                               timeout=30).read())
        assert hz["status"] == "ok" and hz["rank"] == 0
        with thealth.HealthMonitor(tick_sec=0, flight_on_breach=False,
                                   rules=[thealth.SLORule(
                                       "never", "goodput", below=-1)]) as m:
            m.tick()
            hz = json.loads(urllib.request.urlopen(base + "/healthz",
                                                   timeout=30).read())
            assert hz["status"] == "ok" and hz["rules"] == []
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nope", timeout=30)
        with pytest.raises(MXNetError):
            srv.start()
    finally:
        srv.stop()
        rstats.reset_resilience_stats()


def test_env_knobs_arm_the_trace_and_the_flight_recorder(tmp_path):
    path = tmp_path / "env.trace.json"
    code = ("import mxnet_tpu_torch as mx\n"
            "from mxnet_tpu_torch import profiler, telemetry\n"
            "assert telemetry.tracing() and telemetry.flight.enabled()\n"
            "with profiler.op_scope('env.scope', cat='trainer'):\n"
            "    pass\n")
    env = dict(os.environ, PYTHONPATH=REPO, MXTPU_TRACE=str(path),
               MXTPU_FLIGHT_RECORDER="16")
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=REPO, timeout=120)
    names = [e["name"] for e in json.loads(path.read_text())["traceEvents"]]
    assert "env.scope" in names


# -- the health monitor -------------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 100.0

    def monotonic(self):
        return self.t


class _Param:
    shape = (3, 4)


class _Trainer:
    _params = [_Param(), _Param()]


def _health_feed(health, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(health, "time", clock)
    rules = [health.SLORule("slow", "step_p95_ms", above=50.0),
             health.SLORule("gp", "goodput", below=0.9, for_ticks=2),
             health.SLORule("src", "serve.latency.p99_ms", above=1.0),
             health.SLORule("absent", "router.requests_lost", above=0)]
    health.reset_health_stats()
    health._reset_learned_flops()
    mon = health.HealthMonitor(tick_sec=0, peak_flops=1e12, rules=rules,
                               flight_on_breach=False)
    mon.watch("serve", lambda: {"latency": {"p99_ms": 2.0}})
    mon.arm()
    try:
        windows = []
        for durs in ([10, 20, 30], [60, 70], [5], []):
            for d in durs:
                health.scope_end("whole_step", "trainer", 0.0, d * 1e3)
                health.scope_end("allreduce", "trainer", 0.0, 2e3)
                health.scope_end("fused_update", "trainer", 0.0, 1e3)
                health.scope_end("checkpoint.save.commit", "checkpoint",
                                 0.0, 5e2)
                health.scope_end("cached_op.compile.net0", "cached_op", 0.0,
                                 3e3)
                health.note_whole_step(_Trainer(), 4)
            clock.t += 0.25
            windows.append(mon.tick())
            windows[-1]["status_now"] = mon.status()
        out = {"windows": windows, "healthz": health.healthz(),
               "diag": health.describe_for_diagnostic(),
               "section": health.health_stats()}
    finally:
        mon.disarm()
    return out


def test_health_windows_and_slo_verdicts_match_the_jax_monitor(monkeypatch):
    got = _health_feed(thealth, monkeypatch)
    want = _health_feed(_jtel().health, monkeypatch)
    assert got == want
    w = got["windows"]
    assert [x["steps"] for x in w] == [3, 2, 1, 0]
    assert w[0]["goodput"] == 0.24 and w[3]["goodput"] is None
    assert w[1]["status_now"] == ("degraded", ["gp", "slow", "src"])
    assert got["windows"][0]["flops_source"] == "analytic"
    assert got["windows"][0]["flops_per_step"] == 6 * 24 * 4
    for name in HEALTH_HOOKS:
        assert getattr(thealth, name) is thealth._noop


@pytest.mark.parametrize("device,peak", [
    ("NVIDIA H100 80GB HBM3", 989e12), ("NVIDIA H100 PCIe", 756e12),
    ("NVIDIA H100 NVL", 835e12), ("NVIDIA A100-SXM4-80GB", 1e11)])
def test_peak_flops_are_the_h100_datasheets_by_device_name(
        monkeypatch, device, peak):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: device)
    monkeypatch.delenv("MXTPU_HEALTH_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("MXNET_HEALTH_PEAK_FLOPS", raising=False)
    assert thealth._resolve_peak_flops() == peak
    assert thealth.HealthMonitor(tick_sec=0).peak_flops == peak
    monkeypatch.setenv("MXTPU_HEALTH_PEAK_FLOPS", "5e14")
    assert thealth._resolve_peak_flops() == 5e14
    assert thealth._resolve_peak_flops(override=2e12) == 2e12
    # no TPU figure in the port's table
    assert all(k.startswith("h100") for k, _ in thealth._PEAK_FLOPS_TABLE)


def test_capture_note_changes_no_count_and_one_monitor_owns_the_hooks():
    thealth._reset_learned_flops()
    with thealth.HealthMonitor(tick_sec=0) as mon:
        thealth.note_whole_step(_Trainer(), 2)
        thealth.note_whole_step_compiled(object(), ())
        assert thealth.health_stats()["flops_per_step"] == 6 * 24 * 2
        assert thealth._flops_state["source"] == "analytic"
        with pytest.raises(MXNetError, match="already armed"):
            thealth.HealthMonitor(tick_sec=0).arm()
        assert thealth.active_monitor() is mon
    assert thealth.active_monitor() is None
    with pytest.raises(MXNetError, match="needs a bound"):
        thealth.SLORule("x", "goodput")
