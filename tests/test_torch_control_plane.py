"""The port's control plane (``mxnet_tpu_torch/serve/control_plane/``)
against the JAX package's, on the CPU, over real loopback sockets.

The wire is the JAX package's byte for byte: the same meta and arrays
give the same frame bytes, each side decodes the other's, a newer wire
version is refused and a truncated frame is a ``network`` failure.  The
lease directories read each other's markers and reject stale ones.  A
port ``RemoteReplica`` against a port endpoint answers bit for bit as the
in-process server does, and a JAX ``RemoteReplica`` against the same
endpoint gets the same tokens as the JAX ``DecodeServer`` with the same
weights.  A connection cut mid-stream fails over with no request lost, a
slow consumer does not hold up another stream, the autoscaler decides as
the JAX one does over the same load sequence, a spawn failure is
classified, and one real worker process (``--ctx cpu()``) registers and
serves through a ``ControlPlane``; without ``--ctx cpu()`` the worker
refuses to start on a machine with no CUDA device.
"""
import os
import socket
import struct
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import base, serve
from mxnet_tpu_torch.parallel.dist import LeaseDir
from mxnet_tpu_torch.resilience import faults
from mxnet_tpu_torch.resilience.supervisor import classify
from mxnet_tpu_torch.serve import control_plane as cp
from mxnet_tpu_torch.serve.control_plane.rpc import (RPCConnectionError,
                                                     WIRE_MAGIC, WIRE_VERSION)

ROOT = Path(__file__).resolve().parents[1]
CPU = tmx.cpu()
VOCAB = 64
TIMEOUT = 60
#: routers over the shared ``decode_pair`` never evict: an eviction shuts
#: the evicted replica's server down over the wire, and the next test would
#: find it closed
EVICT_NEVER = 1000


def _host_params(block):
    return {k: np.array(p.data().asnumpy())
            for k, p in block._collect_params_with_prefix().items()}


def _dspec(mod):
    return mod.BucketSpec(batch_sizes=(1, 2), example_shape=(None,),
                          lengths=(4, 8), dtype="int32")


def _jax_decoder():
    import mxnet_tpu as jmx
    from mxnet_tpu import serve as jserve

    jmx.random.seed(4)
    model = jserve.TinyDecoder(vocab=VOCAB, embed=16)
    model.initialize(jmx.init.Xavier())
    return model


@pytest.fixture(scope="module")
def decode_pair():
    """Two warmed port decode servers with the JAX model's weights, each
    behind an endpoint, and the JAX model.  Tests drop their client
    connections and never shut the shared servers down."""
    jmodel = _jax_decoder()
    weights = _host_params(jmodel)
    pair = []
    for _ in range(2):
        tmx.random.seed(4)
        model = serve.TinyDecoder(vocab=VOCAB, embed=16)
        model.initialize(tmx.init.Xavier(), ctx=CPU)
        tmx.load_numpy_params(model, weights)
        srv = serve.DecodeServer(model, _dspec(serve), max_slots=2,
                                 max_len=24, ctx=CPU)
        srv.start()
        pair.append((srv, cp.serve_replica(srv)))
    yield pair, jmodel
    for srv, ep in pair:
        ep.stop()
        srv.shutdown(drain=False)


def _remotes(pair):
    return [cp.RemoteReplica(ep.host, ep.port, rid=i)
            for i, (_, ep) in enumerate(pair)]


def _drop(replicas):
    for rr in replicas:
        rr._teardown(RPCConnectionError("test teardown"))


def _frame_bytes(mod, meta, arrays=None):
    a, b = socket.socketpair()
    try:
        mod.send_frame(a, meta, arrays)
        a.shutdown(socket.SHUT_WR)
        chunks = []
        while True:
            buf = b.recv(1 << 16)
            if not buf:
                return b"".join(chunks)
            chunks.append(buf)
    finally:
        a.close()
        b.close()


def _decode_bytes(mod, raw):
    a, b = socket.socketpair()
    try:
        a.sendall(raw)
        a.shutdown(socket.SHUT_WR)
        return mod.recv_frame(b)
    finally:
        a.close()
        b.close()


# -- the wire -----------------------------------------------------------------


@pytest.mark.parametrize("arrays", [
    None,
    {"example": np.arange(6, dtype=np.int32).reshape(2, 3),
     "f": np.linspace(0, 1, 4, dtype=np.float32)},
    {"result": np.asarray([5, 7, 11], np.int32)},
], ids=["meta_only", "tensors", "result"])
def test_frames_are_the_jax_frames_byte_for_byte(arrays):
    from mxnet_tpu.serve.control_plane import rpc as jrpc

    meta = {"op": "submit", "rid": 3, "deadline_ms": 12.5,
            "kwargs": {"max_new_tokens": 4}}
    got = _frame_bytes(cp, meta, arrays)
    assert got == _frame_bytes(jrpc, meta, arrays)
    assert got[:4] == WIRE_MAGIC == jrpc.WIRE_MAGIC
    assert WIRE_VERSION == jrpc.WIRE_VERSION
    for reader in (cp, jrpc):
        got_meta, got_arrays = _decode_bytes(reader, got)
        assert got_meta == meta
        if arrays is None:
            assert got_arrays is None
        else:
            for k, v in arrays.items():
                assert got_arrays[k].dtype == v.dtype
                assert np.array_equal(got_arrays[k], v)


def test_newer_wire_and_bad_magic_are_refused_and_truncation_is_network():
    hdr = struct.Struct("<HIQ")
    with pytest.raises(tmx.MXNetError, match="newer mxnet_tpu"):
        _decode_bytes(cp, WIRE_MAGIC + hdr.pack(WIRE_VERSION + 7, 2, 0)
                      + b"{}")
    with pytest.raises(tmx.MXNetError, match="bad magic"):
        _decode_bytes(cp, b"HTTP" + b"\x00" * hdr.size)
    with pytest.raises(RPCConnectionError, match="truncated frame") as ei:
        _decode_bytes(cp, WIRE_MAGIC + hdr.pack(WIRE_VERSION, 100, 0)
                      + b"{par")
    assert classify(ei.value) == "network"
    assert classify(ConnectionResetError("peer reset")) == "network"
    assert classify(tmx.MXNetError(
        "corrupt or truncated NDArray file")) == "corrupt_checkpoint"


def test_lease_directories_read_each_other_and_reject_stale(tmp_path):
    from mxnet_tpu.parallel.dist import LeaseDir as JLeaseDir
    from mxnet_tpu.serve import control_plane as jcp

    d = str(tmp_path)
    port, jax = (LeaseDir(d, prefix="replica", lease_sec=5.0),
                 JLeaseDir(d, prefix="replica", lease_sec=5.0))
    port.publish("0", {"host": "h", "port": 1, "pid": 11, "kind": "model"})
    jax.publish("1", {"host": "h", "port": 2, "pid": 22, "kind": "decode"})
    port.publish("2", {"host": "h", "port": 3, "pid": 33, "kind": "model"})
    assert port.path_for("1") == jax.path_for("1")
    assert port.fresh() == jax.fresh()
    assert set(port.fresh()) == {"0", "1", "2"}
    old = time.time() - 3600           # replica 2 stopped heartbeating
    os.utime(port.path_for("2"), (old, old))
    before = cp.ctrl_stats()["stale_leases_rejected"]
    found = cp.discover_replicas(d, lease_sec=5.0)
    assert found == jcp.discover_replicas(d, lease_sec=5.0)
    assert set(found) == {"0", "1"} and found["1"]["port"] == 2
    assert cp.ctrl_stats()["stale_leases_rejected"] == before + 1
    port.retire("0")
    assert set(jax.fresh()) == {"1"}
    port.clear()
    assert not os.path.exists(d)


# -- remote parity ------------------------------------------------------------


def test_remote_decode_replica_is_the_in_process_server(decode_pair):
    """The same prompts through a port RemoteReplica and in process: the
    same tokens, streamed and resolved; a JAX RemoteReplica against the
    same port endpoint gets the JAX DecodeServer's tokens."""
    from mxnet_tpu import serve as jserve
    from mxnet_tpu.serve import control_plane as jcp

    pair, jmodel = decode_pair
    srv, ep = pair[0]
    rr = _remotes(pair)[0]
    jr = jcp.RemoteReplica(ep.host, ep.port, rid=0)
    jsrv = jserve.DecodeServer(jmodel, _dspec(jserve), max_slots=2,
                               max_len=24)
    jsrv.start()
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, VOCAB, size=int(rng.randint(2, 8)))
               .astype(np.int32) for _ in range(4)]
    try:
        rr.start()
        jr.start()
        for p in prompts:
            local = np.asarray(srv.generate(p, max_new_tokens=6,
                                            timeout=TIMEOUT))
            handle = rr.submit(p, max_new_tokens=6)
            assert list(handle) == [int(t) for t in local]
            assert np.array_equal(handle.result(timeout=TIMEOUT), local)
            jhandle = jr.submit(p, max_new_tokens=6)
            jtoks = list(jhandle)
            want = np.asarray(jsrv.generate(p, max_new_tokens=6,
                                            timeout=TIMEOUT))
            assert jtoks == [int(t) for t in want] == list(local)
        assert rr.pending() == srv.pending() == jr.pending()
        assert np.array_equal(rr.probe_example(), srv.probe_example())
        assert np.array_equal(jr.probe_example(), srv.probe_example())
        assert rr.health()["ok"] is True and rr.health()["kind"] == "decode"
        assert rr.stats()["admitted"] >= 8
    finally:
        _drop([rr])
        jr._teardown(jcp.RPCConnectionError("test teardown"))
        jsrv.shutdown()


def test_a_dropped_idle_connection_ends_on_both_sides(decode_pair):
    """A client that drops an idle connection from another thread (as an
    injected ``serve.rpc.send`` fault does) wakes its demux thread, which
    sits in ``recv()``, and the endpoint's handler sees the connection end:
    no thread of it is left."""
    import threading

    pair, _ = decode_pair
    rr = _remotes(pair)[0]
    before = set(threading.enumerate())
    rr.start()
    handle = rr.submit(np.array([1, 2, 3], np.int32), max_new_tokens=4)
    assert len(handle.result(timeout=TIMEOUT)) == 4
    assert rr.ping() is True      # idle from here on
    # this connection's threads: the client's demux, the endpoint's
    # handler and writer
    mine = [t for t in threading.enumerate() if t not in before]
    assert {"mxtpu-ctrl-demux-0", "mxtpu-ctrl-conn-writer"} <= \
        {t.name for t in mine}
    _drop([rr])
    deadline = time.monotonic() + TIMEOUT
    while time.monotonic() < deadline and any(t.is_alive() for t in mine):
        time.sleep(0.01)
    assert not [t.name for t in mine if t.is_alive()]


def test_remote_model_replica_is_bit_identical():
    from mxnet_tpu_torch.gluon import nn

    tmx.random.seed(3)
    net = nn.HybridSequential()
    net.add(nn.Dense(8, flatten=False, in_units=6, activation="relu"),
            nn.Dense(5, flatten=False, in_units=8))
    net.initialize(tmx.init.Xavier(), ctx=CPU)
    spec = serve.BucketSpec(batch_sizes=(1, 2), example_shape=(None, 6),
                            lengths=(4, 8))
    srv = serve.ModelServer(net, spec, max_queue=16, ctx=CPU)
    srv.start()
    ep = cp.serve_replica(srv)
    rr = cp.RemoteReplica(ep.host, ep.port, rid=0)
    try:
        rr.start()
        rng = np.random.RandomState(0)
        for n in (3, 4, 7):
            x = rng.rand(n, 6).astype(np.float32)
            remote = rr.submit(x).result(timeout=TIMEOUT)
            local = srv.predict(x, timeout=TIMEOUT)
            assert remote.dtype == local.dtype
            assert np.array_equal(remote, local)
    finally:
        _drop([rr])
        ep.stop()
        srv.shutdown(drain=False)


def test_a_model_of_two_outputs_crosses_the_wire():
    """A served block with two outputs of different shapes (BERT's
    sequence and pooled outputs): a port client gets both, bit-identical
    to the in-process server; a JAX client reads the first.  The JAX
    endpoint cannot send such a result (ROADMAP queue 3)."""
    from mxnet_tpu.serve.control_plane import rpc as jrpc

    from mxnet_tpu_torch.gluon import HybridBlock, nn

    class TwoOutputs(HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.dense = nn.Dense(5, flatten=False, in_units=6)

        def hybrid_forward(self, F, x):
            y = self.dense(x)
            return y, y.sum(axis=1)

    tmx.random.seed(3)
    net = TwoOutputs()
    net.initialize(tmx.init.Xavier(), ctx=CPU)
    spec = serve.BucketSpec(batch_sizes=(1, 2), example_shape=(None, 6),
                            lengths=(4, 8))
    srv = serve.ModelServer(net, spec, ctx=CPU)
    srv.start()
    ep = cp.serve_replica(srv)
    rr = cp.RemoteReplica(ep.host, ep.port, rid=0)
    jr = jrpc.RemoteReplica(ep.host, ep.port, rid=0)
    try:
        x = np.random.RandomState(2).rand(3, 6).astype(np.float32)
        local = srv.predict(x, timeout=TIMEOUT)
        remote = rr.submit(x).result(timeout=TIMEOUT)
        assert isinstance(remote, tuple) and len(remote) == 2
        assert remote[0].shape == (3, 5) and remote[1].shape == (5,)
        for r, want in zip(remote, local):
            assert np.array_equal(r, want)
        assert np.array_equal(jr.submit(x).result(timeout=TIMEOUT),
                              local[0])
    finally:
        _drop([rr])
        jr._teardown(jrpc.RPCConnectionError("test teardown"))
        ep.stop()
        srv.shutdown(drain=False)


# -- failover and multiplexing ------------------------------------------------


def test_midstream_connection_kill_fails_over(decode_pair):
    """Cut the serving connection after 2 streamed tokens: the router
    re-dispatches on the other replica and the consumer sees one stream,
    without gap or duplicate, equal to a single server's."""
    pair, _ = decode_pair
    srv0, _ = pair[0]
    replicas = _remotes(pair)
    router = serve.Router(servers=replicas, health_sec=0.0,
                          evict_after=EVICT_NEVER)
    router.start()
    try:
        prompt = np.array([1, 2, 3], np.int32)
        ref = [int(t) for t in srv0.generate(prompt, max_new_tokens=6,
                                             timeout=TIMEOUT)]
        stall = faults.FaultPlan([{"site": "serve.decode",
                                   "action": "stall", "delay_s": 0.05,
                                   "times": None}])
        with faults.armed(stall):
            handle = router.submit_stream(prompt, max_new_tokens=6)
            got = [next(handle), next(handle)]
            victim = next(r for r in replicas if r._pending)
            plan = faults.FaultPlan([{"site": "serve.rpc.send",
                                      "action": "raise",
                                      "match": {"replica": victim.rid}}])
            with faults.armed(plan):
                with pytest.raises(tmx.MXNetError):
                    victim.ping()
        assert [f["site"] for f in plan.fired()] == ["serve.rpc.send"]
        got += list(handle)
        assert got == ref
        assert np.array_equal(handle.result(timeout=TIMEOUT),
                              np.asarray(ref, np.int32))
        s = router.stats()
        assert s["retries"] >= 1 and s["requests_lost"] == 0
    finally:
        _drop(replicas)


def test_requests_lost_zero_across_a_connection_kill(decode_pair):
    pair, _ = decode_pair
    srv0, _ = pair[0]
    replicas = _remotes(pair)
    router = serve.Router(servers=replicas, health_sec=0.0,
                          evict_after=EVICT_NEVER)
    router.start()
    try:
        rng = np.random.RandomState(11)
        prompts = [rng.randint(0, VOCAB, size=int(rng.randint(2, 7)))
                   .astype(np.int32) for _ in range(6)]
        refs = [[int(t) for t in srv0.generate(p, max_new_tokens=4,
                                               timeout=TIMEOUT)]
                for p in prompts]
        futs = [router.submit(p, max_new_tokens=4) for p in prompts[:3]]
        plan = faults.FaultPlan([{"site": "serve.rpc.send",
                                  "action": "raise",
                                  "match": {"replica": 0}}])
        with faults.armed(plan):
            try:
                replicas[0].ping()
            except tmx.MXNetError:
                pass
        futs += [router.submit(p, max_new_tokens=4) for p in prompts[3:]]
        outs = [f.result(timeout=TIMEOUT) for f in futs]
        for out, ref in zip(outs, refs):
            assert [int(t) for t in out] == ref
        s = router.stats()
        assert s["served"] == s["submitted"] == 6
        assert s["failed"] == 0 and s["requests_lost"] == 0
    finally:
        _drop(replicas)


def test_slow_consumer_does_not_block_others(decode_pair):
    pair, _ = decode_pair
    replicas = _remotes(pair)[:1]
    router = serve.Router(servers=replicas, health_sec=0.0,
                          evict_after=EVICT_NEVER)
    router.start()
    try:
        slow = router.submit_stream(np.array([1, 2, 3], np.int32),
                                    max_new_tokens=8)
        fast = router.submit_stream(np.array([4, 5], np.int32),
                                    max_new_tokens=4)
        fast_toks = list(fast)
        assert len(fast_toks) == 4
        assert np.array_equal(fast.result(timeout=TIMEOUT),
                              np.asarray(fast_toks, np.int32))
        assert len(list(slow)) == 8
        s = router.stats()
        assert s["served"] == 2 and s["requests_lost"] == 0
    finally:
        _drop(replicas)


# -- the autoscaler -----------------------------------------------------------


class _FakePool:
    def __init__(self, n=1):
        self.n = n
        self.actions = []

    def replica_count(self):
        return self.n

    def healthy_count(self):
        return self.n

    def load(self):
        return 0.0

    def scale_up(self):
        self.n += 1
        self.actions.append("up")
        return self.n

    def scale_down(self, timeout=60.0):
        self.n -= 1
        self.actions.append("down")
        return self.n


class _FakeMonitor:
    def __init__(self, states):
        self.states = list(states)

    def status(self):
        state = self.states.pop(0)
        return (state, [] if state == "ok" else ["latency"])


#: (load, slo verdict) per tick: a hot tick alone, a trend, a breach in the
#: cooldown, the ceiling, sustained idle down to the floor, then an SLO
#: breach at low load
LOADS = [0.9, 0.2, 0.9, 0.9, 0.9, 0.95, 0.8, 0.9, 0.3, 0.3, 0.5, 0.1,
         0.1, 0.1, 0.1, 0.1, 0.05, 0.1, 0.1, 0.1, 0.3, 0.3]
SLOS = (["ok"] * 8 + ["degraded", "degraded"] + ["ok"] * 10
        + ["degraded", "degraded"])


def _autoscale_run(cp_mod):
    pool = _FakePool(n=1)
    loads = list(LOADS)
    scaler = cp_mod.Autoscaler(pool, monitor=_FakeMonitor(SLOS),
                               min_replicas=1, max_replicas=3, up_ticks=2,
                               down_ticks=2, load_fn=lambda: loads.pop(0))
    before = cp_mod.ctrl_stats()
    decisions = [scaler.tick(now=float(t)) for t in range(len(LOADS))]
    after = cp_mod.ctrl_stats()
    moved = {k: after[k] - before[k] for k in ("ticks", "scale_ups",
                                               "scale_downs",
                                               "blocked_cooldown",
                                               "blocked_bounds")}
    return decisions, pool.actions, moved


def test_autoscaler_decides_as_the_jax_autoscaler():
    from mxnet_tpu.serve import control_plane as jcp

    names = ("CTRL_COOLDOWN_SEC", "CTRL_SCALE_UP_OCCUPANCY",
             "CTRL_SCALE_DOWN_OCCUPANCY")
    base.setenv("CTRL_COOLDOWN_SEC", 2.5)
    base.setenv("CTRL_SCALE_UP_OCCUPANCY", 0.75)
    try:
        got = _autoscale_run(cp)
        want = _autoscale_run(jcp)
    finally:
        for n in names:
            base.setenv(n, None)
    assert got == want
    actions = [d["action"] for d in got[0]]
    assert {"up", "down", "hold"} <= set(actions)
    assert got[2]["blocked_cooldown"] >= 1 and got[2]["blocked_bounds"] >= 1
    assert any("slo" in d["reason"] for d in got[0] if d["action"] == "up")


# -- worker processes ---------------------------------------------------------


def _worker_argv(registry, ctx="cpu()"):
    def argv(rid):
        cmd = [sys.executable, "-m", "mxnet_tpu_torch.serve.control_plane."
               "worker", "--registry", registry, "--id", str(rid),
               "--kind", "model", "--seed", "4"]
        return cmd + (["--ctx", ctx] if ctx else [])
    return argv


def _worker_env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def test_spawn_failure_is_injected_and_classified(tmp_path):
    proc = cp.ReplicaProcess(["/definitely/not/a/binary"], str(tmp_path),
                             "7")
    plan = faults.FaultPlan([{"site": "serve.replica.spawn",
                              "action": "raise"}])
    with faults.armed(plan):
        with pytest.raises(tmx.MXNetError) as ei:
            proc.spawn()
    assert classify(ei.value) == "transient"
    assert plan.fired()[0]["ctx"]["replica"] == "7"
    with pytest.raises(cp.ReplicaSpawnError) as ei:
        proc.spawn()
    assert classify(ei.value) == "transient"
    assert "spawn failed" in str(ei.value)


def test_a_spawned_cpu_worker_registers_and_serves(tmp_path):
    """One real worker process on the CPU, behind a ControlPlane: it
    registers after its warm-up and answers as an in-process server with
    the same seed does, bit for bit; the ctrl counters book the spawn."""
    from mxnet_tpu_torch.gluon import nn

    tmx.random.seed(4)
    net = nn.HybridSequential()
    net.add(nn.Dense(8, flatten=False, in_units=6, activation="relu"),
            nn.Dense(5, flatten=False, in_units=8))
    net.initialize(tmx.init.Xavier(), ctx=CPU)
    local = serve.ModelServer(
        net, serve.BucketSpec(batch_sizes=(1, 2), example_shape=(None, 6),
                              lengths=(4, 8)), ctx=CPU)
    registry = str(tmp_path / "registry")
    before = cp.ctrl_stats()["spawns"]
    plane = cp.ControlPlane(_worker_argv(registry), registry, 1,
                            health_sec=0.0, spawn_timeout=120,
                            spawn_env=_worker_env())
    plane.start()
    local.start()
    try:
        assert cp.ctrl_stats()["spawns"] == before + 1
        (rep,) = plane.router.replicas
        assert rep.server.process.alive()
        assert set(cp.discover_replicas(registry)) == {"0"}
        rng = np.random.RandomState(5)
        for n in (2, 4, 8):
            x = rng.rand(n, 6).astype(np.float32)
            got = plane.predict(x, timeout=TIMEOUT)
            assert np.array_equal(got, local.predict(x, timeout=TIMEOUT))
        assert plane.stats()["requests_lost"] == 0
    finally:
        plane.shutdown(drain=False, timeout=10)
        local.shutdown()
    assert not rep.server.process.alive()
    assert cp.discover_replicas(registry) == {}


def test_a_worker_without_a_device_refuses_and_the_spawn_error_quotes_it(
        tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the worker would start")
    proc = cp.ReplicaProcess(_worker_argv(str(tmp_path), ctx=None)(0),
                             str(tmp_path), 0, env=_worker_env(),
                             start_timeout=120)
    proc.spawn()
    with pytest.raises(cp.ReplicaSpawnError) as ei:
        proc.wait_registered()
    assert "exited with code 2" in str(ei.value)
    assert "no CUDA device is visible" in str(ei.value)
    assert classify(ei.value) == "transient"
