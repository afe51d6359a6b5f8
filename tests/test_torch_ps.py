"""The port's parameter servers (``mxnet_tpu_torch/parallel/ps.py``,
``kvstore_server.py``) and ``kvstore('dist_async')`` against the JAX
package's (``mxnet_tpu/parallel/ps.py``).

- the JAX package's reliability cases (``tests/test_ps_reliability.py``):
  resend dedup by (worker, seq), a client that reconnects after its
  server restarted, heartbeats that mark a dead server, a diagnosable
  error for an unreachable one;
- the wire both ways: the JAX ``PSClient`` against the port's
  ``PSServer`` and the port's client against the JAX server, over init,
  push, pull and heartbeat, the values bit-identical;
- launches through the port's launcher (``tests/torch_ps_worker.py``):
  the JAX nightly's two-worker and three-worker conflict cases, with the
  servers in worker 0 and as a ``-s 1`` process, and a Trainer over
  ``dist_async`` (2 workers and a server, rank 0 training) bit-identical
  to the same Trainer in one process, where ``dist_async`` is the local
  store with the optimizer on it (caveat (q));
- a server process killed or frozen mid-run fails its client fast.
"""
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel.ps import PSClient, PSServer

import torch_ps_worker as w

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _start_server():
    return PSServer(0).start()   # an ephemeral port


# -- the JAX package's reliability cases ----------------------------------------


def test_push_dedup_by_worker_seq():
    srv = _start_server()
    try:
        srv._handle(("init", "w", np.zeros(3, np.float32)))
        g = np.ones(3, np.float32)
        assert srv._handle(("push", "w", g, 7, 1)) == ("ok",)
        # a resend of the same (worker, seq): acknowledged, not re-applied
        assert srv._handle(("push", "w", g, 7, 1)) == ("ok", "dup")
        np.testing.assert_array_equal(srv._handle(("pull", "w"))[1], g)
        assert srv._handle(("push", "w", g, 7, 2)) == ("ok",)
        np.testing.assert_array_equal(srv._handle(("pull", "w"))[1], 2 * g)
        # other workers have seq spaces of their own
        assert srv._handle(("push", "w", g, 8, 1)) == ("ok",)
        np.testing.assert_array_equal(srv._handle(("pull", "w"))[1], 3 * g)
    finally:
        srv.stop()


def test_client_reconnects_after_server_restart():
    srv = _start_server()
    port = srv.port
    cli = PSClient([("127.0.0.1", port)], timeout=5, retries=4, worker_id=1)
    try:
        cli.init("k", np.arange(4, dtype=np.float32))
        assert cli.pull("k")[2] == 2.0
        # a fresh server on the same port: the client resends on a new
        # connection
        srv.stop()
        time.sleep(0.1)
        srv = PSServer(port).start()
        srv._handle(("init", "k", np.arange(4, dtype=np.float32) * 10))
        assert cli.pull("k")[2] == 20.0
        cli.push("k", np.ones(4, np.float32))
        np.testing.assert_array_equal(
            cli.pull("k"), np.arange(4, dtype=np.float32) * 10 + 1)
    finally:
        cli.close()
        srv.stop()


def test_heartbeat_marks_dead_server():
    srv = _start_server()
    deaths = []
    cli = PSClient([("127.0.0.1", srv.port)], timeout=2, retries=0,
                   worker_id=2, heartbeat_interval=0.05, dead_after=2,
                   on_server_death=lambda i, ep, why: deaths.append(
                       (i, ep, why)))
    try:
        cli.init("k", np.zeros(2, np.float32))
        assert cli.alive() == [("127.0.0.1", srv.port)]
        srv.stop()
        deadline = time.time() + 5
        while cli.alive() and time.time() < deadline:
            time.sleep(0.05)
        assert cli.alive() == []
        assert deaths and deaths[0][0] == 0
        t0 = time.time()    # later calls fail fast, naming the cause
        with pytest.raises(MXNetError, match="dead"):
            cli.pull("k")
        assert time.time() - t0 < 1.0
    finally:
        cli.close()


def test_unreachable_server_raises_diagnosable_error():
    srv = _start_server()
    cli = PSClient([("127.0.0.1", srv.port)], timeout=2, retries=1,
                   worker_id=3)
    srv.stop()
    time.sleep(0.1)
    with pytest.raises(MXNetError, match="unreachable|dead"):
        for _ in range(3):  # the first calls may drain buffered replies
            cli.pull("k")
    cli.close()


# -- the wire, both ways --------------------------------------------------------


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_the_wire_is_the_jax_packages(server_pkg):
    """Each package's client against the other's server: init
    (set-if-absent), push with dedup ids, pull and heartbeat carry the
    same bits."""
    from mxnet_tpu.parallel import ps as jps

    srv_cls, cli_cls = ((PSServer, jps.PSClient) if server_pkg == "port"
                        else (jps.PSServer, PSClient))
    srv = srv_cls(0).start()
    cli = cli_cls([("127.0.0.1", srv.port)], timeout=5, retries=1,
                  worker_id=5)
    try:
        rng = np.random.RandomState(3)
        w0, g = rng.randn(3, 5).astype(np.float32), \
            rng.randn(3, 5).astype(np.float32)
        cli.init("w", w0)
        cli.init("w", w0 + 1)        # set-if-absent: the first wins
        np.testing.assert_array_equal(cli.pull("w"), w0)
        cli.push("w", g)
        got = cli.pull("w")
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, w0 + g)
        assert isinstance(cli._call_on(0, "heartbeat"), float)
        with pytest.raises(Exception, match="not initialized"):
            cli.pull("missing")
    finally:
        cli.close()
        srv.stop()


def test_server_updates_on_the_host_with_the_pickled_optimizer():
    """``set_optimizer`` pickles the optimizer (its ``param_dict`` cut to
    the multipliers) and the server's updates equal the port's own
    updater on the same values, on ``cpu()`` tensors."""
    import pickle

    p = tmx.gluon.Parameter("p0", shape=(4,), lr_mult=0.5)
    p.initialize(ctx=tmx.cpu())
    opt = tmx.optimizer.create("adam", learning_rate=0.1,
                               param_dict={0: p})
    blob = pickle.loads(pickle.dumps(opt))
    assert blob.param_dict[0].lr_mult == 0.5
    assert not any(isinstance(v, torch.Tensor) for v in vars(blob).values())
    srv = _start_server()
    cli = PSClient([("127.0.0.1", srv.port)], timeout=5, worker_id=0)
    try:
        w0 = np.linspace(-1, 1, 4).astype(np.float32)
        cli.init("0", w0)
        cli.set_optimizer(opt)
        upd = tmx.optimizer.get_updater(pickle.loads(pickle.dumps(opt)))
        ref = tmx.nd.NDArray(torch.from_numpy(w0.copy()), tmx.cpu())
        for s in range(3):
            g = np.full(4, 0.5 * (s + 1), np.float32)
            cli.push("0", g)
            upd(0, tmx.nd.NDArray(torch.from_numpy(g), tmx.cpu()), ref)
            np.testing.assert_array_equal(cli.pull("0"), ref.asnumpy())
    finally:
        cli.close()
        srv.stop()


# -- launches -------------------------------------------------------------------


def _launch(tmp_path, mode, n, servers, timeout=180):
    """Launch ``n`` workers of ``mode`` beside ``servers`` servers; one
    launch at a time across the session's xdist workers (a lock in the
    session's base temp directory), since each starts 3-4 processes."""
    import fcntl

    root = tmp_path.parent.parent
    if os.environ.get("PYTEST_XDIST_WORKER") is not None:
        root = root.parent
    with open(root / "ps-launch.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return _launch_locked(tmp_path, mode, n, servers, timeout)


def _launch_locked(tmp_path, mode, n, servers, timeout):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for k in list(env):
        if k.startswith(("DMLC_", "MXTPU_COORDINATOR", "MXTPU_NUM_WORKER",
                         "MXTPU_WORKER_ID")):
            del env[k]
    for _ in range(3):   # another process may take the free port first
        port = _free_port_pair()
        cmd = [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n",
               str(n), "-s", str(servers), "-p", str(port), sys.executable,
               os.path.join(REPO, "tests", "torch_ps_worker.py"),
               str(tmp_path), mode]
        proc = subprocess.run(cmd, cwd=REPO, env=env, timeout=timeout,
                              capture_output=True, text=True)
        if "address already in use" not in proc.stderr.lower():
            break
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-3000:]
    for r in range(n):
        assert f"worker {r}/{n}: {mode} OK" in out, out[-3000:]
    return out


def _free_port_pair():
    """A port whose successor is free too (the launcher's servers bind
    PORT + 1)."""
    import socket

    for _ in range(50):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        try:
            with socket.socket() as s:
                s.bind(("127.0.0.1", port + 1))
            return port
        except OSError:
            continue
    raise AssertionError("no free port pair")


@pytest.mark.parametrize("servers", [0, 1])
def test_dist_async_two_workers(tmp_path, servers):
    """Per-push merges with no barrier and the server-side optimizer;
    ``-s 0``: worker 0 hosts the server thread; ``-s 1``: a server
    process, which stays off the card."""
    out = _launch(tmp_path, "async2", 2, servers)
    if servers:
        assert "kvstore_server 0 stopped" in out
        assert "CUDA initialized in this process: False" in out
        assert ("launch: server 0 exited with 0" in out
                or "launch: server 0 exited with -15" in out)


@pytest.mark.parametrize("servers", [0, 1])
def test_dist_async_conflicting_three_workers(tmp_path, servers):
    _launch(tmp_path, "conflict3", 3, servers)


def test_dist_async_trainer_matches_the_local_update_store(tmp_path):
    """Rank 0's 3 steps through ``Trainer(kvstore='dist_async')`` and a
    server process equal, bit for bit, the same Trainer in one process,
    whose ``dist_async`` is the local store updating with the optimizer
    (caveat (q)); no synchronous all-reduce ran in the launch."""
    _launch(tmp_path, "trainer", 2, 1)
    got = np.load(tmp_path / "trainer-rank0.npz")
    net, trainer = w.train_mlp(tmx, "dist_async")
    assert trainer._update_on_kvstore and not trainer._kvstore._is_async()
    ref = {k: p.data().detach().numpy() for k, p in
           net._collect_params_with_prefix().items()}
    assert sorted(got.files) == sorted(ref)
    start = w.mlp(tmx)._collect_params_with_prefix()
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v)
        assert not np.array_equal(v, start[k].data().detach().numpy())


@pytest.mark.parametrize("failure", ["sigkill", "sigstop"])
def test_a_dead_server_process_fails_its_client_fast(failure):
    """SIGKILL: the socket closes and the resend path reports the server
    unreachable; SIGSTOP: the socket stays open and only the heartbeat
    marks it dead.  Either way a diagnosable error well within 40 s."""
    port = _free_port_pair()
    env = dict(os.environ, PYTHONPATH=REPO, DMLC_PS_SERVER_PORT=str(port),
               DMLC_NUM_SERVER="1", DMLC_SERVER_ID="0")
    server = subprocess.Popen(
        [sys.executable, "-c",
         "from mxnet_tpu_torch.parallel import ps; ps.run_server()"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        cli = None
        for _ in range(80):   # the server's cold start
            if server.poll() is not None:
                break
            try:
                cli = PSClient([("127.0.0.1", port)], timeout=2, retries=1,
                               worker_id=0, heartbeat_interval=0.05,
                               dead_after=4)
                break
            except OSError:
                time.sleep(0.25)
        assert cli is not None, server.communicate(timeout=10)[1][-2000:]
        cli.init("w", np.zeros(4, np.float32))
        cli.push("w", np.ones(4, np.float32))
        assert cli.pull("w")[0] == 1.0
        t0 = time.time()
        if failure == "sigkill":
            server.send_signal(signal.SIGKILL)
            server.wait(timeout=10)
        else:
            server.send_signal(signal.SIGSTOP)   # frozen, its socket open
            deadline = time.time() + 20
            while cli.alive() and time.time() < deadline:
                time.sleep(0.05)
            assert cli.alive() == [], "the heartbeat never marked it dead"
        with pytest.raises(MXNetError, match="dead" if failure == "sigstop"
                           else "dead|unreachable"):
            for _ in range(40):
                cli.push("w", np.ones(4, np.float32))
                time.sleep(0.1)
        assert time.time() - t0 < 40
        cli.close()
    finally:
        if server.poll() is None:
            server.send_signal(signal.SIGCONT)
            server.kill()
        server.communicate(timeout=10)


# -- on the card ----------------------------------------------------------------


def _card_files(pid):
    out = []
    for fd in os.listdir(f"/proc/{pid}/fd"):
        try:
            target = os.readlink(f"/proc/{pid}/fd/{fd}")
        except OSError:
            continue
        if target.startswith("/dev/nvidia"):
            out.append(target)
    return out


@pytest.mark.gpu
def test_the_server_process_leaves_the_card_untouched():
    """A server process fed by a client on the card (values from CUDA
    tensors, the optimizer of a Trainer over CUDA parameters) never
    initializes CUDA: its own log says so, and it holds no NVIDIA device
    file open."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine with -m gpu")
    port = _free_port_pair()
    env = dict(os.environ, PYTHONPATH=REPO, DMLC_PS_SERVER_PORT=str(port),
               DMLC_NUM_SERVER="1", DMLC_SERVER_ID="0")
    server = subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.kvstore_server"], env=env,
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        cli = None
        for _ in range(80):
            try:
                cli = PSClient([("127.0.0.1", port)], timeout=5, worker_id=0)
                break
            except OSError:
                time.sleep(0.25)
        assert cli is not None
        net = tmx.gluon.nn.Dense(4, in_units=4)
        net.initialize(ctx=tmx.gpu(0))
        tr = tmx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 0.1})
        w0 = net.weight.data()
        cli.init("0", w0.detach().cpu().numpy())
        cli.set_optimizer(tr._optimizer)
        g = torch.ones_like(w0)
        cli.push("0", g.cpu().numpy())
        assert np.isfinite(cli.pull("0")).all()
        # a CUDA context holds the card's device files open (importing
        # torch maps the driver library but opens none); this process,
        # which made one, is the control
        assert _card_files(server.pid) == []
        assert _card_files(os.getpid())
        cli.stop_server()
        cli.close()
        _, err = server.communicate(timeout=30)
        assert "CUDA initialized in this process: False" in err, err[-2000:]
    finally:
        if server.poll() is None:
            server.kill()
