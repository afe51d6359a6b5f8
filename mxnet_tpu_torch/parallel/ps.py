"""Parameter-server transport for ``dist_async`` (ref:
``mxnet_tpu/parallel/ps.py``; 3rdparty/ps-lite's Van/KVWorker/KVServer and
src/kvstore/kvstore_dist_server.h).

``dist_async``'s semantics: each worker's push updates the server's value
at once (no barrier, no waiting for the other workers), and a pull returns
whatever the server holds now.  A synchronous collective cannot express
that, so, as in the reference, it rides a transport of its own: a threaded
TCP key-value server.  ``dist_sync`` stays on ``torch.distributed``
(``parallel.dist``).

The server is a host role.  Its values are numpy arrays and its optimizer
updates run on ``cpu()`` tensors: it never initializes CUDA and holds
nothing on a card, as the JAX package pins its server to XLA:CPU.
:func:`run_server` logs, as it stops, whether CUDA was initialized in the
process.

Protocol: length-prefixed pickled tuples, the JAX package's wire byte for
byte (either package's client talks to either package's server) --
TRUSTED-CLUSTER ONLY: unpickling attacker bytes is remote code execution,
so servers bind loopback unless ``DMLC_PS_BIND_HOST`` opts in (e.g.
0.0.0.0), and a multi-host cluster must isolate the PS ports.  Ops:

  ("init", key, array)      -> set-if-absent (idempotent)
  ("push", key, array[, wid, seq]) -> merge: the server-side optimizer's
                               update (update_on_kvstore) if one is set,
                               else +=; (wid, seq) deduplicates resends
  ("pull", key)             -> the current value
  ("set_optimizer", bytes)  -> install a pickled optimizer (worker 0)
  ("heartbeat",)            -> liveness probe
  ("stop",)                 -> shut down

Reliability (ref: ps-lite's Van resend and Postoffice heartbeats): a
client resends a dropped request on a fresh connection up to
``MXTPU_PS_RESEND`` times with exponential backoff (a push carries its
(worker, seq) id, so a resend never applies twice), and an optional
heartbeat thread (``MXTPU_PS_HEARTBEAT`` seconds) marks a server dead
after consecutive misses, so calls fail fast with the cause instead of
hanging.
"""
from __future__ import annotations

import itertools
import os
import pickle
import socket
import socketserver
import struct
import threading
import time

import numpy as np

from ..base import MXNetError, getenv


def _send_frame(sock, obj):
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(struct.pack("<Q", len(payload)) + payload)


def _recv_exact(sock, n):
    """``n`` bytes from ``sock``, received into one buffer (linear in
    ``n``: a frame holds a whole array)."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise ConnectionError("peer closed")
        got += k
    return buf


def _recv_frame(sock):
    (n,) = struct.unpack("<Q", _recv_exact(sock, 8))
    return pickle.loads(_recv_exact(sock, n))


class PSServer:
    """The KVServer role (ref: KVStoreDistServer::Run DataHandleEx)."""

    def __init__(self, port, host=None):
        if host is None:
            # loopback unless the cluster explicitly opts in: the pickle
            # protocol is RCE to anyone who can reach the port (see
            # module docstring)
            host = os.environ.get("DMLC_PS_BIND_HOST", "127.0.0.1")
        self._store = {}           # key -> np.ndarray (weights)
        self._updater = None       # server-side optimizer updater
        self._applied = {}         # (wid, key) -> last applied push seq
        self._lock = threading.Lock()
        self._conns = set()        # live handler sockets (closed on stop)
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                with outer._lock:
                    outer._conns.add(self.request)
                try:
                    while True:
                        msg = _recv_frame(self.request)
                        reply = outer._handle(msg)
                        _send_frame(self.request, reply)
                        if msg[0] == "stop":
                            # shutdown() from this handler thread is safe
                            # (serve_forever runs in its own thread) and
                            # unblocks run_server's join
                            threading.Thread(target=outer.stop,
                                             daemon=True).start()
                            return
                except (ConnectionError, OSError):
                    return
                finally:
                    with outer._lock:
                        outer._conns.discard(self.request)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._server.shutdown()
        self._server.server_close()
        # sever live connections so clients observe the death (a real
        # process exit does this; shutdown() alone leaves handler
        # threads serving stale state over established sockets)
        with self._lock:
            conns = list(self._conns)
            self._conns.clear()
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass

    def _handle(self, msg):
        op = msg[0]
        with self._lock:
            if op == "init":
                _, key, arr = msg
                self._store.setdefault(key, np.array(arr, copy=True))
                return ("ok",)
            if op == "push":
                key, grad = msg[1], msg[2]
                wid, seq = (msg[3], msg[4]) if len(msg) >= 5 \
                    else (None, None)
                if key not in self._store:
                    return ("err", f"key {key} not initialized")
                if wid is not None:
                    # resend dedup (ref: ps-lite PS_RESEND message ids):
                    # a retried push whose original landed is ACKed, not
                    # re-applied — pushes are not idempotent
                    if self._applied.get((wid, key), -1) >= seq:
                        return ("ok", "dup")
                    self._applied[(wid, key)] = seq
                if self._updater is not None:
                    # per-push server-side optimizer: THE async semantic
                    # (ref: kvstore_dist_server.h DataHandleDefault,
                    # sync_mode_=false branch), on the host
                    w = _host_array(self._store[key])
                    self._updater(_ps_key_index(key), _host_array(grad), w)
                    self._store[key] = w.asnumpy()
                else:
                    self._store[key] = self._store[key] + np.asarray(grad)
                return ("ok",)
            if op == "pull":
                _, key = msg
                if key not in self._store:
                    return ("err", f"key {key} not initialized")
                return ("ok", self._store[key])
            if op == "set_optimizer":
                from .. import optimizer as _opt

                self._updater = _opt.get_updater(pickle.loads(msg[1]))
                return ("ok",)
            if op == "heartbeat":
                return ("ok", time.time())
            if op == "stop":
                return ("ok",)
        return ("err", f"unknown op {op!r}")


def _host_array(a):
    """A fresh NDArray on ``cpu()`` holding a copy of ``a``."""
    import torch

    from ..context import cpu
    from ..ndarray.ndarray import NDArray

    return NDArray(torch.from_numpy(np.array(a, copy=True)), cpu())


def _ps_key_index(k):
    try:
        return int(k)
    except (TypeError, ValueError):
        return k


class PSClient:
    """The KVWorker role (ref: ps::KVWorker push/pull).

    Keys are sharded over the server group by hash (ref: ps-lite's
    key→server range partitioning); optimizer installs broadcast to
    every server.

    Reliability: a dropped/timed-out request is resent on a fresh
    connection up to MXTPU_PS_RESEND times with exponential backoff
    (pushes carry (worker, seq) ids so a resend can never double-apply);
    an optional heartbeat thread (interval > 0) probes every server and
    marks one dead after `dead_after` consecutive misses — calls then
    fail fast with the failure cause instead of hanging (ref: ps-lite
    Van resend + Postoffice heartbeats).
    """

    def __init__(self, endpoints, timeout=60, retries=None, worker_id=None,
                 heartbeat_interval=None, dead_after=3,
                 on_server_death=None):
        if isinstance(endpoints, tuple) and isinstance(endpoints[0], str):
            endpoints = [endpoints]
        self._endpoints = list(endpoints)
        self._timeout = timeout
        self._retries = int(getenv("PS_RESEND", 3, int)) \
            if retries is None else int(retries)
        if worker_id is not None:
            self._worker_id = int(worker_id)
        elif "DMLC_WORKER_ID" in os.environ:
            self._worker_id = int(os.environ["DMLC_WORKER_ID"])
        else:
            # pid alone collides across hosts/containers (two "pid 1"
            # workers would share a dedup watermark and silently drop
            # each other's pushes) — fold in the hostname
            import zlib

            self._worker_id = (
                zlib.crc32(socket.gethostname().encode()) << 22
            ) | (os.getpid() & 0x3FFFFF)
        # seq base = µs since epoch: a restarted worker (same wid) must
        # start ABOVE the server's dedup watermark from its previous
        # incarnation, else its pushes are silently dropped as dups
        self._seq = itertools.count(int(time.time() * 1e6))
        self._socks = [socket.create_connection((h, p), timeout=timeout)
                       for h, p in self._endpoints]
        self._locks = [threading.Lock() for _ in self._socks]
        self._dead = [None] * len(self._socks)  # index -> failure reason
        self._misses = [0] * len(self._socks)
        self._on_server_death = on_server_death
        self._hb_stop = threading.Event()
        self._hb_thread = None
        interval = float(getenv("PS_HEARTBEAT", 0.0, float)) \
            if heartbeat_interval is None else float(heartbeat_interval)
        self._dead_after = int(dead_after)
        if interval > 0:
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop, args=(interval,), daemon=True)
            self._hb_thread.start()

    # -- transport with resend ----------------------------------------------

    def _reconnect(self, i):
        try:
            self._socks[i].close()
        except OSError:
            pass
        self._socks[i] = socket.create_connection(
            self._endpoints[i], timeout=self._timeout)

    def _call_on(self, i, *msg):
        if self._dead[i]:
            raise MXNetError(
                f"ps server {self._endpoints[i]} marked dead: "
                f"{self._dead[i]}")
        last = None
        for attempt in range(self._retries + 1):
            try:
                with self._locks[i]:
                    _send_frame(self._socks[i], msg)
                    reply = _recv_frame(self._socks[i])
                break
            except (ConnectionError, OSError) as e:
                last = e
                if attempt >= self._retries:
                    self._mark_dead(i, f"{type(e).__name__}: {e} after "
                                       f"{self._retries + 1} attempts")
                    raise MXNetError(
                        f"ps server {self._endpoints[i]} unreachable "
                        f"({last}); gave up after "
                        f"{self._retries + 1} attempts") from e
                time.sleep(min(0.1 * 2 ** attempt, 2.0))
                with self._locks[i]:
                    try:
                        self._reconnect(i)
                    except OSError as e2:
                        last = e2
        if reply[0] != "ok":
            raise MXNetError(f"ps server error: {reply[1:]}")
        return reply[1] if len(reply) > 1 else None

    def _call(self, op, key, *rest):
        return self._call_on(self._server_of(key), op, key, *rest)

    def _server_of(self, key):
        import zlib

        return zlib.crc32(str(key).encode()) % len(self._socks)

    # -- failure detection ---------------------------------------------------

    def _mark_dead(self, i, reason):
        if self._dead[i] is None:
            self._dead[i] = reason
            if self._on_server_death is not None:
                try:
                    self._on_server_death(i, self._endpoints[i], reason)
                except Exception:
                    pass

    def _heartbeat_loop(self, interval):
        while not self._hb_stop.wait(interval):
            for i in range(len(self._socks)):
                if self._dead[i]:
                    continue
                try:
                    with self._locks[i]:
                        _send_frame(self._socks[i], ("heartbeat",))
                        _recv_frame(self._socks[i])
                    self._misses[i] = 0
                except (ConnectionError, OSError) as e:
                    self._misses[i] += 1
                    try:
                        with self._locks[i]:
                            self._reconnect(i)
                    except OSError:
                        pass
                    if self._misses[i] >= self._dead_after:
                        self._mark_dead(
                            i, f"{self._misses[i]} consecutive heartbeat "
                               f"misses ({e})")

    def alive(self):
        """Endpoints still considered live (failure-detection view)."""
        return [ep for ep, d in zip(self._endpoints, self._dead) if not d]

    # -- kv api --------------------------------------------------------------

    def init(self, key, arr):
        self._call("init", key, np.asarray(arr))

    def push(self, key, grad):
        self._call("push", key, np.asarray(grad),
                   self._worker_id, next(self._seq))

    def pull(self, key):
        return self._call("pull", key)

    def set_optimizer(self, optimizer):
        blob = pickle.dumps(optimizer)
        for i in range(len(self._socks)):
            self._call_on(i, "set_optimizer", blob)

    def stop_server(self):
        for i in range(len(self._socks)):
            self._call_on(i, "stop")

    def close(self):
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5)
        for s in self._socks:
            s.close()


_server_singleton = None


def server_endpoints():
    """[(host, port), ...] of the PS group for this job.

    Dedicated server roles if the launcher (``tools.launch -s N``)
    spawned them
    (DMLC_PS_SERVER_PORT base + DMLC_NUM_SERVER consecutive ports);
    otherwise worker 0 hosts one in-process server thread on
    root_port+1 — the local-launcher degenerate mode.
    """
    host = os.environ.get("DMLC_PS_ROOT_URI", "127.0.0.1")
    base = int(os.environ.get(
        "DMLC_PS_SERVER_PORT",
        int(os.environ.get("DMLC_PS_ROOT_PORT", "9099")) + 1))
    n = max(1, int(os.environ.get("DMLC_NUM_SERVER", "0") or 0))
    if "DMLC_PS_SERVER_PORT" not in os.environ:
        n = 1  # embedded single-server mode
    return [(host, base + i) for i in range(n)]


def _check_bind_optin(root_host):
    """Multi-host cluster without an explicit bind opt-in: binding
    loopback would strand remote workers in retry loops, and binding
    wide open silently would expose the pickle transport (= RCE).
    Fail fast with the knob to turn."""
    if (root_host not in ("127.0.0.1", "localhost", "::1")
            and not os.environ.get("DMLC_PS_BIND_HOST")):
        raise MXNetError(
            f"dist server for cluster root {root_host!r} needs "
            "DMLC_PS_BIND_HOST set (e.g. 0.0.0.0). The PS pickle "
            "transport is remote-code-execution to anything that can "
            "reach the port, so non-loopback binding is opt-in; the "
            "launcher must network-isolate the PS ports.")


def ensure_local_server():
    """Start the in-process server on worker 0 when no dedicated server
    role exists. Idempotent.  Binds loopback unless DMLC_PS_BIND_HOST
    opts in — and fails fast (rather than stranding remote workers)
    when the cluster root is non-loopback and no opt-in is set."""
    global _server_singleton
    if _server_singleton is None:
        (host, port), = server_endpoints()
        _check_bind_optin(host)
        _server_singleton = PSServer(port).start()
    return _server_singleton


def run_server():
    """Blocking server loop for a dedicated ``DMLC_ROLE=server`` process
    (ref: MXKVStoreRunServer / ``kvstore_server.py``).  The server is a
    host role: nothing here touches a card, and the log line it writes as
    it stops says whether CUDA was initialized in the process."""
    import sys

    import torch

    host, base = server_endpoints()[0]
    my_id = int(os.environ.get("DMLC_SERVER_ID", "0"))
    _check_bind_optin(host)
    srv = PSServer(base + my_id).start()
    srv._thread.join()
    print(f"kvstore_server {my_id} stopped (port {srv.port}); CUDA "
          f"initialized in this process: {torch.cuda.is_initialized()}",
          file=sys.stderr, flush=True)
