"""The control plane's socket wire: length-prefixed frames between the
router process and replica processes (ref: ``mxnet_tpu/serve/
control_plane/rpc.py``).  The bytes are the JAX package's, so a client of
either package talks to an endpoint of the other.

- **Frames**: ``MXRP`` magic, ``<H`` wire version, ``<I`` header
  length, ``<Q`` payload length, then a JSON header and an optional
  binary payload, the ``utils/serialization.py`` container.  A frame
  whose wire version is newer than this build is rejected with an
  actionable error, never misparsed.
- **Server**: :class:`ReplicaEndpoint` wraps a STARTED
  ``ModelServer``/``DecodeServer`` in a ``ThreadingTCPServer``.  Each
  connection gets a reader (the handler thread) and ONE writer thread fed
  by an outbound queue: decode-loop sinks enqueue token frames and return
  at once, so a slow consumer's connection never stalls the decode loop,
  and per-request frames interleave on the shared connection.
- **Discovery**: the endpoint registers ``replica-<id>.json`` in a shared
  :class:`~...parallel.dist.LeaseDir` and re-publishes it on a heartbeat;
  a registration older than the lease window (a SIGKILLed worker, a
  previous incarnation) is rejected by :func:`discover_replicas`.
- **Client**: :class:`RemoteReplica` speaks the replica surface the
  Router scores and evicts (``submit/pending/probe_example/
  reload_weights/drain/stats/start/shutdown``) over ONE persistent
  connection; a demux reader thread routes response frames by request id
  into per-request futures and queues.  A dropped connection fails every
  in-flight request with a 'network'-classified
  :class:`RPCConnectionError`, which the router's retry path re-dispatches
  on another replica, mid-stream included.

Chaos: ``engine.fault_point("serve.rpc.send", replica=..., attempt=...)``
fires before every client frame send; an armed ``raise`` drops the whole
connection.
"""
from __future__ import annotations

import itertools
import json
import os
import queue as _queue_mod
import socket
import socketserver
import struct
import threading
from concurrent.futures import Future

import numpy as np

from ... import engine
from ...base import MXNetError, getenv
from ...log import get_logger
from ...parallel.dist import LeaseDir
from ...telemetry import tracer as _tracer
from ...utils.serialization import dumps_ndarrays, loads_ndarrays
from ..batcher import (DeadlineExceededError, ServerClosedError,
                       ServerOverloadedError)
from ..decode import STREAM_DONE
from . import _sec_bump

logger = get_logger("mxnet_tpu_torch.serve.control_plane.rpc")

WIRE_MAGIC = b"MXRP"
#: Bump on any frame-layout change; both ends reject newer-versioned
#: frames loudly instead of misparsing them.
WIRE_VERSION = 1
_FRAME_HDR = struct.Struct("<HIQ")   # wire version, header len, payload len

_DEFAULT_LEASE_SEC = 10.0


class RPCConnectionError(MXNetError):
    """A control-plane connection died (reset, refused, truncated
    frame).  Message shapes are in ``resilience`` 's network signature
    list, so ``classify()`` returns ``'network'`` and the router
    re-dispatches instead of forwarding a transport blip as fatal."""


# ---------------------------------------------------------------------------
# frame codec


def _recv_exact(sock, n, what):
    chunks, got = [], 0
    while got < n:
        try:
            buf = sock.recv(min(n - got, 1 << 20))
        except OSError as e:
            raise RPCConnectionError(
                f"rpc connection reset while reading {what}: {e}"
            ) from e
        if not buf:
            raise RPCConnectionError(
                f"rpc connection closed mid-frame: truncated frame — "
                f"wanted {n} bytes for {what}, got {got}")
        chunks.append(buf)
        got += len(buf)
    return b"".join(chunks)


def send_frame(sock, meta, arrays=None):
    """Write one frame: JSON ``meta`` plus an optional dict of
    numpy/NDArray payloads (the versioned container).  The caller
    serializes concurrent senders (one writer thread per connection)."""
    header = json.dumps(meta, default=_jsonable).encode()
    payload = dumps_ndarrays(arrays) if arrays else b""
    try:
        sock.sendall(WIRE_MAGIC
                     + _FRAME_HDR.pack(WIRE_VERSION, len(header),
                                       len(payload))
                     + header + payload)
    except OSError as e:
        raise RPCConnectionError(
            f"rpc connection reset while sending "
            f"{meta.get('op', '?')}: {e}") from e


def recv_frame(sock):
    """Read one frame -> ``(meta, arrays-or-None)``; ``None`` on a
    clean peer close AT a frame boundary (mid-frame closes raise the
    network-classified truncation error)."""
    try:
        first = sock.recv(1)
    except OSError as e:
        raise RPCConnectionError(
            f"rpc connection reset while reading a frame: {e}") from e
    if not first:
        return None
    magic = first + _recv_exact(sock, len(WIRE_MAGIC) - 1, "the magic")
    if magic != WIRE_MAGIC:
        raise MXNetError(
            f"not an MXRP frame (bad magic {magic!r}) — is the peer "
            "speaking the control-plane wire protocol?")
    ver, hlen, plen = _FRAME_HDR.unpack(
        _recv_exact(sock, _FRAME_HDR.size, "the frame header"))
    if ver > WIRE_VERSION:
        raise MXNetError(
            f"RPC frame wire v{ver} was sent by a newer mxnet_tpu or "
            f"mxnet_tpu_torch (this build speaks <= v{WIRE_VERSION}); "
            "upgrade this process or downgrade the peer")
    meta = json.loads(_recv_exact(sock, hlen, "the frame meta"))
    arrays = None
    if plen:
        arrays = loads_ndarrays(_recv_exact(sock, plen, "the payload"),
                                name="<frame>", numpy=True)
    return meta, arrays


def _jsonable(o):
    if hasattr(o, "item"):
        return o.item()          # numpy scalars
    if isinstance(o, (set, tuple)):
        return list(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    return str(o)


# exception <-> wire: the client re-raises the same serve exception
# TYPES the in-process replica would, so the router's failure matrix
# (spill on overload, fail on deadline, retry on closed) is unchanged
# across the process boundary
def _exc_to_wire(e):
    if isinstance(e, DeadlineExceededError):
        return "deadline"
    if isinstance(e, ServerClosedError):
        return "closed"
    if isinstance(e, ServerOverloadedError):
        return "overloaded"
    return "app"


# a model's result on the wire: one output is the "result" array, the JAX
# package's frame; a model of several outputs (a tuple: BERT's sequence
# and pooled outputs) adds "outputs": n to the meta and "result.1" ..
# "result.<n-1>" to the arrays.  The JAX endpoint cannot send a tuple
# (np.asarray of outputs of different shapes raises in its callback, and
# the request never resolves); a JAX client reads the first output.
def _result_to_wire(rid, result):
    if not isinstance(result, tuple):
        return {"op": "done", "rid": rid}, {"result": np.asarray(result)}
    arrays = {"result": np.asarray(result[0])}
    arrays.update((f"result.{i}", np.asarray(r))
                  for i, r in enumerate(result[1:], 1))
    return {"op": "done", "rid": rid, "outputs": len(result)}, arrays


def _result_from_wire(meta, arrays):
    first = np.asarray(arrays["result"])
    n = meta.get("outputs")
    if n is None:
        return first
    return (first,) + tuple(np.asarray(arrays[f"result.{i}"])
                            for i in range(1, int(n)))


def _exc_from_wire(etype, msg):
    return {"deadline": DeadlineExceededError,
            "closed": ServerClosedError,
            "overloaded": ServerOverloadedError}.get(
                etype, MXNetError)(msg)


# ---------------------------------------------------------------------------
# discovery (LeaseDir — the elastic-rendezvous lease protocol)


def _registry(registry_dir, lease_sec=None):
    return LeaseDir(registry_dir, prefix="replica",
                    lease_sec=float(
                        getenv("CTRL_LEASE_SEC", _DEFAULT_LEASE_SEC,
                               float)
                        if lease_sec is None else lease_sec))


def discover_replicas(registry_dir, lease_sec=None):
    """``{replica_key: {"host", "port", "pid", "kind"}}`` for every
    LIVE registration — a marker staler than the lease window (a
    SIGKILLed worker that can no longer heartbeat, a previous job's
    leftovers) is rejected, not returned, and booked in the ``ctrl``
    section's ``stale_leases_rejected``."""
    ld = _registry(registry_dir, lease_sec)
    fresh = ld.fresh()
    try:
        total = sum(1 for n in os.listdir(ld.root)
                    if ld._rx.match(n))
    except OSError:
        total = len(fresh)
    if total > len(fresh):
        _sec_bump(stale_leases_rejected=total - len(fresh))
    return fresh


# ---------------------------------------------------------------------------
# server side


class ReplicaEndpoint:
    """Expose a STARTED server on the wire (one per replica process).

    Mirrors ``telemetry.httpd``: a ``ThreadingTCPServer`` with daemon
    handler threads, ephemeral port by default, ``serve_forever`` on a
    background thread.  With ``registry_dir`` the endpoint publishes
    (and heartbeats) its lease so routers discover it; the worker only
    constructs its endpoint AFTER ``server.start()`` finished the AOT
    warmup, so a discovered replica is a WARM replica.
    """

    def __init__(self, server, host="127.0.0.1", port=None,
                 registry_dir=None, replica_id=None, lease_sec=None):
        self.server = server
        self.kind = "decode" if hasattr(server, "generate") else "model"
        port = int(getenv("CTRL_PORT", 0, int) if port is None else port)
        endpoint = self

        class _TCP(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self):
                endpoint._handle_conn(self.request)

        self._tcp = _TCP((host, port), _Handler)
        self.host, self.port = self._tcp.server_address[:2]
        self._thread = threading.Thread(
            target=self._tcp.serve_forever, kwargs={"poll_interval": 0.1},
            name=f"mxtpu-ctrl-endpoint-{self.port}", daemon=True)
        self._thread.start()
        self._closed = False
        self._lease_stop = None
        self._leases = None
        self.replica_id = replica_id
        if registry_dir is not None:
            if replica_id is None:
                raise MXNetError(
                    "registering an endpoint needs replica_id=")
            self._leases = _registry(registry_dir, lease_sec)
            payload = {"host": self.host, "port": self.port,
                       "pid": os.getpid(), "kind": self.kind}
            self._leases.publish(replica_id, payload)
            self._lease_stop = threading.Event()
            period = self._leases.lease_sec / 3.0
            threading.Thread(
                target=self._lease_loop, args=(period, payload),
                name=f"mxtpu-ctrl-lease-{replica_id}",
                daemon=True).start()

    def _lease_loop(self, period, payload):
        while not self._lease_stop.wait(period):
            self._leases.publish(self.replica_id, payload)

    def stop(self, unregister=True):
        """Stop serving (existing connections drop; the worker's model
        server is NOT shut down — that is the owner's call)."""
        if self._closed:
            return
        self._closed = True
        if self._lease_stop is not None:
            self._lease_stop.set()
        if unregister and self._leases is not None:
            self._leases.retire(self.replica_id)
        self._tcp.shutdown()
        self._tcp.server_close()

    # -- one connection -----------------------------------------------------

    def _handle_conn(self, sock):
        outq = _queue_mod.Queue()
        live = {}            # rid -> handle/future (cancel on close)
        live_lock = threading.Lock()
        stop = object()

        def writer():
            while True:
                item = outq.get()
                if item is stop:
                    return
                meta, arrays = item
                try:
                    send_frame(sock, meta, arrays)
                except (RPCConnectionError, OSError):
                    return   # reader notices and tears down

        wt = threading.Thread(target=writer, daemon=True,
                              name="mxtpu-ctrl-conn-writer")
        wt.start()
        outq.put(({"op": "hello", "wire": WIRE_VERSION,
                   "kind": self.kind, "pid": os.getpid(),
                   "replica": self.replica_id}, None))
        try:
            while not self._closed:
                try:
                    frame = recv_frame(sock)
                except (RPCConnectionError, MXNetError):
                    break
                if frame is None:
                    break
                try:
                    self._dispatch(frame, outq, live, live_lock)
                except Exception as e:  # noqa: BLE001 — per-request
                    # failure; the connection (other requests!) lives on
                    rid = frame[0].get("rid")
                    _sec_bump(rpc_errors=1)
                    outq.put(({"op": "error", "rid": rid,
                               "etype": _exc_to_wire(e),
                               "error": str(e)}, None))
        finally:
            outq.put(stop)
            # the peer is gone: stop computing for its dead requests
            with live_lock:
                handles = list(live.values())
                live.clear()
            for h in handles:
                try:
                    h.cancel()
                except Exception:  # noqa: BLE001 — best-effort
                    pass
            try:
                sock.close()
            except OSError:
                pass

    def _dispatch(self, frame, outq, live, live_lock):
        meta, arrays = frame
        op = meta.get("op")
        rid = meta.get("rid")
        if op == "submit":
            self._op_submit(meta, arrays, outq, live, live_lock)
        elif op == "call":
            self._op_call(meta, outq)
        elif op == "cancel":
            with live_lock:
                h = live.pop(rid, None)
            if h is not None:
                h.cancel()
        else:
            raise MXNetError(f"unknown rpc op {op!r}")

    def _op_submit(self, meta, arrays, outq, live, live_lock):
        rid = meta["rid"]
        _sec_bump(rpc_requests=1)
        tid = _tracer.request_begin("serve.rpc.request", cat="serve",
                                    op="submit", rid=rid)
        example = arrays["example"] if arrays else None
        kwargs = meta.get("kwargs") or {}
        inner = self.server.submit(example,
                                   deadline_ms=meta.get("deadline_ms"),
                                   **kwargs)
        fut = getattr(inner, "future", inner)
        stream = inner is not fut and hasattr(inner, "add_sink")
        with live_lock:
            live[rid] = inner
        outq.put(({"op": "ack", "rid": rid, "stream": stream}, None))

        def finish(meta_out, arrays_out, outcome):
            with live_lock:
                live.pop(rid, None)
            outq.put((meta_out, arrays_out))
            _tracer.request_end("serve.rpc.request", tid, cat="serve",
                                op="submit", rid=rid, outcome=outcome)

        if stream:
            _sec_bump(rpc_streams=1)

            def sink(item):
                # runs on the decode loop thread: enqueue-and-return —
                # the per-connection writer drains; a slow consumer
                # backs up ITS OWN socket, never the decode loop
                if item is STREAM_DONE:
                    finish({"op": "done", "rid": rid},
                           {"result": np.asarray(fut.result(timeout=5),
                                                 np.int32)}, "served")
                elif isinstance(item, BaseException):
                    _sec_bump(rpc_errors=1)
                    finish({"op": "error", "rid": rid,
                            "etype": _exc_to_wire(item),
                            "error": str(item)}, None, "failed")
                else:
                    outq.put(({"op": "tok", "rid": rid,
                               "t": int(item)}, None))

            inner.add_sink(sink)
        else:
            def on_done(f):
                exc = f.exception() if not f.cancelled() else None
                if f.cancelled():
                    finish({"op": "error", "rid": rid,
                            "etype": "closed",
                            "error": "request cancelled on the "
                                     "replica"}, None, "cancelled")
                elif exc is not None:
                    _sec_bump(rpc_errors=1)
                    finish({"op": "error", "rid": rid,
                            "etype": _exc_to_wire(exc),
                            "error": str(exc)}, None, "failed")
                else:
                    finish(*_result_to_wire(rid, f.result()), "served")

            fut.add_done_callback(on_done)

    def _op_call(self, meta, outq):
        rid, method = meta["rid"], meta["method"]
        args = meta.get("args") or {}
        _sec_bump(rpc_requests=1)
        tid = _tracer.request_begin("serve.rpc.request", cat="serve",
                                    op=method, rid=rid)
        arrays = None
        if method == "pending":
            value = int(self.server.pending())
        elif method == "probe_example":
            value, arrays = None, {"example":
                                   np.asarray(self.server.probe_example())}
        elif method == "reload_weights":
            value = self.server.reload_weights(args.get("step"))
        elif method == "drain":
            self.server.drain(args.get("timeout"))
            value = True
        elif method == "stats":
            value = self.server.stats(reset=bool(args.get("reset")))
        elif method == "health":
            value = {"ok": True, "kind": self.kind, "pid": os.getpid()}
        elif method == "ping":
            value = True
        elif method == "shutdown":
            self.server.shutdown(drain=bool(args.get("drain", True)),
                                 timeout=args.get("timeout"))
            value = True
        else:
            raise MXNetError(f"unknown rpc method {method!r}")
        outq.put(({"op": "ret", "rid": rid, "value": value}, arrays))
        _tracer.request_end("serve.rpc.request", tid, cat="serve",
                            op=method, rid=rid, outcome="served")


def serve_replica(server, host="127.0.0.1", port=None,
                  registry_dir=None, replica_id=None, lease_sec=None):
    """Wrap a STARTED server in a :class:`ReplicaEndpoint` (start it
    first — registration is the 'I am warm' signal)."""
    return ReplicaEndpoint(server, host=host, port=port,
                           registry_dir=registry_dir,
                           replica_id=replica_id, lease_sec=lease_sec)


# ---------------------------------------------------------------------------
# client side


class RemoteDecodeHandle:
    """Client half of a streamed decode request: same iterate/future
    surface as ``DecodeHandle``, fed by the demux reader."""

    def __init__(self, client, rid):
        self._client = client
        self._rid = rid
        self.future = Future()
        self._q = _queue_mod.Queue()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is STREAM_DONE:
            self._q.put(STREAM_DONE)
            raise StopIteration
        if isinstance(item, BaseException):
            self._q.put(item)
            raise item
        return item

    def result(self, timeout=None):
        return self.future.result(timeout)

    def cancel(self):
        self.future.cancel()
        self._client._send_cancel(self._rid)

    # demux callbacks -------------------------------------------------------

    def _on_frame(self, meta, arrays):
        op = meta["op"]
        if op == "tok":
            self._q.put(int(meta["t"]))
        elif op == "done":
            if self.future.set_running_or_notify_cancel():
                self.future.set_result(
                    np.asarray(arrays["result"], np.int32))
            self._q.put(STREAM_DONE)
            return True
        elif op == "error":
            exc = _exc_from_wire(meta.get("etype"), meta.get("error"))
            if self.future.set_running_or_notify_cancel():
                self.future.set_exception(exc)
            self._q.put(exc)
            return True
        return False

    def _fail(self, exc):
        if self.future.set_running_or_notify_cancel():
            self.future.set_exception(exc)
        self._q.put(exc)


class _PendingCall:
    """One synchronous round trip (ack wait / call return)."""

    def __init__(self):
        self.future = Future()

    def _on_frame(self, meta, arrays):
        op = meta["op"]
        if op == "error":
            self.future.set_exception(
                _exc_from_wire(meta.get("etype"), meta.get("error")))
            return True
        value = meta.get("value")
        if arrays and "example" in arrays:
            value = arrays["example"]
        self.future.set_result((meta, value))
        return True

    def _fail(self, exc):
        if not self.future.done():
            self.future.set_exception(exc)


class _PendingSubmit(_PendingCall):
    """submit() waits for the admission ack; result frames afterwards
    go to the future/handle this ack installs."""

    def __init__(self, client, rid):
        super().__init__()
        self._client = client
        self._rid = rid
        self.consumer = None     # installed on ack

    def _on_frame(self, meta, arrays):
        op = meta["op"]
        if op == "ack" and self.consumer is None:
            if meta.get("stream"):
                self.consumer = RemoteDecodeHandle(self._client,
                                                   self._rid)
            else:
                self.consumer = _RemoteFuture(self._client, self._rid)
            self.future.set_result((meta, None))
            return False         # stay registered for result frames
        if self.consumer is not None:
            return self.consumer._on_frame(meta, arrays)
        return super()._on_frame(meta, arrays)

    def _fail(self, exc):
        super()._fail(exc)
        if self.consumer is not None:
            self.consumer._fail(exc)


class _RemoteFuture:
    """Non-streamed (ModelServer) submit consumer: one result frame."""

    def __init__(self, client, rid):
        self._client = client
        self._rid = rid
        self.future = Future()

    def cancel(self):
        self.future.cancel()
        self._client._send_cancel(self._rid)

    def _on_frame(self, meta, arrays):
        op = meta["op"]
        if op == "done":
            if self.future.set_running_or_notify_cancel():
                self.future.set_result(_result_from_wire(meta, arrays))
            return True
        if op == "error":
            exc = _exc_from_wire(meta.get("etype"), meta.get("error"))
            if self.future.set_running_or_notify_cancel():
                self.future.set_exception(exc)
            return True
        return False

    def _fail(self, exc):
        if self.future.set_running_or_notify_cancel():
            self.future.set_exception(exc)


class RemoteReplica:
    """A cross-process replica, speaking the pool-member surface over
    one multiplexed connection.

    The Router treats it exactly like an in-process server: it is
    scored by ``pending()``, probed, evicted, drained, and reloaded
    through the same methods — so the router's failure matrix applies to
    replicas in other processes unchanged.  A connection drop fails
    every in-flight request with a 'network'-classified error (the
    router re-dispatches) and the next use reconnects."""

    def __init__(self, host, port, rid=-1, process=None,
                 connect_timeout=10.0, call_timeout=120.0):
        self.host, self.port = host, int(port)
        self.rid = rid                 # fault-point ctx + diagnostics
        self.process = process         # owning ReplicaProcess, if any
        self._connect_timeout = float(connect_timeout)
        self._call_timeout = float(call_timeout)
        self._lock = threading.Lock()      # connection lifecycle
        self._send_lock = threading.Lock()
        self._sock = None
        self._pending = {}
        self._pending_lock = threading.Lock()
        self._rids = itertools.count(0)
        self._sends = itertools.count(1)
        self._kind = None
        self._started = False
        self._last_pending = 0

    # -- connection ---------------------------------------------------------

    def _ensure_connected(self):
        with self._lock:
            if self._sock is not None:
                return
            try:
                sock = socket.create_connection(
                    (self.host, self.port),
                    timeout=self._connect_timeout)
                sock.settimeout(None)
                hello = recv_frame(sock)
            except OSError as e:
                raise RPCConnectionError(
                    f"rpc connection refused by replica {self.rid} at "
                    f"{self.host}:{self.port}: {e}") from e
            if hello is None or hello[0].get("op") != "hello":
                try:
                    sock.close()
                finally:
                    pass
                raise RPCConnectionError(
                    f"rpc connection to {self.host}:{self.port} closed "
                    "during the hello handshake")
            self._kind = hello[0].get("kind")
            self._sock = sock
            threading.Thread(
                target=self._reader, args=(sock,),
                name=f"mxtpu-ctrl-demux-{self.rid}", daemon=True).start()

    def _reader(self, sock):
        """Demux loop: drains the socket UNCONDITIONALLY into
        per-request consumers, so one unread stream can never back up
        the connection for the others."""
        exc = None
        while True:
            try:
                frame = recv_frame(sock)
            except (MXNetError, OSError) as e:
                exc = e
                break
            if frame is None:
                break
            meta, arrays = frame
            rid = meta.get("rid")
            with self._pending_lock:
                entry = self._pending.get(rid)
            if entry is None:
                continue   # late frame for a cancelled request
            try:
                done = entry._on_frame(meta, arrays)
            except Exception:  # noqa: BLE001 — a consumer bug must not
                # kill the demux loop for every other request
                done = True
            if done:
                with self._pending_lock:
                    self._pending.pop(rid, None)
        self._teardown(exc if isinstance(exc, RPCConnectionError)
                       else RPCConnectionError(
                           f"rpc connection to replica {self.rid} "
                           f"({self.host}:{self.port}) was reset"
                           + (f": {exc}" if exc else "")))

    def _teardown(self, exc):
        with self._lock:
            sock, self._sock = self._sock, None
        if sock is not None:
            # shutdown() first: close() alone neither wakes the demux
            # thread blocked in recv() nor ends the connection, so the
            # endpoint would go on computing for it
            for end in (lambda: sock.shutdown(socket.SHUT_RDWR), sock.close):
                try:
                    end()
                except OSError:
                    pass
        with self._pending_lock:
            pending = list(self._pending.values())
            self._pending.clear()
        for entry in pending:
            entry._fail(exc)

    def _send(self, meta, arrays=None):
        attempt = next(self._sends)
        try:
            engine.fault_point("serve.rpc.send", replica=self.rid,
                               attempt=attempt)
        except BaseException as e:
            # injected connection drop: realistic semantics — the WHOLE
            # connection (every in-flight stream on it) dies, not just
            # this send
            self._teardown(RPCConnectionError(
                f"rpc connection to replica {self.rid} dropped by "
                f"injected fault at serve.rpc.send (attempt "
                f"{attempt}): {e}"))
            raise RPCConnectionError(
                f"rpc connection to replica {self.rid} dropped by "
                f"injected fault at serve.rpc.send: {e}") from e
        self._ensure_connected()
        with self._lock:
            sock = self._sock
        if sock is None:
            raise RPCConnectionError(
                f"rpc connection to replica {self.rid} is down")
        try:
            with self._send_lock:
                send_frame(sock, meta, arrays)
        except RPCConnectionError as e:
            self._teardown(e)
            raise

    def _send_cancel(self, rid):
        try:
            self._send({"op": "cancel", "rid": rid})
        except (RPCConnectionError, MXNetError):
            pass

    def _register(self, entry):
        rid = next(self._rids)
        with self._pending_lock:
            self._pending[rid] = entry
        return rid

    def _call(self, method, args=None, timeout=None):
        entry = _PendingCall()
        rid = self._register(entry)
        try:
            self._send({"op": "call", "rid": rid, "method": method,
                        "args": args or {}})
            _meta, value = entry.future.result(
                timeout=self._call_timeout if timeout is None
                else timeout)
            return value
        finally:
            with self._pending_lock:
                self._pending.pop(rid, None)

    # -- the pool-member surface --------------------------------------------

    def start(self):
        """Connect + handshake (the WORKER warmed its server before
        registering, so a connectable replica is a warm replica)."""
        self._ensure_connected()
        self._started = True
        return self

    def submit(self, example, deadline_ms=None, **kwargs):
        """Returns a Future (model replicas) or a
        :class:`RemoteDecodeHandle` (decode replicas) — mirrors the
        wrapped server.  Admission errors (overload, closed, deadline)
        raise synchronously with the SAME exception types, so router
        spill/shed behaves identically cross-process."""
        entry = _PendingSubmit(self, None)
        rid = self._register(entry)
        entry._rid = rid
        arrays = ({"example": np.asarray(example)}
                  if example is not None else None)
        try:
            self._send({"op": "submit", "rid": rid,
                        "deadline_ms": deadline_ms, "kwargs": kwargs},
                       arrays)
            entry.future.result(timeout=self._connect_timeout
                                + (deadline_ms or 0) / 1e3)
        except Exception:
            with self._pending_lock:
                self._pending.pop(rid, None)
            raise
        consumer = entry.consumer
        return (consumer if isinstance(consumer, RemoteDecodeHandle)
                else consumer.future)

    def pending(self):
        """Live queue depth — the router's scoring gauge.  NEVER raises:
        scoring runs outside any retry path, so a dead connection
        reports 'very loaded' (deprioritized) and lets the health
        prober make the eviction call."""
        try:
            self._last_pending = int(self._call("pending", timeout=5.0))
        except Exception:  # noqa: BLE001 — see docstring
            return 1 << 20
        return self._last_pending

    def probe_example(self):
        return self._call("probe_example")

    def reload_weights(self, step=None):
        return self._call("reload_weights", {"step": step})

    def drain(self, timeout=None):
        """Wait for the worker's in-flight requests to settle.  A
        replica whose connection is already dead has nothing left to
        drain — its in-flight work was failed over at teardown — so a
        connection error here is a completed drain, not a failure
        (``ControlPlane.shutdown(drain=True)`` must survive a pool
        that still holds a SIGKILLed corpse)."""
        try:
            return self._call("drain", {"timeout": timeout},
                              timeout=(timeout or self._call_timeout)
                              + 10.0)
        except RPCConnectionError:
            return None

    def stats(self, reset=False):
        return self._call("stats", {"reset": bool(reset)})

    def health(self):
        return self._call("health", timeout=5.0)

    def ping(self):
        return self._call("ping", timeout=5.0)

    def shutdown(self, drain=True, timeout=None):
        """Best-effort remote stop, then drop the connection; owning a
        :class:`ReplicaProcess` also reaps the worker process (the
        eviction path's cleanup for a replica that may already be
        SIGKILL-dead)."""
        try:
            self._call("shutdown", {"drain": drain, "timeout": timeout},
                       timeout=(timeout or 10.0) + 10.0)
        except Exception:  # noqa: BLE001 — it may already be dead
            pass
        self._teardown(RPCConnectionError(
            f"rpc connection to replica {self.rid} closed by "
            "shutdown"))
        if self.process is not None:
            self.process.stop(timeout=timeout or 10.0)
        self._started = False

    def __getattr__(self, item):
        # decode pools are detected via hasattr(server, "generate")
        # (router probe kwargs); surface it only once the handshake
        # told us the peer is a decode server
        if item == "generate" and self.__dict__.get("_kind") == "decode":
            return self._generate
        raise AttributeError(item)

    def _generate(self, prompt, max_new_tokens=None, deadline_ms=None):
        handle = self.submit(prompt, deadline_ms=deadline_ms,
                             max_new_tokens=max_new_tokens)
        return handle.result()
