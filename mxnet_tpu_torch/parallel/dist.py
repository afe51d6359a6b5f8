"""Distributed runtime: the process group and its collectives (ref:
``mxnet_tpu/parallel/dist.py``; 3rdparty/ps-lite's Postoffice and
src/kvstore/kvstore_dist.h).

The process group is ``torch.distributed``'s.  :func:`init` reads the
env protocol that ``tools/launch.py`` and this package's launcher
(``python -m mxnet_tpu_torch.tools.launch``) export:

- ``MXTPU_COORDINATOR`` (``host:port``), or ``DMLC_PS_ROOT_URI`` with
  ``DMLC_PS_ROOT_PORT``: the rendezvous address (``tcp://host:port``,
  where rank 0 listens);
- ``MXTPU_NUM_WORKER`` / ``DMLC_NUM_WORKER``: the world size;
- ``MXTPU_WORKER_ID`` / ``DMLC_WORKER_ID``: this process's rank.

Without a coordinator :func:`init` does nothing, as in the JAX package:
:func:`rank` is 0, :func:`num_workers` 1 and :func:`allreduce` returns
its input, so ``kvstore('dist_sync')`` runs in one process.

The backend is chosen by one rule, at :func:`init`, before any
collective, and logged: ``nccl`` where the node has a GPU for every rank
(``torch.cuda.device_count() >= world size``; rank ``r`` then uses
``cuda:r``), else ``gloo`` (the CPU, and one card shared by several
ranks, which NCCL refuses).  Under ``gloo`` a CUDA tensor is copied to
the host for the collective and back; under ``nccl`` a CPU tensor to the
rank's card and back.  A collective that fails raises; it never retries
on another backend.

``MXTPU_DIST_TIMEOUT`` (seconds; ``MXTPU_BARRIER_TIMEOUT_S`` is the older
spelling; 0, the default, waits for ever) is the process group's timeout,
and each collective's work is waited on with it.  A timeout or a
transport error that a dead peer causes raises :class:`MXNetError` with
the peer-death message.

Elastic resizing (``reinit``, ``shrink``, ``LeaseDir``) comes with slice
7, part 3, and the world mesh with part 2; they raise naming it.
"""
from __future__ import annotations

import datetime
import logging
import os

import torch

from ..base import MXNetError, getenv

_log = logging.getLogger("mxnet_tpu_torch.parallel.dist")

_initialized = False
_backend = None


def _later(what, part):
    return MXNetError(f"parallel.dist: {what} is not ported yet; it comes "
                      f"with part {part} of the distributed slice (slice 7, "
                      f"part {part}; ROADMAP.md queue 1)")


def _collective_timeout():
    """The bounded-failure-detector window, seconds; 0 = wait forever.

    ``MXTPU_DIST_TIMEOUT`` is the knob; the older
    ``MXTPU_BARRIER_TIMEOUT_S`` spelling is read when it is unset."""
    t = getenv("DIST_TIMEOUT", None, float)
    if t is None:
        t = getenv("BARRIER_TIMEOUT_S", 0.0, float)
    return t


def _timedelta():
    t = _collective_timeout()
    return datetime.timedelta(seconds=t) if t else None


def _bounded(start, what):
    """Start a collective (``start()`` returns its async work), wait for
    it with the collective timeout and turn a timeout or a transport
    error into the peer-death :class:`MXNetError`."""
    timeout = _timedelta()
    try:
        work = start()
        done = work.wait() if timeout is None else work.wait(timeout)
    except Exception as e:  # noqa: BLE001 - re-raised below
        text = str(e).lower()
        if "timed out" in text or "timeout" in text:
            raise MXNetError(_peer_death_msg(
                f"{what} did not complete within MXTPU_DIST_TIMEOUT="
                f"{_collective_timeout():g}s")) from e
        _raise_if_peer_death(e, what)
        raise
    if done is False:
        raise MXNetError(_peer_death_msg(
            f"{what} did not complete within MXTPU_DIST_TIMEOUT="
            f"{_collective_timeout():g}s"))


# transport-level shapes a dead peer produces (Gloo closes the socket at
# once; NCCL's watchdog reports a failed communicator) — converted to the
# same diagnosable error as a timeout so callers have ONE failure surface
_PEER_DEATH_SIGNATURES = (
    "connection closed by peer", "connection reset", "broken pipe",
    "heartbeat timeout", "gloo", "nccl error", "socket closed",
    "peer closed",
)


def _peer_death_msg(prefix):
    return (
        f"{prefix} (rank {rank()} of {num_workers()} workers): a peer "
        "process is likely dead or partitioned. Check the other workers' "
        "logs. Restart the job, and "
        "mxnet_tpu_torch.checkpoint.CheckpointManager(ckpt_dir)"
        ".restore(params=net, trainer=trainer) picks the newest complete "
        "snapshot (an automatic supervisor comes with the resilience "
        "tier, slice 8).")


def _raise_if_peer_death(e, what):
    text = str(e).lower()
    if any(sig in text for sig in _PEER_DEATH_SIGNATURES):
        first = str(e).splitlines()[0][:200] if str(e) else type(e).__name__
        raise MXNetError(_peer_death_msg(
            f"{what} failed with a transport error [{first}]")) from e


def choose_backend(world_size):
    """The backend rule: ``nccl`` where every rank has a card of its own,
    else ``gloo``."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n >= int(world_size) and torch.distributed.is_nccl_available():
        return "nccl"
    return "gloo"


def init(coordinator_address=None, num_processes=None, process_id=None):
    """Join the process group (ref: Postoffice::Start; the
    DMLC_PS_ROOT_URI env protocol of ``tools/launch.py``).  A no-op
    without a coordinator, and after the first call."""
    global _initialized, _backend
    if _initialized:
        return
    # getenv gives the MXTPU_/MXNET_ spellings; the raw DMLC_* reads are
    # the launcher's wire protocol
    coordinator_address = (coordinator_address
                           or getenv("COORDINATOR")
                           or os.environ.get("DMLC_PS_ROOT_URI"))
    if coordinator_address and num_processes is None:
        num_processes = getenv(
            "NUM_WORKER", int(os.environ.get("DMLC_NUM_WORKER", "1")), int)
        process_id = getenv(
            "WORKER_ID", int(os.environ.get("DMLC_WORKER_ID", "0")), int)
    if coordinator_address:
        port = os.environ.get("DMLC_PS_ROOT_PORT")
        if port and ":" not in coordinator_address:
            coordinator_address = f"{coordinator_address}:{port}"
        backend = choose_backend(num_processes)
        _log.info("parallel.dist: rank %d of %d joins tcp://%s with backend "
                  "%s (%d CUDA device(s) visible)", process_id,
                  num_processes, coordinator_address, backend,
                  torch.cuda.device_count() if torch.cuda.is_available()
                  else 0)
        if backend == "nccl":
            torch.cuda.set_device(int(process_id))
        kwargs = {}
        if _timedelta() is not None:
            kwargs["timeout"] = _timedelta()
        torch.distributed.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes), rank=int(process_id), **kwargs)
        _backend = backend
    _initialized = True


def backend():
    """The process group's backend (``"nccl"`` or ``"gloo"``), or None in
    one process."""
    return _backend if torch.distributed.is_initialized() else None


def shutdown():
    """Leave the process group (a no-op in one process)."""
    global _initialized, _backend
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    _initialized, _backend = False, None


def is_multiprocess():
    return num_workers() > 1


def rank():
    if torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return 0


def num_workers():
    if torch.distributed.is_initialized():
        return torch.distributed.get_world_size()
    return 1


def _comm_device():
    """Where the backend's collectives run: the rank's card under
    ``nccl``, the host under ``gloo``."""
    if _backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def allreduce(value):
    """The sum of ``value`` (an NDArray or a tensor) over every process, a
    new array on ``value``'s context (ref: KVStoreDist push+pull).  One
    process: ``value`` itself."""
    from ..ndarray.ndarray import NDArray

    if not is_multiprocess():
        return value
    t = value.data if isinstance(value, NDArray) else value
    dev = _comm_device()
    buf = t.detach().to(dev, copy=True)
    _bounded(lambda: torch.distributed.all_reduce(
        buf, op=torch.distributed.ReduceOp.SUM, async_op=True),
        f"dist_sync all-reduce of {tuple(t.shape)} {t.dtype}")
    out = buf.to(t.device)
    if isinstance(value, NDArray):
        return NDArray(out, value._ctx)
    return out


def _allgather(t):
    """Every rank's ``t`` (same shape), stacked in rank order."""
    dev = _comm_device()
    t = t.to(dev)
    outs = [torch.empty_like(t) for _ in range(num_workers())]
    _bounded(lambda: torch.distributed.all_gather(outs, t, async_op=True),
             f"allgather of {tuple(t.shape)}")
    return torch.stack(outs).cpu()


def allgather_bytes(data):
    """Every rank's byte payload, in rank order: the lengths first, so
    every rank pads to the same longest, then the padded payloads.  One
    process: ``[data]``."""
    data = bytes(data)
    if not is_multiprocess():
        return [data]
    lens = _allgather(torch.tensor([len(data)], dtype=torch.int64))
    max_len = max(int(lens.max()), 1)
    row = torch.zeros(max_len, dtype=torch.uint8)
    if data:
        row[:len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    rows = _allgather(row)
    return [bytes(rows[i, :int(lens[i, 0])].numpy())
            for i in range(rows.shape[0])]


def barrier(name="kvstore"):
    """Wait for every process (ref: Postoffice barrier): a one-element
    all-reduce, bounded by the collective timeout."""
    if not is_multiprocess():
        return
    buf = torch.zeros(1, device=_comm_device())
    _bounded(lambda: torch.distributed.all_reduce(buf, async_op=True),
             f"barrier({name!r})")


def world_mesh():
    """The one-device-per-process mesh of the JAX package's traced step."""
    raise _later("world_mesh (a mesh over the processes)", 2)


def reinit(num_processes=None, process_id=None):
    raise _later("reinit (re-forming the process group after a peer "
                 "died)", 3)


def shrink(dead_ranks=None, *, world=None, timeout=None,
           rendezvous_dir=None, round_index=0):
    raise _later("shrink (elastic resizing of the world)", 3)


def _shrink_multiprocess(*args, **kwargs):
    raise _later("elastic resizing across processes", 3)


class LeaseDir:
    """The elastic rendezvous's lease directory (ref: dist.py LeaseDir)."""

    def __init__(self, *args, **kwargs):
        raise _later("LeaseDir (the elastic rendezvous)", 3)
