"""Asynchronous, atomic, resumable training checkpoints (ref:
``mxnet_tpu/checkpoint/manager.py``).

A checkpoint is a step-tagged directory, laid out as the JAX package lays
it out, so either package restores the other's::

    <dir>/ckpt-00000042/
        MANIFEST.json            format_version, step, epoch, files, extra,
                                 num_processes
        params-shard<r>.params   utils.serialization container, a process
        trainer-shard<r>.states  versioned Trainer states pickle
        rng-shard<r>.json        mx.random.get_state() snapshot

Commit protocol: every process writes its files into ``ckpt-<step>.tmp``
and fsyncs them; after a barrier (``parallel.dist``) process 0 writes the
manifest and renames the directory onto its final name (the commit
point) and fsyncs the parent.  ``latest()`` needs both the final name and
the manifest, so a save killed at any point is never resumable state; its
``*.tmp`` leftovers are collected by the next commit.

Saves are asynchronous, and they copy.  The port updates weights,
optimizer states and moving statistics in place (a captured step writes
them at every replay), so the JAX package's snapshot of buffer
references would be overwritten by the next step and commit a torn
checkpoint.  ``save()`` instead copies every parameter and state on the
current stream into device buffers the manager keeps between saves
(``snapshot.Snapshot``) and returns; the manager's writer thread copies them
to pinned host memory on a side stream, serialises and commits.  At most
one save is in flight, and its errors surface at
``wait_until_finished()``, which also runs before the next save.  In a
multi-process job every rank saves synchronously, on its own thread: the
commit's barriers are collectives, which must not interleave with the
training's.

A Trainer whose states live in its kvstore's updater (``update_on_kvstore``)
is saved and restored like any other: its blob's ``"kvstore"`` entry is
the updater's pickled states (``gluon.trainer.states_file_blob``).  A
ZeRO-sharded Trainer's blob holds the shards of the ranks this process
has; a restore gathers the other ranks' from their files.

A Trainer on a mesh (``Trainer(mesh_shape=...)``) is checkpointed as the
JAX package checkpoints its global arrays: the full parameters and states
(every rank gathers them, collectives in the same order), written once,
by rank 0, into the files of one process; the manifest records
``num_processes`` 1 and the ``mesh_shape``.  Every rank writes its own
``rng-shard<r>.json``: its dropout stream (its data coordinate), which a
restore on a mesh gives back to the rank of the same data coordinate.  Any
job restores it, on a mesh of another shape (every rank reads those files;
the next step slices them), in one process without a mesh (stream 0), or
in the JAX package.

A checkpoint of another world size is resharded on restore (``reshard``):
each rank reads the parameter and RNG files of :func:`reshard.source_rank`
and ZeRO shards are gathered and sliced for this trainer;
``strict_topology=True`` refuses it instead.

An input pipeline (``pipeline=``, a ``pipeline.Pipeline``) is saved as
the JAX package saves it: its state, captured at the call (in-flight
batches drained to host arrays), pickled into ``pipeline-shard<r>.state``
a rank.  It holds only host trees (numpy arrays, ``RandomState`` tuples,
Python lists), so a directory with a pipeline moves between the packages
both ways.  A restore sets the RNG before the pipeline; across world
sizes it merges the saved ranks' states (``reshard.merge_pipeline_states``).
"""
from __future__ import annotations

import concurrent.futures
import glob
import json
import logging
import os
import pickle
import re
import shutil
import signal
import threading
import time

import torch

from .. import engine, profiler
from .. import random as _random
from ..base import MXNetError
from ..parallel import dist
from . import atomic
from . import reshard as _reshard
from .snapshot import Snapshot, host_leaves, writer
from ..gluon.trainer import states_file_blob

MANIFEST = "MANIFEST.json"

_log = logging.getLogger("mxnet_tpu_torch.checkpoint")


def _barrier(name):
    if dist.is_multiprocess():
        dist.barrier(name)


def _is_corrupt_failure(e):
    """Does this restore failure mean the checkpoint PAYLOAD is damaged
    (fall back to an older step), as opposed to a caller error like a
    shape mismatch (raise)?  Raw deserialization errors -- pickle, EOF,
    json -- are damage by definition; MXNetErrors count only when they
    carry the serialization tier's corrupt/truncated wording.  OSError
    does not count: a transient I/O failure on an intact newest step must
    surface, not forfeit its progress to an older step."""
    if isinstance(e, MXNetError):
        text = str(e).lower()
        return "corrupt" in text or "truncated" in text
    return isinstance(e, (pickle.UnpicklingError, EOFError, ValueError))


def _is_fallback_skippable(e):
    """During the auto-resume fallback scan, a step is also skippable
    when it lacks a component the caller asked for (saved without
    params= or trainer=)."""
    return _is_corrupt_failure(e) or (
        isinstance(e, MXNetError) and "saved without" in str(e))


def _first_line(e):
    """First line of an exception message, safe for empty messages."""
    lines = str(e).splitlines()
    return lines[0][:200] if lines else type(e).__name__


def _param_dict(params):
    """Normalize a params target into name -> tensor."""
    from ..ndarray.ndarray import NDArray

    if params is None:
        return None
    if hasattr(params, "_collect_params_with_prefix"):  # gluon Block
        return {k: v.data()
                for k, v in params._collect_params_with_prefix().items()
                if v._data is not None}
    if isinstance(params, dict):
        out = {}
        for k, v in params.items():
            if hasattr(v, "_finish_deferred_init"):  # Parameter
                v = v.data()
            out[k] = v.data if isinstance(v, NDArray) else v
        return out
    raise MXNetError(
        f"cannot checkpoint params of type {type(params).__name__}: "
        "expected a gluon Block or a name->NDArray dict")


def _cpu_copies(tree):
    """``tree`` with CPU copies of its tensors (and NDArrays' tensors)."""
    from ..ndarray.ndarray import NDArray

    if isinstance(tree, NDArray):
        tree = tree.data
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _cpu_copies(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu_copies(v) for v in tree)
    return tree


class _Ready:
    """A snapshot already on the host (``Snapshot.take``'s interface)."""

    def __init__(self, tree):
        self._tree = tree

    def fetch(self):
        return self._tree


def _mesh_shape_of(trainer):
    """The mesh of a multi-process save of a Trainer on a mesh, whose
    values are full arrays every rank holds alike, as a spec string; else
    None (the world step's per-rank ZeRO shards included)."""
    shape = getattr(trainer, "_mesh_shape", None)
    if shape is None or not dist.is_multiprocess() or trainer._zero_states:
        return None
    from ..parallel.spmd.mesh import format_mesh_shape

    return format_mesh_shape(shape)


def _saved_rng(d, src, manifest, trainer):
    """The generator state this rank restores from checkpoint directory
    ``d``: saved rank ``src``'s, or in a mesh checkpoint (where every rank
    saved its own) the one of this rank's dropout stream -- its data
    coordinate on a mesh Trainer, whose streams are set first
    (``SpmdStepCompiler.start_streams``), else stream 0.  None where no
    file holds it (that stream starts afresh)."""
    if not manifest.get("mesh_shape"):
        paths = [os.path.join(d, f"rng-shard{src}.json")]
        stream = None
    else:
        paths = sorted(glob.glob(os.path.join(d, "rng-shard*.json")),
                       key=lambda p: int(re.findall(r"\d+", p)[-1]))
        stream = 0
        if trainer is not None and trainer._mesh_shape is not None \
                and trainer._whole_step:
            comp = trainer._compiler()
            comp.start_streams()
            stream = comp.mesh.data_index if comp.mesh.size > 1 else 0
    for path in paths:
        if os.path.isfile(path):
            with open(path) as f:
                state = json.load(f)
            if stream is None or int(state.get("stream", 0)) == stream:
                return state
    if stream is not None:
        _log.warning("%s: no saved generators of dropout stream %d; it "
                     "starts afresh", d, stream)
    return None


class CheckpointManager:
    """Atomic, async, resumable checkpoints (see module docstring).

    Usage::

        mgr = checkpoint.CheckpointManager("/ckpts", keep_n=3)
        meta = mgr.restore(params=net, trainer=trainer) \
            if mgr.latest() is not None else None   # auto-resume
        for step in range(start, n_steps):
            ...train...
            if step % 100 == 0:
                mgr.save(step, params=net, trainer=trainer)
        mgr.wait_until_finished()

    ``ctx`` is accepted for the JAX package's signature: the copies of a
    save run on each tensor's own device.
    """

    FORMAT_VERSION = 1

    def __init__(self, directory, keep_n=5, prefix="ckpt", ctx=None):
        self.directory = os.path.abspath(os.fspath(directory))
        self.keep_n = int(keep_n) if keep_n else 0
        self.prefix = prefix
        self._step_re = re.compile(rf"^{re.escape(prefix)}-(\d+)$")
        self._tmp_re = re.compile(rf"^{re.escape(prefix)}-(\d+)\.tmp$")
        os.makedirs(self.directory, exist_ok=True)
        if dist.rank() == 0:  # the ranks share the directory: one healer
            self._recover()
        # no rank scans (latest, restore) before the heal is done, else
        # ranks of one job could resume different steps
        _barrier("checkpoint-init")
        self._snapshot = Snapshot()
        self._writer = writer()
        self._pending = None  # (step, future) of the in-flight save
        self._hook_signum = None
        self._prev_handler = None
        self._state_fn = None

    # -- discovery ----------------------------------------------------------

    def steps(self):
        """Committed checkpoint steps, ascending.  A directory without a
        manifest is NOT committed."""
        out = []
        for name in os.listdir(self.directory):
            m = self._step_re.match(name)
            if m and os.path.isfile(
                    os.path.join(self.directory, name, MANIFEST)):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest(self):
        """Newest committed step, or None when no checkpoint exists."""
        s = self.steps()
        return s[-1] if s else None

    def _dir_for(self, step):
        return os.path.join(self.directory, f"{self.prefix}-{step:08d}")

    # -- save ---------------------------------------------------------------

    def save(self, step, params=None, trainer=None, pipeline=None,
             epoch=None, extra=None, sync=False):
        """Checkpoint `step` asynchronously; returns the commit future.

        params : gluon Block or name->NDArray dict (optional)
        trainer : gluon.Trainer (optional) — optimizer states + counters
        pipeline : pipeline.Pipeline (optional) — every stage's iterator
            state (source position, shuffle ring and RNG, in-flight
            batches), captured at the call, so the resumed job replays the
            exact remaining batch sequence
        extra : JSON-serializable user metadata stored in the manifest
        sync : block until committed

        The values are those at the call: every parameter and state is
        copied on the current stream before this returns, so a step
        queued after it (a captured step writes in place) does not reach
        the checkpoint.  Blocks first on any still-draining previous save
        (the error surfacing point) — at most one checkpoint is in
        flight.
        """
        # A SIGTERM landing between the wait_until_finished below and
        # the _pending registration would re-enter save() from the
        # preemption handler and start a second commit racing this one;
        # defer delivery across the critical section.
        deferred = []
        prev_sig = None
        if (self._hook_signum is not None
                and threading.current_thread() is threading.main_thread()):
            prev_sig = signal.getsignal(self._hook_signum)
            signal.signal(self._hook_signum,
                          lambda s, f: deferred.append(s))
        try:
            self.wait_until_finished()
            step = int(step)
            mesh_shape = _mesh_shape_of(trainer)
            tree = {"params": _param_dict(params),
                    "trainer": (None if trainer is None
                                else trainer._states_blob()),
                    "rng": _random.get_state()}
            meta = {"format_version": self.FORMAT_VERSION,
                    "step": step, "epoch": epoch, "extra": extra,
                    "num_processes": dist.num_workers()}
            # host trees by construction: in-flight batches drain to numpy
            pipe_state = None if pipeline is None else pipeline.state_dict()
            if mesh_shape is None:
                with profiler.op_scope("checkpoint.save.capture",
                                       cat="checkpoint"):
                    pending = self._snapshot.take(tree)
            else:
                # full arrays, gathered on every rank: rank 0 writes them;
                # every rank writes its own generators (its dropout
                # stream)
                pending = _Ready(_cpu_copies(tree) if dist.rank() == 0
                                 else {"params": None, "trainer": None,
                                       "rng": tree["rng"]})
                meta.update(num_processes=1, mesh_shape=mesh_shape)
            if dist.is_multiprocess():
                # the commit's barriers are collectives: run them here,
                # in order with the training's, not on the writer thread
                fut = concurrent.futures.Future()
                try:
                    fut.set_result(self._write_commit(pending, step, meta,
                                                      pipe_state))
                except Exception as e:  # noqa: BLE001 - raised below
                    fut.set_exception(e)
            else:
                fut = self._writer.submit(self._write_commit, pending, step,
                                          meta, pipe_state)
            self._pending = (step, fut)
            if sync or dist.is_multiprocess():
                self.wait_until_finished()
        finally:
            if prev_sig is not None:
                signal.signal(self._hook_signum, prev_sig)
                if deferred and callable(prev_sig):
                    prev_sig(deferred[0], None)
        return fut

    def wait_until_finished(self):
        """Barrier for the in-flight save; re-raises its error if the
        async copy, serialization or commit failed."""
        pending = self._pending
        if pending is None:
            return
        try:
            pending[1].result()
        finally:
            if self._pending is pending:
                self._pending = None

    def _write_commit(self, pending, step, meta, pipe_state=None):
        with profiler.op_scope("checkpoint.save.readback", cat="checkpoint"):
            engine.fault_point("engine.d2h")
            state = pending.fetch()
        with profiler.op_scope("checkpoint.save.commit", cat="checkpoint"):
            return self._commit(state, step, meta, pipe_state)

    def _commit(self, state, step, meta, pipe_state):
        rank = dist.rank()
        tmp = self._dir_for(step) + ".tmp"
        final = self._dir_for(step)
        # a crashed earlier save at this step may have left stale files:
        # rank 0 clears them, and a barrier orders that before any write
        if rank == 0 and os.path.isdir(tmp):
            shutil.rmtree(tmp)
        _barrier("checkpoint-clear")
        os.makedirs(tmp, exist_ok=True)
        if state["params"] is not None:
            from ..utils import serialization

            p = os.path.join(tmp, f"params-shard{rank}.params")
            serialization.save_ndarrays(p, state["params"])
            atomic.fsync_file(p)
        if state["trainer"] is not None:
            p = os.path.join(tmp, f"trainer-shard{rank}.states")
            with open(p, "wb") as f:
                # protocol 5 writes the arrays from their own memory
                pickle.dump(states_file_blob(
                    host_leaves(state["trainer"], copy=False)), f,
                    protocol=5)
            atomic.fsync_file(p)
        if pipe_state is not None:
            p = os.path.join(tmp, f"pipeline-shard{rank}.state")
            with open(p, "wb") as f:
                pickle.dump(pipe_state, f)
            atomic.fsync_file(p)
        atomic.write_json(os.path.join(tmp, f"rng-shard{rank}.json"),
                          state["rng"])
        # chaos site: a 'truncate' fault here damages a shard after the
        # writes and before the manifest, so a corrupt checkpoint commits
        engine.fault_point("checkpoint.commit", dir=tmp, step=step)
        atomic.fsync_dir(tmp)
        _barrier("checkpoint-save")
        if rank == 0:
            meta["files"] = sorted(os.listdir(tmp))
            atomic.write_json(os.path.join(tmp, MANIFEST), meta)
            old = None
            if os.path.isdir(final):
                # re-save of the same step: park the committed copy aside
                # so a kill in this window loses nothing (_recover renames
                # it back if the commit never happened)
                old = final + ".old"
                if os.path.isdir(old):
                    shutil.rmtree(old)
                os.rename(final, old)
            os.rename(tmp, final)  # the commit point
            atomic.fsync_dir(self.directory)
            if old is not None:
                shutil.rmtree(old, ignore_errors=True)
        _barrier("checkpoint-commit")
        if rank == 0:
            self._gc(step)
        return final

    def _recover(self):
        """Heal a kill inside a re-save's two-rename commit window: a
        parked ``*.old`` whose final name is gone is the still-committed
        copy — rename it back; one whose final exists is garbage."""
        for name in os.listdir(self.directory):
            if not (name.endswith(".old")
                    and self._step_re.match(name[:-len(".old")])):
                continue
            src = os.path.join(self.directory, name)
            base = src[:-len(".old")]
            try:
                if os.path.isdir(base):
                    shutil.rmtree(src, ignore_errors=True)
                else:
                    os.rename(src, base)
            except OSError:
                pass

    def _gc(self, current_step):
        """Retention: drop committed checkpoints beyond keep_n and temp
        leftovers of older interrupted saves."""
        if self.keep_n:
            for s in self.steps()[:-self.keep_n]:
                shutil.rmtree(self._dir_for(s), ignore_errors=True)
        for name in os.listdir(self.directory):
            m = self._tmp_re.match(name)
            if m and int(m.group(1)) < current_step:
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def restore(self, step=None, params=None, trainer=None, pipeline=None,
                restore_rng=True, strict_topology=False):
        """Load checkpoint `step` (default: ``latest()``) in place.

        Parameters load into the Block or dict, optimizer states and
        update counters into the Trainer, and the random generators are
        set to their saved states, all by copying into the tensors and
        generators that exist, so a captured step keeps replaying on
        them.  Iterator state loads into a freshly built, identically
        composed Pipeline, which then replays the exact remaining batch
        sequence; the RNG is restored BEFORE the pipeline, so sources that
        replay by drawing from it draw the saved epoch's order.  Returns the manifest metadata ``{"step", "epoch",
        "extra", "params"}`` — "params" is the loaded name->NDArray dict
        only when no target was given.

        With ``step=None`` a corrupt or truncated newest step does NOT
        raise: it is logged and the previous retained step is restored
        instead, falling back step by step; only when no retained step
        loads does restore raise, listing every step's failure.  An
        explicit ``step=`` keeps strict semantics.
        """
        self.wait_until_finished()
        if step is not None:
            return self._restore_step(int(step), params, trainer, pipeline,
                                      restore_rng, strict_topology)
        steps = self.steps()
        if not steps:
            raise MXNetError(
                f"no committed checkpoint under {self.directory}: nothing "
                "to resume (an interrupted save's *.tmp directory does "
                "not count)")
        failures = []
        for s in reversed(steps):
            try:
                meta = self._restore_step(s, params, trainer, pipeline,
                                          restore_rng, strict_topology)
            except Exception as e:  # noqa: BLE001 — filtered below
                if not _is_fallback_skippable(e):
                    if failures:
                        raise MXNetError(
                            f"restore failed at step {s} while falling "
                            f"back past corrupt step(s) "
                            f"{[f[0] for f in failures]}: "
                            f"{_first_line(e)} — the restore target may "
                            "be PARTIALLY mutated by the failed "
                            "attempt(s); restore an explicit step= or "
                            "rebuild the targets before retrying") from e
                    raise
                failures.append((s, e))
                _log.error(
                    "checkpoint step %d under %s is corrupt, truncated "
                    "or incomplete (%s); falling back to the previous "
                    "retained step", s, self.directory, _first_line(e))
                continue
            if failures:
                _log.error(
                    "restored step %d after %d newer corrupt step(s): %s "
                    "— training resumes from older state; investigate "
                    "the storage layer", s, len(failures),
                    [f[0] for f in failures])
                from ..resilience import stats as _rstats

                _rstats.add("fallback_restores")   # the resilience section
            return meta
        raise MXNetError(
            f"no retained checkpoint under {self.directory} is loadable "
            "— every step failed: "
            + "; ".join(f"step {s}: {_first_line(e)[:150]}"
                        for s, e in failures))

    def _restore_step(self, step, params, trainer, pipeline, restore_rng,
                      strict_topology=False):
        d = self._dir_for(int(step))
        mpath = os.path.join(d, MANIFEST)
        if not os.path.isfile(mpath):
            raise MXNetError(
                f"checkpoint step {step} under {self.directory} is "
                "missing or uncommitted")
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except ValueError as e:
            raise MXNetError(
                f"{mpath}: corrupt checkpoint manifest ({e}); this "
                "should be impossible for a committed checkpoint — "
                "restore an earlier step") from None
        ver = manifest.get("format_version", 0)
        if ver > self.FORMAT_VERSION:
            raise MXNetError(
                f"{mpath}: checkpoint format v{ver} was written by a "
                f"newer mxnet_tpu (this build reads <= "
                f"v{self.FORMAT_VERSION}); upgrade to restore it")
        saved_procs = int(manifest.get("num_processes", 1))
        procs = dist.num_workers()
        # a mesh checkpoint holds full arrays: every rank reads them
        resharding = saved_procs != procs and not manifest.get("mesh_shape")
        if resharding and strict_topology:
            raise MXNetError(
                f"{mpath}: world-size mismatch — checkpoint was saved "
                f"by a {saved_procs}-process job but this job runs "
                f"{procs} process(es), and strict_topology=True "
                "forbids elastic resharding. Drop strict_topology to "
                "repartition the checkpoint onto this topology "
                "(rank-replicated param/RNG shards remap, ZeRO-1 "
                "optimizer shards gather and re-slice, per-rank "
                "pipeline cursors merge under the rank-symmetric "
                "shard() contract), or restore with the original world "
                "size.")
        rank = dist.rank()
        src = _reshard.source_rank(rank, saved_procs) if resharding \
            or manifest.get("mesh_shape") else rank
        if resharding:
            # chaos site: a 'raise' fault makes the reshard itself fail
            engine.fault_point("checkpoint.reshard", kind="topology",
                               saved_world=saved_procs, world=procs)
            _log.warning(
                "elastic restore: repartitioning checkpoint step %s "
                "saved at world %d onto world %d (rank %d reads saved "
                "shard %d; pass strict_topology=True to forbid this)",
                step, saved_procs, procs, rank, src)
        with profiler.op_scope("checkpoint.restore", cat="checkpoint"):
            loaded = self._restore_params(d, src, params)
            self._restore_trainer(d, src, trainer)
            if restore_rng:
                state = _saved_rng(d, src, manifest, trainer)
                if state is not None:
                    _random.set_state(state)
            self._restore_pipeline(
                d, src, pipeline,
                saved_world=saved_procs if resharding else None)
        return {"step": int(manifest["step"]),
                "epoch": manifest.get("epoch"),
                "extra": manifest.get("extra"),
                "params": loaded}

    def _restore_params(self, d, rank, params):
        from ..ndarray.ndarray import NDArray
        from ..utils import serialization

        pfile = os.path.join(d, f"params-shard{rank}.params")
        if not os.path.isfile(pfile):
            if params is not None:
                raise MXNetError(
                    f"{d}: no parameter shard for process {rank} "
                    f"(params-shard{rank}.params) — this step was saved "
                    "without params=; pass step= an entry of steps() "
                    "that has them")
            return None
        if params is not None and hasattr(params,
                                          "_collect_params_with_prefix"):
            # Block target: the same validated dict path
            params = params._collect_params_with_prefix()
        loaded = serialization.load_ndarrays(pfile)
        if params is None:
            return loaded
        # validate EVERYTHING first, then apply: a caller catching a
        # mismatch error is never left half-restored
        extra = set(loaded) - set(params)
        if extra:
            raise MXNetError(
                f"{pfile}: checkpoint has parameters with no "
                f"counterpart in the restore target: {sorted(extra)}")
        missing = set(params) - set(loaded)
        if missing:
            raise MXNetError(
                f"{pfile}: restore target has parameters missing from "
                f"the checkpoint: {sorted(missing)}")
        for name, arr in loaded.items():
            shape = getattr(params[name], "shape", None)
            if shape is not None and (
                    len(shape) != len(arr.shape)
                    or any(s and s != a
                           for s, a in zip(shape, arr.shape))):
                raise MXNetError(
                    f"{pfile}: shape mismatch for {name!r}: checkpoint "
                    f"{tuple(arr.shape)} vs target {tuple(shape)}")
        for name, arr in loaded.items():
            tgt = params[name]
            if hasattr(tgt, "set_data"):  # Parameter: copies in place
                tgt.set_data(arr)
            else:  # NDArray or tensor: copied in place too
                dst = tgt.data if isinstance(tgt, NDArray) else tgt
                with torch.no_grad():
                    dst.copy_(arr.data.to(dst.dtype))
        return None

    def _restore_pipeline(self, d, rank, pipeline, saved_world=None):
        if pipeline is None:
            return
        if saved_world is not None:
            # a reshard: every saved rank's state, merged under the
            # rank-symmetric shard() contract (an agreement check,
            # reshard.merge_pipeline_states), loads into this rank's
            # rebuilt pipeline
            blobs = []
            for r in range(saved_world):
                pfile = os.path.join(d, f"pipeline-shard{r}.state")
                if not os.path.isfile(pfile):
                    raise MXNetError(
                        f"{d}: cannot reshard the input pipeline — "
                        f"saved rank {r}'s pipeline-shard{r}.state is "
                        f"missing (saved world {saved_world}); was "
                        "this step saved without pipeline= on every "
                        "rank?")
                with open(pfile, "rb") as f:
                    blobs.append(pickle.load(f))
            pipeline.load_state_dict(
                _reshard.merge_pipeline_states(blobs, where=d))
            return
        pfile = os.path.join(d, f"pipeline-shard{rank}.state")
        if not os.path.isfile(pfile):
            raise MXNetError(
                f"{d}: checkpoint has no input-pipeline state for "
                f"process {rank} (was it saved without pipeline=?)")
        with open(pfile, "rb") as f:
            blob = pickle.load(f)
        pipeline.load_state_dict(blob)

    def _restore_trainer(self, d, rank, trainer):
        tfile = os.path.join(d, f"trainer-shard{rank}.states")
        if trainer is None:
            return
        if not os.path.isfile(tfile):
            raise MXNetError(
                f"{d}: checkpoint has no trainer states for process "
                f"{rank} (was it saved without trainer=?)")
        with open(tfile, "rb") as f:
            blob = pickle.load(f)
        self._merge_zero_shards(d, blob, own=f"trainer-shard{rank}.states")
        blob = self._reshard_zero_for(trainer, blob, tfile)
        saved_mesh = blob.get("mesh_shape") if isinstance(blob, dict) \
            else None
        if saved_mesh or getattr(trainer, "_mesh_shape", None):
            # the mesh leg of a reshard: full arrays, no data motion; a
            # chaos site for plans (ref: mxnet_tpu/checkpoint/manager.py:716)
            engine.fault_point("checkpoint.reshard", kind="mesh",
                               saved_mesh=saved_mesh or "", world=0)
        trainer.load_states_dict(blob, source=tfile)

    @staticmethod
    def _reshard_zero_for(trainer, blob, tfile):
        """ZeRO's leg of a reshard: where the snapshot's world differs from
        the number of contexts a sharded trainer runs on, the blob with its
        shards re-sliced for that trainer on the host
        (``reshard.reshard_states_blob``), so ``load_states_dict`` adopts
        them; else the blob as it is (an unsharded trainer, or one rank a
        process, gathers them into per-parameter states)."""
        zero = blob.get("zero") if isinstance(blob, dict) else None
        if not zero or not getattr(trainer, "_zero_shard", False):
            return blob
        world = len(trainer._param_contexts())
        if world <= 1 or int(zero["world"]) == world:
            return blob
        t0 = time.perf_counter()
        engine.fault_point("checkpoint.reshard", kind="zero",
                           saved_world=int(zero["world"]), world=world)
        _log.warning("elastic restore: re-slicing ZeRO-1 optimizer shards "
                     "from world %d onto world %d (%s)", int(zero["world"]),
                     world, tfile)
        blob = _reshard.reshard_states_blob(blob, world)
        _reshard._book_reshard_ms(time.perf_counter() - t0)
        return blob

    @staticmethod
    def _merge_zero_shards(d, blob, own=None):
        """Gather ZeRO-1 shards on restore: a multi-process sharded save
        leaves each rank's shards in its own ``trainer-shard<r>.states``;
        where this blob does not hold every rank's, the others are read
        from the sibling files."""
        zero = blob.get("zero") if isinstance(blob, dict) else None
        if not zero:
            return
        world = int(zero["world"])
        have = {int(r) for r in zero["shards"]}
        if have == set(range(world)):
            return
        rx = re.compile(r"^trainer-shard(\d+)\.states$")
        for name in sorted(os.listdir(d)):
            if have == set(range(world)):
                break
            m = rx.match(name)
            if m is None or name == own:
                continue
            with open(os.path.join(d, name), "rb") as f:
                peer = pickle.load(f)
            pz = peer.get("zero") if isinstance(peer, dict) else None
            if not pz:
                continue
            for r, chunks in pz["shards"].items():
                if int(r) not in have:
                    zero["shards"][r] = chunks
                    have.add(int(r))
        missing = set(range(world)) - have
        if missing:
            raise MXNetError(
                f"{d}: ZeRO-1 optimizer-state shards for rank(s) "
                f"{sorted(missing)} of {world} are missing — the "
                "sharded save did not complete on every rank; restore "
                "an earlier step")

    # -- preemption ---------------------------------------------------------

    def install_sigterm_hook(self, state_fn, signum=signal.SIGTERM):
        """Final synchronous save on SIGTERM (preemption notice).

        ``state_fn()`` returns the kwargs for ``save()`` — typically
        ``{"step": n, "params": net, "trainer": trainer}`` — or None to
        skip.  After the save the previous handler is chained (or the
        default disposition re-raised), so the process still terminates.
        Main-process/main-thread only, like any Python signal handler.
        """
        if self._hook_signum is not None:
            # re-install = swap the state provider; never re-chain (the
            # handler would chain to ITSELF and recurse on delivery)
            if signum != self._hook_signum:
                self.uninstall_sigterm_hook()
            else:
                self._state_fn = state_fn
                return

        self._state_fn = state_fn

        def _handler(sig, frame):
            try:
                kwargs = self._state_fn()
                if kwargs is not None:
                    kwargs.setdefault("sync", True)
                    self.save(**kwargs)
            finally:
                # post-mortem timeline next to the final checkpoint
                # (no-op unless the flight-recorder ring is armed); a
                # failure here must never skip the chaining below
                try:
                    from ..telemetry import flight as _flight

                    _flight.dump_if_enabled("sigterm",
                                            directory=self.directory)
                except Exception:  # noqa: BLE001 — advisory only
                    pass
                prev = self._prev_handler
                if callable(prev):
                    prev(sig, frame)
                elif prev is None or prev == signal.SIG_DFL:
                    # installed from C, or the default: re-raise the
                    # default disposition so the process still dies
                    signal.signal(sig, signal.SIG_DFL)
                    os.kill(os.getpid(), sig)

        self._prev_handler = signal.signal(signum, _handler)
        self._hook_signum = signum

    def uninstall_sigterm_hook(self):
        if self._hook_signum is None:
            return
        signal.signal(self._hook_signum,
                      self._prev_handler if self._prev_handler is not None
                      else signal.SIG_DFL)
        self._hook_signum = None
        self._prev_handler = None
        self._state_fn = None


def latest(directory, prefix="ckpt"):
    """Newest committed step under `directory`, or None — a read-only
    scan (unlike constructing a CheckpointManager, which heals
    interrupted re-saves), safe for monitors polling a live job."""
    if not os.path.isdir(directory):
        return None
    rx = re.compile(rf"^{re.escape(prefix)}-(\d+)$")
    steps = [int(m.group(1)) for name in os.listdir(directory)
             if (m := rx.match(name))
             and os.path.isfile(os.path.join(directory, name, MANIFEST))]
    return max(steps) if steps else None
