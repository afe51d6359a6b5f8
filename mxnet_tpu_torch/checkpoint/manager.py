"""Asynchronous, atomic, resumable training checkpoints (ref:
``mxnet_tpu/checkpoint/manager.py``, its single-process path).

A checkpoint is a step-tagged directory, laid out as the JAX package lays
it out, so either package restores the other's::

    <dir>/ckpt-00000042/
        MANIFEST.json            format_version, step, epoch, files, extra
        params-shard0.params     utils.serialization container
        trainer-shard0.states    versioned Trainer states pickle
        rng-shard0.json          mx.random.get_state() snapshot

Commit protocol: the files are written into ``ckpt-<step>.tmp`` and
fsync'd, then the manifest, then the directory is renamed onto its final
name (the commit point) and the parent fsync'd.  ``latest()`` needs both
the final name and the manifest, so a save killed at any point is never
resumable state; its ``*.tmp`` leftovers are collected by the next commit.

Saves are asynchronous, and they copy.  The port updates weights,
optimizer states and moving statistics in place (a captured step writes
them at every replay), so the JAX package's snapshot of buffer
references would be overwritten by the next step and commit a torn
checkpoint.  ``save()`` instead copies every parameter and state on the
current stream into device buffers the manager keeps between saves
(``snapshot.Snapshot``) and returns; the manager's writer thread copies them
to pinned host memory on a side stream, serialises and commits.  At most
one save is in flight, and its errors surface at
``wait_until_finished()``, which also runs before the next save.

A Trainer whose states live in its kvstore's updater (``update_on_kvstore``)
is saved and restored like any other: its blob's ``"kvstore"`` entry is
the updater's pickled states (``gluon.trainer.states_file_blob``).

Not in the port yet: input pipelines (``pipeline=``, slice 8), and
multi-process manifests, ZeRO-sharded optimizer states and resharding onto
another topology (slice 7, part 2); each raises :class:`MXNetError` naming
its slice.
"""
from __future__ import annotations

import json
import logging
import os
import pickle
import re
import shutil
import signal
import threading

import torch

from .. import random as _random
from ..base import MXNetError
from . import atomic
from .snapshot import Snapshot, host_leaves, writer
from ..gluon.trainer import states_file_blob

MANIFEST = "MANIFEST.json"

_log = logging.getLogger("mxnet_tpu_torch.checkpoint")


def _later(what, slice_no):
    return MXNetError(f"CheckpointManager: {what} is not ported yet; it "
                      f"comes with slice {slice_no} of the port "
                      "(ROADMAP.md queue 1)")


_RESHARD = "7, part 2 (the distributed slice's resharding)"


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
        self._recover()
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
        extra : JSON-serializable user metadata stored in the manifest
        sync : block until committed

        The values are those at the call: every parameter and state is
        copied on the current stream before this returns, so a step
        queued after it (a captured step writes in place) does not reach
        the checkpoint.  Blocks first on any still-draining previous save
        (the error surfacing point) — at most one checkpoint is in
        flight.
        """
        if pipeline is not None:
            raise _later("checkpointing an input pipeline (pipeline=)", 8)
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
            tree = {"params": _param_dict(params),
                    "trainer": (None if trainer is None
                                else trainer._states_blob()),
                    "rng": _random.get_state()}
            pending = self._snapshot.take(tree)
            meta = {"format_version": self.FORMAT_VERSION,
                    "step": step, "epoch": epoch, "extra": extra,
                    "num_processes": 1}
            fut = self._writer.submit(self._write_commit, pending, step,
                                      meta)
            self._pending = (step, fut)
            if sync:
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

    def _write_commit(self, pending, step, meta):
        state = pending.fetch()
        tmp = self._dir_for(step) + ".tmp"
        final = self._dir_for(step)
        # a crashed earlier save at this step may have left stale files
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
        if state["params"] is not None:
            from ..utils import serialization

            p = os.path.join(tmp, "params-shard0.params")
            serialization.save_ndarrays(p, state["params"])
            atomic.fsync_file(p)
        if state["trainer"] is not None:
            p = os.path.join(tmp, "trainer-shard0.states")
            with open(p, "wb") as f:
                # protocol 5 writes the arrays from their own memory
                pickle.dump(states_file_blob(
                    host_leaves(state["trainer"], copy=False)), f,
                    protocol=5)
            atomic.fsync_file(p)
        atomic.write_json(os.path.join(tmp, "rng-shard0.json"),
                          state["rng"])
        atomic.fsync_dir(tmp)
        meta["files"] = sorted(os.listdir(tmp))
        atomic.write_json(os.path.join(tmp, MANIFEST), meta)
        old = None
        if os.path.isdir(final):
            # re-save of the same step: park the committed copy aside so
            # a kill in this window loses nothing (_recover renames it
            # back if the commit never happened)
            old = final + ".old"
            if os.path.isdir(old):
                shutil.rmtree(old)
            os.rename(final, old)
        os.rename(tmp, final)  # the commit point
        atomic.fsync_dir(self.directory)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
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
        them.  Returns the manifest metadata ``{"step", "epoch",
        "extra", "params"}`` — "params" is the loaded name->NDArray dict
        only when no target was given.

        With ``step=None`` a corrupt or truncated newest step does NOT
        raise: it is logged and the previous retained step is restored
        instead, falling back step by step; only when no retained step
        loads does restore raise, listing every step's failure.  An
        explicit ``step=`` keeps strict semantics.
        """
        if pipeline is not None:
            raise _later("restoring an input pipeline (pipeline=)", 8)
        self.wait_until_finished()
        if step is not None:
            return self._restore_step(int(step), params, trainer,
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
                meta = self._restore_step(s, params, trainer, restore_rng,
                                          strict_topology)
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
            return meta
        raise MXNetError(
            f"no retained checkpoint under {self.directory} is loadable "
            "— every step failed: "
            + "; ".join(f"step {s}: {_first_line(e)[:150]}"
                        for s, e in failures))

    def _restore_step(self, step, params, trainer, restore_rng,
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
        if saved_procs != 1:
            # strict_topology or not: every multi-process layout and its
            # resharding onto this job's topology waits for slice 7, part 2
            raise _later(
                f"restoring {mpath}, saved by a {saved_procs}-process job "
                "(multi-process checkpoints and resharding)", _RESHARD)
        loaded = self._restore_params(d, params)
        self._restore_trainer(d, trainer)
        if restore_rng:
            rpath = os.path.join(d, "rng-shard0.json")
            if os.path.isfile(rpath):
                with open(rpath) as f:
                    _random.set_state(json.load(f))
        return {"step": int(manifest["step"]),
                "epoch": manifest.get("epoch"),
                "extra": manifest.get("extra"),
                "params": loaded}

    def _restore_params(self, d, params):
        from ..ndarray.ndarray import NDArray
        from ..utils import serialization

        pfile = os.path.join(d, "params-shard0.params")
        if not os.path.isfile(pfile):
            if params is not None:
                raise MXNetError(
                    f"{d}: no parameter shard for process 0 "
                    "(params-shard0.params) — this step was saved "
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

    def _restore_trainer(self, d, trainer):
        tfile = os.path.join(d, "trainer-shard0.states")
        if trainer is None:
            return
        if not os.path.isfile(tfile):
            raise MXNetError(
                f"{d}: checkpoint has no trainer states for process 0 "
                "(was it saved without trainer=?)")
        with open(tfile, "rb") as f:
            blob = pickle.load(f)
        trainer.load_states_dict(blob, source=tfile)

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
