"""Self-healing training supervisor (the recovery half of
``mxnet_tpu_torch.resilience``; ref: ``mxnet_tpu/resilience/
supervisor.py``).

``Supervisor.run(train_fn)`` owns the retry/resume policy for a long
training job.  ``train_fn(ctx)`` is written restartably — it restores
from ``ctx.manager.latest()`` when one exists, registers its preemption
state, and reports progress::

    mgr = checkpoint.CheckpointManager(ckpt_dir, keep_n=3)
    sup = resilience.Supervisor(mgr, on_preemption="resume")

    def train(ctx):
        net, trainer = build_model()
        pipe = build_pipeline()
        start = 0
        if ctx.manager.latest() is not None:   # (re)start: resume
            meta = ctx.manager.restore(params=net, trainer=trainer,
                                       pipeline=pipe)
            start = meta["step"] + 1
        state = {"step": start - 1}
        ctx.set_preemption_state(lambda: dict(
            step=state["step"], params=net, trainer=trainer,
            pipeline=pipe))
        for step, (x, y) in enumerate(pipe, start):
            ...forward/backward/trainer.step...
            state["step"] = step
            ctx.step_done(step, save=dict(params=net, trainer=trainer,
                                          pipeline=pipe))
        return net

    net = sup.run(train)

The supervisor classifies every failure that escapes ``train_fn``:

- **transient** (injected :class:`~.faults.TransientFault`, or real
  flaky-transport / UNAVAILABLE / RESOURCE_EXHAUSTED shapes) — bounded
  exponential backoff via :class:`~.retry.RetryPolicy`, then re-invoke
  ``train_fn`` (which resumes from the last committed checkpoint).
- **preemption** (SIGTERM) — the supervisor chains BEHIND the
  CheckpointManager's final-save hook, so by the time its handler
  raises :class:`Preempted` the final checkpoint is committed.
  ``on_preemption="resume"`` restarts in-process (chaos rehearsal);
  ``"exit"`` (default, the real-preemption behavior) writes a resume
  marker and re-raises as :class:`ResumeRequired`.
- **peer_death** (the ``parallel.dist`` bounded-failure-detector
  message) — the JAX package's non-elastic path (its
  ``MXTPU_ELASTIC=0``): in one process a restart; across processes a
  clean exit with the resume marker and :class:`ResumeRequired`, since
  ``dist.reinit`` and the elastic resize (``dist.shrink``,
  ``pick_mesh_shape``) come with slice 7, part 3 of the port.
- **corrupt_checkpoint** — restart; ``CheckpointManager.restore()``
  itself falls back to the previous retained step (loudly).
- **watchdog** — no ``ctx.step_done`` within ``watchdog_sec``: the
  watchdog thread captures the stuck phase from the profiler's OPEN op
  scopes, books the diagnostic, and interrupts the training thread.
- **fatal** — everything else re-raises unchanged.

Non-transient recoveries consume the ``max_restarts`` budget
(``MXTPU_MAX_RESTARTS``); transient retries are bounded by the
:class:`RetryPolicy`.  Both budgets are per STALL POINT: steps
completed between two failures reset the counters, so a long job
absorbing an occasional flake never exhausts them while a loop stuck
at one step still trips the bound.  Every recovery is visible in the profiler's
``resilience`` section (restarts, retries by fault class,
fallback_restores, watchdog_fires, time_lost_ms).

Watchdog scope: it interrupts Python-level stalls (a stuck map fn, a
dead data source, host-side deadlock).  A hang inside a C-level
collective does not take the interrupt — bound those with
``MXTPU_DIST_TIMEOUT``, which converts the hang into a diagnosable
(peer_death) error the supervisor classifies normally.

On the card.  A sticky CUDA error (an illegal address, a launch failure,
a capture invalidated by an earlier error) leaves the context unusable,
so it classifies ``fatal`` and is never retried in-process: the
transient signatures are checked after the CUDA ones.  A restarted
``train_fn`` builds a new net and trainer; the old trainer's captured
graphs and their memory pool are freed with it.  ``run`` restores the
SIGTERM handler it found when it returns.
"""
from __future__ import annotations

import _thread
import gc
import os
import signal
import threading
import time

from .. import engine, profiler
from ..base import MXNetError, getenv
from ..log import get_logger
from ..telemetry import flight as _flight, tracer as _tracer
from . import stats as _stats
from .faults import TransientFault
from .retry import RetryPolicy

logger = get_logger("mxnet_tpu_torch.resilience")

RESUME_MARKER = "RESUME.json"

_UNSET = object()  # train_fn-result sentinel (None is a valid result)


class Preempted(MXNetError):
    """SIGTERM landed; the final checkpoint (if registered) is saved."""


class WatchdogTimeout(MXNetError):
    """No training step completed within the watchdog window."""


class ResumeRequired(MXNetError):
    """Clean exit on an unrecoverable-in-process fault: a resume marker
    was written; restart the job to continue from the last
    checkpoint."""


# -- classification ---------------------------------------------------------

# dist._peer_death_msg's stable phrase — checked FIRST because transport
# errors ("connection reset") would otherwise look transient
_PEER_SIGNATURES = ("likely dead or partitioned",)
# restore()'s terminal errors mention corruption but restarting cannot
# fix them (every retained step already failed / the target was left
# partially mutated and needs a rebuild) — fatal, checked before the
# corrupt signatures
_UNRECOVERABLE_SIGNATURES = ("no retained checkpoint",
                             "every step failed",
                             "partially mutated")
_CORRUPT_SIGNATURES = ("corrupt", "truncated")
# RPC/transport blips between serving processes (the control plane's
# socket wire): RETRYABLE — the router re-dispatches on another replica
# instead of forwarding them as fatal.  Raw socket exceptions
# (ConnectionResetError & friends) are OSErrors, not MXNetErrors, so
# they get an isinstance check of their own; the text shapes cover
# errors re-wrapped by the wire layer.  Checked after the peer-death
# signature (a peer-death message may embed "connection reset") and
# BEFORE the corrupt signatures: a "truncated frame" is a dropped
# connection, not a corrupt checkpoint.
_NETWORK_EXC_TYPES = (ConnectionResetError, ConnectionRefusedError,
                      ConnectionAbortedError, BrokenPipeError)
_NETWORK_SIGNATURES = ("connection reset", "connection refused",
                       "connection aborted", "broken pipe",
                       "econnreset", "econnrefused", "epipe",
                       "truncated frame", "mid-frame",
                       "rpc connection")
# serving shed-don't-retry shapes, checked BEFORE the transient list:
# both read "try again later", but retrying an overloaded pool is
# exactly how a retry loop turns one slow replica into a meltdown, and
# an exhausted deadline budget cannot be retried back into existence
_OVERLOAD_SIGNATURES = ("queue full", "overloaded", "quota exceeded")
_DEADLINE_SIGNATURES = ("deadline exceeded", "deadline_exceeded",
                        "deadline passed", "deadline budget")
_TRANSIENT_SIGNATURES = (
    "injected transient", "transient", "unavailable",
    "resource exhausted", "resource_exhausted",
    "try again", "temporarily", "aborted",
)
# sticky CUDA errors: the context is unusable after them, so a retry in
# the same process can only fail again (or compute garbage).  Checked
# before every other signature: "cudaErrorLaunchFailure ... unspecified
# launch failure" must not reach the transient list, and a wrapper's
# re-raise may say "aborted".  The texts are the CUDA runtime's error
# names and strings as torch and the kernel wrappers report them.
_CUDA_FATAL_SIGNATURES = (
    "illegal memory access", "illegal address", "cudaerrorillegaladdress",
    "unspecified launch failure", "cudaerrorlaunchfailure",
    "misaligned address", "cudaerrormisalignedaddress",
    "illegal instruction", "cudaerrorillegalinstruction",
    "device-side assert", "cudaerrorassert",
    "operation not permitted when stream is capturing",
    "cudaerrorstreamcaptureunsupported",
    "capture sequence has been invalidated",
    "previous error during capture", "cudaerrorstreamcaptureinvalidated",
    "cudaerrorstreamcaptureimplicit", "uncorrectable ecc",
    "cudaerrorecouncorrectable", "context is destroyed",
    "cudaerrorcontextisdestroyed",
)


def _serve_request_class(exc):
    """``'overloaded'`` / ``'deadline'`` for the serve tier's
    backpressure and deadline errors — resolved through ``sys.modules``
    so classifying never imports the serving stack (if serve was never
    imported, ``exc`` cannot be one of its exception types)."""
    import sys

    batcher = sys.modules.get(
        __package__.rsplit(".", 1)[0] + ".serve.batcher")
    if batcher is None:
        return None
    if isinstance(exc, batcher.ServerOverloadedError):
        return "overloaded"
    if isinstance(exc, batcher.DeadlineExceededError):
        return "deadline"
    return None


def _is_sticky_cuda_error(exc):
    """A sticky CUDA error anywhere in the exception's chain (a wrapper
    may re-raise torch's ``RuntimeError`` or ``torch.AcceleratorError``
    as an ``MXNetError``)."""
    seen = 0
    e = exc
    while e is not None and seen < 8:
        text = str(e).lower()
        if any(s in text for s in _CUDA_FATAL_SIGNATURES):
            return True
        e = e.__cause__ or e.__context__
        seen += 1
    return False


def classify(exc):
    """Map an exception to its fault class: ``'transient'``,
    ``'preemption'``, ``'peer_death'``, ``'corrupt_checkpoint'``,
    ``'watchdog'``, ``'overloaded'``, ``'deadline'``, ``'network'``
    or ``'fatal'``.

    A sticky CUDA error (``_CUDA_FATAL_SIGNATURES``, in the exception or
    its cause) is ``'fatal'`` whatever else its text says.

    ``overloaded`` (a full bounded queue / exhausted tenant quota) and
    ``deadline`` (an expired request budget) are NON-RETRYABLE: the
    right reaction is shedding load (or spilling to a less-loaded
    replica) and failing the request, respectively — a naive retry
    loop treating their "try again"-shaped messages as ``transient``
    burns its whole budget hammering a pool that needs the opposite.

    ``network`` (a dropped/refused connection, a truncated RPC frame)
    IS retryable — on a DIFFERENT path: the serve router re-dispatches
    the request to another replica, and the supervisor paces it like a
    transient.  It is distinct from ``peer_death``, whose collective
    cannot proceed without a world resize.
    """
    if isinstance(exc, TransientFault):
        return "transient"
    if isinstance(exc, Preempted):
        return "preemption"
    if isinstance(exc, WatchdogTimeout):
        return "watchdog"
    kind = _serve_request_class(exc)
    if kind is not None:
        return kind
    if isinstance(exc, _NETWORK_EXC_TYPES):
        return "network"
    if _is_sticky_cuda_error(exc):
        return "fatal"
    if isinstance(exc, MXNetError):
        text = str(exc).lower()
        if any(s in text for s in _PEER_SIGNATURES):
            return "peer_death"
        if any(s in text for s in _UNRECOVERABLE_SIGNATURES):
            return "fatal"
        if any(s in text for s in _NETWORK_SIGNATURES):
            return "network"
        if any(s in text for s in _CORRUPT_SIGNATURES):
            return "corrupt_checkpoint"
        if any(s in text for s in _OVERLOAD_SIGNATURES):
            return "overloaded"
        if any(s in text for s in _DEADLINE_SIGNATURES):
            return "deadline"
        if any(s in text for s in _TRANSIENT_SIGNATURES):
            return "transient"
    return "fatal"


def _release_attempt(exc):
    """Free the failed attempt before the next one builds its own model.

    The exception's traceback holds the attempt's frames, and with them
    its net, trainer and captured graphs (their memory pool): on the card
    a restarted BERT-base would otherwise run beside the dead one's
    graphs.  The frames are dropped and the cycles collected.  A CUDA
    stream left in capture mode (a signal that landed inside a capture)
    cannot be recovered in this process, so it is fatal."""
    e, seen = exc, 0
    while e is not None and seen < 8:
        e.__traceback__ = None
        e = e.__cause__ or e.__context__
        seen += 1
    gc.collect()
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized() \
            and torch.cuda.is_current_stream_capturing():
        raise MXNetError(
            "a CUDA stream was left in capture mode by the failed attempt "
            f"({exc}); the context cannot be reused — restart the process "
            "to resume from the last checkpoint") from None


# -- the per-invocation context the train_fn sees ---------------------------


class RunContext:
    """Handed to ``train_fn`` on every (re)invocation.

    attempt : 0 on the first invocation, +1 per recovery
    manager : the supervisor's CheckpointManager (or None)
    world   : the job's world size (the port resizes no world yet:
              the elastic resize comes with slice 7, part 3)
    dead_ranks : ranks lost so far (always empty until then)
    resizes : elastic resize events so far (0 until then)
    """

    def __init__(self, supervisor):
        self._sup = supervisor
        self.attempt = 0

    @property
    def manager(self):
        return self._sup.manager

    @property
    def world(self):
        return self._sup._world

    @property
    def dead_ranks(self):
        return list(self._sup._dead_ranks)

    @property
    def resizes(self):
        return self._sup._resizes

    def mesh_shape(self, world=None):
        """The spmd mesh shape THIS invocation should train at, or
        None when no multi-axis mesh is configured: the configured
        ``MXTPU_MESH_SHAPE``.  Asked for another ``world`` than the
        job's, it applies ``parallel.spmd.mesh.pick_mesh_shape``, which
        comes with slice 7, part 3 (and raises until then)."""
        from ..parallel.spmd.mesh import (mesh_shape_from_env,
                                          pick_mesh_shape)

        shape = mesh_shape_from_env()
        if shape is None:
            return None
        if world is not None and int(world) != self.world:
            shape = pick_mesh_shape(shape, int(world))
        return shape

    def step_done(self, step, save=None):
        """Report step ``step`` completed: feeds the progress watchdog,
        fires the ``train.step`` fault point (where kill-at-step-N chaos
        plans trigger), and — when ``save`` kwargs are given — commits a
        checkpoint through the manager (``save`` maps to
        ``manager.save(step, **save)``)."""
        step = int(step)
        self._sup._last_step = step
        self._sup._progress = time.monotonic()
        engine.fault_point("train.step", step=step)
        if save is not None:
            if self._sup.manager is None:
                raise MXNetError(
                    "step_done(save=...) needs a CheckpointManager: "
                    "construct the Supervisor with manager=")
            self._sup.manager.save(step, **save)

    def heartbeat(self):
        """Feed the progress watchdog WITHOUT completing a step — for
        legitimately step-free phases longer than ``watchdog_sec``
        (initial restore of a huge model, end-of-run export/eval), so
        they are not misread as a stall."""
        self._sup._progress = time.monotonic()

    def set_preemption_state(self, state_fn):
        """Register the final-save state provider: ``state_fn()``
        returns ``manager.save`` kwargs (``step``, ``params``, ...)
        capturing everything a resume needs, or None to skip.  A
        SIGTERM then commits that state synchronously before the
        supervisor sees :class:`Preempted`."""
        self._sup._state_fn = state_fn


# -- the supervisor ---------------------------------------------------------


class Supervisor:
    """Retry/resume policy owner for a supervised training job.

    manager       : CheckpointManager used for final saves, restores and
                    the resume marker (optional but required for
                    ``step_done(save=...)`` / preemption saves)
    max_restarts  : non-transient recovery budget
                    (``MXTPU_MAX_RESTARTS``, default 3)
    watchdog_sec  : progress watchdog window; 0 disables
                    (``MXTPU_WATCHDOG_SEC``, default 0)
    retry         : :class:`RetryPolicy` bounding transient retries
    on_preemption : ``'exit'`` (default — write the resume marker and
                    raise :class:`ResumeRequired`, the real-preemption
                    behavior) or ``'resume'`` (restart in-process, the
                    chaos-rehearsal behavior)
    elastic       : the elastic resize on peer death comes with slice
                    7, part 3: ``True`` raises; ``None``/``False`` take
                    the non-elastic path (the JAX package's
                    ``MXTPU_ELASTIC=0``), whatever ``MXTPU_ELASTIC`` says
    world         : the job's world size; defaults to
                    ``dist.num_workers()``
    min_world, rendezvous_timeout : the elastic resize's bounds
                    (``MXTPU_MIN_WORLD``, ``MXTPU_RENDEZVOUS_TIMEOUT``),
                    kept for the JAX signature
    """

    def __init__(self, manager=None, *, max_restarts=None,
                 watchdog_sec=None, retry=None, on_preemption="exit",
                 resume_marker=None, elastic=None, world=None,
                 min_world=None, rendezvous_timeout=None):
        if on_preemption not in ("exit", "resume"):
            raise MXNetError(
                f"on_preemption must be 'exit' or 'resume', got "
                f"{on_preemption!r}")
        self.manager = manager
        self.max_restarts = int(getenv("MAX_RESTARTS", 3, int)
                                if max_restarts is None else max_restarts)
        self.watchdog_sec = float(getenv("WATCHDOG_SEC", 0.0, float)
                                  if watchdog_sec is None else watchdog_sec)
        self.retry = retry if retry is not None else RetryPolicy()
        self.on_preemption = on_preemption
        self.resume_marker = resume_marker or (
            os.path.join(manager.directory, RESUME_MARKER)
            if manager is not None else RESUME_MARKER)
        if elastic:
            raise MXNetError(
                "Supervisor(elastic=True): the elastic resize on peer "
                "death (dist.shrink, reinit, pick_mesh_shape) is not "
                "ported yet; it comes with slice 7, part 3 of the port. "
                "Without it a peer death writes the resume marker and "
                "raises ResumeRequired")
        self.elastic = False
        self.min_world = int(getenv("MIN_WORLD", 1, int)
                             if min_world is None else min_world)
        self.rendezvous_timeout = float(
            getenv("RENDEZVOUS_TIMEOUT", 60.0, float)
            if rendezvous_timeout is None else rendezvous_timeout)
        self._world = None if world is None else int(world)
        self._dead_ranks = []
        self._resizes = 0
        self._state_fn = None
        self._last_step = None
        self._progress = time.monotonic()
        self._watchdog_diag = None
        self._orig_sigterm = None

    # -- the loop ------------------------------------------------------------

    def run(self, train_fn):
        """Drive ``train_fn(ctx)`` to completion through failures;
        returns its result.  See the module docstring for the policy per
        fault class."""
        is_main = threading.current_thread() is threading.main_thread()
        if self._world is None:
            from ..parallel import dist

            try:
                self._world = dist.num_workers()
            except Exception:  # no process group: single process
                self._world = 1
        ctx = RunContext(self)
        restarts = 0
        transient_failures = 0
        last_fail_step = None
        # flight recorder rides along for the whole supervised job
        # (unless MXTPU_FLIGHT_RECORDER=off): any crash below leaves a
        # loadable timeline next to the checkpoints
        flight_token = _flight.auto_enable(
            directory=self.manager.directory
            if self.manager is not None else None)
        try:
            return self._run_supervised(train_fn, ctx, restarts,
                                        transient_failures,
                                        last_fail_step, is_main)
        finally:
            _flight.auto_disable(flight_token)

    def _run_supervised(self, train_fn, ctx, restarts,
                        transient_failures, last_fail_step, is_main):
        while True:
            ctx.attempt = restarts + transient_failures
            self._watchdog_diag = None
            self._progress = time.monotonic()
            watchdog = self._start_watchdog() if (
                self.watchdog_sec > 0 and is_main) else None
            chained = self._install_signal_chain() if is_main else False
            result = _UNSET
            try:
                result = train_fn(ctx)
                return result
            except KeyboardInterrupt:
                if result is not _UNSET:
                    # the watchdog lost the race with completion: its
                    # SIGINT landed after train_fn returned — the run
                    # SUCCEEDED, don't discard the result or restart
                    return result
                if self._watchdog_diag is None:
                    raise  # a real Ctrl-C is never swallowed
                exc, kind = WatchdogTimeout(self._watchdog_diag), "watchdog"
            except BaseException as e:  # noqa: BLE001 — classified below
                kind = classify(e)
                if kind == "fatal":
                    # post-mortem before the re-raise: the ring holds
                    # the job's last seconds
                    _flight.dump_if_enabled(
                        "fatal", extra={"error": str(e)[:500],
                                        "type": type(e).__name__,
                                        "last_step": self._last_step})
                    raise
                exc = e
            finally:
                try:
                    self._stop_watchdog(watchdog)
                    if chained:
                        self._uninstall_signal_chain()
                except KeyboardInterrupt:
                    # a last-instant watchdog SIGINT landing inside this
                    # cleanup would escape run() uncatchable; swallow it
                    # iff it is ours (teardown below already completed
                    # enough: stop is set, the thread is a daemon)
                    if self._watchdog_diag is None:
                        raise
                    if chained:
                        self._uninstall_signal_chain()
            t_fail = time.monotonic()

            # recovery budgets are per STALL POINT, not per job
            # lifetime: steps completed since the previous failure mean
            # the job is progressing, so a months-long run surviving a
            # flake every few hours never exhausts its budget
            if self._last_step is not None and last_fail_step is not None \
                    and self._last_step > last_fail_step:
                transient_failures = 0
                restarts = 0
            last_fail_step = self._last_step

            if kind in ("transient", "network"):
                transient_failures += 1
                if not self.retry.should_retry(transient_failures):
                    raise MXNetError(
                        f"transient failure persisted through "
                        f"{transient_failures - 1} retries "
                        f"(RetryPolicy.max_retries="
                        f"{self.retry.max_retries}): {exc}") from exc
                delay = self.retry.delay_for(transient_failures)
                logger.warning(
                    "transient failure (retry %d/%d, backoff %.3fs): %s",
                    transient_failures, self.retry.max_retries, delay, exc)
                time.sleep(delay)
            elif kind == "preemption":
                if self.on_preemption != "resume" \
                        or restarts >= self.max_restarts:
                    self._write_resume_marker("preemption", exc)
                    raise ResumeRequired(
                        f"preempted (SIGTERM); final checkpoint "
                        f"committed and resume marker written to "
                        f"{self.resume_marker} — restart the job to "
                        "resume from CheckpointManager.latest()") from exc
                restarts += 1
                logger.warning(
                    "preempted; restarting in-process (restart %d/%d)",
                    restarts, self.max_restarts)
            elif kind == "peer_death":
                if restarts >= self.max_restarts or not self._try_reinit():
                    self._write_resume_marker("peer_death", exc)
                    raise ResumeRequired(
                        f"peer death and the process group could not be "
                        f"re-initialized in-process; resume marker "
                        f"written to {self.resume_marker} — restart the "
                        f"whole job to resume from the last checkpoint "
                        f"(original failure: {exc})") from exc
                restarts += 1
                logger.warning(
                    "peer death; process group re-initialized, "
                    "restarting (restart %d/%d): %s",
                    restarts, self.max_restarts, exc)
            else:  # watchdog / corrupt_checkpoint / overloaded / deadline
                if restarts >= self.max_restarts:
                    raise exc
                restarts += 1
                if kind in ("overloaded", "deadline"):
                    # non-retryable at the REQUEST level (the serve
                    # router sheds), but a training job seeing these
                    # shapes from a collective/RPC must restart PACED:
                    # an instant restart hammers the very resource the
                    # error names, and back-to-back restarts would burn
                    # the whole budget inside one network blip
                    delay = self.retry.delay_for(restarts)
                    logger.warning(
                        "%s failure; backing off %.3fs before restart "
                        "(restart %d/%d): %s", kind, delay, restarts,
                        self.max_restarts, exc)
                    time.sleep(delay)
                else:
                    logger.warning(
                        "%s failure; restarting (restart %d/%d): %s",
                        kind, restarts, self.max_restarts, exc)

            _release_attempt(exc)
            _stats.add("restarts")
            _stats.add_retry(kind)
            _stats.add("time_lost_ms",
                       (time.monotonic() - t_fail) * 1e3)
            _tracer.instant("resilience.retry", cat="resilience",
                            kind=kind, last_step=self._last_step
                            if self._last_step is not None else -1,
                            error=str(exc)[:200])

    # -- preemption chain ----------------------------------------------------

    def _install_signal_chain(self):
        """Install SIGTERM handling so delivery runs: manager final save
        -> (chained) supervisor handler -> raise Preempted in the
        training thread."""

        def _handler(sig, frame):
            raise Preempted(
                "SIGTERM received (preemption notice); the final "
                "checkpoint, if a preemption state was registered, is "
                "already committed")

        try:
            self._orig_sigterm = signal.signal(signal.SIGTERM, _handler)
        except ValueError:  # not the main thread after all
            return False
        if self.manager is not None:
            self.manager.install_sigterm_hook(self._final_state)
        return True

    def _uninstall_signal_chain(self):
        if self.manager is not None:
            self.manager.uninstall_sigterm_hook()
        if self._orig_sigterm is not None:
            signal.signal(signal.SIGTERM, self._orig_sigterm)
            self._orig_sigterm = None

    def _final_state(self):
        fn = self._state_fn
        if fn is None:
            return None
        kwargs = fn()
        if kwargs is not None:
            kwargs.setdefault("sync", True)
            if "step" not in kwargs:
                kwargs["step"] = self._last_step if self._last_step \
                    is not None else 0
        return kwargs

    # -- resume marker -------------------------------------------------------

    def _write_resume_marker(self, reason, exc, dead_applied=False):
        # surviving topology: dead_applied says whether the caller
        # already shrank _world for THIS failure's dead ranks (the
        # min-world path does; a non-elastic peer death does not).
        # An explicit flag, not a membership test against the historic
        # _dead_ranks — those ids are from PRE-resize numberings, so a
        # re-used rank number must still be subtracted here
        dead_now = sorted({int(r) for r in
                           getattr(exc, "dead_ranks", ()) or ()})
        world = self._world
        surviving = ((world if dead_applied
                      else max(world - len(dead_now), 0))
                     if world is not None else None)
        marker = {
            "reason": reason,
            "error": str(exc)[:500],
            "last_step": self._last_step,
            "latest_checkpoint": (self.manager.latest()
                                  if self.manager is not None else None),
            "topology": {
                "world": surviving,
                "dead_ranks": sorted(set(self._dead_ranks) | set(dead_now)),
                "resizes": self._resizes,
            },
            "resume": "restart the job; a train_fn that restores from "
                      "CheckpointManager.latest() continues from "
                      "latest_checkpoint. topology.world is the "
                      "surviving world size — an on_preemption='exit' "
                      "relauncher sizes the next job with it (the "
                      "resharding restore repartitions the checkpoint)",
        }
        try:
            # atomic (tmp+fsync+rename): this path runs in the SIGKILL
            # escalation window, where a plain write could leave a
            # truncated marker for the restart tooling to parse
            from ..checkpoint import atomic

            atomic.write_json(self.resume_marker, marker)
        except OSError as e:  # the marker is advisory, never fatal
            logger.warning("could not write resume marker %s: %s",
                           self.resume_marker, e)

    # -- peer-death re-init --------------------------------------------------

    def _try_reinit(self):
        """Best-effort process-group re-init.  True in a single process
        (nothing to re-init — the rehearsal path); multi-process, tries
        ``dist.reinit()``, which raises in the port until slice 7, part
        3 — so False routes to the clean-exit path."""
        from ..parallel import dist

        try:
            if not dist.is_multiprocess():
                return True
            dist.reinit()
            return True
        except Exception as e:  # noqa: BLE001 — any failure = exit path
            logger.warning("process-group re-init failed: %s", e)
            return False

    # -- watchdog ------------------------------------------------------------

    def _start_watchdog(self):
        profiler.track_scopes(True)
        stop = threading.Event()
        th = threading.Thread(target=self._watch, args=(stop,),
                              daemon=True, name="mxtpu-watchdog")
        th.start()
        return stop, th

    def _stop_watchdog(self, watchdog):
        if watchdog is None:
            return
        stop, th = watchdog
        stop.set()
        th.join(timeout=2.0)
        profiler.track_scopes(False)

    def _watch(self, stop):
        period = max(0.05, min(1.0, self.watchdog_sec / 4.0))
        while not stop.wait(period):
            idle = time.monotonic() - self._progress
            if idle < self.watchdog_sec:
                continue
            diag = self._diagnose(idle)
            _stats.add("watchdog_fires")
            _tracer.instant("resilience.watchdog", cat="resilience",
                            idle_s=round(idle, 3))
            # the post-mortem: dump the ring BEFORE interrupting the
            # training thread, while the stall is still in progress
            # (active scopes name the stuck phase)
            _flight.dump_if_enabled("watchdog",
                                    extra={"diagnostic": diag})
            logger.error(diag)
            if stop.is_set():  # train_fn finished while we diagnosed
                return
            self._watchdog_diag = diag
            # a REAL signal (not just the interpreter's async-exception
            # flag): pthread_kill EINTRs a blocking C call like
            # time.sleep / a socket read, where interrupt_main would
            # wait for the next bytecode boundary that never comes
            try:
                signal.pthread_kill(threading.main_thread().ident,
                                    signal.SIGINT)
            except (AttributeError, ValueError, ProcessLookupError):
                _thread.interrupt_main()
            return

    def _diagnose(self, idle):
        scopes = profiler.active_scopes()
        phases = sorted({stack[-1] for stack in scopes.values() if stack})
        where = (f"stuck phase (open profiler sections): "
                 f"{', '.join(phases)}" if phases else
                 "no profiler section is open — the stall is in user "
                 "code between instrumented phases")
        # an armed HealthMonitor knows what was SLOW before the hang
        # (phase breakdown + firing SLO rules), not just which scope is
        # open now — append its last window to the diagnostic
        try:
            from ..telemetry import health as _health

            where += _health.describe_for_diagnostic()
        except Exception:  # noqa: BLE001 — diagnosis must never fail
            pass
        return (
            f"watchdog: no training step completed in {idle:.1f}s "
            f"(MXTPU_WATCHDOG_SEC={self.watchdog_sec:g}; last completed "
            f"step: {self._last_step}); {where}. A stuck "
            "'dist.allreduce'/'barrier' means a dead or partitioned "
            "peer — set MXTPU_DIST_TIMEOUT to convert the hang into a "
            "diagnosable error; a stuck 'pipeline.map' names the input "
            "pipeline (raise its timeout= or inspect the batch); "
            "'checkpoint.save.*' points at storage.")
