"""Deterministic fault-injection harness (the chaos half of
``mxnet_tpu_torch.resilience``; ref: ``mxnet_tpu/resilience/faults.py``).

A :class:`FaultPlan` arms named **fault points** — call sites the
runtime's failure-prone seams expose via ``engine.fault_point(name,
**ctx)``.  When no plan is armed the hook is a module-level no-op (the
call is the whole cost: zero branches taken, see ``engine._fault_noop``
and the zero-overhead test); arming a plan rebinds it to the plan's
dispatcher.  Every trigger decision is a pure function of the plan
(seed + specs) and the site-hit sequence, so a chaos test replays
bit-identically.

Fault-point catalog (site -> where it fires -> ctx keys):

========================  =====================================  ==========
``train.step``            ``Supervisor`` ctx.step_done()         ``step``
``kvstore.pushpull``      top of ``KVStore.pushpull``            —
``dist.allreduce``        top of ``parallel.dist.allreduce``     —
``dist.barrier``          top of ``parallel.dist.barrier``       ``name``
``dist.rendezvous``       top of ``parallel.dist.shrink``        ``world,
                          (elastic survivor rendezvous)          dead,
                                                                 round_index``
``engine.h2d``            ``engine.batched_put``                 ``n, device``
``engine.d2h``            checkpoint d2h readback                —
``checkpoint.commit``     after shard writes, pre-manifest       ``dir, step``
``checkpoint.reshard``    elastic restore, before the            ``kind,
                          repartition is applied                 saved_world,
                                                                 world``
``pipeline.map``          ``MapStage`` worker, before the fn     —
``serve.decode``          ``DecodeServer`` token loop, pre-step  ``step, live``
``serve.replica.submit``  ``Router`` dispatch, before the        ``replica,
                          replica's ``submit()``                 attempt``
``serve.replica.health``  ``Router`` health prober, before the   ``replica``
                          probe request
``serve.rpc.send``        ``RemoteReplica`` client, before each  ``replica,
                          control-plane frame send (a raise      attempt``
                          drops the WHOLE connection — every
                          in-flight stream on it)
``serve.replica.spawn``   ``ReplicaProcess.spawn``, before the   ``replica``
                          worker process is forked
========================  =====================================  ==========

The port calls every site but ``dist.rendezvous``, which comes with the
elastic resize (slice 7, part 3).

Actions:

- ``kill``      — ``os.kill(os.getpid(), SIGTERM)``: a preemption
  notice, exercising the CheckpointManager final-save hook and the
  supervisor's preemption path.
- ``raise``     — raise :class:`TransientFault` (classified by the
  supervisor as retriable: backoff + re-run from the last checkpoint).
- ``peer_death`` — raise :class:`PeerDeathFault` carrying the spec's
  ``dead_ranks``: the rank-loss rehearsal (classified ``peer_death``;
  the port's supervisor restarts in one process and, across processes,
  writes the resume marker and raises ``ResumeRequired``: the elastic
  resize by the dead ranks comes with slice 7, part 3).
- ``delay`` / ``stall`` — sleep ``delay_s`` at the site (exercises the
  pipeline map timeout and the progress watchdog).
- ``truncate``  — truncate a shard file inside the in-flight checkpoint
  commit directory, so the COMMITTED checkpoint is corrupt — the
  injected failure behind the restore-fallback regression test.

``MXTPU_FAULT_PLAN`` (inline JSON or a path to a JSON file) arms a plan
for the whole process::

    MXTPU_FAULT_PLAN='{"seed": 7, "faults": [
        {"site": "train.step", "action": "kill", "match": {"step": 3}},
        {"site": "kvstore.pushpull", "action": "raise", "on_hit": 6}
    ]}'
"""
from __future__ import annotations

import json
import os
import signal
import threading
import time
from contextlib import contextmanager

import numpy as np

from .. import engine
from ..base import MXNetError, getenv

_ACTIONS = ("kill", "raise", "peer_death", "delay", "stall", "truncate")


class FaultInjected(MXNetError):
    """Base class for errors raised by an armed fault plan."""


class TransientFault(FaultInjected):
    """Injected retriable failure (the supervisor's 'transient' class —
    same recovery path as a real flaky collective / transport error)."""


class PeerDeathFault(FaultInjected):
    """Injected rank loss (the supervisor's 'peer_death' class — the
    message carries the stable peer-death signature, and
    ``dead_ranks`` names the ranks the rehearsal declares lost so an
    elastic supervisor can shrink the virtual world by exactly them)."""

    def __init__(self, msg, dead_ranks=()):
        super().__init__(msg)
        self.dead_ranks = [int(r) for r in dead_ranks]


class FaultSpec:
    """One armed fault: where (``site``), what (``action``), when
    (``on_hit``/``match``/``prob``), how often (``times``).

    site    : fault-point name (see the module catalog)
    action  : 'kill' | 'raise' | 'delay' | 'stall' | 'truncate'
    on_hit  : fire only on the Nth invocation of the site (1-based);
              default: every eligible hit
    match   : dict of ctx keys that must equal the site's ctx (e.g.
              ``{"step": 3}`` on ``train.step``)
    prob    : fire with this probability per eligible hit, drawn from
              the spec's own seeded RNG (deterministic replay)
    times   : maximum fires before the spec disarms itself (default 1;
              ``None`` = unbounded)
    delay_s : sleep for 'delay'/'stall' actions (default 0.05)
    signum  : signal for 'kill' (default SIGTERM)
    dead_ranks : ranks the 'peer_death' action declares lost (the
              elastic supervisor shrinks the virtual world by them)
    """

    def __init__(self, site, action, on_hit=None, match=None, prob=None,
                 times=1, delay_s=0.05, signum=signal.SIGTERM,
                 dead_ranks=None):
        if action not in _ACTIONS:
            raise MXNetError(
                f"unknown fault action {action!r}; valid: {_ACTIONS}")
        if on_hit is not None and int(on_hit) < 1:
            raise MXNetError(f"on_hit is 1-based, got {on_hit}")
        if prob is not None and not 0.0 < float(prob) <= 1.0:
            raise MXNetError(f"prob must be in (0, 1], got {prob}")
        if times is not None and int(times) < 1:
            raise MXNetError(f"times must be >= 1 (or None), got {times}")
        self.site = str(site)
        self.action = action
        self.on_hit = None if on_hit is None else int(on_hit)
        self.match = dict(match) if match else None
        self.prob = None if prob is None else float(prob)
        self.times = None if times is None else int(times)
        self.delay_s = float(delay_s)
        self.signum = int(signum)
        self.dead_ranks = [int(r) for r in (dead_ranks or ())]
        if self.action == "peer_death" and not self.dead_ranks:
            raise MXNetError(
                "a 'peer_death' fault needs dead_ranks=[...] — the "
                "rehearsal must name which ranks the failure kills")
        self._left = self.times  # None = unbounded
        self._rng = None         # seeded by the owning plan

    def _reset(self, seed, index):
        self._left = self.times
        self._rng = np.random.RandomState((int(seed) + 7919 * index)
                                          & 0x7FFFFFFF)


class FaultPlan:
    """A seeded, deterministic set of :class:`FaultSpec`\\ s.

    ``arm()`` rebinds ``engine.fault_point`` to this plan's dispatcher;
    ``disarm()`` restores the no-op.  ``fired()`` returns the replay
    record — the exact (site, action, hit) sequence that fired — which
    is a pure function of the plan and the site-hit sequence.
    """

    def __init__(self, faults=(), seed=0):
        self.seed = int(seed)
        self._specs = []
        self._lock = threading.Lock()
        self._hits = {}
        self._fired = []
        for f in faults:
            self.add(f if isinstance(f, FaultSpec) else FaultSpec(**f))

    def add(self, spec):
        if not isinstance(spec, FaultSpec):
            raise MXNetError(
                f"FaultPlan.add wants a FaultSpec, got {type(spec).__name__}")
        spec._reset(self.seed, len(self._specs))
        self._specs.append(spec)
        return self

    # -- arming --------------------------------------------------------------

    def arm(self):
        engine.set_fault_dispatcher(self.fire)
        return self

    def disarm(self):
        # `fault_point` holds a bound `fire`; compare receivers (a fresh
        # `self.fire` is a new bound-method object, `is` would miss)
        if getattr(engine.fault_point, "__self__", None) is self:
            engine.set_fault_dispatcher(None)

    def reset(self):
        """Rewind hit counters, fire budgets and per-spec RNGs so the
        same plan replays the same decisions (determinism contract)."""
        with self._lock:
            self._hits.clear()
            self._fired.clear()
            for i, spec in enumerate(self._specs):
                spec._reset(self.seed, i)
        return self

    # -- introspection -------------------------------------------------------

    def fired(self):
        """The replay record: list of {site, action, hit, ctx} dicts in
        fire order."""
        with self._lock:
            return [dict(f) for f in self._fired]

    def hits(self, site=None):
        with self._lock:
            return dict(self._hits) if site is None \
                else self._hits.get(site, 0)

    # -- dispatch ------------------------------------------------------------

    def fire(self, site, /, **ctx):
        """The armed ``engine.fault_point`` binding: count the hit, find
        the first eligible spec, perform its action.  (`site` is
        positional-only so ctx keys like `name` never clash.)"""
        with self._lock:
            hit = self._hits.get(site, 0) + 1
            self._hits[site] = hit
            todo = None
            for spec in self._specs:
                if spec.site != site or spec._left == 0:
                    continue
                if spec.match is not None and any(
                        ctx.get(k) != v for k, v in spec.match.items()):
                    continue
                if spec.on_hit is not None and hit != spec.on_hit:
                    continue
                if spec.prob is not None and \
                        float(spec._rng.random_sample()) >= spec.prob:
                    continue
                if spec._left is not None:
                    spec._left -= 1
                self._fired.append({
                    "site": site, "action": spec.action, "hit": hit,
                    "ctx": {k: v for k, v in ctx.items()
                            if isinstance(v, (int, float, str, bool))}})
                todo = spec
                break
        if todo is not None:
            self._perform(todo, site, hit, ctx)

    def _perform(self, spec, site, hit, ctx):
        if spec.action in ("delay", "stall"):
            time.sleep(spec.delay_s)
            return
        if spec.action == "raise":
            raise TransientFault(
                f"injected transient fault at {site!r} (hit {hit}) — "
                "armed by the active FaultPlan (chaos rehearsal, not a "
                "real failure)")
        if spec.action == "peer_death":
            # the stable phrase below is dist._peer_death_msg's
            # signature, so classify() routes this like a real dead peer
            raise PeerDeathFault(
                f"injected peer death at {site!r} (hit {hit}): rank(s) "
                f"{spec.dead_ranks} likely dead or partitioned — armed "
                "by the active FaultPlan (chaos rehearsal, not a real "
                "failure); an elastic Supervisor treats this as a "
                "resize event",
                dead_ranks=spec.dead_ranks)
        if spec.action == "kill":
            os.kill(os.getpid(), spec.signum)
            return
        # truncate: corrupt a shard file inside the in-flight commit dir
        # so the checkpoint COMMITS with a truncated payload
        d = ctx.get("dir")
        if not d or not os.path.isdir(d):
            raise MXNetError(
                f"'truncate' fault fired at {site!r} without a commit "
                "dir in ctx — arm it on 'checkpoint.commit'")
        names = sorted(os.listdir(d))
        target = next((n for n in names if n.startswith("params-shard")),
                      None) or next(
            (n for n in names
             if os.path.isfile(os.path.join(d, n))), None)
        if target is None:  # empty commit (metadata-only save): no-op
            return
        p = os.path.join(d, target)
        size = os.path.getsize(p)
        with open(p, "r+b") as f:
            f.truncate(max(size // 2, 1))


# ---------------------------------------------------------------------------
# module-level install surface


def install_plan(plan):
    """Arm ``plan`` process-wide (programmatic form of
    ``MXTPU_FAULT_PLAN``)."""
    if not isinstance(plan, FaultPlan):
        raise MXNetError(
            f"install_plan wants a FaultPlan, got {type(plan).__name__}")
    return plan.arm()


def clear_plan():
    """Disarm any installed plan; ``engine.fault_point`` is the no-op
    again."""
    engine.set_fault_dispatcher(None)


@contextmanager
def armed(plan):
    """Scoped arming for tests: arm on enter, disarm on exit."""
    plan.arm()
    try:
        yield plan
    finally:
        plan.disarm()


def parse_plan(text):
    """Build a :class:`FaultPlan` from inline JSON or a JSON file path
    (the ``MXTPU_FAULT_PLAN`` format: ``{"seed": int, "faults":
    [{"site": ..., "action": ..., ...}, ...]}``)."""
    raw = text
    if os.path.isfile(text):
        with open(text) as f:
            raw = f.read()
    try:
        obj = json.loads(raw)
    except ValueError as e:
        raise MXNetError(
            f"MXTPU_FAULT_PLAN is neither a JSON object nor a readable "
            f"JSON file ({e}); the format is in "
            "mxnet_tpu_torch/resilience/faults.py") \
            from None
    if not isinstance(obj, dict) or not isinstance(obj.get("faults"),
                                                   list):
        raise MXNetError(
            "MXTPU_FAULT_PLAN must be a JSON object with a 'faults' "
            "list (and an optional integer 'seed')")
    try:
        return FaultPlan(obj["faults"], seed=obj.get("seed", 0))
    except TypeError as e:
        raise MXNetError(f"bad fault spec in MXTPU_FAULT_PLAN: {e}") \
            from None


_env_installed = False
_env_mu = threading.Lock()


def install_from_env():
    """Arm the ``MXTPU_FAULT_PLAN`` plan (idempotent; no-op when the
    env var is unset).  Called lazily by the engine's bootstrap hook on
    the first fault-point fire of a process started with the var set —
    which can land concurrently from pool workers, so exactly ONE plan
    instance must win (two would split hit counts and double-fire
    ``times``-budgeted specs, breaking the determinism contract)."""
    global _env_installed
    with _env_mu:
        if _env_installed:
            return
        spec = getenv("FAULT_PLAN")
        if not spec:
            engine.set_fault_dispatcher(None)  # clear a stale bootstrap
            _env_installed = True
            return
        install_plan(parse_plan(spec))
        _env_installed = True
