"""mxnet_tpu_torch.resilience — fault-injection harness + self-healing
training supervisor (ref: ``mxnet_tpu/resilience/``).

Two halves that test each other:

- :mod:`.faults` — a seeded, deterministic :class:`FaultPlan` arming
  named ``engine.fault_point`` sites (kill-at-step-N, transient
  collective errors, transfer delays, checkpoint-commit truncation,
  pipeline map stalls).  Zero overhead unless armed.
- :mod:`.supervisor` — :class:`Supervisor`.run(train_fn) owns the
  retry/resume policy: classification, bounded backoff
  (:class:`RetryPolicy`), preemption final-save + restart, peer-death
  clean exit with a resume marker (the elastic resize comes with slice
  7, part 3), corrupt-checkpoint fallback, and a progress watchdog
  naming the stuck phase.

Recovery telemetry lands in the profiler's ``resilience`` section
(:func:`resilience_stats`).
"""
from .faults import (FaultInjected, FaultPlan, FaultSpec,  # noqa: F401
                     PeerDeathFault, TransientFault, armed, clear_plan,
                     install_from_env, install_plan, parse_plan)
from .retry import RetryPolicy  # noqa: F401
from .stats import resilience_stats, reset_resilience_stats  # noqa: F401
from .supervisor import (Preempted, ResumeRequired, RunContext,  # noqa: F401
                         Supervisor, WatchdogTimeout, classify)
