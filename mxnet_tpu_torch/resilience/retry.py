"""Bounded-exponential-backoff retry policy — the supervisor's recovery
knob for the 'transient' fault class (ref: ``mxnet_tpu/resilience/
retry.py``; the jitter is drawn from numpy as there, so the delays are
the JAX class's for the same seed).

Deterministic: with ``jitter`` enabled the perturbation comes from the
policy's own seeded RNG, so a rehearsed recovery schedule replays
exactly (the same property :mod:`.faults` guarantees on the injection
side).
"""
from __future__ import annotations

import time

import numpy as np

from ..base import MXNetError


class RetryPolicy:
    """``delay_for(attempt)`` grows ``base_delay * multiplier**(n-1)``
    capped at ``max_delay``; ``should_retry`` bounds total attempts.

    max_retries : failures tolerated before giving up (0 = never retry)
    base_delay  : first backoff sleep, seconds
    max_delay   : backoff cap, seconds
    multiplier  : exponential growth factor
    jitter      : +/- fraction of the delay drawn from the seeded RNG
                  (0 disables; keeps herds of workers from re-trying in
                  lockstep while staying replayable)
    """

    def __init__(self, max_retries=5, base_delay=0.05, max_delay=2.0,
                 multiplier=2.0, jitter=0.0, seed=0):
        if max_retries < 0:
            raise MXNetError(f"max_retries must be >= 0, got {max_retries}")
        if base_delay < 0 or max_delay < 0 or multiplier < 1:
            raise MXNetError(
                f"need base_delay/max_delay >= 0 and multiplier >= 1, got "
                f"base_delay={base_delay} max_delay={max_delay} "
                f"multiplier={multiplier}")
        if not 0.0 <= jitter < 1.0:
            raise MXNetError(f"jitter must be in [0, 1), got {jitter}")
        self.max_retries = int(max_retries)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.seed = int(seed)
        self._rng = np.random.RandomState(self.seed & 0x7FFFFFFF)

    def should_retry(self, attempt):
        """``attempt`` = 1-based count of failures so far."""
        return int(attempt) <= self.max_retries

    def delay_for(self, attempt):
        """Backoff before retry number ``attempt`` (1-based), seconds."""
        n = max(int(attempt), 1)
        d = min(self.base_delay * self.multiplier ** (n - 1),
                self.max_delay)
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * float(self._rng.random_sample())
                                      - 1.0)
        return d

    def call(self, fn, *args, retriable=None, on_retry=None, **kwargs):
        """Run ``fn`` retrying ``retriable`` exception types with this
        policy's backoff.  ``on_retry(attempt, exc)`` (optional) is
        called before each sleep — the supervisor uses it to book the
        retry into the resilience stats."""
        if retriable is None:
            from .faults import TransientFault

            retriable = (TransientFault,)
        attempt = 0
        while True:
            try:
                return fn(*args, **kwargs)
            except retriable as e:
                attempt += 1
                if not self.should_retry(attempt):
                    raise
                if on_retry is not None:
                    on_retry(attempt, e)
                time.sleep(self.delay_for(attempt))
