"""Learning-rate schedulers (ref: python/mxnet/lr_scheduler.py; a copy of
``mxnet_tpu/lr_scheduler.py``, which imports no JAX)."""
from __future__ import annotations

import math

from .base import MXNetError


class LRScheduler:
    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0,
                 warmup_mode="linear"):
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_final_lr = base_lr
        self.warmup_mode = warmup_mode

    def get_warmup_lr(self, num_update):
        assert num_update < self.warmup_steps
        if self.warmup_mode == "linear":
            inc = (self.warmup_final_lr - self.warmup_begin_lr) \
                * num_update / self.warmup_steps
            return self.warmup_begin_lr + inc
        if self.warmup_mode == "constant":
            return self.warmup_begin_lr
        raise MXNetError(f"unknown warmup mode {self.warmup_mode}")

    def __call__(self, num_update):
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    """lr *= factor every `step` updates (ref: FactorScheduler)."""

    def __init__(self, step, factor=1.0, stop_factor_lr=1e-8, base_lr=0.01,
                 **kwargs):
        super().__init__(base_lr, **kwargs)
        if step < 1:
            raise MXNetError("schedule step must be >= 1")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0
        self._cur_lr = None

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        lr = self.base_lr * (self.factor ** (num_update // self.step))
        return max(lr, self.stop_factor_lr)


class MultiFactorScheduler(LRScheduler):
    """lr *= factor at each milestone in `step` (ref: MultiFactorScheduler)."""

    def __init__(self, step, factor=1.0, base_lr=0.01, **kwargs):
        super().__init__(base_lr, **kwargs)
        assert all(step[i] < step[i + 1] for i in range(len(step) - 1))
        self.step = step
        self.factor = factor

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        lr = self.base_lr
        for s in self.step:
            if num_update >= s:
                lr *= self.factor
        return lr


class PolyScheduler(LRScheduler):
    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0,
                 **kwargs):
        super().__init__(base_lr, **kwargs)
        self.max_update = max_update
        self.power = pwr
        self.final_lr = final_lr
        self.max_steps = max_update - self.warmup_steps

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update >= self.max_update:
            return self.final_lr
        frac = (num_update - self.warmup_steps) / self.max_steps
        return self.final_lr + (self.base_lr - self.final_lr) \
            * ((1 - frac) ** self.power)


class CosineScheduler(LRScheduler):
    def __init__(self, max_update, base_lr=0.01, final_lr=0, **kwargs):
        super().__init__(base_lr, **kwargs)
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = max_update - self.warmup_steps

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update >= self.max_update:
            return self.final_lr
        frac = (num_update - self.warmup_steps) / self.max_steps
        return self.final_lr + (self.base_lr - self.final_lr) \
            * (1 + math.cos(math.pi * frac)) / 2
