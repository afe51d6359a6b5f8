"""Monitor: tap layer outputs for debugging (ref: python/mxnet/monitor.py;
``mxnet_tpu/monitor.py`` of the JAX package): the reference's executor
output callback as gluon forward hooks.  ``Module.fit(monitor=)`` takes
one and, as in the JAX package, installs nothing on the executors."""
from __future__ import annotations

import re

import numpy as np
import torch

from .ndarray.ndarray import NDArray


def _host(o):
    t = o.data if isinstance(o, NDArray) else o
    return t.detach().float().cpu().numpy()


def _default_stat(x):
    return np.abs(x).mean()


class Monitor:
    """Ref: mx.mon.Monitor(interval, stat_func, pattern)."""

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        self.interval = interval
        self.stat_func = stat_func or _default_stat
        self.pattern = re.compile(pattern)
        self.sort = sort
        self.step = 0
        self.activated = False
        self.queue = []
        self._handles = []

    def install(self, block):
        """Attach to a Gluon block tree (the executor-callback analogue)."""

        def make_hook(name):
            def hook(blk, inputs, output):
                if not self.activated:
                    return
                outs = output if isinstance(output, (list, tuple)) \
                    else [output]
                for i, o in enumerate(outs):
                    if isinstance(o, (NDArray, torch.Tensor)) \
                            and self.pattern.match(name):
                        self.queue.append(
                            (self.step, f"{name}_output{i}",
                             self.stat_func(_host(o))))

            return hook

        def walk(blk, prefix):
            for cname, child in blk._children.items():
                full = f"{prefix}{cname}"
                self._handles.append(
                    child.register_forward_hook(make_hook(full)))
                walk(child, full + ".")

        walk(block, "")
        return self

    def tic(self):
        if self.step % self.interval == 0:
            self.activated = True
            self.queue = []

    def toc(self):
        if not self.activated:
            return []
        self.activated = False
        res = sorted(self.queue) if self.sort else list(self.queue)
        self.step += 1
        return res

    def toc_print(self):
        for step, name, value in self.toc():
            print(f"Batch {step:>7d} {name:<40s} {value:g}")
