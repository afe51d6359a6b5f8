"""Random number handling (ref: python/mxnet/random.py).

One explicit ``torch.Generator`` per device, owned by a
:class:`GeneratorPool`.  ``seed(s)`` reseeds every generator of the
process pool in place; initializers and dropout draw from the generator of
the device they fill.  A captured training step registers its device's
generators with its CUDA graph (:meth:`GeneratorPool.generators`), so
each replay advances them as the eager step does and dropout draws the
same masks; reseeding in place keeps those registrations valid.  A CPU and a CUDA generator seeded alike give
different numbers, so tests make shared inputs with numpy.
"""
from __future__ import annotations

import threading

import numpy as np
import torch


class GeneratorPool:
    """Seeded ``torch.Generator``s, one per device, created on first use."""

    def __init__(self, seed_state=None):
        self._lock = threading.Lock()
        self._gens = {}
        self.seed(seed_state)

    def seed(self, seed_state=None):
        if seed_state is None:
            seed_state = int(np.random.randint(0, 2**31 - 1))
        with self._lock:
            self._seed = int(seed_state)
            for gen in self._gens.values():
                gen.manual_seed(self._seed)

    def generator(self, device):
        """The generator for ``device`` (a ``torch.device`` or string)."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        with self._lock:
            gen = self._gens.get(device)
            if gen is None:
                gen = torch.Generator(device=device)
                gen.manual_seed(self._seed)
                self._gens[device] = gen
            return gen

    def generators(self, device):
        """The generators made so far for ``device``."""
        device = torch.device(device)
        with self._lock:
            return [g for d, g in self._gens.items() if d.type == device.type
                    and (device.index is None or d.index == device.index)]


#: the process-wide pool behind :func:`seed` and :func:`generator`
default_pool = GeneratorPool()


def seed(seed_state=None, ctx="all"):
    """Seed the generators of every device (ref: mx.random.seed)."""
    default_pool.seed(seed_state)


def generator(device):
    """The default pool's generator for ``device``."""
    return default_pool.generator(device)
