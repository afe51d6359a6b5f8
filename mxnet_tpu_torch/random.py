"""Random number handling (ref: python/mxnet/random.py).

One explicit ``torch.Generator`` per device, owned by a
:class:`GeneratorPool`.  ``seed(s)`` reseeds every generator of the
process pool in place; initializers and dropout draw from the generator of
the device they fill.  A captured training step registers its device's
generators with its CUDA graph (:meth:`GeneratorPool.generators`), so
each replay advances them as the eager step does and dropout draws the
same masks; reseeding in place keeps those registrations valid.  A CPU and a CUDA generator seeded alike give
different numbers, so tests make shared inputs with numpy.

``get_state``/``set_state`` snapshot and restore the pool as JSON (the
checkpoint's ``rng-shard0.json``).  ``set_state`` writes into the
generators in place (``Generator.set_state``), so the graphs that
registered them draw, at their next replay, what an uninterrupted run
would draw.  A JAX package's file (a threefry key, a counter and a numpy
stream) cannot be continued by torch generators: ``set_state`` logs a
warning and leaves the generators as they are.
"""
from __future__ import annotations

import logging
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

    def get_state(self):
        """``{"seed": s, "generators": {device: state bytes as a list}}``."""
        with self._lock:
            return {"seed": self._seed,
                    "generators": {str(d): g.get_state().tolist()
                                   for d, g in self._gens.items()}}

    def set_state(self, state):
        """Inverse of :meth:`get_state`, in place: each saved device's
        generator (made through the pool if this process has none yet) is
        set with ``Generator.set_state``; no generator is replaced."""
        with self._lock:
            self._seed = int(state["seed"])
        for dev, raw in state["generators"].items():
            dev = torch.device(dev)
            if dev.type == "cuda" and not torch.cuda.is_available():
                _log.warning("random.set_state: no CUDA device here; the "
                             "saved state of %s is not restored", dev)
                continue
            self.generator(dev).set_state(
                torch.tensor(raw, dtype=torch.uint8))


_log = logging.getLogger("mxnet_tpu_torch.random")

#: the process-wide pool behind :func:`seed` and :func:`generator`
default_pool = GeneratorPool()


def seed(seed_state=None, ctx="all"):
    """Seed the generators of every device (ref: mx.random.seed)."""
    default_pool.seed(seed_state)


def generator(device):
    """The default pool's generator for ``device``."""
    return default_pool.generator(device)


def get_state():
    """JSON-serializable snapshot of the default pool: its seed and each
    generator's state (ref: ``mx.random.get_state``)."""
    return default_pool.get_state()


def set_state(state):
    """Restore :func:`get_state`'s snapshot in place.  A JAX package's
    snapshot (``jax_base_key``) cannot be continued by torch generators:
    it logs a warning and changes nothing."""
    if "generators" not in state:
        _log.warning("random.set_state: %s is a JAX package RNG state, "
                     "which torch generators cannot continue; the "
                     "generators are left as they are",
                     sorted(state))
        return
    default_pool.set_state(state)
