"""Random number handling (ref: python/mxnet/random.py).

One explicit ``torch.Generator`` per device, owned by a
:class:`GeneratorPool`.  ``seed(s)`` reseeds every generator of the
process pool in place; initializers and dropout draw from the generator of
the device they fill.  A captured training step registers its device's
generators with its CUDA graph (:meth:`GeneratorPool.generators`), so
each replay advances them as the eager step does and dropout draws the
same masks; reseeding in place keeps those registrations valid.  A CPU and a CUDA generator seeded alike give
different numbers, so tests make shared inputs with numpy.

Host-side draws (``io.NDArrayIter``'s shuffle) come from :func:`np_rng`,
the framework's numpy ``RandomState``, which ``seed(s)`` seeds with
``s & 0x7FFFFFFF`` as the JAX package does, so a shuffled iterator gives
the same order in both packages after the same ``mx.random.seed``.

``get_state``/``set_state`` snapshot and restore the pool and the numpy
stream as JSON (the checkpoint's ``rng-shard0.json``).  ``set_state`` writes into the
generators in place (``Generator.set_state``), so the graphs that
registered them draw, at their next replay, what an uninterrupted run
would draw.  A JAX package's file (a threefry key, a counter and a numpy
stream) cannot be continued by torch generators: ``set_state`` logs a
warning and leaves the generators as they are, and restores its numpy
stream, whose format both packages share.
"""
from __future__ import annotations

import logging
import threading

import numpy as np
import torch


class GeneratorPool:
    """Seeded ``torch.Generator``s, one per device, created on first use.

    A pool has a *stream* (0 unless :meth:`set_stream` says otherwise): its
    generators are seeded from ``(seed, stream)``, ``seed`` itself for
    stream 0.  The ``DataParallelTrainer`` gives a rank of a mesh its data
    coordinate as its stream when it builds on a mesh of more than one
    rank, so data ranks draw different dropout masks and the
    tensor-parallel ranks of one data group, which compute the same rows,
    draw the same ones."""

    def __init__(self, seed_state=None):
        self._lock = threading.Lock()
        self._gens = {}
        self._stream = 0
        self.seed(seed_state)

    def _stream_seed(self):
        if not self._stream:
            return self._seed
        return (self._seed + self._stream * 0x9E3779B97F4A7C15) % (1 << 63)

    def seed(self, seed_state=None):
        if seed_state is None:
            seed_state = int(np.random.randint(0, 2**31 - 1))
        with self._lock:
            self._seed = int(seed_state)
            for gen in self._gens.values():
                gen.manual_seed(self._stream_seed())

    def set_stream(self, stream):
        """Seed every generator from ``(seed, stream)`` in place, from the
        start of that stream whatever was drawn before."""
        with self._lock:
            self._stream = int(stream)
            for gen in self._gens.values():
                gen.manual_seed(self._stream_seed())

    def generator(self, device):
        """The generator for ``device`` (a ``torch.device`` or string)."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        with self._lock:
            gen = self._gens.get(device)
            if gen is None:
                gen = torch.Generator(device=device)
                gen.manual_seed(self._stream_seed())
                self._gens[device] = gen
            return gen

    def generators(self, device):
        """The generators made so far for ``device``."""
        device = torch.device(device)
        with self._lock:
            return [g for d, g in self._gens.items() if d.type == device.type
                    and (device.index is None or d.index == device.index)]

    def get_state(self):
        """``{"seed": s, "generators": {device: state bytes as a list}}``
        (and ``"stream"`` where it is not 0)."""
        with self._lock:
            state = {"seed": self._seed,
                     "generators": {str(d): g.get_state().tolist()
                                    for d, g in self._gens.items()}}
            if self._stream:
                state["stream"] = self._stream
            return state

    def set_state(self, state):
        """Inverse of :meth:`get_state`, in place: each saved device's
        generator (made through the pool if this process has none yet) is
        set with ``Generator.set_state``; no generator is replaced."""
        with self._lock:
            self._seed = int(state["seed"])
            self._stream = int(state.get("stream", 0))
        for dev, raw in state["generators"].items():
            dev = torch.device(dev)
            if dev.type == "cuda" and not torch.cuda.is_available():
                _log.warning("random.set_state: no CUDA device here; the "
                             "saved state of %s is not restored", dev)
                continue
            self.generator(dev).set_state(
                torch.tensor(raw, dtype=torch.uint8))


_log = logging.getLogger("mxnet_tpu_torch.random")

#: Torch runs one CUDA graph capture at a time in a process; a capture
#: registers every generator of its device, and torch fails a draw made
#: outside the capture on a generator one holds ("Offset increment outside
#: graph capture encountered unexpectedly"); and a device-wide
#: synchronisation on another thread during a capture fails and
#: invalidates it.  So captures (``gluon/whole_step.py:CapturedStep``),
#: parameter initializations (``initializer.py``) and servers' warm-ups
#: (``serve/server.py``, ``serve/decode.py``: they synchronise the device)
#: take turns under this lock: a router's warm spare and a scale-up warm up
#: one after the other.
capture_lock = threading.RLock()

#: the process-wide pool behind :func:`seed` and :func:`generator`
default_pool = GeneratorPool()

# the framework's seeded numpy generator (ref: mxnet_tpu/random.py:31)
_np_rng = np.random.RandomState()
_np_lock = threading.Lock()


def np_rng():
    """The framework's seeded numpy generator (host-side draws such as
    ``io.NDArrayIter``'s shuffle)."""
    return _np_rng


def seed(seed_state=None, ctx="all"):
    """Seed the generators of every device and the numpy stream (ref:
    mx.random.seed)."""
    if seed_state is None:
        seed_state = int(np.random.randint(0, 2**31 - 1))
    default_pool.seed(seed_state)
    with _np_lock:
        _np_rng.seed(int(seed_state) & 0x7FFFFFFF)


def _np_state():
    mt = _np_rng.get_state()
    return [mt[0], np.asarray(mt[1]).tolist(), int(mt[2]), int(mt[3]),
            float(mt[4])]


def _set_np_state(mt):
    _np_rng.set_state((mt[0], np.asarray(mt[1], dtype=np.uint32),
                       int(mt[2]), int(mt[3]), float(mt[4])))


def generator(device):
    """The default pool's generator for ``device``."""
    return default_pool.generator(device)


def get_state():
    """JSON-serializable snapshot of the default pool (its seed and each
    generator's state) and of the numpy stream under ``"numpy"``, in the
    JAX package's layout (ref: ``mx.random.get_state``)."""
    state = default_pool.get_state()
    with _np_lock:
        state["numpy"] = _np_state()
    return state


def set_state(state):
    """Restore :func:`get_state`'s snapshot in place.  A JAX package's
    snapshot (``jax_base_key``) cannot be continued by torch generators:
    it logs a warning and leaves them as they are; its numpy stream, in
    the same layout as the port's, is restored."""
    mt = state.get("numpy")
    if mt is not None:
        with _np_lock:
            _set_np_state(mt)
    if "generators" not in state:
        _log.warning("random.set_state: %s is a JAX package RNG state, "
                     "which torch generators cannot continue; the "
                     "generators are left as they are%s",
                     sorted(state), "" if mt is None
                     else " (its numpy stream is restored)")
        return
    default_pool.set_state(state)
