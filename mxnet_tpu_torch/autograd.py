"""Recording and training-mode flags (ref: python/mxnet/autograd.py).

Only the flags inference reads are ported: ``record`` turns PyTorch's
gradient tracking on for the blocks called inside it; outside ``record``
every block runs under ``torch.no_grad``.  ``backward`` and the tape
come with the training slice.
"""
from __future__ import annotations

import threading

_state = threading.local()


def _st():
    if not hasattr(_state, "recording"):
        _state.recording = False
        _state.training = False
    return _state


class _RecordingScope:
    def __init__(self, recording, training):
        self._rec, self._train = recording, training

    def __enter__(self):
        st = _st()
        self._old = (st.recording, st.training)
        st.recording, st.training = self._rec, self._train
        return self

    def __exit__(self, *exc):
        st = _st()
        st.recording, st.training = self._old


def record(train_mode=True):
    return _RecordingScope(True, train_mode)


def pause(train_mode=False):
    return _RecordingScope(False, train_mode)


def is_recording():
    return _st().recording


def is_training():
    return _st().training
