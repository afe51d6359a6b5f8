"""Parallel training (ref: ``mxnet_tpu/parallel/``): the one-device
``DataParallelTrainer``; meshes and the distributed paths come with a
later slice (ROADMAP queue 1, slice 7)."""
from . import data_parallel  # noqa: F401
from .data_parallel import DataParallelTrainer  # noqa: F401
