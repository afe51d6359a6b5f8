"""Parallel training (ref: ``mxnet_tpu/parallel/``): ``dist``, the process
group and its collectives on ``torch.distributed`` (slice 7, part 1), and
the one-device ``DataParallelTrainer``.  Meshes (``mesh.py``,
``spmd/``), a ``DataParallelTrainer`` over several devices and ZeRO come
with slice 7, part 2; ``ring_attention``, ``ulysses``, ``moe``,
``pipeline_lm``, ``ps`` and elastic resizing with part 3 (ROADMAP queue
1)."""
from . import data_parallel, dist  # noqa: F401
from .data_parallel import DataParallelTrainer  # noqa: F401
