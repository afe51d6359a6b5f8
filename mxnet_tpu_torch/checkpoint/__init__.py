"""mxnet_tpu_torch.checkpoint — atomic, async, resumable checkpoints (ref:
``mxnet_tpu/checkpoint/``).

``CheckpointManager`` writes the JAX package's layout, so either package
restores the other's checkpoints; a checkpoint of another world size is
resharded onto this job's (``reshard``).
"""
from .atomic import atomic_file, fsync_dir, fsync_file, write_json  # noqa: F401
from .manager import MANIFEST, CheckpointManager, latest  # noqa: F401
from .reshard import (merge_pipeline_states,  # noqa: F401
                      reshard_zero_snapshot, source_rank)
