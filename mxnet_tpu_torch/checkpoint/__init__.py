"""mxnet_tpu_torch.checkpoint — atomic, async, resumable checkpoints (ref:
``mxnet_tpu/checkpoint/``).

``CheckpointManager`` writes the JAX package's layout, so either package
restores the other's checkpoints.  The reference's ``reshard`` module
(ZeRO shards and per-rank pipeline cursors onto another world size)
comes with slice 7, part 2b.
"""
from .atomic import atomic_file, fsync_dir, fsync_file, write_json  # noqa: F401
from .manager import MANIFEST, CheckpointManager, latest  # noqa: F401
