"""mxnet_tpu_torch.pipeline — the device-prefetching, checkpointable input
pipeline (ref: ``mxnet_tpu/pipeline/``)::

    from mxnet_tpu_torch import pipeline

    pipe = (pipeline.Pipeline(dataset)
            .shuffle(1024, seed=7)
            .map(augment)
            .batch(32, bucket_spec=spec)
            .shard(num_replicas, rank)
            .prefetch_to_device(mx.gpu(0), depth=2))
    mgr.save(step, params=net, trainer=trainer, pipeline=pipe)

Host stages keep their arrays on ``cpu()``; ``prefetch_to_device`` moves
each batch to the card through one ``engine.batched_put`` (pinned
staging, a copy stream, an event the consumer's stream waits on).
"""
from .stages import (Pipeline, Stage, DatasetSource,  # noqa: F401
                     IterableSource, ShuffleStage, MapStage, BatchStage,
                     RebatchStage, ShardStage, PrefetchToDeviceStage,
                     default_batchify)
from .stats import pipeline_stats, reset_pipeline_stats  # noqa: F401
