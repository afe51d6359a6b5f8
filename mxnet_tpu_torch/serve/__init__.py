"""mxnet_tpu_torch.serve: dynamic-batching inference serving::

    from mxnet_tpu_torch import serve

    spec = serve.BucketSpec(batch_sizes=(1, 4, 8), example_shape=(None,),
                            lengths=(128, 256, 512), dtype="int32")
    with serve.ModelServer(net, spec) as srv:
        result = srv.submit(token_ids).result()
        print(srv.stats())
"""
from .batcher import (Batcher, DeadlineExceededError,  # noqa: F401
                      ServerClosedError, ServerOverloadedError)
from .buckets import BucketOverflowError, BucketSpec  # noqa: F401
from .server import ModelServer  # noqa: F401
from .stats import LatencyWindow, ServerStats  # noqa: F401
