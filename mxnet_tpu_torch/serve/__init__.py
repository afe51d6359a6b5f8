"""mxnet_tpu_torch.serve: dynamic-batching inference serving and
continuous-batching decode::

    from mxnet_tpu_torch import serve

    spec = serve.BucketSpec(batch_sizes=(1, 4, 8), example_shape=(None,),
                            lengths=(128, 256, 512), dtype="int32")
    with serve.ModelServer(net, spec, checkpoint="/ckpts") as srv:
        result = srv.submit(token_ids).result()
        print(srv.stats())

    dspec = serve.BucketSpec(batch_sizes=(1, 2, 4, 8), example_shape=(None,),
                             lengths=(4, 8, 16), dtype="int32")
    with serve.DecodeServer(model, dspec, max_slots=16, max_len=96) as dec:
        tokens = dec.generate(prompt, max_new_tokens=32)

The router and the control plane come with slice 5, part 2 of the port.
"""
from .batcher import (Batcher, DeadlineExceededError,  # noqa: F401
                      ServerClosedError, ServerOverloadedError)
from .buckets import BucketOverflowError, BucketSpec  # noqa: F401
from .decode import (DecodeHandle, DecodeServer,  # noqa: F401
                     TinyDecoder, TinyDraft)
from .paging import (PageAllocator, PrefixIndex,  # noqa: F401
                     chunk_keys, pages_spanned)
from .server import ModelServer  # noqa: F401
from .stats import LatencyWindow, ServerStats  # noqa: F401
