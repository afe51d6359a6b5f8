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

    factory = lambda rid: serve.ModelServer(make_net(), spec)
    with serve.Router(factory, 3, evict_after=2) as router:
        result = router.submit(token_ids, deadline_ms=500).result()

``serve.ControlPlane`` fronts replicas in worker processes with the same
router (``serve/control_plane/``).
"""
from .batcher import (Batcher, DeadlineExceededError,  # noqa: F401
                      ServerClosedError, ServerOverloadedError)
from .buckets import BucketOverflowError, BucketSpec  # noqa: F401
from .decode import (DecodeHandle, DecodeServer,  # noqa: F401
                     TinyDecoder, TinyDraft)
from .paging import (PageAllocator, PrefixIndex,  # noqa: F401
                     chunk_keys, pages_spanned)
from .router import (NoHealthyReplicaError, PooledStreamHandle,  # noqa: F401
                     Replica, ReplicaPool, Router,
                     TenantQuotaExceededError)
from .server import ModelServer  # noqa: F401
from .stats import LatencyWindow, ServerStats  # noqa: F401
from .control_plane import (Autoscaler, ControlPlane,  # noqa: F401,E402
                            RPCConnectionError, RemoteReplica,
                            ReplicaEndpoint, ReplicaProcess,
                            ReplicaSpawnError, serve_replica)
