"""Replica worker entry point (ref: ``mxnet_tpu/serve/control_plane/
worker.py``)::

    python -m mxnet_tpu_torch.serve.control_plane.worker \\
        --registry /shared/ctrl --id 0 --kind decode --seed 4

Builds a deterministic demo server (every worker launched with the same
``--seed`` holds bit-identical weights, so failover between replicas
cannot be seen in the outputs), runs its full warm-up ``start()``, and
only THEN registers the endpoint's lease: a replica a router can discover
is a replica that will not warm up in traffic.  Runs until SIGTERM or
SIGINT.

``--ctx`` (default ``gpu(0)``) is the device the server runs on; the JAX
worker takes its platform from ``JAX_PLATFORMS`` instead.  Without a CUDA
device and without ``--ctx cpu()`` the worker exits with code 2 before
it registers, and the spawner's error quotes its log.

Real deployments supply their own worker that loads real weights; the
contract is only "start() before serve_replica()".
"""
from __future__ import annotations

import argparse
import re
import signal
import sys
import threading


def _csv_ints(s):
    return tuple(int(x) for x in s.split(",") if x)


def _parse_ctx(mx, text):
    """``gpu(N)``, ``cpu()``, ``cpu(N)``, ``gpu`` or ``cpu`` as a Context."""
    m = re.fullmatch(r"\s*(cpu|gpu)\s*(?:\(\s*(\d*)\s*\))?\s*", text)
    if m is None:
        raise SystemExit(f"--ctx {text!r}: expected gpu(N) or cpu()")
    make = mx.gpu if m.group(1) == "gpu" else mx.cpu
    return make(int(m.group(2) or 0))


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="mxnet_tpu_torch control-plane replica worker")
    ap.add_argument("--registry", required=True,
                    help="shared lease/registry directory")
    ap.add_argument("--id", required=True, help="replica id (lease key)")
    ap.add_argument("--kind", choices=("decode", "model"),
                    default="decode")
    ap.add_argument("--seed", type=int, default=4,
                    help="weight seed: the same seed gives bit-identical "
                         "replicas")
    ap.add_argument("--ctx", default="gpu(0)",
                    help="device of the server: gpu(N) (default gpu(0)) "
                         "or cpu()")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    # decode knobs
    ap.add_argument("--vocab", type=int, default=64)
    ap.add_argument("--embed", type=int, default=16)
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=32)
    # shared bucket grid
    ap.add_argument("--batch-sizes", type=_csv_ints, default=(1, 2))
    ap.add_argument("--lengths", type=_csv_ints, default=(4, 8))
    # model (ModelServer) knobs
    ap.add_argument("--feat", type=int, default=6)
    ap.add_argument("--out-units", type=int, default=5)
    ap.add_argument("--max-queue", type=int, default=64)
    args = ap.parse_args(argv)

    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import serve
    from mxnet_tpu_torch.serve.control_plane import serve_replica

    ctx = _parse_ctx(mx, args.ctx)
    if ctx.device_type == "gpu" and not torch.cuda.is_available():
        print(f"replica {args.id}: --ctx {args.ctx} but no CUDA device is "
              "visible (pass --ctx 'cpu()' to serve on the CPU)",
              file=sys.stderr, flush=True)
        return 2
    mx.random.seed(args.seed)
    if args.kind == "decode":
        model = serve.TinyDecoder(vocab=args.vocab, embed=args.embed)
        model.initialize(mx.init.Xavier(), ctx=ctx)
        spec = serve.BucketSpec(batch_sizes=args.batch_sizes,
                                example_shape=(None,),
                                lengths=args.lengths, dtype="int32")
        server = serve.DecodeServer(model, spec, max_slots=args.max_slots,
                                    max_len=args.max_len, ctx=ctx)
    else:
        from mxnet_tpu_torch.gluon import nn

        model = nn.HybridSequential()
        model.add(nn.Dense(8, flatten=False, in_units=args.feat,
                           activation="relu"),
                  nn.Dense(args.out_units, flatten=False, in_units=8))
        model.initialize(mx.init.Xavier(), ctx=ctx)
        spec = serve.BucketSpec(batch_sizes=args.batch_sizes,
                                example_shape=(None, args.feat),
                                lengths=args.lengths)
        server = serve.ModelServer(model, spec, max_queue=args.max_queue,
                                   ctx=ctx)

    server.start()          # the full warm-up, BEFORE registering
    endpoint = serve_replica(server, host=args.host, port=args.port,
                             registry_dir=args.registry,
                             replica_id=args.id)
    print(f"replica {args.id} ({args.kind}, {ctx}) serving on "
          f"{endpoint.host}:{endpoint.port}", flush=True)

    done = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: done.set())
    done.wait()
    endpoint.stop()
    server.shutdown(drain=False, timeout=10.0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
