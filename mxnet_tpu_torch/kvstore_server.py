"""The parameter-server process (ref: ``mxnet_tpu/kvstore_server.py``;
python/mxnet/kvstore_server.py, the MXKVStoreRunServer role).

The launcher starts it for ``-s N`` with ``DMLC_ROLE=server``; it serves
the ``dist_async`` transport (``parallel/ps.py``) on the host, never on a
card, and blocks until a worker sends ``("stop",)``::

    python -m mxnet_tpu_torch.kvstore_server
"""
from .parallel import ps


def main():
    ps.run_server()


if __name__ == "__main__":
    main()
