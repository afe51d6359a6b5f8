"""Utilities of the port (ref: ``mxnet_tpu/utils/``): the NDArray file
container (``serialization``), the native-library loader (``libloader``)
and the binding of the host-side C++ engine (``native_engine``)."""
from . import libloader, native_engine, serialization  # noqa: F401
