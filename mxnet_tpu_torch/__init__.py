"""mxnet_tpu_torch: the PyTorch/CUDA port of mxnet_tpu for NVIDIA Hopper.

``import mxnet_tpu_torch as mx`` gives the MXNet surface of the JAX
package, computed with PyTorch, with the JAX package's Pallas kernels
replaced by CUDA kernels written for the H100 (``csrc/``).  Entry points
run on ``gpu(0)`` unless the caller asks for ``cpu()``; without a CUDA
device they raise rather than fall back.
"""
from .base import MXNetError, __version__, getenv  # noqa: F401
from .context import (Context, cpu, current_context, gpu,  # noqa: F401
                      num_gpus, xla)
from . import ndarray  # noqa: F401
from . import ndarray as nd  # noqa: F401
from .ndarray import waitall  # noqa: F401
from . import autograd, lr_scheduler, ops, optimizer, random  # noqa: F401
from . import initializer  # noqa: F401
from . import initializer as init  # noqa: F401
from . import gluon  # noqa: F401
from . import models, parallel, serve  # noqa: F401
from . import checkpoint, utils  # noqa: F401
from . import kvstore  # noqa: F401
from . import kvstore as kv  # noqa: F401
from . import data, image, io, rnn  # noqa: F401
from .io import recordio  # noqa: F401
from . import engine, metric, pipeline, storage  # noqa: F401
# the observability and recovery tiers; importing telemetry arms what
# MXTPU_TRACE / MXTPU_FLIGHT_RECORDER / MXTPU_METRICS_PORT ask for
from . import log, profiler, resilience, telemetry  # noqa: F401
from .convert import load_numpy_params  # noqa: F401
# the symbolic API (ref: mxnet_tpu/__init__.py:24-85)
from . import symbol  # noqa: F401
from . import symbol as sym  # noqa: F401
from . import attribute, callback, executor, model, name  # noqa: F401
from . import operator  # noqa: F401
from . import module  # noqa: F401
from . import module as mod  # noqa: F401
from . import monitor  # noqa: F401
from . import monitor as mon  # noqa: F401
from .symbol import AttrScope  # noqa: F401

# tiers imported on first use, as the JAX package imports them: the int8
# tier (``mx.contrib.quantization``), the autotuner (``mx.tune``) and
# mixed precision (``mx.amp``)
_LAZY = {"contrib": ".contrib", "tune": ".tune",
         "kvstore_server": ".kvstore_server", "amp": ".amp"}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(_LAZY[name], __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module 'mxnet_tpu_torch' has no attribute "
                         f"{name!r}")
