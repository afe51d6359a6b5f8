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
from . import autograd, lr_scheduler, ops, optimizer, random  # noqa: F401
from . import initializer  # noqa: F401
from . import initializer as init  # noqa: F401
from . import gluon  # noqa: F401
from . import models, parallel, serve  # noqa: F401
from . import checkpoint, utils  # noqa: F401
from . import kvstore  # noqa: F401
from . import kvstore as kv  # noqa: F401
from . import data, io, rnn  # noqa: F401
from .convert import load_numpy_params  # noqa: F401
