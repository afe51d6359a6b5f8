"""gluon.nn layers (ref: python/mxnet/gluon/nn/)."""
from ..block import Block, HybridBlock  # noqa: F401
from .basic_layers import (ELU, GELU, SELU, Activation,  # noqa: F401
                           BatchNorm, Dense, Dropout, Embedding, Flatten,
                           GroupNorm, HybridLambda, HybridSequential,
                           InstanceNorm, Lambda, LayerNorm, LeakyReLU, PReLU,
                           Sequential, Swish)
from .conv_layers import (AvgPool1D, AvgPool2D, AvgPool3D,  # noqa: F401
                          Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose,
                          Conv3D, Conv3DTranspose, GlobalAvgPool1D,
                          GlobalAvgPool2D, GlobalAvgPool3D, GlobalMaxPool1D,
                          GlobalMaxPool2D, GlobalMaxPool3D, MaxPool1D,
                          MaxPool2D, MaxPool3D, ReflectionPad2D)
