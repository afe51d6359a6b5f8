"""LeNet (ref: ``mxnet_tpu/gluon/model_zoo/vision/others.py:11-27,271``,
BASELINE.json's LeNet/MNIST model).  AlexNet, VGG, MobileNet, SqueezeNet
and DenseNet of the same file come with slice 9 of the port."""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn


class LeNet(HybridBlock):
    """The BASELINE LeNet/MNIST model (ref: example/image-classification):
    two tanh 5x5 convolutions (20, 50 channels), each max-pooled 2x2, a
    500-unit tanh Dense and the classifier."""

    def __init__(self, classes=10, **kwargs):
        super().__init__(**kwargs)
        self.features = nn.HybridSequential()
        self.features.add(
            nn.Conv2D(20, kernel_size=5, activation="tanh"),
            nn.MaxPool2D(2, 2),
            nn.Conv2D(50, kernel_size=5, activation="tanh"),
            nn.MaxPool2D(2, 2),
            nn.Flatten(),
            nn.Dense(500, activation="tanh"))
        self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def lenet(**kw):
    return LeNet(**kw)
