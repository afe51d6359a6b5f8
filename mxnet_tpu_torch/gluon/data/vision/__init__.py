"""gluon.data.vision (ref: ``mxnet_tpu/gluon/data/vision/``)."""
from . import transforms  # noqa: F401
from .datasets import (MNIST, FashionMNIST, CIFAR10, CIFAR100,  # noqa: F401
                       ImageRecordDataset, ImageFolderDataset)
