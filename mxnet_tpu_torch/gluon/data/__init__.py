"""gluon.data (ref: ``mxnet_tpu/gluon/data/``): datasets, samplers, the
``DataLoader`` over the pipeline tier, and ``vision``."""
from .dataset import (Dataset, SimpleDataset, ArrayDataset,  # noqa: F401
                      RecordFileDataset)
from .sampler import (Sampler, SequentialSampler, RandomSampler,  # noqa: F401
                      BatchSampler, FilterSampler)
from .dataloader import DataLoader  # noqa: F401
from . import vision  # noqa: F401
