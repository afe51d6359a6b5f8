"""Module API (ref: python/mxnet/module/)."""
from .module import (Module, BaseModule, save_checkpoint,  # noqa: F401
                     load_checkpoint)
from .bucketing_module import BucketingModule  # noqa: F401
