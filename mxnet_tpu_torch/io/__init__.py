"""IO (ref: ``mxnet_tpu/io/``): the batch descriptors, the iterators
(``NDArrayIter``, ``MNISTIter``, ``CSVIter``, ``LibSVMIter``,
``PrefetchingIter``, ``ResizeIter``), ``DataIter.as_pipeline`` and
``recordio``.  ``ImageRecordIter`` and ``ImageDetRecordIter`` need the
image tier and the native decode pipeline of slice 8, part 2: they
raise."""
from .io import (DataBatch, DataDesc, DataIter, NDArrayIter, MNISTIter,  # noqa: F401
                 CSVIter, LibSVMIter, ImageRecordIter, PrefetchingIter,
                 ResizeIter)
from . import recordio  # noqa: F401


def ImageDetRecordIter(**kwargs):
    """Detection record iterator (ref: io.ImageDetRecordIter, an alias onto
    ``image.ImageDetIter``): comes with slice 8, part 2 of the port."""
    from .io import _image_tier

    raise _image_tier("ImageDetRecordIter")
