"""IO (ref: mxnet_tpu/io/): the batch descriptors and the iterator base
that the bucketed iterators (``data.nmt.NMTBucketIter``,
``rnn.BucketSentenceIter``) build on.  The record iterators and the
pipeline tier come with slice 8 of the port (ROADMAP.md queue 1)."""
from .io import DataBatch, DataDesc, DataIter  # noqa: F401
