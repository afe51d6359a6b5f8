"""Command-line tools of the port (ref: the repository's ``tools/``):
``python -m mxnet_tpu_torch.tools.launch`` starts the workers of a
multi-process job; ``python -m mxnet_tpu_torch.tools.im2rec`` lists and
packs an image folder into RecordIO."""
