"""Command-line tools of the port (ref: the repository's ``tools/``):
``python -m mxnet_tpu_torch.tools.launch`` starts the workers of a
multi-process job."""
