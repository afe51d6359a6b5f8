"""Data pipelines (ref: mxnet_tpu/data/): the DeepAR time series."""
from . import timeseries  # noqa: F401
