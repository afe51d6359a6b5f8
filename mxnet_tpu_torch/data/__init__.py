"""Data pipelines (ref: mxnet_tpu/data/): the DeepAR time series
(``timeseries``), the WMT-style NMT pipeline (``nmt``: shared BPE and
length-bucketed batches), the BERT pretraining batches (``bert``: NSP
pairs and MLM masking) and the trainable subword tokenizers (``text``:
BPE and WordPiece)."""
from . import bert, nmt, text, timeseries  # noqa: F401
from .text import BPETokenizer, WordPieceTokenizer, learn_bpe  # noqa: F401
