"""Model families (ref: mxnet_tpu/models/): BERT."""
from . import bert  # noqa: F401
from .bert import BERTModel, bert_base, bert_tiny  # noqa: F401
