"""Model families (ref: mxnet_tpu/models/): BERT and DeepAR."""
from . import bert  # noqa: F401
from .bert import BERTModel, bert_base, bert_tiny  # noqa: F401
from .deepar import DeepARNetwork, deepar  # noqa: F401
