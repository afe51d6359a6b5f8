"""Model families (ref: mxnet_tpu/models/): BERT (base, large, tiny),
the Transformer encoder-decoder (big, base, tiny, with greedy and beam
decoding) and DeepAR."""
from . import bert, transformer  # noqa: F401
from .bert import BERTModel, bert_base, bert_large, bert_tiny  # noqa: F401
from .transformer import (TransformerModel, transformer_base,  # noqa: F401
                          transformer_big, transformer_tiny)
from .deepar import DeepARNetwork, deepar  # noqa: F401
