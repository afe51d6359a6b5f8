"""BERT (ref: mxnet_tpu/models/bert.py, after GluonNLP's BERTModel:
embeddings + transformer encoder + MLM/NSP heads).

Attention runs through ``F.multihead_attention``, whose scaled
dot-product attention is the flash-attention kernel on a CUDA device;
the ``(b, 1, 1, S)`` key-padding mask built from ``valid_length`` rides
inside the kernel.  Parameter structural names equal the JAX package's.
"""
from __future__ import annotations

from ..gluon import nn
from ..gluon.block import HybridBlock


class BERTEncoderLayer(HybridBlock):
    def __init__(self, units=768, hidden_size=3072, num_heads=12,
                 dropout=0.1, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._num_heads = num_heads
        self.attn_in_weight = self.params.get(
            "attn_in_weight", shape=(3 * units, units))
        self.attn_in_bias = self.params.get(
            "attn_in_bias", shape=(3 * units,), init="zeros")
        self.attn_out_weight = self.params.get(
            "attn_out_weight", shape=(units, units))
        self.attn_out_bias = self.params.get(
            "attn_out_bias", shape=(units,), init="zeros")
        self.attn_ln = nn.LayerNorm(in_channels=units)
        self.ffn1 = nn.Dense(hidden_size, flatten=False)
        self.ffn2 = nn.Dense(units, flatten=False)
        self.ffn_ln = nn.LayerNorm(in_channels=units)
        self.dropout = nn.Dropout(dropout)

    def hybrid_forward(self, F, x, mask=None, attn_in_weight=None,
                       attn_in_bias=None, attn_out_weight=None,
                       attn_out_bias=None):
        att = F.multihead_attention(x, x, x, attn_in_weight, attn_in_bias,
                                    attn_out_weight, attn_out_bias, mask,
                                    num_heads=self._num_heads)
        x = self.attn_ln(x + self.dropout(att))
        h = self.ffn2(F.LeakyReLU(self.ffn1(x), act_type="gelu"))
        return self.ffn_ln(x + self.dropout(h))


class BERTEncoder(HybridBlock):
    def __init__(self, num_layers=12, units=768, hidden_size=3072,
                 num_heads=12, dropout=0.1, **kwargs):
        super().__init__(**kwargs)
        self.layers = nn.HybridSequential()
        for _ in range(num_layers):
            self.layers.add(BERTEncoderLayer(units, hidden_size, num_heads,
                                             dropout))

    def hybrid_forward(self, F, x, mask=None):
        for layer in self.layers:
            x = layer(x, mask)
        return x


class BERTModel(HybridBlock):
    """BERT backbone + MLM decoder + NSP classifier."""

    def __init__(self, vocab_size=30522, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=512,
                 type_vocab_size=2, dropout=0.1, use_pooler=True,
                 use_decoder=True, use_classifier=True, **kwargs):
        super().__init__(**kwargs)
        if use_classifier and not use_pooler:
            raise ValueError(
                "use_classifier=True requires use_pooler=True (the NSP "
                "head reads the pooled [CLS]); gluonnlp enforces the "
                "same combination")
        self._units = units
        self._use_pooler = use_pooler
        self._use_decoder = use_decoder
        self._use_classifier = use_classifier
        self.word_embed = nn.Embedding(vocab_size, units)
        self.token_type_embed = nn.Embedding(type_vocab_size, units)
        self.position_embed = nn.Embedding(max_length, units)
        self.embed_ln = nn.LayerNorm(in_channels=units)
        self.embed_dropout = nn.Dropout(dropout)
        self.encoder = BERTEncoder(num_layers, units, hidden_size,
                                   num_heads, dropout)
        if use_pooler:
            self.pooler = nn.Dense(units, flatten=False,
                                   activation="tanh")
        if use_decoder:
            self.mlm_transform = nn.Dense(units, flatten=False)
            self.mlm_ln = nn.LayerNorm(in_channels=units)
            self.mlm_decoder = nn.Dense(vocab_size, flatten=False)
        if use_classifier:
            self.nsp_classifier = nn.Dense(2, flatten=False)

    def _encode_sequence(self, F, inputs, token_types, valid_length=None):
        """Embeddings + the encoder stack under the key-padding mask."""
        seq_len = inputs.shape[1]
        positions = F.arange(0, seq_len, dtype="int32", ctx=inputs.device)
        x = self.word_embed(inputs) + self.token_type_embed(token_types)
        x = x + self.position_embed(positions)
        x = self.embed_dropout(self.embed_ln(x))
        mask = None
        if valid_length is not None:
            steps = F.arange(0, seq_len, dtype="float32", ctx=inputs.device)
            m = F.broadcast_lesser(
                steps.reshape(1, -1), valid_length.reshape(-1, 1))
            mask = (m.reshape(m.shape[0], 1, 1, seq_len) - 1.0) * 1e9
        return self.encoder(x, mask)

    def pool(self, F, seq):
        """[CLS] representation through the tanh pooler."""
        return self.pooler(F.slice_axis(seq, 1, 0, 1).reshape(
            seq.shape[0], self._units))

    def hybrid_forward(self, F, inputs, token_types, valid_length=None,
                       masked_positions=None):
        """``(mlm_scores, nsp_scores)`` with both heads; a backbone built
        with ``use_decoder=False, use_classifier=False`` returns
        ``(sequence, pooled)``, or the sequence alone without the pooler.
        ``masked_positions`` ``(b, K)`` makes the MLM head decode only
        those positions, giving ``(b, K, vocab)``."""
        seq = self._encode_sequence(F, inputs, token_types, valid_length)
        if not (self._use_decoder or self._use_classifier):
            if not self._use_pooler:
                return seq
            return seq, self.pool(F, seq)
        mlm_in = seq
        if self._use_decoder and masked_positions is not None:
            b, S = inputs.shape[0], inputs.shape[1]
            K = masked_positions.shape[1]
            flat = seq.reshape(b * S, self._units)
            offsets = F.arange(0, b, dtype="int32",
                               ctx=inputs.device).reshape(b, 1) * S
            fidx = (masked_positions.to(offsets.dtype) + offsets) \
                .reshape(b * K)
            mlm_in = F.take(flat, fidx).reshape(b, K, self._units)
        mlm = self.mlm_decoder(
            self.mlm_ln(F.LeakyReLU(self.mlm_transform(mlm_in),
                                    act_type="gelu"))) \
            if self._use_decoder else None
        nsp = self.nsp_classifier(self.pool(F, seq)) \
            if self._use_classifier else None
        if mlm is not None and nsp is not None:
            return mlm, nsp
        return mlm if mlm is not None else nsp


def bert_base(vocab_size=30522, **kwargs):
    """BERT-base: 12 layers, 768 units, 12 heads of 64."""
    return BERTModel(vocab_size, 768, 3072, 12, 12, **kwargs)


def bert_large(vocab_size=30522, **kwargs):
    """BERT-large: 24 layers, 1024 units, 16 heads of 64."""
    return BERTModel(vocab_size, 1024, 4096, 24, 16, **kwargs)


def bert_tiny(vocab_size=1000, **kwargs):
    """Small config for tests."""
    return BERTModel(vocab_size, 64, 128, 2, 4, max_length=128, **kwargs)
