"""Transformer encoder-decoder (ref: mxnet_tpu/models/transformer.py, the
BASELINE config 'Transformer-big WMT14 En-De (Sockeye, hybridized
encoder/decoder)').

Attention runs through ``F.multihead_attention``, whose scaled
dot-product attention is the flash-attention kernel on a CUDA device: the
encoder's self-attention under the ``(b, 1, 1, s)`` key-padding mask made
from ``src_valid_len``, the decoder's causal self-attention (sq = sk) and
its cross-attention over the encoder's output (sq != sk when decoding,
under the same key-padding mask).  Parameter structural names equal the
JAX package's, the positional table ``pos_const`` included.

``greedy_decode`` and ``beam_search_decode`` are the reference's host
loops: each step runs the whole model on the prefix so far and copies only
the last position's ``(rows, vocab)`` logits to the host.  A hybridized
model in predict mode on the card replays one CUDA graph per prefix
length (``gluon.block.CachedOp``): the first decode call warms each
length, the second captures it, and later calls replay it.  Each prefix
is made on the source's device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..context import current_context
from ..gluon import nn
from ..gluon.block import HybridBlock
from ..ndarray.ndarray import NDArray


def positional_encoding(length, dim):
    """The sinusoidal table, ``(length, dim)`` float32 (ref: :17)."""
    pos = np.arange(length)[:, None]
    i = np.arange(dim // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * i / dim)
    enc = np.zeros((length, dim), np.float32)
    enc[:, 0::2] = np.sin(angle)
    enc[:, 1::2] = np.cos(angle)
    return enc


class TransformerLayer(HybridBlock):
    """Post-LN encoder layer, or decoder layer with cross-attention (ref:
    :27)."""

    _split_params = ("self_in_weight", "self_in_bias", "self_out_weight",
                     "self_out_bias", "cross_in_weight", "cross_in_bias",
                     "cross_out_weight", "cross_out_bias")

    def __init__(self, units, hidden_size, num_heads, dropout=0.1,
                 is_decoder=False, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._num_heads = num_heads
        self._is_decoder = is_decoder
        self.self_in_weight = self.params.get(
            "self_in_weight", shape=(3 * units, units))
        self.self_in_bias = self.params.get(
            "self_in_bias", shape=(3 * units,), init="zeros")
        self.self_out_weight = self.params.get(
            "self_out_weight", shape=(units, units))
        self.self_out_bias = self.params.get(
            "self_out_bias", shape=(units,), init="zeros")
        self.ln1 = nn.LayerNorm(in_channels=units)
        if is_decoder:
            self.cross_in_weight = self.params.get(
                "cross_in_weight", shape=(3 * units, units))
            self.cross_in_bias = self.params.get(
                "cross_in_bias", shape=(3 * units,), init="zeros")
            self.cross_out_weight = self.params.get(
                "cross_out_weight", shape=(units, units))
            self.cross_out_bias = self.params.get(
                "cross_out_bias", shape=(units,), init="zeros")
            self.ln_cross = nn.LayerNorm(in_channels=units)
        self.ffn1 = nn.Dense(hidden_size, flatten=False, activation="relu")
        self.ffn2 = nn.Dense(units, flatten=False)
        self.ln2 = nn.LayerNorm(in_channels=units)
        self.dropout = nn.Dropout(dropout)

    def hybrid_forward(self, F, x, memory=None, self_mask=None,
                       mem_mask=None, **params):
        att = F.multihead_attention(
            x, x, x, params["self_in_weight"], params["self_in_bias"],
            params["self_out_weight"], params["self_out_bias"], self_mask,
            num_heads=self._num_heads, causal=self._is_decoder)
        x = self.ln1(x + self.dropout(att))
        if self._is_decoder and memory is not None:
            catt = F.multihead_attention(
                x, memory, memory, params["cross_in_weight"],
                params["cross_in_bias"], params["cross_out_weight"],
                params["cross_out_bias"], mem_mask,
                num_heads=self._num_heads)
            x = self.ln_cross(x + self.dropout(catt))
        h = self.ffn2(self.ffn1(x))
        return self.ln2(x + self.dropout(h))


def _tensor(x, device=None):
    """``x`` (NDArray, tensor or array-like) as a tensor, on ``device``
    when given (default for array-likes: :func:`current_context`)."""
    if isinstance(x, NDArray):
        x = x.data
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
        device = device or current_context().torch_device()
    return x if device is None else x.to(device)


class TransformerModel(HybridBlock):
    """Encoder-decoder for seq2seq (WMT-style) (ref: :76).
    ``tie_embeddings`` is accepted and unused, as in the reference."""

    def __init__(self, src_vocab, tgt_vocab, units=512, hidden_size=2048,
                 num_layers=6, num_heads=8, max_length=512, dropout=0.1,
                 tie_embeddings=False, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self.src_embed = nn.Embedding(src_vocab, units)
        self.tgt_embed = nn.Embedding(tgt_vocab, units)
        self.pos_const = self.params.get_constant(
            "pos_enc", positional_encoding(max_length, units))
        self.enc_layers = nn.HybridSequential()
        for _ in range(num_layers):
            self.enc_layers.add(TransformerLayer(units, hidden_size,
                                                 num_heads, dropout))
        self.dec_layers = nn.HybridSequential()
        for _ in range(num_layers):
            self.dec_layers.add(TransformerLayer(units, hidden_size,
                                                 num_heads, dropout,
                                                 is_decoder=True))
        self.out_proj = nn.Dense(tgt_vocab, flatten=False)
        self.dropout = nn.Dropout(dropout)

    def _mask_from_len(self, F, valid_length, q_len, k_len):
        """The additive ``(b, 1, 1, k_len)`` key-padding mask, made on
        ``valid_length``'s device."""
        steps = F.arange(0, k_len, dtype="float32",
                         ctx=valid_length.device)
        m = F.broadcast_lesser(steps.reshape(1, -1),
                               valid_length.reshape(-1, 1))
        return (m.reshape(m.shape[0], 1, 1, k_len) - 1.0) * 1e9

    def encode(self, F, src, src_valid_len=None):
        """``(memory, mask)``: the encoder's output and its key-padding
        mask (None without ``src_valid_len``)."""
        s = src.shape[1]
        pos = self.pos_const.data()
        x = self.src_embed(src) * math.sqrt(self._units)
        x = self.dropout(x + pos[:s])
        mask = None
        if src_valid_len is not None:
            mask = self._mask_from_len(F, src_valid_len, s, s)
        for layer in self.enc_layers:
            x = layer(x, None, mask, None)
        return x, mask

    def decode(self, F, tgt, memory, mem_mask=None):
        """The target's logits, ``(b, t, tgt_vocab)``."""
        t = tgt.shape[1]
        pos = self.pos_const.data()
        x = self.tgt_embed(tgt) * math.sqrt(self._units)
        x = self.dropout(x + pos[:t])
        for layer in self.dec_layers:
            x = layer(x, memory, None, mem_mask)
        return self.out_proj(x)

    def hybrid_forward(self, F, src, tgt, src_valid_len=None, **params):
        # params carries pos_const, read through self.pos_const.data()
        # (the trainer's copy while a DataParallelTrainer runs)
        memory, mem_mask = self.encode(F, src, src_valid_len)
        return self.decode(F, tgt, memory, mem_mask)

    def _last_logits(self, src, prefix, src_valid_len):
        """The last position's logits of ``prefix`` (a host int32 array),
        on the host as float32 (ref: :144-147); the prefix is made on
        ``src``'s device."""
        tgt = torch.from_numpy(np.ascontiguousarray(prefix, np.int32)) \
            .to(src.device)
        logits = self(src, tgt, src_valid_len)
        return logits[:, -1].float().cpu().numpy()

    def greedy_decode(self, src, max_len=32, bos=1, eos=2,
                      src_valid_len=None):
        """Greedy inference loop (ref: :135): ``(b, <=max_len)`` int32,
        BOS-led; stops early once every row has emitted EOS."""
        src = _tensor(src)
        svl = None if src_valid_len is None else _tensor(src_valid_len,
                                                         src.device)
        b = src.shape[0]
        out = np.full((b, 1), bos, np.int32)
        for _ in range(max_len - 1):
            nxt = self._last_logits(src, out, svl).argmax(-1) \
                .astype(np.int32)
            out = np.concatenate([out, nxt[:, None]], axis=1)
            if (nxt == eos).all():
                break
        return out

    def beam_search_decode(self, src, beam_size=4, max_len=32, bos=1,
                           eos=2, alpha=0.6, src_valid_len=None):
        """Beam search with the GNMT length penalty (ref: :154).

        Returns ``(sequences, scores)``: the best sequence per batch row
        ((b, <=max_len) int32, BOS-led, truncated after EOS, padded with
        EOS) and its length-normalized log-prob."""
        src = _tensor(src)
        b = src.shape[0]
        K = int(beam_size)
        if K < 1:
            raise ValueError(f"beam_size must be >= 1, got {K}")
        src_k = src.repeat_interleave(K, dim=0)
        svl_k = None
        if src_valid_len is not None:
            svl_k = _tensor(src_valid_len, src.device) \
                .repeat_interleave(K, dim=0)

        seqs = np.full((b, K, 1), bos, np.int32)
        # only beam 0 live at t=0 so the first expansion doesn't pick
        # K copies of the same hypothesis
        scores = np.full((b, K), -np.inf, np.float32)
        scores[:, 0] = 0.0
        finished = np.zeros((b, K), bool)

        for t in range(max_len - 1):
            last = self._last_logits(src_k, seqs.reshape(b * K, t + 1),
                                     svl_k)
            last = last - last.max(-1, keepdims=True)
            logp = last - np.log(np.exp(last).sum(-1, keepdims=True))
            V = logp.shape[-1]
            logp = logp.reshape(b, K, V)
            # a finished hypothesis only continues as itself: EOS with
            # zero added score, every other continuation impossible
            frozen = np.full((V,), -np.inf, np.float32)
            frozen[eos] = 0.0
            step = np.where(finished[:, :, None], frozen[None, None, :],
                            logp)
            cand = scores[:, :, None] + step
            flat = cand.reshape(b, K * V)
            top = np.argpartition(-flat, K - 1, axis=1)[:, :K]
            beam_idx, tok = top // V, (top % V).astype(np.int32)
            scores = np.take_along_axis(flat, top, axis=1)
            seqs = np.concatenate(
                [np.take_along_axis(seqs, beam_idx[:, :, None], axis=1),
                 tok[:, :, None]], axis=2)
            finished = np.take_along_axis(finished, beam_idx, axis=1) \
                | (tok == eos)
            if finished.all():
                break

        # GNMT length penalty over the generated length (BOS excluded,
        # EOS counted for finished rows)
        gen_len = np.full((b, K), seqs.shape[2] - 1, np.float32)
        for bi in range(b):
            for ki in range(K):
                hit = np.where(seqs[bi, ki, 1:] == eos)[0]
                if hit.size:
                    gen_len[bi, ki] = float(hit[0] + 1)
        lp = ((5.0 + gen_len) / 6.0) ** alpha
        norm = scores / lp
        best = norm.argmax(axis=1)
        out_seqs, out_scores = [], []
        for bi in range(b):
            s = seqs[bi, best[bi]]
            hit = np.where(s[1:] == eos)[0]
            if hit.size:
                s = s[:hit[0] + 2]  # keep BOS..EOS
            out_seqs.append(s)
            out_scores.append(float(norm[bi, best[bi]]))
        width = max(len(s) for s in out_seqs)
        padded = np.full((b, width), eos, np.int32)
        for bi, s in enumerate(out_seqs):
            padded[bi, :len(s)] = s
        return padded, np.asarray(out_scores, np.float32)


def transformer_big(src_vocab, tgt_vocab, **kwargs):
    """Transformer-big (the WMT14 BASELINE config): 1024 units, 16 heads,
    4096 ffn, 6+6 layers, dropout 0.3."""
    return TransformerModel(src_vocab, tgt_vocab, units=1024,
                            hidden_size=4096, num_layers=6, num_heads=16,
                            dropout=0.3, **kwargs)


def transformer_base(src_vocab, tgt_vocab, **kwargs):
    """Transformer-base: 512 units, 8 heads, 2048 ffn, 6+6 layers."""
    return TransformerModel(src_vocab, tgt_vocab, units=512,
                            hidden_size=2048, num_layers=6, num_heads=8,
                            **kwargs)


def transformer_tiny(src_vocab=100, tgt_vocab=100, **kwargs):
    """Small config for tests: 32 units, 4 heads, 64 ffn, 2+2 layers."""
    return TransformerModel(src_vocab, tgt_vocab, units=32,
                            hidden_size=64, num_layers=2, num_heads=4,
                            max_length=64, **kwargs)
