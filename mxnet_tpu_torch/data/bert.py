"""BERT pretraining data pipeline (ref: ``mxnet_tpu/data/bert.py``):
documents -> NSP sentence pairs -> MLM-masked fixed-length batches of
numpy arrays, the same as the JAX package's from the same seed.

Ref (behavioral parity): GluonNLP scripts/bert/create_pretraining_data
.py (itself the BERT paper's recipe): 50% true next-sentence pairs, 15%
token masking split 80% [MASK] / 10% random / 10% unchanged, weights
over masked positions only.  Emits exactly the five tensors the
examples/bert pretraining head consumes: (input_ids, token_types,
mlm_targets, nsp_labels, mask_weight).
"""
from __future__ import annotations

import numpy as np

from ..base import MXNetError
from .text import WordPieceTokenizer


def read_documents(path_or_lines):
    """Corpus format: one sentence per line, blank line between
    documents (the create_pretraining_data.py convention)."""
    if isinstance(path_or_lines, str):
        with open(path_or_lines) as f:
            lines = f.readlines()
    else:
        lines = list(path_or_lines)
    docs, cur = [], []
    for line in lines:
        line = line.strip()
        if not line:
            if cur:
                docs.append(cur)
                cur = []
        else:
            cur.append(line)
    if cur:
        docs.append(cur)
    if len(docs) < 2:
        raise MXNetError(
            "BERT pretraining needs >=2 documents (blank-line "
            "separated) so NSP can draw negatives across documents")
    return docs


class BertPretrainPipeline:
    """Stream of MLM+NSP batches from a document corpus."""

    def __init__(self, docs, tokenizer, seq_len=128, mask_prob=0.15,
                 max_preds=20, seed=0, short_seq_prob=0.1):
        if not isinstance(tokenizer, WordPieceTokenizer):
            raise MXNetError("tokenizer must be a WordPieceTokenizer")
        self.docs = docs if isinstance(docs[0], list) \
            else read_documents(docs)
        self.tok = tokenizer
        self.seq_len = seq_len
        self.mask_prob = mask_prob
        self.max_preds = max_preds
        self.short_seq_prob = short_seq_prob
        self.rng = np.random.RandomState(seed)
        self._tok_docs = [[self.tok.encode(s) for s in d]
                          for d in self.docs]
        self._cls = self.tok.ids["[CLS]"]
        self._sep = self.tok.ids["[SEP]"]
        self._mask = self.tok.ids["[MASK]"]
        self._n_special = 5

    # -- NSP pairing -------------------------------------------------------
    def _draw_pair(self):
        """(tokens_a, tokens_b, is_next).  50%: consecutive sentences
        of one document; 50%: b from a DIFFERENT document."""
        rng = self.rng
        di = rng.randint(len(self._tok_docs))
        doc = self._tok_docs[di]
        if len(doc) < 2:
            a = doc[0]
            is_next = False
        else:
            si = rng.randint(len(doc) - 1)
            a = doc[si]
            if rng.rand() < 0.5:
                return a, doc[si + 1], True
            is_next = False
        dj = rng.randint(len(self._tok_docs))
        while dj == di and len(self._tok_docs) > 1:
            dj = rng.randint(len(self._tok_docs))
        other = self._tok_docs[dj]
        b = other[rng.randint(len(other))]
        return a, b, is_next

    def _build_instance(self):
        rng = self.rng
        target_len = self.seq_len
        if rng.rand() < self.short_seq_prob:
            target_len = rng.randint(5, self.seq_len + 1)
        a, b, is_next = self._draw_pair()
        # truncate the pair to fit [CLS] a [SEP] b [SEP]
        budget = target_len - 3
        a, b = list(a), list(b)
        while len(a) + len(b) > budget:
            (a if len(a) > len(b) else b).pop()
        if not a or not b:
            return None
        ids = [self._cls] + a + [self._sep] + b + [self._sep]
        types = [0] * (len(a) + 2) + [1] * (len(b) + 1)

        # MLM masking over non-special positions
        cand = [i for i, t in enumerate(ids)
                if t not in (self._cls, self._sep)]
        rng.shuffle(cand)
        n_pred = min(self.max_preds,
                     max(1, int(round(len(cand) * self.mask_prob))))
        targets = [0] * len(ids)
        weights = [0.0] * len(ids)
        for pos in cand[:n_pred]:
            targets[pos] = ids[pos]
            weights[pos] = 1.0
            r = rng.rand()
            if r < 0.8:
                ids[pos] = self._mask
            elif r < 0.9:
                ids[pos] = rng.randint(self._n_special, len(self.tok))
            # else: keep the original token
        valid = len(ids)
        pad = self.seq_len - valid
        ids += [0] * pad
        types += [0] * pad
        targets += [0] * pad
        weights += [0.0] * pad
        return ids, types, targets, int(is_next), weights, valid

    def batches(self, batch_size, num_batches):
        """Yield dicts of numpy arrays shaped for the pretraining head:
        input_ids/token_types/mlm_targets (b, s) int32, nsp_labels (b,)
        int32, mask_weight (b, s) float32, valid_length (b,) int32 (so
        attention can mask the [PAD] tail — BERTModel's valid_length
        contract).  Additionally the position form (gluonnlp
        run_pretraining / BERTForPretrain contract — the MLM head
        decodes only these): masked_positions (b, max_preds) int32 and
        position-aligned mlm_targets_k (b, max_preds) int32 /
        mask_weight_k (b, max_preds) float32, zero-padded past each
        row's prediction count."""
        K = self.max_preds
        for _ in range(num_batches):
            rows = []
            while len(rows) < batch_size:
                inst = self._build_instance()
                if inst is not None:
                    rows.append(inst)
            ids, types, tgt, nsp, wt, valid = zip(*rows)
            tgt = np.asarray(tgt, np.int32)
            wt = np.asarray(wt, np.float32)
            pos_k = np.zeros((batch_size, K), np.int32)
            tgt_k = np.zeros((batch_size, K), np.int32)
            wt_k = np.zeros((batch_size, K), np.float32)
            for r in range(batch_size):
                where = np.nonzero(wt[r] > 0)[0][:K]
                pos_k[r, :len(where)] = where
                tgt_k[r, :len(where)] = tgt[r, where]
                wt_k[r, :len(where)] = 1.0
            yield {
                "input_ids": np.asarray(ids, np.int32),
                "token_types": np.asarray(types, np.int32),
                "mlm_targets": tgt,
                "nsp_labels": np.asarray(nsp, np.int32),
                "mask_weight": wt,
                "valid_length": np.asarray(valid, np.int32),
                "masked_positions": pos_k,
                "mlm_targets_k": tgt_k,
                "mask_weight_k": wt_k,
            }


def synthetic_corpus(rng, n_docs=20, sents_per_doc=8, words_per_sent=12,
                     n_words=200):
    """A synthetic word-level corpus with document structure — enough
    signal for the pipeline tests (vocab build, pairing, masking)."""
    words = [f"w{i}" for i in range(n_words)]
    lines = []
    for _ in range(n_docs):
        for _ in range(sents_per_doc):
            k = rng.randint(5, words_per_sent + 1)
            lines.append(" ".join(rng.choice(words, k)))
        lines.append("")
    return lines
