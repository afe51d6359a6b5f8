"""WMT-style NMT data pipeline: parallel corpus -> shared BPE ->
length-bucketed padded batches (the port's own copy of
``mxnet_tpu/data/nmt.py``; numpy only).

Ref (behavioral parity): the WMT14 Transformer-big recipe (subword-nmt
BPE + Sockeye/GluonNLP bucketing) and python/mxnet/rnn/io.py
BucketSentenceIter.  ``NMTBucketIter`` draws from its ``RandomState`` in
the reference's order (a permutation per bucket, then the shuffle of the
plan), so one seed gives the same batches in both packages.  Each bucket
is one input signature of a training step: one captured CUDA graph per
bucket in ``parallel.DataParallelTrainer`` on the card.
"""
from __future__ import annotations

import numpy as np

from ..base import MXNetError
from ..io.io import DataBatch, DataDesc
from .text import BPETokenizer, learn_bpe


def load_parallel(src_path, tgt_path):
    """Read an aligned sentence-pair corpus (one sentence per line)."""
    with open(src_path) as f:
        src = [line.strip() for line in f]
    with open(tgt_path) as f:
        tgt = [line.strip() for line in f]
    if len(src) != len(tgt):
        raise MXNetError(
            f"parallel corpus misaligned: {len(src)} vs {len(tgt)}")
    pairs = [(s, t) for s, t in zip(src, tgt) if s and t]
    if not pairs:
        raise MXNetError("empty parallel corpus")
    return pairs


def build_shared_bpe(pairs, num_merges=1000):
    """Joint source+target BPE (the WMT14 shared-vocab convention)."""
    return BPETokenizer(learn_bpe(
        (s for p in pairs for s in p), num_merges))


def encode_pairs(pairs, tokenizer, max_len=None):
    """-> list of (src_ids, tgt_ids) with BOS/EOS on the target side."""
    out = []
    for s, t in pairs:
        src = tokenizer.encode(s, eos=True)
        tgt = tokenizer.encode(t, bos=True, eos=True)
        if max_len and (len(src) > max_len or len(tgt) > max_len + 1):
            continue
        out.append((src, tgt))
    return out


class NMTBucketIter:
    """Length-bucketed batches of (src, tgt_in, tgt_out) with a
    ``bucket_key`` per batch (BucketSentenceIter contract, so
    BucketingModule binds one executor per bucket).

    tgt_in = tgt[:-1] (BOS-led decoder input), tgt_out = tgt[1:]
    (shifted labels) — standard teacher forcing.
    """

    def __init__(self, encoded_pairs, batch_size,
                 buckets=(8, 16, 32, 64), seed=0,
                 data_name="src", label_name="tgt"):
        self.batch_size = batch_size
        self.buckets = sorted(buckets)
        self.rng = np.random.RandomState(seed)
        self.data_name = data_name
        self.label_name = label_name
        self._by_bucket = {b: [] for b in self.buckets}
        dropped = 0
        for src, tgt in encoded_pairs:
            need = max(len(src), len(tgt) - 1)
            bucket = next((b for b in self.buckets if need <= b), None)
            if bucket is None:
                dropped += 1
                continue
            self._by_bucket[bucket].append((src, tgt))
        self.dropped = dropped  # no silent truncation: surfaced
        self.default_bucket_key = self.buckets[-1]
        self.reset()
        if not self._plan:
            # only FULL batches are planned; fail loudly rather than
            # yielding nothing forever
            sizes = {b: len(r) for b, r in self._by_bucket.items()}
            raise MXNetError(
                f"corpus too small for batch_size={batch_size}: no "
                f"bucket holds a full batch (per-bucket counts "
                f"{sizes}, dropped(too long) {dropped})")

    @property
    def provide_data(self):
        return [DataDesc(self.data_name,
                         (self.batch_size, self.default_bucket_key)),
                DataDesc("tgt_in",
                         (self.batch_size, self.default_bucket_key))]

    @property
    def provide_label(self):
        return [DataDesc(self.label_name,
                         (self.batch_size, self.default_bucket_key))]

    def reset(self):
        self._plan = []
        for b, rows in self._by_bucket.items():
            idx = self.rng.permutation(len(rows))
            for i in range(0, len(rows) - self.batch_size + 1,
                           self.batch_size):
                self._plan.append((b, idx[i:i + self.batch_size]))
        self.rng.shuffle(self._plan)
        self._cursor = 0

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def next(self):
        if self._cursor >= len(self._plan):
            raise StopIteration
        bucket, rows_idx = self._plan[self._cursor]
        self._cursor += 1
        rows = self._by_bucket[bucket]
        src = np.zeros((self.batch_size, bucket), np.int32)
        tgt_in = np.zeros((self.batch_size, bucket), np.int32)
        tgt_out = np.zeros((self.batch_size, bucket), np.int32)
        src_len = np.zeros((self.batch_size,), np.int32)
        for r, i in enumerate(rows_idx):
            s, t = rows[i]
            src[r, :len(s)] = s
            src_len[r] = len(s)
            ti, to = t[:-1], t[1:]
            tgt_in[r, :len(ti)] = ti
            tgt_out[r, :len(to)] = to
        batch = DataBatch([src, tgt_in], [tgt_out],
                          provide_data=[
                              DataDesc(self.data_name,
                                       (self.batch_size, bucket)),
                              DataDesc("tgt_in",
                                       (self.batch_size, bucket))],
                          provide_label=[
                              DataDesc(self.label_name,
                                       (self.batch_size, bucket))])
        batch.bucket_key = bucket
        batch.src_valid_length = src_len
        return batch


def synthetic_parallel_corpus(rng, n=256, vocab=60):
    """Copy-with-offset 'translation': target word i+1 for source word
    i — learnable by a tiny transformer, so the pipeline can carry a
    real convergence smoke without WMT data."""
    pairs = []
    for _ in range(n):
        k = rng.randint(3, 12)
        ws = rng.randint(0, vocab - 1, k)
        src = " ".join(f"s{w}" for w in ws)
        tgt = " ".join(f"s{w + 1}" for w in ws)
        pairs.append((src, tgt))
    return pairs
