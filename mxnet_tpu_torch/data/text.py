"""Trainable subword tokenizers: WordPiece (BERT) and BPE (WMT).

The port's own copy of ``mxnet_tpu/data/text.py`` (pure Python: the
same corpus gives the same merges, vocabularies and ids).

Ref (behavioral parity): GluonNLP's BERTTokenizer/Vocab +
subword-nmt's learn_bpe/apply_bpe — the two preprocessing stacks the
reference-era BERT and Transformer-big recipes used.  Pure Python on
purpose: tokenization is offline/host-side prep, never on the device's hot
path.
"""
from __future__ import annotations

import collections
import json

from ..base import MXNetError

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
SPECIALS = (PAD, UNK, CLS, SEP, MASK)


def _word_freqs(lines):
    freqs = collections.Counter()
    for line in lines:
        for w in line.strip().lower().split():
            freqs[w] += 1
    return freqs


def _bpe_merges(freqs, num_merges, end_of_word):
    """Frequency-greedy pair merging over word character sequences —
    the shared training core of BPE and (practically) WordPiece
    vocabularies.

    Incremental bookkeeping (the subword-nmt trick): pair counts and a
    pair->words index are maintained across merges, so each merge only
    touches the words that actually contain the merged pair — O(merges
    x affected words), not O(merges x all word types).  That's the
    difference between minutes and hours on the real corpora the
    --data paths exist for."""
    words = {w: tuple(w) + ((end_of_word,) if end_of_word else ())
             for w in freqs}
    pairs = collections.Counter()
    index = collections.defaultdict(set)
    for w, sym in words.items():
        f = freqs[w]
        for p in zip(sym, sym[1:]):
            pairs[p] += f
            index[p].add(w)
    merges = []
    for _ in range(num_merges):
        if not pairs:
            break
        # deterministic: max count, ties broken lexicographically
        (a, b), count = max(pairs.items(),
                            key=lambda kv: (kv[1], kv[0]))
        if count < 2:
            break
        merges.append((a, b))
        merged = a + b
        for w in list(index[(a, b)]):
            sym, f = words[w], freqs[w]
            for p in zip(sym, sym[1:]):
                pairs[p] -= f
                if pairs[p] <= 0:
                    del pairs[p]
                index[p].discard(w)
            out, i = [], 0
            while i < len(sym):
                if i + 1 < len(sym) and sym[i] == a and sym[i + 1] == b:
                    out.append(merged)
                    i += 2
                else:
                    out.append(sym[i])
                    i += 1
            sym2 = tuple(out)
            words[w] = sym2
            for p in zip(sym2, sym2[1:]):
                pairs[p] += f
                index[p].add(w)
    return merges, words


class WordPieceTokenizer:
    """Greedy longest-match-first subword tokenizer with '##'
    continuation pieces (BERT convention)."""

    def __init__(self, vocab):
        """vocab: list of tokens; must start with the 5 specials."""
        if list(vocab[:5]) != list(SPECIALS):
            raise MXNetError(
                f"vocab must start with the specials {SPECIALS}")
        self.tokens = list(vocab)
        self.ids = {t: i for i, t in enumerate(self.tokens)}

    # -- training ----------------------------------------------------------
    @classmethod
    def build(cls, lines, vocab_size=1000):
        """Learn a vocab from a corpus iterable (one sentence per
        line).  Merge-based (BPE-style) training; pieces that continue
        a word carry the '##' prefix."""
        freqs = _word_freqs(lines)
        merges, words = _bpe_merges(freqs, max(0, vocab_size), None)
        pieces = collections.Counter()
        for w, sym in words.items():
            for i, s in enumerate(sym):
                pieces[("##" + s) if i else s] += freqs[w]
        # chars always present so no word is untokenizable
        chars = collections.Counter()
        for w, f in freqs.items():
            for i, c in enumerate(w):
                chars[("##" + c) if i else c] += f
        vocab = list(SPECIALS)
        seen = set(vocab)
        for tok, _ in (pieces + chars).most_common():
            if tok not in seen:
                vocab.append(tok)
                seen.add(tok)
            if len(vocab) >= vocab_size:
                break
        return cls(vocab)

    # -- use ---------------------------------------------------------------
    def tokenize_word(self, word):
        out, start = [], 0
        while start < len(word):
            end = len(word)
            piece = None
            while end > start:
                sub = word[start:end]
                if start:
                    sub = "##" + sub
                if sub in self.ids:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [UNK]
            out.append(piece)
            start = end
        return out

    def tokenize(self, text):
        toks = []
        for w in text.strip().lower().split():
            toks.extend(self.tokenize_word(w))
        return toks

    def encode(self, text):
        return [self.ids[t] for t in self.tokenize(text)]

    def decode(self, ids):
        words = []
        for i in ids:
            t = self.tokens[i]
            if t in SPECIALS:
                continue
            if t.startswith("##") and words:
                words[-1] += t[2:]
            else:
                words.append(t)
        return " ".join(words)

    def save(self, path):
        with open(path, "w") as f:
            json.dump(self.tokens, f)

    @classmethod
    def load(cls, path):
        with open(path) as f:
            return cls(json.load(f))

    def __len__(self):
        return len(self.tokens)


def learn_bpe(lines, num_merges=1000):
    """subword-nmt learn_bpe role: returns the ordered merge list."""
    freqs = _word_freqs(lines)
    merges, _ = _bpe_merges(freqs, num_merges, "</w>")
    return merges


class BPETokenizer:
    """subword-nmt apply_bpe role: '@@ '-joined subwords, '</w>' closes
    a word (WMT14 preprocessing convention for Transformer-big)."""

    BOS, EOS, PAD_TOK, UNK_TOK = "<s>", "</s>", "<pad>", "<unk>"

    def __init__(self, merges):
        self.merges = [tuple(m) for m in merges]
        self.ranks = {m: i for i, m in enumerate(self.merges)}
        self._cache = {}
        # vocab: specials + every symbol reachable from the merges
        syms = set()
        for a, b in self.merges:
            syms.update((a, b, a + b))
        self.tokens = [self.PAD_TOK, self.UNK_TOK, self.BOS, self.EOS]
        self.tokens += sorted(syms)
        # single chars seen in merges are included above; unseen chars
        # at encode time map to UNK
        self.ids = {t: i for i, t in enumerate(self.tokens)}

    def _apply(self, word):
        sym = list(word) + ["</w>"]
        # merge lowest-rank pair until none applies (apply_bpe order)
        while len(sym) > 1:
            best, bi = None, -1
            for i, pair in enumerate(zip(sym, sym[1:])):
                r = self.ranks.get(pair)
                if r is not None and (best is None or r < best):
                    best, bi = r, i
            if best is None:
                break
            sym[bi:bi + 2] = [sym[bi] + sym[bi + 1]]
        return sym

    def segment_word(self, word):
        if word not in self._cache:
            self._cache[word] = self._apply(word)
        return self._cache[word]

    def segment(self, text):
        out = []
        for w in text.strip().lower().split():
            out.extend(self.segment_word(w))
        return out

    def encode(self, text, bos=False, eos=False):
        ids = [self.ids.get(s, 1) for s in self.segment(text)]
        if bos:
            ids = [self.ids[self.BOS]] + ids
        if eos:
            ids = ids + [self.ids[self.EOS]]
        return ids

    def decode(self, ids):
        words, cur = [], ""
        for i in ids:
            t = self.tokens[i]
            if t in (self.PAD_TOK, self.BOS, self.EOS, self.UNK_TOK):
                continue
            cur += t
            if cur.endswith("</w>"):
                words.append(cur[:-4])
                cur = ""
        if cur:
            words.append(cur)
        return " ".join(words)

    def save(self, path):
        with open(path, "w") as f:
            json.dump(self.merges, f)

    @classmethod
    def load(cls, path):
        with open(path) as f:
            return cls(json.load(f))

    def __len__(self):
        return len(self.tokens)
