"""The NMT data pipeline, the subword tokenizers, ``mx.io``'s batch
classes and ``mx.rnn.BucketSentenceIter`` of the PyTorch port against the
JAX package.  All host-side: the same corpus and seed must give the same
merges, vocabularies, ids and batches, exactly."""
import random

import numpy as np
import pytest

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.data import nmt as tnmt
from mxnet_tpu_torch.data import text as ttext


def _corpus(n=240, vocab=30):
    return tnmt.synthetic_parallel_corpus(np.random.RandomState(0), n=n,
                                          vocab=vocab)


def test_synthetic_corpus_bpe_and_encodings_match_jax():
    from mxnet_tpu.data import nmt as jnmt

    pairs = _corpus()
    assert pairs == jnmt.synthetic_parallel_corpus(
        np.random.RandomState(0), n=240, vocab=30)
    tbpe = tnmt.build_shared_bpe(pairs, num_merges=80)
    jbpe = jnmt.build_shared_bpe(pairs, num_merges=80)
    assert tbpe.merges == jbpe.merges and len(tbpe.merges) > 20
    assert tbpe.tokens == jbpe.tokens
    tenc = tnmt.encode_pairs(pairs, tbpe, max_len=16)
    assert tenc == jnmt.encode_pairs(pairs, jbpe, max_len=16)
    s, t = tenc[0]
    assert t[0] == tbpe.ids[tbpe.BOS] and t[-1] == s[-1] == tbpe.ids[
        tbpe.EOS]
    assert tbpe.decode(t) == pairs[0][1]


def _batches(it):
    out = []
    for b in it:
        src, tgt_in = b.data
        out.append((b.bucket_key, np.asarray(b.src_valid_length),
                    np.asarray(src), np.asarray(tgt_in),
                    np.asarray(b.label[0]),
                    [(d.name, d.shape) for d in b.provide_data],
                    [(d.name, d.shape) for d in b.provide_label]))
    return out


def _same_batches(a, b):
    assert len(a) == len(b) and a
    for x, y in zip(a, b):
        assert x[0] == y[0] and x[5:] == y[5:]
        for u, v in zip(x[1:5], y[1:5]):
            assert u.dtype == v.dtype and np.array_equal(u, v)


def test_nmt_bucket_iter_matches_jax_for_seed_0():
    """Every batch of two epochs (``reset`` draws a new plan from the same
    RandomState): bucket_key, src_valid_length, data and label."""
    from mxnet_tpu.data import nmt as jnmt

    pairs = _corpus()
    bpe = tnmt.build_shared_bpe(pairs, num_merges=80)
    enc = tnmt.encode_pairs(pairs, bpe)
    its = [mod.NMTBucketIter(enc, 8, buckets=(8, 16, 32), seed=0)
           for mod in (tnmt, jnmt)]
    assert its[0].dropped == its[1].dropped
    assert [(d.name, d.shape) for d in its[0].provide_data] == \
        [(d.name, d.shape) for d in its[1].provide_data]
    for _ in range(2):
        got, want = (_batches(it) for it in its)
        _same_batches(got, want)
        assert len({g[0] for g in got}) > 1  # batches from several buckets
        for it in its:
            it.reset()
    key, vlen, src, tgt_in, tgt_out = got[0][:5]
    assert src.shape == (8, key) and (vlen > 0).all()
    assert (src[np.arange(key)[None, :] >= vlen[:, None]] == 0).all()


def test_nmt_bucket_iter_refuses_a_corpus_without_a_full_batch():
    from mxnet_tpu.data import nmt as jnmt

    enc = tnmt.encode_pairs(_corpus(n=5),
                            tnmt.build_shared_bpe(_corpus(n=5), 10))
    for mod in (tnmt, jnmt):
        with pytest.raises(Exception, match="corpus too small"):
            mod.NMTBucketIter(enc, 8, buckets=(8, 16))


def test_load_parallel_matches_jax(tmp_path):
    from mxnet_tpu.data import nmt as jnmt

    src, tgt = tmp_path / "src.txt", tmp_path / "tgt.txt"
    src.write_text("a b c\n\nd e\nf\n")
    tgt.write_text("x y\nz\nw v\n\n")
    pairs = tnmt.load_parallel(str(src), str(tgt))
    assert pairs == jnmt.load_parallel(str(src), str(tgt))
    assert pairs == [("a b c", "x y"), ("d e", "w v")]
    tgt.write_text("x\n")
    with pytest.raises(tmx.MXNetError, match="misaligned"):
        tnmt.load_parallel(str(src), str(tgt))


def test_wordpiece_tokenizer_matches_jax(tmp_path):
    from mxnet_tpu.data import text as jtext

    lines = ["the quick brown fox jumps over the lazy dog",
             "the dog sleeps", "quick quick foxes jump", "lazy brown dogs"]
    tw = ttext.WordPieceTokenizer.build(lines, vocab_size=40)
    jw = jtext.WordPieceTokenizer.build(lines, vocab_size=40)
    assert tw.tokens == jw.tokens and len(tw) == 40
    for text in ("the lazy foxes", "quickly unknown zzz"):
        assert tw.tokenize(text) == jw.tokenize(text)
        assert tw.encode(text) == jw.encode(text)
        assert tw.decode(tw.encode(text)) == jw.decode(jw.encode(text))
    tw.save(str(tmp_path / "wp.json"))
    assert ttext.WordPieceTokenizer.load(str(tmp_path / "wp.json")).tokens \
        == tw.tokens
    with pytest.raises(tmx.MXNetError):
        ttext.WordPieceTokenizer(["a", "b"])


def test_bpe_tokenizer_matches_jax(tmp_path):
    from mxnet_tpu.data import text as jtext

    lines = ["low lower lowest", "new newer newest", "wide wider widest"]
    merges = ttext.learn_bpe(lines, num_merges=20)
    assert merges == jtext.learn_bpe(lines, num_merges=20)
    tb, jb = ttext.BPETokenizer(merges), jtext.BPETokenizer(merges)
    assert tb.tokens == jb.tokens
    for text in ("lowest newer", "slow q"):
        assert tb.segment(text) == jb.segment(text)
        assert tb.encode(text, bos=True, eos=True) == \
            jb.encode(text, bos=True, eos=True)
    assert tb.decode(tb.encode("lowest newer")) == "lowest newer"
    tb.save(str(tmp_path / "bpe.json"))
    assert ttext.BPETokenizer.load(str(tmp_path / "bpe.json")).merges == \
        tb.merges


def _sentences(n=60, seed=0):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(1, 20, rng.randint(2, 14))) for _ in range(n)]


def _sentence_batches(mod, layout, buckets):
    random.seed(0)
    it = mod.BucketSentenceIter(_sentences(), 4, buckets=buckets,
                                layout=layout)
    out = []
    for _ in range(2):
        for b in it:
            out.append((b.bucket_key, b.data[0].asnumpy(),
                        b.label[0].asnumpy(),
                        [(d.name, d.shape, d.layout)
                         for d in b.provide_data + b.provide_label]))
        it.reset()
    desc = [(d.name, d.shape) for d in it.provide_data + it.provide_label]
    return out, desc, it.default_bucket_key


@pytest.mark.parametrize("layout,buckets", [("NT", [5, 10, 15]),
                                            ("TN", [8, 16]),
                                            ("NT", None)])
def test_bucket_sentence_iter_matches_jax(layout, buckets):
    """One ``random.seed`` gives the same batches (two epochs), labels
    shifted by one step and bucket descriptors in both packages."""
    import mxnet_tpu as jmx

    with tmx.cpu():
        got = _sentence_batches(tmx.rnn, layout, buckets)
    want = _sentence_batches(jmx.rnn, layout, buckets)
    assert got[1:] == want[1:]
    assert len(got[0]) == len(want[0]) and got[0]
    for g, w in zip(got[0], want[0]):
        assert g[0] == w[0] and g[3] == w[3]
        assert np.array_equal(g[1], w[1]) and np.array_equal(g[2], w[2])


def test_legacy_rnn_names_and_io_base():
    assert tmx.rnn.LSTMCell is tmx.gluon.rnn.LSTMCell
    assert tmx.rnn.GRUCell is tmx.gluon.rnn.GRUCell
    assert tmx.rnn.ZoneoutCell is tmx.gluon.rnn.ZoneoutCell
    assert issubclass(tmx.rnn.BucketSentenceIter, tmx.io.DataIter)
    assert repr(tmx.io.DataDesc("data", (2, 3))) == \
        "DataDesc[data,(2, 3),<class 'numpy.float32'>]"

    class Count(tmx.io.DataIter):
        def __init__(self):
            super().__init__(batch_size=2)
            self.i = 0

        def iter_next(self):
            self.i += 1
            return self.i <= 2

        def getdata(self):
            return [np.full((2,), self.i)]

        def getlabel(self):
            return None

    batches = list(Count())
    assert [b.data[0][0] for b in batches] == [1, 2]
    assert batches[0].pad == 0 and batches[0].bucket_key is None
    # the pipeline tier came with slice 8, part 1
    assert [b.data[0][0] for b in Count().as_pipeline()] == [1, 2]
