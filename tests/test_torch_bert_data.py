"""``data.bert`` of the PyTorch port (``read_documents``,
``BertPretrainPipeline``, ``synthetic_corpus``) against the JAX package.

Both build the same WordPiece vocabulary (``data.text``) from a small
synthetic corpus and draw pairs and masks from ``RandomState(seed)``, so
every batch is compared key for key and bit for bit (dtypes included),
with ``short_seq_prob`` rows in them.  The batches then feed the port's
``pipeline.IterableSource`` with ``prefetch_to_device(cpu())`` unchanged.
"""
import numpy as np
import pytest

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.data import bert as tbert


def _jbert():
    from mxnet_tpu.data import bert as jbert

    return jbert


def _corpus(n_docs=6):
    return tbert.synthetic_corpus(np.random.RandomState(0), n_docs=n_docs,
                                  sents_per_doc=5, words_per_sent=14,
                                  n_words=60)


def test_synthetic_corpus_and_read_documents_match_jax(tmp_path):
    jb = _jbert()
    lines = _corpus()
    assert lines == jb.synthetic_corpus(np.random.RandomState(0), n_docs=6,
                                        sents_per_doc=5, words_per_sent=14,
                                        n_words=60)
    path = tmp_path / "corpus.txt"
    path.write_text("\n".join(lines) + "\n")
    docs = tbert.read_documents(str(path))
    assert docs == jb.read_documents(str(path)) == tbert.read_documents(lines)
    assert len(docs) == 6 and all(len(d) == 5 for d in docs)
    with pytest.raises(MXNetError, match=">=2 documents"):
        tbert.read_documents(lines[:5])


@pytest.mark.parametrize("short_seq_prob", [0.1, 0.5])
def test_pretrain_batches_match_jax(short_seq_prob):
    import mxnet_tpu.data as jdata

    jb = _jbert()
    lines = _corpus()
    words = [ln for ln in lines if ln.strip()]
    ttok = tmx.data.WordPieceTokenizer.build(words, vocab_size=120)
    jtok = jdata.WordPieceTokenizer.build(words, vocab_size=120)
    assert ttok.ids == jtok.ids
    t = tbert.BertPretrainPipeline(lines, ttok, seq_len=32, seed=4,
                                   max_preds=6,
                                   short_seq_prob=short_seq_prob)
    j = jb.BertPretrainPipeline(lines, jtok, seq_len=32, seed=4, max_preds=6,
                                short_seq_prob=short_seq_prob)
    got = list(t.batches(8, 3))
    want = list(j.batches(8, 3))
    assert len(got) == 3
    for a, b in zip(got, want):
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    valid = np.concatenate([b["valid_length"] for b in got])
    assert (valid < 32).any()   # short rows are in the batches
    with pytest.raises(MXNetError, match="WordPieceTokenizer"):
        tbert.BertPretrainPipeline(lines, object())


def test_batches_through_the_pipeline_tier():
    """``pretrain_bert.py``'s data path: the dicts through
    ``pipeline.IterableSource`` and ``prefetch_to_device`` arrive as NDArrays
    equal to the host arrays."""
    lines = _corpus()
    tok = tmx.data.WordPieceTokenizer.build([ln for ln in lines if ln],
                                            vocab_size=120)
    host = list(tbert.BertPretrainPipeline(lines, tok, seq_len=32,
                                           seed=0).batches(4, 2))
    pipe = tmx.pipeline.Pipeline(tmx.pipeline.IterableSource(
        tbert.BertPretrainPipeline(lines, tok, seq_len=32, seed=0)
        .batches(4, 2))).prefetch_to_device(tmx.cpu(), 2)
    got = list(pipe)
    assert len(got) == 2
    for a, b in zip(got, host):
        for k in b:
            assert a[k].context == tmx.cpu()
            np.testing.assert_array_equal(a[k].asnumpy(), b[k])
