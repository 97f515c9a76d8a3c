"""The port's text readers held against the JAX package (port of
tests/test_datasets_aux.py's news20, movielens and BPE cases,
tests/test_component_tails.py's RowTransformer case and
tests/test_zoo_mains.py's text-pipeline case).

Everything here is host code, so the comparisons are exact: the same
parse of an extracted tree, the same synthetic corpora for the same
seed, the same tokens, dictionaries, ids, BPE merges and vocabularies,
the same sample bytes. No case downloads: the offline error is checked
against a closed port on localhost.
"""

import numpy as np
import pytest

from bigdl_tpu.dataset import bpe as jbpe
from bigdl_tpu.dataset import movielens as jmovielens
from bigdl_tpu.dataset import news20 as jnews20
from bigdl_tpu.dataset import row_transformer as jrow
from bigdl_tpu.dataset import text as jtext
from bigdl_tpu_torch.dataset import bpe, movielens, news20, row_transformer
from bigdl_tpu_torch.dataset import text
from bigdl_tpu_torch.utils.table import Table

CORPUS = ["the lower the newer the lowest", "lower and lower, newest",
          "low new lowest newest the the the"] * 5
TEXT = "The cat sat. The dog ran! A cat ran?  Then: it's 3 o'clock... ok"


# ------------------------------------------------------------ news20
def _write_tree(root, groups):
    for group, docs in groups:
        d = root / group
        d.mkdir(parents=True)
        for name, body in docs.items():
            (d / name).write_text(body)


def test_get_news20_parses_extracted_tree_as_jax(tmp_path):
    _write_tree(tmp_path / "20news-18828",
                [("alt.atheism", {"1001": "first doc text"}),
                 ("sci.space", {"1002": "orbit talk", "1003": "x",
                                "notes.txt": "not a message"})])
    (tmp_path / "20news-18828" / "README").write_text("stray file")
    texts = news20.get_news20(str(tmp_path))
    assert texts == jnews20.get_news20(str(tmp_path))
    assert sorted(texts) == [("first doc text", 1), ("orbit talk", 2),
                             ("x", 2)]


def test_news20_download_raises_clear_error_offline(tmp_path):
    with pytest.raises(RuntimeError, match="synthetic_news20"):
        news20._maybe_download("nope.tar.gz", str(tmp_path),
                               "http://127.0.0.1:9/nope.tar.gz")
    # a file already there is a cache hit: nothing is fetched
    (tmp_path / "have.zip").write_bytes(b"x")
    assert news20._maybe_download("have.zip", str(tmp_path),
                                  "http://127.0.0.1:9/have.zip") \
        == str(tmp_path / "have.zip")


@pytest.mark.parametrize("kw", [dict(n=40, class_num=4),
                                dict(n=2000, class_num=20, seed=3),
                                dict(n=7, class_num=2, doc_len=5)])
def test_synthetic_news20_gives_the_jax_corpus(kw):
    texts = news20.synthetic_news20(**kw)
    assert texts == jnews20.synthetic_news20(**kw)
    k = kw["class_num"]
    assert sorted({lab for _, lab in texts}) == list(range(1, k + 1))[
        :len(texts)]
    for doc, label in texts:
        assert news20._TOPIC_WORDS[label - 1] in doc.split()
    with pytest.raises(ValueError, match="class_num"):
        news20.synthetic_news20(class_num=21)


def test_glove_reader_parses_vectors_as_jax(tmp_path):
    d = tmp_path / "glove.6B"
    d.mkdir()
    (d / "glove.6B.50d.txt").write_text(
        "the " + " ".join(str(0.5 * i) for i in range(50)) + "\n"
        "caf\xe9 " + " ".join("-1.25" for _ in range(50)) + "\n",
        encoding="latin-1")
    got = news20.get_glove_w2v(str(tmp_path), dim=50)
    assert got == jnews20.get_glove_w2v(str(tmp_path), dim=50)
    assert len(got["the"]) == 50 and got["caf\xe9"][0] == -1.25


# --------------------------------------------------------- movielens
def test_movielens_parses_ratings_dat_as_jax(tmp_path):
    ml = tmp_path / "ml-1m"
    ml.mkdir()
    (ml / "ratings.dat").write_text(
        "1::1193::5::978300760\n2::661::3::978302109\n\n3::914::4::1\n")
    data = movielens.read_data_sets(str(tmp_path))
    np.testing.assert_array_equal(data, jmovielens.read_data_sets(
        str(tmp_path)))
    assert data.shape == (3, 4)
    np.testing.assert_array_equal(movielens.get_id_pairs(str(tmp_path)),
                                  data[:, :2])
    np.testing.assert_array_equal(movielens.get_id_ratings(str(tmp_path)),
                                  data[:, :3])


@pytest.mark.parametrize("kw", [dict(), dict(n_users=10, n_items=20,
                                             n_ratings=200, seed=5)])
def test_synthetic_movielens_gives_the_jax_rows(kw):
    data = movielens.synthetic_movielens(**kw)
    np.testing.assert_array_equal(data, jmovielens.synthetic_movielens(**kw))
    assert set(np.unique(data[:, 2])) <= {1, 2, 3, 4, 5}
    assert data[:, 0].min() >= 1 and data[:, 1].min() >= 1


# -------------------------------------------------------------- text
def test_text_pipeline_gives_the_jax_tokens_ids_and_samples(tmp_path):
    sents = list(text.SentenceSplitter()(iter([TEXT, "", "One more."])))
    assert sents == list(jtext.SentenceSplitter()(
        iter([TEXT, "", "One more."])))
    assert len(sents) == 6
    for markers in (True, False):
        for lower in (True, False):
            ours = list(text.SentenceTokenizer(markers, lower)(iter(sents)))
            theirs = list(jtext.SentenceTokenizer(markers, lower)(
                iter(sents)))
            assert ours == theirs
    toks = list(text.SentenceTokenizer()(iter(sents)))
    assert toks[0][0] == text.SENTENCE_START and toks[0][-1] == \
        text.SENTENCE_END

    for vocab in (None, 5, 100):
        d, jd = text.Dictionary(toks, vocab), jtext.Dictionary(toks, vocab)
        assert d.word2index() == jd.word2index()
        assert d.index2word() == jd.index2word()
        assert d.vocab_size() == jd.vocab_size()
        assert d.get_index("zzz-not-present") == d.get_index(
            text.Dictionary.UNK)
        assert [d.get_index(w) for w in toks[1]] == [jd.get_index(w)
                                                     for w in toks[1]]
    d = text.Dictionary(toks, vocab_size=5)
    d.save(str(tmp_path))
    # the files are interchangeable
    assert jtext.Dictionary.load(str(tmp_path)).word2index() == \
        d.word2index()
    d2 = text.Dictionary.load(str(tmp_path / "dictionary.txt"))
    assert d2.word2index() == d.word2index() and d2.get_word(0) == \
        d.get_word(0)

    jd = jtext.Dictionary(toks, vocab_size=5)
    for kw in (dict(fixed_length=8), dict(fixed_length=4),
               dict(fixed_length=None, one_hot=False)):
        pipe = text.TextToLabeledSentence(d) >> text.LabeledSentenceToSample(
            d.vocab_size(), **kw)
        jpipe = jtext.TextToLabeledSentence(jd) >> \
            jtext.LabeledSentenceToSample(jd.vocab_size(), **kw)
        ours, theirs = list(pipe(iter(toks))), list(jpipe(iter(toks)))
        assert len(ours) == len(theirs) == len(toks)
        for s, js in zip(ours, theirs):
            for a, b in ((s.feature(), js.feature()),
                         (s.label(), js.label())):
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        assert ours[0].label().min() >= 1.0          # 1-based targets


# --------------------------------------------------------------- BPE
@pytest.mark.parametrize("corpus,size", [
    (CORPUS, 80), (["a banana bandana and a band"] * 3, 40),
    (["hello, world. hello world!"] * 4, 60),
    ([t for t, _ in jnews20.synthetic_news20(n=200, class_num=20)], 400)])
def test_bpe_learns_the_jax_merges_and_ids(corpus, size):
    tok = bpe.BPETokenizer.train(corpus, vocab_size=size)
    jtok = jbpe.BPETokenizer.train(corpus, vocab_size=size)
    assert tok.merges == jtok.merges
    assert tok.vocab == jtok.vocab
    assert tok.vocab_size <= size
    for doc in corpus[:5] + ["the zzz \xe9 lowest, newer!", ""]:
        for bos, eos in ((False, False), (True, True)):
            ids = tok.encode(doc, add_bos=bos, add_eos=eos)
            assert ids == jtok.encode(doc, add_bos=bos, add_eos=eos)
            assert tok.decode(ids) == jtok.decode(ids)


def test_bpe_roundtrip_unk_bos_eos_and_persistence(tmp_path):
    tok = bpe.BPETokenizer.train(CORPUS, vocab_size=80)
    assert tok.decode(tok.encode("the lowest newest lower")) == \
        "the lowest newest lower"
    assert len(tok.encode("the")) <= 2
    ids = tok.encode("the zzz \xe9")
    assert bpe.UNK in ids and "the" in tok.decode(ids)
    ids = tok.encode("the lower", add_bos=True, add_eos=True)
    assert ids[0] == bpe.BOS and ids[-1] == bpe.EOS
    p = str(tmp_path / "bpe.json")
    tok.save(p)
    for loaded in (bpe.BPETokenizer.load(p), jbpe.BPETokenizer.load(p)):
        assert loaded.vocab == tok.vocab
        assert loaded.encode("a lower newest") == tok.encode("a lower newest")
    # unknown words keep their spacing; the vocabulary cap raises
    tok = bpe.BPETokenizer.train(["abc abc"] * 3, vocab_size=30)
    assert tok.decode(tok.encode("abc zz abc")).count("abc") == 2
    assert "abc<unk>" not in tok.decode(tok.encode("abc zz abc"))
    with pytest.raises(ValueError, match="vocab_size"):
        bpe.BPETokenizer.train(["abcdefghijklmnopqrstuvwxyz"], vocab_size=10)


def test_bpe_feeds_the_ports_transformer_generate():
    import torch

    from bigdl_tpu_torch.models.transformer import TransformerLM

    tok = bpe.BPETokenizer.train(["hello world, small world"] * 3,
                                 vocab_size=48)
    m = TransformerLM(tok.vocab_size, embed_dim=16, num_heads=2,
                      num_layers=1, max_len=32, use_rope=True, seed=0,
                      device="cpu")
    m.evaluate()
    prompt = torch.tensor([tok.encode("hello world", add_bos=True)])
    out = m.generate(prompt, 5)
    decoded = tok.decode(out[0].tolist())
    assert isinstance(decoded, str) and decoded.startswith("hello world")


# ----------------------------------------------------- RowTransformer
ROWS = [{"a": 1.0, "b": 2.0, "c": 3.0}, {"a": 4.0, "b": 5.0, "c": 6.0}]


def _same_tables(ours, theirs):
    assert isinstance(ours, Table)
    assert list(ours.keys()) == list(theirs.keys())
    for k in ours.keys():
        np.testing.assert_array_equal(ours[k], theirs[k])
        assert ours[k].dtype == theirs[k].dtype


@pytest.mark.parametrize("make", [
    lambda m: m.RowTransformer.atomic(["a", "c"]),
    lambda m: m.RowTransformer.atomic(indices=[2, 0], row_size=3),
    lambda m: m.RowTransformer.numeric(["a", "b", "c"]),
    lambda m: m.RowTransformer.atomic_with_numeric(["a"], ["b", "c"]),
    lambda m: m.RowTransformer([m.RowTransformSchema(
        "sq", field_names=["b"], transform=lambda v: [x * x for x in v]),
        m.RowTransformSchema("all")]),
])
def test_row_transformer_gives_the_jax_tables(make):
    ours = list(make(row_transformer)(iter(ROWS)))
    theirs = list(make(jrow)(iter(ROWS)))
    assert len(ours) == len(theirs) == 2
    for o, t in zip(ours, theirs):
        _same_tables(o, t)


def test_row_transformer_argument_errors():
    with pytest.raises(ValueError, match="replicated"):
        row_transformer.RowTransformer.atomic(["a", "a"])
    with pytest.raises(ValueError, match="out of bound"):
        row_transformer.RowTransformer.atomic(indices=[3], row_size=3)
    with pytest.raises(ValueError, match="not both"):
        row_transformer.RowTransformSchema("k", field_names=["a"],
                                           indices=[0])
