"""The port's text and record preparation against the reference's, on the
CPU: `data/bpe.py`, `data/vocabulary.py`, `data/indexer.py`,
`data/preprocess.py` and `data/readers.py`.

The port's pre-tokenizer is GPT-2's pattern written for `re`, over
character classes built from `unicodedata` (the card's machine has no
`regex`); the reference runs the pattern through `regex`. Every check
here is exact:

- the tokens of every code point Python's Unicode database assigns, and
  of corpora with accents, CJK, combining marks, `Nl` / `No` numerals,
  `_`, contractions, U+001C-U+001F, U+0085, U+00A0, U+2028 and trailing
  whitespace, equal `regex.findall(PAT, text)`; the whitespace class is
  the `regex` module's `\\s`, code point by code point;
- a trained BPE's merges (with the training's tie order), vocabulary,
  ids and decoded text, and one loaded from files, equal the
  reference's;
- the indexer's ids, byte-exact character offsets, copy masks, proper
  masks and decoded text, the word vocabulary, the text cleanup and
  templating equal the reference's;
- the readers' records, paragraph windows, instances (every builder
  flag), the `jsonl_news` dataset through `config.build_dataset`, the
  Mongo reader over a fake database and the HDF5 loader's batches equal
  the reference's.
"""

import json
import unicodedata

import numpy as np
import pytest

regex = pytest.importorskip("regex")

from news_image_caption_tpu import config as jax_config  # noqa: E402
from news_image_caption_tpu.data import bpe as jax_bpe  # noqa: E402
from news_image_caption_tpu.data import indexer as jax_indexer  # noqa: E402
from news_image_caption_tpu.data import preprocess as jax_pre  # noqa: E402
from news_image_caption_tpu.data import readers as jax_readers  # noqa: E402
from news_image_caption_tpu.data import vocabulary as jax_vocab  # noqa: E402
from news_image_caption_tpu_torch import config  # noqa: E402
from news_image_caption_tpu_torch.data import (bpe, indexer,  # noqa: E402
                                               preprocess, readers,
                                               vocabulary)

CORPUS = [
    "Barack Obama's visit to Zürich: the café was José's favourite.",
    "北京 (Beijing) 中文字符 and 日本語のテキスト, 한국어 뉴스.",
    "Combining marks: e\u0301cole, n\u0303o, a\u0308\u0301 x\u20dd \u0301.",
    "Numerals Ⅻ and ² and ½, ³⁄₄ ٣ ४ ⅷ 10,000 or 3.14 and 2nd.",
    "snake_case under_score __init__ _x_ a_1 _",
    "It's they'll we've I'm you'd she's 'S ’s don't 're 'd'll",
    "controls \x1c\x1d\x1e\x1f between \x1cwords\x1f",
    "next\x85line nbsp\xa0here line\u2028sep para\u2029sep \u3000wide",
    "trailing whitespace   \n\n  ",
    "tabs\tand\nnewlines \r\n mixed  \t end ",
    "emoji 🙂 👍🏽 and flags 🇺🇸 ok",
    "   leading spaces and  double  spaces",
    "Angela Merkel met Emmanuel Macron in Paris on Monday.",
    "",
    " ",
    "A",
]


def _all_assigned() -> str:
    """Every code point Python's Unicode database assigns, but surrogates,
    in a seeded order, a space after every seventh."""
    chars = [chr(c) for c in range(0x110000)
             if unicodedata.category(chr(c)) not in ("Cn", "Cs")]
    order = np.random.default_rng(0).permutation(len(chars))
    out = []
    for i, j in enumerate(order):
        out.append(chars[j])
        if i % 7 == 6:
            out.append(" ")
    return "".join(out)


def test_whitespace_is_the_regex_modules():
    every = "".join(chr(c) for c in range(0x110000)
                    if not 0xD800 <= c <= 0xDFFF)
    assert regex.findall(r"\s", every) == [c for c in every
                                           if c in bpe.WHITE_SPACE]
    # Not str.isspace(): the file and group separators are not \s.
    assert not set("\x1c\x1d\x1e\x1f") & set(bpe.WHITE_SPACE)


def test_pretokenizer_matches_regex_on_every_assigned_code_point():
    text = _all_assigned()
    assert bpe.pattern().findall(text) == regex.findall(jax_bpe.PAT, text)
    # The same code points in their own order: runs of letters, numbers
    # and marks as Unicode lays them out.
    ordered = "".join(chr(c) for c in range(0x110000)
                      if unicodedata.category(chr(c)) not in ("Cn", "Cs"))
    assert bpe.pattern().findall(ordered) == regex.findall(jax_bpe.PAT,
                                                           ordered)


def test_pretokenizer_matches_regex_on_the_corpus_and_mixtures():
    pool = sorted(set("".join(CORPUS)) | set("'stremvld 0123456789"))
    rng = np.random.default_rng(1)
    texts = list(CORPUS)
    for _ in range(400):
        n = int(rng.integers(1, 30))
        texts.append("".join(pool[i] for i in rng.integers(0, len(pool), n)))
    for t in texts:
        got = [(m.group(0), m.start()) for m in bpe.pattern().finditer(t)]
        want = [(m.group(0), m.start())
                for m in regex.finditer(jax_bpe.PAT, t)]
        assert got == want, repr(t)


@pytest.fixture(scope="module")
def trained():
    corpus = CORPUS * 3 + [f"{w} {i}" for i, w in enumerate(
        "the cat sat on the mat the end".split())]
    return jax_bpe.ByteBPE.train(corpus, 200), bpe.ByteBPE.train(corpus, 200)


def test_bpe_train_encode_decode_match(trained):
    want, got = trained
    assert got.bpe_ranks == want.bpe_ranks
    assert list(got.bpe_ranks) == list(want.bpe_ranks)   # merge order
    assert got.encoder == want.encoder
    assert got.vocab_size == want.vocab_size
    for t in CORPUS + ["unseen Ωmega wörds 42"]:
        ids = got.encode(t)
        assert ids == want.encode(t), repr(t)
        assert got.decode(ids) == want.decode(ids) == t
    for max_len in (512, 8):
        jr, r = (jax_bpe.RobertaBPE(want, max_len),
                 bpe.RobertaBPE(got, max_len))
        for t in CORPUS:
            for specials in (True, False):
                assert r.encode(t, specials) == jr.encode(t, specials)
            assert r.decode(r.encode(t)) == jr.decode(jr.encode(t))
        assert r.vocab_size == jr.vocab_size


def test_bpe_from_files_match(tmp_path, trained):
    want, _ = trained
    enc = tmp_path / "encoder.json"
    enc.write_text(json.dumps(want.encoder))
    merges = tmp_path / "merges.txt"
    lines = ["#version: 0.2"] + [f"{a} {b}" for a, b in want.bpe_ranks]
    # '#' opens real merges too: only the header line is skipped.
    lines.insert(3, "# #")
    lines.insert(5, "")
    merges.write_text("\n".join(lines) + "\n", encoding="utf-8")
    a = jax_bpe.ByteBPE.from_files(str(enc), str(merges))
    b = bpe.ByteBPE.from_files(str(enc), str(merges))
    assert b.bpe_ranks == a.bpe_ranks and b.encoder == a.encoder
    assert ("#", "#") in b.bpe_ranks
    for t in CORPUS:
        assert b.encode(t) == a.encode(t)


def test_indexer_ids_offsets_and_masks_match(trained):
    want_bpe, got_bpe = trained
    for max_len in (512, 12):
        jidx = jax_indexer.RobertaCopyIndexer(want_bpe, max_len)
        idx = indexer.RobertaCopyIndexer(got_bpe, max_len)
        for t in CORPUS:
            ids, offsets = idx.encode_with_offsets(t)
            assert (ids, offsets) == jidx.encode_with_offsets(t), repr(t)
            spans = [(0, 6, 1), (7, 12, 2), (len(t) - 4, len(t), 3)]
            assert idx.encode(t, spans) == jidx.encode(t, spans)
            assert idx.encode(t) == jidx.encode(t)
            assert idx.proper_masks(t) == jidx.proper_masks(t)
            assert idx.decode(ids) == jidx.decode(ids)
    # A multi-byte token's pieces cover its characters exactly.
    _, offsets = idx.encode_with_offsets("José")
    assert offsets[0][0] == 0 and offsets[-1][1] == 4


def test_word_vocabulary_matches(tmp_path):
    texts = [t for t in CORPUS if t] * 2 + ["the the the cat"]
    for kw in ({}, {"min_count": 2}, {"max_size": 10}, {"max_size": 2}):
        want = jax_vocab.WordVocab.build(texts, **kw)
        got = vocabulary.WordVocab.build(texts, **kw)
        assert got.word2idx == want.word2idx and len(got) == len(want)
        for t in texts + ["unknown words here"]:
            ids = got.encode(t)
            assert ids == want.encode(t)
            assert got.decode(ids) == want.decode(ids)
            assert got.decode(ids, False) == want.decode(ids, False)
    got.save(str(tmp_path / "v.json"))
    assert jax_vocab.WordVocab.load(str(tmp_path / "v.json")).word2idx == \
        vocabulary.WordVocab.load(str(tmp_path / "v.json")).word2idx
    want = vars(jax_vocab.RobertaSpecialTokens())
    assert vocabulary.RobertaSpecialTokens() == \
        vocabulary.RobertaSpecialTokens(**want)


def test_preprocess_matches():
    texts = CORPUS + ["<p>Barack <b>Obama</b> visited Paris &amp; "
                      "London on Monday!</p>", "Mr. John Smith of Acme "
                      "Corp. said on Jan. 5 that New York is big."]
    for t in texts:
        for strip in (True, False):
            assert preprocess.clean_sentence(t, strip) == \
                jax_pre.clean_sentence(t, strip)
        assert preprocess.entity_spans(t) == jax_pre.entity_spans(t)
        assert preprocess.template_entities(t) == jax_pre.template_entities(t)
        for n in (500, 3):
            assert preprocess.truncate_words(t, n) == \
                jax_pre.truncate_words(t, n)


def _records(n: int = 6):
    rng = np.random.default_rng(2)
    names = ["Barack Obama", "Angela Merkel", "New York", "José Müller"]
    out = []
    for i in range(n):
        rec = {"caption": f"{names[i % 4]} visited city number {i}.",
               "metadata": {"id": i}}
        if i % 2:
            rec["paragraphs"] = [
                f"Paragraph {j}: {names[(i + j) % 4]} said it's {j}."
                for j in range(5)]
            rec["image_index"] = i % 5
        else:
            rec["article"] = (f"{names[(i + 1) % 4]} was seen in "
                              f"{names[i % 4]} on day {i}. It rained.")
        if i % 3 == 0:
            rec["face_embeds"] = rng.standard_normal((2, 512)).tolist()
        if i % 3 == 1:
            rec["obj_embeds"] = rng.standard_normal((3, 24)).tolist()
        if i == 4:
            rec["image_path"] = "/nonexistent/img.jpg"
        out.append(rec)
    return out


@pytest.fixture(scope="module")
def jsonl(tmp_path_factory):
    path = tmp_path_factory.mktemp("jsonl") / "news.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in _records()))
    return str(path)


def _same(a, b):
    """Equal nested structures of numpy arrays (NaNs equal), dicts, lists
    and scalars."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b


def test_jsonl_reader_and_paragraph_window_match(jsonl, trained):
    want_bpe, got_bpe = trained
    want = list(jax_readers.JsonlNewsReader(jsonl))
    got = list(readers.JsonlNewsReader(jsonl))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        _same(vars(g), vars(w))
    jidx = jax_indexer.RobertaCopyIndexer(want_bpe)
    idx = indexer.RobertaCopyIndexer(got_bpe)
    paras = [f"Paragraph {j} " + "word " * (3 * j) for j in range(8)]
    for image_index in (-1, 0, 3, 7, 20):
        for budget in (510, 40, 12, 1):
            assert readers.paragraph_window(paras, image_index, idx, budget) \
                == jax_readers.paragraph_window(paras, image_index, jidx,
                                                budget)
    assert readers.paragraph_window([], 0, idx) == ""


@pytest.mark.parametrize("flags", [
    {},
    {"with_copy_masks": True},
    {"with_faces": True, "with_objects": True, "max_faces": 3,
     "max_objects": 2},
    {"use_paragraph_window": True, "max_context_words": 7},
], ids=["plain", "copy", "faces_objects", "window"])
def test_instance_builder_matches(jsonl, trained, flags):
    want_bpe, got_bpe = trained
    jb = jax_readers.InstanceBuilder(
        jax_indexer.RobertaCopyIndexer(want_bpe, 24), **flags)
    b = readers.InstanceBuilder(indexer.RobertaCopyIndexer(got_bpe, 24),
                                **flags)
    recs = list(readers.JsonlNewsReader(jsonl))
    jrecs = list(jax_readers.JsonlNewsReader(jsonl))
    recs[2].image = jrecs[2].image = np.zeros((4, 4, 3), np.uint8)
    for rec, jrec in zip(recs, jrecs):
        _same(b.build(rec), jb.build(jrec))
    assert b.obj_dim == jb.obj_dim


def test_jsonl_news_dataset_through_build_dataset(jsonl):
    cfg = {"dataset": {"type": "jsonl_news", "path": jsonl,
                       "with_copy_masks": True, "bpe_merges": 150,
                       "val": {"with_objects": True, "max_objects": 2}}}
    for split in ("train", "val"):
        want = jax_config.build_dataset(cfg, split)
        got = config.build_dataset(cfg, split)
        assert len(got) == len(want) == 6
        _same(got, want)
    # One trained BPE per corpus source: sibling splits share it.
    assert (readers._BPE_MEMO.keys() and
            len([k for k in readers._BPE_MEMO if k[1] == 150]) == 1)
    texts = ["Barack Obama visited.", "José said it's fine."]
    _same(readers.jsonl_news_dataset(jsonl, bpe_corpus=texts, bpe_merges=30),
          jax_readers.jsonl_news_dataset(jsonl, bpe_corpus=texts,
                                         bpe_merges=30))


class _Cursor(list):
    closed = False

    def close(self):
        self.closed = True


class _FakeDb:
    """The two collections `MongoNewsReader` reads."""

    def __init__(self, image_dir):
        self.cursors = []
        self.samples = [
            {"_id": "a", "article_id": 1, "split": "train",
             "image_index": 0},
            {"_id": "b", "article_id": 2, "split": "train",
             "image_index": "1", "caption": "unused"},
            {"_id": "c", "article_id": 3, "split": "train"},    # no article
            {"_id": "d", "article_id": 1, "split": "train"},    # no image
            {"_id": "e", "article_id": 2, "split": "test"},
            {"_id": "f", "article_id": 4, "split": "train",
             "image_index": 2},                                 # no caption
        ]
        self._articles = {
            1: {"_id": 1, "context": "Obama spoke.", "web_url": "u1",
                "images": {"0": "  Barack Obama speaks.  "}},
            2: {"_id": 2, "context": "Merkel met.", "paragraphs": ["p"],
                "images": {"1": "Angela Merkel."}},
            4: {"_id": 4, "context": "x", "images": {"0": "y"}},
        }
        for name in ("a", "b", "c", "e", "f"):
            (image_dir / f"{name}.jpg").write_bytes(b"")

    @property
    def splits(self):
        db = self

        class Splits:
            def find(self, query, no_cursor_timeout):
                assert no_cursor_timeout
                cur = _Cursor(s for s in db.samples
                              if s["split"] == query["split"])
                db.cursors.append(cur)
                return cur
        return Splits()

    @property
    def articles(self):
        db = self

        class Articles:
            def find_one(self, query):
                return db._articles.get(query["_id"])
        return Articles()


def test_mongo_reader_over_a_fake_database_matches(tmp_path):
    db = _FakeDb(tmp_path)
    want = list(jax_readers.MongoNewsReader(db=db, image_dir=str(tmp_path)))
    got = list(readers.MongoNewsReader(db=db, image_dir=str(tmp_path)))
    assert [r.caption for r in got] == ["Barack Obama speaks.",
                                        "Angela Merkel."]
    for g, w in zip(got, want):
        _same(vars(g), vars(w))
    assert all(c.closed for c in db.cursors)


@pytest.fixture(scope="module")
def h5(tmp_path_factory):
    h5py = pytest.importorskip("h5py")
    where = tmp_path_factory.mktemp("h5")
    rng = np.random.default_rng(3)
    n, per = 7, [5, 2, 6, 5, 1, 5, 3]
    labels = rng.integers(1, 30, size=(sum(per), 6)).astype(np.uint32)
    labels[::4, 4:] = 0
    start = np.cumsum([0] + per[:-1]) + 1
    with h5py.File(where / "data.h5", "w") as f:
        f["images"] = rng.integers(0, 256, size=(n, 14, 14, 3),
                                   dtype=np.uint8)
        f["labels"] = labels
        f["label_start_ix"] = start
        f["label_end_ix"] = start + np.array(per) - 1
    splits = ["train", "train", "val", "train", "val", "test", "train"]
    info = {"images": [{"split": s, "id": 100 + i, "file_path": f"{i}.jpg",
                        "other": 1} for i, s in enumerate(splits)],
            "ix_to_word": {str(i): f"w{i}" for i in range(1, 30)}}
    (where / "data.json").write_text(json.dumps(info))
    return str(where / "data.h5"), str(where / "data.json")


def test_h5_loader_batches_match(h5):
    want = jax_readers.H5DataLoader(*h5, seq_per_img=5, seed=4)
    got = readers.H5DataLoader(*h5, seq_per_img=5, seed=4)
    assert got.vocab_size == want.vocab_size == 29
    assert got.seq_length == want.seq_length == 6
    assert got.splits == want.splits
    for split, bs in [("train", 3)] * 5 + [("val", 3), ("test", 2)] * 2:
        _same(got.get_batch(split, bs), want.get_batch(split, bs))
