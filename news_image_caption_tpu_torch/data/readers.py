"""Dataset readers: jsonl-materialized news data + gated Mongo + HDF5.

A copy of `news_image_caption_tpu/data/readers.py`: the port imports
nothing of the JAX package. `tests/test_torch_data_prep.py` and
`tests/test_torch_compat.py` hold the two equal. `jsonl_news_dataset` is
the `jsonl_news` dataset of `config.py::build_dataset`. pymongo and h5py
are imported only where `MongoNewsReader` and `H5DataLoader` open their
sources.

Capability parity targets (SURVEY.md §2.5):
- the 11 Mongo-backed lazy readers (goodnews_flattened,
  goodnews_flattened_glove, goodnews_entity(_pointer),
  goodnews_face_ner_matched, goodnews_copy_matched, nytimes{,_glove,
  _position,_copy_matched,_faces_ner_matched})
  ttl/tell/data/dataset_readers/ — unified here as
  one instance builder parameterized by which fields it attaches
  (copy masks, faces, objects, entities), reading from either a
  portable jsonl materialization or MongoDB (if pymongo exists);
- paragraph-window context selection around the image position
  (nytimes_faces_ner_matched.py:145-170);
- Gen-1 HDF5 loader contract: `get_batch` dict with images, labels,
  masks, bounds, infos + `wrapped` epoch flag
  (dataloader.py:57-371).

Readers produce numpy Examples; fixed-shape batching (and the native
C++ prefetch path) happens in collate/native_loader.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from news_image_caption_tpu_torch.data.indexer import RobertaCopyIndexer
from news_image_caption_tpu_torch.data.preprocess import (clean_sentence,
                                                          entity_spans,
                                                          truncate_words)
from news_image_caption_tpu_torch.utils.registry import DATASETS


@dataclass
class NewsRecord:
    """One raw news item (the materialized/Mongo schema)."""
    caption: str
    article: str
    image_path: Optional[str] = None
    image: Optional[np.ndarray] = None           # HWC uint8
    image_index: int = 0                         # paragraph position
    paragraphs: Optional[List[str]] = None
    face_embeds: Optional[np.ndarray] = None     # [n_faces, 512]
    obj_embeds: Optional[np.ndarray] = None      # [n_obj, dim]
    metadata: Dict = field(default_factory=dict)


def _bpe_cost(indexer: RobertaCopyIndexer, text: str) -> int:
    """Memoized BPE token count — articles with several images window
    the same paragraphs repeatedly in the loader hot path. The cache
    lives ON the indexer (a module-level lru_cache keyed on
    (indexer, text) would pin every indexer and 65k paragraph strings
    for the process lifetime)."""
    cache = getattr(indexer, "_bpe_cost_cache", None)
    if cache is None:
        cache = indexer._bpe_cost_cache = {}
    cost = cache.get(text)
    if cost is None:
        if len(cache) >= 65536:
            cache.clear()
        cost = cache[text] = len(indexer.encode_with_offsets(text)[0])
    return cost


def paragraph_window(paragraphs: Sequence[str], image_index: int,
                     indexer: RobertaCopyIndexer,
                     budget: int = 510) -> str:
    """Expand ± around the image's paragraph until ~budget BPE tokens.

    Parity: nytimes_faces_ner_matched.py:145-170.
    """
    if not paragraphs:
        return ""
    n = len(paragraphs)
    i = min(max(image_index, 0), n - 1)
    chosen = [i]
    used = _bpe_cost(indexer, paragraphs[i])
    lo, hi = i - 1, i + 1
    # A side STOPS expanding once a paragraph does not fit — skipping
    # it and continuing outward would join non-adjacent paragraphs
    # with a silent gap (the reference window is contiguous,
    # nytimes_faces_ner_matched.py:145-170).
    lo_open, hi_open = True, True
    while used < budget and ((lo_open and lo >= 0)
                             or (hi_open and hi < n)):
        if lo_open and lo >= 0:
            cost = _bpe_cost(indexer, paragraphs[lo])
            if used + cost <= budget:
                chosen.append(lo)
                used += cost
                lo -= 1
            else:
                lo_open = False
        if hi_open and hi < n:
            cost = _bpe_cost(indexer, paragraphs[hi])
            if used + cost <= budget:
                chosen.append(hi)
                used += cost
                hi += 1
            else:
                hi_open = False
    return " ".join(paragraphs[j] for j in sorted(set(chosen)))


class JsonlNewsReader:
    """Reads materialized NewsRecords from a .jsonl file.

    Record schema: {caption, article | paragraphs, image_path?,
    image_index?, face_embeds?, obj_embeds?, metadata?}.
    """

    def __init__(self, path: str):
        self.path = path

    def __iter__(self) -> Iterator[NewsRecord]:
        with open(self.path) as f:
            for line in f:
                obj = json.loads(line)
                yield NewsRecord(
                    caption=obj["caption"],
                    article=obj.get("article")
                    or " ".join(obj.get("paragraphs", [])),
                    paragraphs=obj.get("paragraphs"),
                    image_path=obj.get("image_path"),
                    image_index=obj.get("image_index", 0),
                    face_embeds=(np.asarray(obj["face_embeds"],
                                            np.float32)
                                 if obj.get("face_embeds") else None),
                    obj_embeds=(np.asarray(obj["obj_embeds"],
                                           np.float32)
                                if obj.get("obj_embeds") else None),
                    metadata=obj.get("metadata", {}))


class MongoNewsReader:
    """MongoDB-backed reader (goodnews/nytimes collections).

    Parity: goodnews_flattened.py:25-118 splits/articles layout.
    Requires pymongo; import is deferred so the rest of the data
    layer works without it.
    """

    def __init__(self, host: str = "localhost", port: int = 27017,
                 database: str = "goodnews", split: str = "train",
                 image_dir: str = ".", db=None):
        """db: injected database handle exposing `.splits.find(...)`
        and `.articles.find_one(...)` — bypasses pymongo entirely
        (dependency injection; the transport/schema mapping is tested
        against a fake this way, pymongo is not installable here)."""
        if db is not None:
            self.client = None
            self.db = db
        else:
            import pymongo  # gated dependency
            self.client = pymongo.MongoClient(host=host, port=port)
            self.db = self.client[database]
        self.split = split
        self.image_dir = image_dir

    def __iter__(self) -> Iterator[NewsRecord]:
        cursor = self.db.splits.find(
            {"split": self.split}, no_cursor_timeout=True)
        try:
            yield from self._iter_cursor(cursor)
        finally:
            # no_cursor_timeout cursors are immortal server-side until
            # explicitly closed; early break/exception must not leak.
            cursor.close()

    def _iter_cursor(self, cursor) -> Iterator[NewsRecord]:
        for sample in cursor:
            article = self.db.articles.find_one(
                {"_id": sample["article_id"]})
            if article is None:
                continue
            image_path = os.path.join(
                self.image_dir, f"{sample['_id']}.jpg")
            if not os.path.exists(image_path):
                continue  # missing-image skip (goodnews_flattened.py:90)
            idx = sample.get("image_index", 0)
            if "images" in article:
                caption = (article.get("images") or {}).get(str(idx))
            else:
                caption = sample.get("caption", "")
            if not caption:
                # Missing/null caption entry: skip like missing image
                # files — one malformed document must not abort the
                # whole training iterator.
                continue
            yield NewsRecord(
                caption=caption.strip(),
                article=article.get("context", ""),
                paragraphs=article.get("paragraphs"),
                image_path=image_path,
                image_index=int(idx) if str(idx).isdigit() else 0,
                metadata={"web_url": article.get("web_url", ""),
                          "_id": str(sample["_id"])})


class InstanceBuilder:
    """NewsRecord -> model-ready numpy instance.

    Flags select the reader variant being reproduced:
      with_copy_masks  (goodnews_copy_matched / pointer readers)
      with_faces / with_objects (faces/objects readers)
      use_paragraph_window (nytimes readers)
    """

    def __init__(self, indexer: RobertaCopyIndexer,
                 max_context_words: int = 500,
                 with_copy_masks: bool = False,
                 with_faces: bool = False,
                 with_objects: bool = False,
                 use_paragraph_window: bool = False,
                 max_faces: int = 4, max_objects: int = 64,
                 obj_dim: Optional[int] = None,
                 analyzer=None):
        self.indexer = indexer
        self.max_context_words = max_context_words
        self.with_copy_masks = with_copy_masks
        self.with_faces = with_faces
        self.with_objects = with_objects
        self.use_paragraph_window = use_paragraph_window
        self.max_faces = max_faces
        self.max_objects = max_objects
        # Object-feature width: latched from the first record that
        # carries embeddings (or set explicitly); every instance then
        # emits the SAME width — records without embeddings previously
        # defaulted to 2048 and broke batching when the real features
        # were a different dim.
        self.obj_dim = obj_dim
        # Resolve ONCE: get_analyzer() may construct a spaCy pipeline.
        if analyzer is None and with_copy_masks:
            from news_image_caption_tpu_torch.evaluation.text_analysis \
                import get_analyzer
            analyzer = get_analyzer()
        self.analyzer = analyzer

    def build(self, rec: NewsRecord) -> Dict:
        if self.use_paragraph_window and rec.paragraphs:
            context = paragraph_window(rec.paragraphs, rec.image_index,
                                       self.indexer)
        else:
            context = truncate_words(rec.article,
                                     self.max_context_words)
        caption = clean_sentence(rec.caption, strip_punct=False)

        out: Dict = {"metadata": {**rec.metadata,
                                  "caption": rec.caption,
                                  "context": context}}
        if self.with_copy_masks:
            cap_spans = entity_spans(caption, self.analyzer)
            numbered = [(s, e, i + 1)
                        for i, (s, e, _) in enumerate(cap_spans)]
            enc = self.indexer.encode(caption, numbered)
            out["caption_ids"] = np.asarray(enc["ids"], np.int32)
            out["caption_copy_masks"] = np.asarray(
                enc["copy_masks"], np.int32)
            ctx = self.indexer.proper_masks(context, self.analyzer)
            out["article_ids"] = np.asarray(ctx["ids"], np.int32)
            out["context_proper_masks"] = np.asarray(
                ctx["proper_masks"], np.int32)
        else:
            out["caption_ids"] = np.asarray(
                self.indexer.encode(caption)["ids"], np.int32)
            out["article_ids"] = np.asarray(
                self.indexer.encode(context)["ids"], np.int32)

        if rec.image is not None:
            out["image"] = rec.image
        elif rec.image_path:
            out["image_path"] = rec.image_path

        if self.with_faces:
            out["face_embeds"] = self._pad_feats(
                rec.face_embeds, self.max_faces, 512)
        if self.with_objects:
            if rec.obj_embeds is not None:
                dim = rec.obj_embeds.shape[-1]
                if self.obj_dim is None:
                    self.obj_dim = dim
                elif dim != self.obj_dim:
                    raise ValueError(
                        f"inconsistent obj_embeds width: record has "
                        f"{dim}, dataset uses {self.obj_dim}")
            out["obj_embeds"] = self._pad_feats(
                rec.obj_embeds, self.max_objects,
                self.obj_dim or 2048)
        return out

    @staticmethod
    def _pad_feats(feats: Optional[np.ndarray], max_n: int,
                   dim: int) -> np.ndarray:
        """NaN-pad to fixed count (NaN rows become masks downstream,
        parity: transformer_faces_objects.py:373-379)."""
        out = np.full((max_n, dim), np.nan, np.float32)
        if feats is not None and len(feats):
            n = min(len(feats), max_n)
            out[:n] = feats[:n]
        return out


# ----------------------------------------------------------------------
# Gen-1 HDF5 loader contract
# ----------------------------------------------------------------------


class H5DataLoader:
    """Gen-1 `DataLoader.get_batch` contract over HDF5 files.

    Expects an HDF5 with datasets: images [N,H,W,3] uint8,
    labels [M, seq_len] int, label_start_ix/label_end_ix [N]
    (1-indexed like the reference), and a split JSON mapping
    {"images": [{"split": ..., "id": ...}, ...]}.

    get_batch returns {images, labels, masks, gts, bounds, infos}
    with seq_per_img replication and the `wrapped` epoch flag
    (parity: dataloader.py:245-371).
    """

    def __init__(self, h5_path: str, split_json: str,
                 seq_per_img: int = 5, seed: int = 0):
        import h5py
        self.h5 = h5py.File(h5_path, "r")
        with open(split_json) as f:
            info = json.load(f)
        self.images_info = info["images"]
        # vocab size from the split JSON's ix_to_word, like the
        # reference (dataloader.py:67-75) — training drivers size the
        # embedding/logit layers from this.
        self.ix_to_word = info.get("ix_to_word", {})
        self.vocab_size = (max(int(k) for k in self.ix_to_word)
                           if self.ix_to_word else None)
        self.seq_per_img = seq_per_img
        self.splits: Dict[str, List[int]] = {}
        for i, img in enumerate(self.images_info):
            self.splits.setdefault(img.get("split", "train"),
                                   []).append(i)
        self._iters = {s: 0 for s in self.splits}
        self._rng = np.random.default_rng(seed)
        # Only the TRAIN split shuffles (reference dataloader.py:265-266
        # reshuffles train only): val/test keep index order so periodic
        # evals score the same fixed prefix every time.
        if "train" in self.splits:
            self._rng.shuffle(self.splits["train"])

    @property
    def seq_length(self) -> int:
        return self.h5["labels"].shape[1]

    def get_batch(self, split: str, batch_size: int = 16) -> Dict:
        idxs = self.splits[split]
        images, labels, infos, gts = [], [], [], []
        wrapped = False
        for _ in range(batch_size):
            pos = self._iters[split]
            if pos >= len(idxs):
                if split == "train":
                    self._rng.shuffle(idxs)
                self._iters[split] = 0
                pos = 0
                wrapped = True
            ix = idxs[pos]
            self._iters[split] += 1
            images.append(self.h5["images"][ix])
            start = int(self.h5["label_start_ix"][ix]) - 1
            end = int(self.h5["label_end_ix"][ix])
            caps = self.h5["labels"][start:end]
            gts.append(np.asarray(caps))
            ncap = len(caps)
            if ncap >= self.seq_per_img:
                # Contiguous block WITHOUT replacement (reference
                # dataloader.py:328-333) — every caption of an image
                # with exactly seq_per_img captions trains each visit.
                q = int(self._rng.integers(
                    0, ncap - self.seq_per_img + 1))
                labels.append(np.asarray(
                    caps[q:q + self.seq_per_img]))
            else:
                # Too few captions: sample with replacement.
                take = self._rng.integers(0, ncap,
                                          size=self.seq_per_img)
                labels.append(caps[np.sort(take)])
            infos.append({"ix": ix,
                          **{k: v for k, v in
                             self.images_info[ix].items()
                             if k in ("id", "file_path")}})
        images = np.stack(images)
        labels = np.concatenate(labels)      # [B*seq_per_img, L]
        # +2 columns for <start>/<end> like the reference layout
        L = labels.shape[1]
        lab = np.zeros((labels.shape[0], L + 2), labels.dtype)
        lab[:, 1:L + 1] = labels
        masks = np.zeros_like(lab, np.float32)
        nonzero = (lab != 0).sum(1) + 2
        for i, n in enumerate(nonzero):
            masks[i, :n] = 1
        return {"images": images, "labels": lab, "masks": masks,
                "gts": gts,
                "bounds": {"it_pos_now": self._iters[split],
                           "it_max": len(idxs), "wrapped": wrapped},
                "infos": infos}


# One trained BPE per corpus source per process: train/val/test
# datasets built separately MUST share token ids (a fresh train per
# split would assign different ids to the same merges and make
# checkpoints unusable across splits/runs).
_BPE_MEMO: Dict = {}


@DATASETS.register("jsonl_news")
def jsonl_news_dataset(path: str, **builder_kwargs):
    """Registry hook: reader + builder over a materialized jsonl.

    bpe_corpus: the CANONICAL tokenizer source shared by every split —
    a jsonl path (its captions are the training corpus) or a list of
    texts. Defaults to `path`, which is only correct for single-split
    datasets: multi-split configs must point every split's bpe_corpus
    at the SAME file (typically the train jsonl). The trained BPE is
    memoized per corpus source, so sibling splits reuse one vocab.
    """
    from news_image_caption_tpu_torch.data.bpe import ByteBPE
    bpe_corpus = builder_kwargs.pop("bpe_corpus", None)
    num_merges = builder_kwargs.pop("bpe_merges", 200)
    if bpe_corpus is None:
        bpe_corpus = path
    if isinstance(bpe_corpus, str):
        memo_key = (os.path.abspath(bpe_corpus), num_merges)
        bpe = _BPE_MEMO.get(memo_key)
        if bpe is None:
            bpe = ByteBPE.train(
                [r.caption for r in JsonlNewsReader(bpe_corpus)],
                num_merges)
            _BPE_MEMO[memo_key] = bpe
    else:
        bpe = ByteBPE.train(list(bpe_corpus), num_merges)
    indexer = RobertaCopyIndexer(bpe)
    records = list(JsonlNewsReader(path))
    # Pre-latch the object-feature width from the first record that
    # has embeddings, so leading records WITHOUT embeddings pad to
    # the dataset's real width instead of a 2048 default.
    obj_dim = builder_kwargs.get("obj_dim")
    if builder_kwargs.get("with_objects") and obj_dim is None:
        for rec in records:
            if rec.obj_embeds is not None:
                builder_kwargs["obj_dim"] = rec.obj_embeds.shape[-1]
                break
    builder = InstanceBuilder(indexer, **builder_kwargs)
    return [builder.build(rec) for rec in records]
