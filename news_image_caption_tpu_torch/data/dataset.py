"""Datasets: in-memory array store + synthetic news-caption data.

A copy of `news_image_caption_tpu/data/dataset.py`: the port
imports nothing of the JAX package.
`tests/test_torch_evaluation_copies.py` holds the two equal.

The reference reads from MongoDB + HDF5 + JPEG dirs at *training time*
(final/dataloader.py:78-141,
 dataloader.py:57-371). TPU-first design materializes
everything into array shards OFFLINE so the input pipeline never
blocks on Python preprocessing (SURVEY.md §7 step 2); this module is
the in-memory form of that contract plus a synthetic generator used
by tests and benchmarks.

The shard dataset of the reference (`nics_shards`, read by its C++
reader) is not ported yet: `config.build_dataset` raises for it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np


@dataclass
class Example:
    caption_ids: List[int]
    article_ids: Optional[List[int]] = None
    image: Optional[np.ndarray] = None          # raw HWC uint8 or feats
    image_feats: Optional[np.ndarray] = None    # [P, C]
    article_feats: Optional[np.ndarray] = None  # [S, C]
    caption_text: str = ""
    metadata: Optional[Dict] = None
    # Pointer-family copy supervision (roberta_indexer.py copy masks):
    # per-caption-token entity index (0 = none, i>=1 = i-th entity)
    # and per-article-token proper-noun marks.
    caption_copy_masks: Optional[List[int]] = None
    context_proper_masks: Optional[List[int]] = None
    template_label: Optional[np.ndarray] = None  # [n_templates] multi-hot
    # Extra attended contexts (faces/objects/entity variants);
    # masks are True = padding, matching the collate convention.
    faces: Optional[np.ndarray] = None           # [n_faces, face_dim]
    faces_mask: Optional[np.ndarray] = None      # [n_faces] bool
    obj: Optional[np.ndarray] = None             # [n_obj, obj_dim]
    obj_mask: Optional[np.ndarray] = None
    entity: Optional[np.ndarray] = None          # [n_ent, entity_dim]
    entity_mask: Optional[np.ndarray] = None


def _example_stream(seed: int, stream: int, idx: int):
    """Per-example rng streams. Stream 0 (captions/features) keeps the
    original multiplier derivation — loss-trajectory tests pin its
    draws bit-exactly. Streams >= 1 (article ids, extra contexts) are
    tuple-seeded through SeedSequence so they stay independent of
    stream 0 for EVERY seed: a `seed*K + idx` offset collapses onto
    stream 0's keystream at seed 0, the shipped default."""
    if stream == 0:
        return np.random.default_rng(seed * 1_000_003 + idx)
    return np.random.default_rng((seed, stream, idx))


class SyntheticNewsDataset:
    """Random but deterministic caption/article/feature data.

    Shapes mirror the flagship contract: image patches [P, image_dim],
    article features [S, article_dim], RoBERTa-style caption ids
    (bos=0, eos=2, pad=1).
    """

    def __init__(self, size: int = 256, vocab_size: int = 50265,
                 caption_len: int = 32, article_len: int = 128,
                 n_patches: int = 49, image_dim: int = 2048,
                 article_dim: int = 1024, seed: int = 0,
                 n_templates: int = 0,
                 n_faces: int = 0, face_dim: int = 512,
                 n_objects: int = 0, obj_dim: int = 2048,
                 n_entities: int = 0, entity_dim: int = 1024,
                 raw_image_size: int = 0):
        self.size = size
        self.vocab_size = vocab_size
        self.caption_len = caption_len
        self.article_len = article_len
        self.n_patches = n_patches
        self.image_dim = image_dim
        self.article_dim = article_dim
        self.seed = seed
        self.n_templates = n_templates
        self.n_faces = n_faces
        self.face_dim = face_dim
        self.n_objects = n_objects
        self.obj_dim = obj_dim
        self.n_entities = n_entities
        self.entity_dim = entity_dim
        # raw_image_size > 0: emit uint8 HWC images of that side
        # instead of precomputed patch features (the gen3_pipeline /
        # online-encoder contract).
        self.raw_image_size = raw_image_size

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, idx: int) -> Example:
        rng = _example_stream(self.seed, 0, idx)
        cap_lo = min(5, self.caption_len - 1)
        cap_len = int(rng.integers(cap_lo, self.caption_len))
        body = rng.integers(4, self.vocab_size, size=max(cap_len - 2, 1))
        caption = [0] + body.tolist() + [2]
        art_lo = min(4, self.article_len - 1)
        art_len = int(rng.integers(art_lo, self.article_len))
        # Article BPE ids, news-like: the caption body appears inside
        # the article (captions copy entity spans from their articles
        # — the property the pointer family and speculative decoding's
        # prompt-lookup drafter both exploit). Separate rng stream so
        # the caption/feature draws stay bit-identical to the pre-
        # article_ids dataset (loss-trajectory tests pin them).
        rng_ids = _example_stream(self.seed, 1, idx)
        art_ids = rng_ids.integers(4, self.vocab_size, size=art_len)
        span = min(len(body), art_len)
        if span > 0:
            off = int(rng_ids.integers(0, art_len - span + 1))
            art_ids[off:off + span] = body[:span]
        # The embedded span doubles as entity 1 for the pointer
        # family's copy supervision (caption positions 1..span follow
        # the bos; the same ids sit at article positions off..off+span)
        # — derived from already-drawn values so every other stream
        # stays bit-identical to the pre-copy-mask dataset.
        cap_masks = [0] * len(caption)
        ctx_proper = [0] * art_len
        if span > 0:
            for j in range(span):
                cap_masks[1 + j] = 1
                ctx_proper[off + j] = 1
        template = None
        if self.n_templates > 0:
            template = np.zeros(self.n_templates, np.float32)
            template[idx % self.n_templates] = 1.0

        # Extra contexts draw from their own stream (keeps the base
        # caption/feature/article draws bit-identical when enabled).
        rng_x = _example_stream(self.seed, 2, idx)

        def _ctx(n, dim):
            if n <= 0:
                return None, None
            feats = rng_x.standard_normal((n, dim)).astype(np.float32)
            valid = 1 + idx % n             # >= 1 real row per sample
            mask = np.arange(n) >= valid    # True = padding
            feats[mask] = 0.0
            return feats, mask

        faces, faces_mask = _ctx(self.n_faces, self.face_dim)
        obj, obj_mask = _ctx(self.n_objects, self.obj_dim)
        entity, entity_mask = _ctx(self.n_entities, self.entity_dim)
        if self.raw_image_size > 0:
            image = rng.integers(
                0, 256, (self.raw_image_size, self.raw_image_size, 3)
            ).astype(np.uint8)
            image_feats = None
        else:
            image = None
            image_feats = rng.standard_normal(
                (self.n_patches, self.image_dim)).astype(np.float32)
        return Example(
            caption_ids=caption,
            article_ids=art_ids.tolist(),
            caption_copy_masks=cap_masks,
            context_proper_masks=ctx_proper,
            template_label=template,
            image=image,
            image_feats=image_feats,
            faces=faces, faces_mask=faces_mask,
            obj=obj, obj_mask=obj_mask,
            entity=entity, entity_mask=entity_mask,
            article_feats=rng.standard_normal(
                (art_len, self.article_dim)).astype(np.float32),
            caption_text=" ".join(f"w{t}" for t in body),
            metadata={"index": idx},
        )

    def batches(self, batch_size: int, shuffle: bool = True,
                seed: int = 0, drop_last: bool = True
                ) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(self.size)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for s in range(0, self.size, batch_size):
            idxs = order[s:s + batch_size]
            if len(idxs) < batch_size and drop_last:
                break
            yield self.collate([self[int(i)] for i in idxs])

    def collate(self, examples: List[Example]) -> Dict[str, np.ndarray]:
        B = len(examples)
        cap = np.full((B, self.caption_len), 1, np.int32)
        # Pad positions carry -1 (= ignore) per the pointer loss
        # contract (models/pointer.py::loss_fn docstring).
        cap_masks = np.full((B, self.caption_len), -1, np.int32)
        art = np.zeros((B, self.article_len, self.article_dim), np.float32)
        art_ids = np.full((B, self.article_len), 1, np.int32)
        art_mask = np.ones((B, self.article_len), bool)
        ctx_proper = np.zeros((B, self.article_len), np.int32)
        if self.raw_image_size > 0:
            img = np.zeros((B, self.raw_image_size,
                            self.raw_image_size, 3), np.uint8)
        else:
            img = np.zeros((B, self.n_patches, self.image_dim),
                           np.float32)
        for i, ex in enumerate(examples):
            n = min(len(ex.caption_ids), self.caption_len)
            cap[i, :n] = ex.caption_ids[:n]
            if ex.caption_copy_masks is not None:
                cap_masks[i, :n] = ex.caption_copy_masks[:n]
            else:
                cap_masks[i, :n] = 0
            s = min(ex.article_feats.shape[0], self.article_len)
            art[i, :s] = ex.article_feats[:s]
            art_mask[i, :s] = False
            if ex.article_ids is not None:
                m = min(len(ex.article_ids), self.article_len)
                art_ids[i, :m] = ex.article_ids[:m]
                if ex.context_proper_masks is not None:
                    ctx_proper[i, :m] = ex.context_proper_masks[:m]
            img[i] = (ex.image if self.raw_image_size > 0
                      else ex.image_feats)
        batch = {
            "caption_ids": cap,
            "caption_copy_masks": cap_masks,
            "image": img,
            "article": art,
            "article_ids": art_ids,
            "article_mask": art_mask,
            "context_proper_masks": ctx_proper,
        }
        if self.raw_image_size == 0:
            batch["image_mask"] = np.zeros((B, self.n_patches), bool)
        if self.n_templates > 0:
            batch["template_label"] = np.stack([
                ex.template_label if ex.template_label is not None
                else np.zeros(self.n_templates, np.float32)
                for ex in examples])
        for name, n in (("faces", self.n_faces), ("obj", self.n_objects),
                        ("entity", self.n_entities)):
            if n > 0:
                batch[name] = np.stack(
                    [getattr(ex, name) for ex in examples])
                batch[name + "_mask"] = np.stack(
                    [getattr(ex, name + "_mask") for ex in examples])
        return batch

