"""Synthetic news-caption batches, numpy only.

Counterpart of `news_image_caption_tpu/data/dataset.py::
SyntheticNewsDataset` for the keys the flagship loss reads:
caption_ids, image, image_mask, article and article_mask. The draws are
the reference's (one numpy generator per example, seeded with
seed * 1_000_003 + idx: caption length, caption body, article length,
image features, article features, in that order), so batches are bit
for bit the reference's. RoBERTa-style captions: bos 0, eos 2, pad 1.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, NamedTuple

import numpy as np
import torch


class Example(NamedTuple):
    caption_ids: List[int]
    image_feats: np.ndarray     # [P, image_dim]
    article_feats: np.ndarray   # [S, article_dim], S below article_len


class SyntheticNewsDataset:
    def __init__(self, size: int = 256, vocab_size: int = 50265,
                 caption_len: int = 32, article_len: int = 128,
                 n_patches: int = 49, image_dim: int = 2048,
                 article_dim: int = 1024, seed: int = 0):
        self.size = size
        self.vocab_size = vocab_size
        self.caption_len = caption_len
        self.article_len = article_len
        self.n_patches = n_patches
        self.image_dim = image_dim
        self.article_dim = article_dim
        self.seed = seed

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, idx: int) -> Example:
        rng = np.random.default_rng(self.seed * 1_000_003 + idx)
        cap_len = int(rng.integers(min(5, self.caption_len - 1),
                                   self.caption_len))
        body = rng.integers(4, self.vocab_size, size=max(cap_len - 2, 1))
        art_len = int(rng.integers(min(4, self.article_len - 1),
                                   self.article_len))
        image = rng.standard_normal(
            (self.n_patches, self.image_dim)).astype(np.float32)
        article = rng.standard_normal(
            (art_len, self.article_dim)).astype(np.float32)
        return Example([0] + body.tolist() + [2], image, article)

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                drop_last: bool = True) -> Iterator[Dict[str, np.ndarray]]:
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
        art = np.zeros((B, self.article_len, self.article_dim), np.float32)
        art_mask = np.ones((B, self.article_len), bool)
        img = np.zeros((B, self.n_patches, self.image_dim), np.float32)
        for i, ex in enumerate(examples):
            n = min(len(ex.caption_ids), self.caption_len)
            cap[i, :n] = ex.caption_ids[:n]
            s = min(ex.article_feats.shape[0], self.article_len)
            art[i, :s] = ex.article_feats[:s]
            art_mask[i, :s] = False
            img[i] = ex.image_feats
        return {"caption_ids": cap, "image": img,
                "image_mask": np.zeros((B, self.n_patches), bool),
                "article": art, "article_mask": art_mask}


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Tensors on `device`; the train step casts the floats."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}
