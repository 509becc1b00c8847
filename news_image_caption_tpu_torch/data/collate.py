"""Fixed-shape batch collation: pad + masks, TPU-friendly.

A copy of `news_image_caption_tpu/data/collate.py`: the port
imports nothing of the JAX package.
`tests/test_torch_evaluation_copies.py` holds the two equal.

Capability parity targets:
- Gen-2 collate_fn (pad targets, causal+pad masks, ntokens):
  final/dataloader.py:143-194
- Gen-3 contexts-dict contract:
  ttl/tell/models/transformer_flattened.py:229-236

TPU-first: sequences pad to a FIXED bucket length (static shapes for
XLA), not to the longest-in-batch.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def pad_to(ids: Sequence[int], length: int, pad_id: int) -> np.ndarray:
    arr = np.full((length,), pad_id, np.int32)
    n = min(len(ids), length)
    arr[:n] = np.asarray(ids[:n], np.int32)
    return arr


def make_causal_pad_mask(ids: np.ndarray, pad_id: int) -> np.ndarray:
    """[B, T, T] bool: True where attendable (non-pad AND not future).

    Parity: Batch.make_std_mask (final/transformer_v2.py:411-417).
    """
    B, T = ids.shape
    pad_ok = (ids != pad_id)[:, None, :]
    causal = np.tril(np.ones((T, T), bool))[None]
    return pad_ok & causal


def collate_captions(captions: List[Sequence[int]],
                     caption_len: int,
                     articles: Optional[List[Sequence[int]]] = None,
                     article_len: int = 512,
                     images: Optional[np.ndarray] = None,
                     pad_id: int = 1) -> Dict[str, np.ndarray]:
    """Batch dict with fixed shapes + masks + ntokens."""
    cap = np.stack([pad_to(c, caption_len, pad_id) for c in captions])
    out: Dict[str, np.ndarray] = {
        "caption_ids": cap,
        "caption_mask": cap != pad_id,
        "ntokens": np.asarray((cap[:, 1:] != pad_id).sum(), np.int32),
    }
    if articles is not None:
        art = np.stack([pad_to(a, article_len, pad_id) for a in articles])
        out["article_ids"] = art
        out["article_mask"] = art == pad_id   # True = PAD (ref convention)
    if images is not None:
        out["image"] = np.asarray(images, np.float32)
    return out
