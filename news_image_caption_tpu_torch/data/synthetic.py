"""Synthetic news-caption batches for the train path, numpy only.

`SyntheticNewsDataset` is `data/dataset.py::SyntheticNewsDataset` (the
reference's draws, bit for bit) with its batches cut to the keys the
flagship loss reads: caption_ids, image, image_mask, article and
article_mask. RoBERTa-style captions: bos 0, eos 2, pad 1.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from news_image_caption_tpu_torch.data import dataset

LOSS_KEYS = ("caption_ids", "image", "image_mask", "article", "article_mask")


class SyntheticNewsDataset(dataset.SyntheticNewsDataset):
    def collate(self, examples: List[dataset.Example]
                ) -> Dict[str, np.ndarray]:
        batch = super().collate(examples)
        return {k: batch[k] for k in LOSS_KEYS}


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Tensors on `device`; the train step casts the floats."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}
