"""Synthetic news-caption batches for the train path, numpy only.

`SyntheticNewsDataset` is `data/dataset.py::SyntheticNewsDataset` (the
reference's draws, bit for bit) with its batches cut to the keys a
captioner's loss reads (`loss_inputs`): caption_ids, image, image_mask,
article and article_mask (`LOSS_KEYS`, in every batch), and the faces,
objects and entities with their masks where the set draws them. A
pointer model's loss also reads article_ids, caption_copy_masks and
context_proper_masks (`POINTER_KEYS`), which `loss_inputs` keeps when
asked, as it keeps TGNC's `template_label` (its `batch_keys`).
RoBERTa-style captions: bos 0, eos 2, pad 1.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from news_image_caption_tpu_torch.data import dataset

LOSS_KEYS = ("caption_ids", "image", "image_mask", "article", "article_mask")
EXTRA_KEYS = ("faces", "faces_mask", "obj", "obj_mask", "entity",
              "entity_mask")
POINTER_KEYS = ("article_ids", "caption_copy_masks", "context_proper_masks")
# Every context and mask a batch may carry, and the article's ids and
# proper-noun marks (speculative drafts, the pointer's copy head), for
# evaluate's staging.
CONTEXT_KEYS = LOSS_KEYS[1:] + EXTRA_KEYS + ("article_ids",
                                             "context_proper_masks")


def loss_inputs(batch: Dict, keep: Sequence[str] = ()) -> Dict:
    """The batch's `LOSS_KEYS`, the extra contexts it has and `keep`."""
    return {k: batch[k] for k in LOSS_KEYS + EXTRA_KEYS + tuple(keep)
            if k in batch}


class SyntheticNewsDataset(dataset.SyntheticNewsDataset):
    def collate(self, examples: List[dataset.Example]
                ) -> Dict[str, np.ndarray]:
        return loss_inputs(super().collate(examples))


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Tensors on `device`; the train step casts the floats."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}
