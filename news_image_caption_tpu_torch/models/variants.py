"""The flagship's decoder with other attended contexts: the faces,
faces-and-objects, GloVe and no-image captioners.

Counterpart of the first four builders of
`news_image_caption_tpu/models/variants.py` (the pointer family's come
with it, ROADMAP Queue 1 item 10), with its defaults and `nan_to_mask`:

- `transformer_faces`: a third context, `faces` [B, n, face_dim]
  (FaceNet embeddings, 512 wide);
- `transformer_faces_objects`: faces, then a fourth, `obj` [B, n,
  obj_dim] (YOLOv3 region features, 2048 wide): Transform-and-Tell's
  full model;
- `transformer_glove`: 300-wide GloVe article features in place of
  RoBERTa's;
- `transformer_no_image`: the article alone.

Each returns a `TransformerFlattened`; `VARIANTS` maps the config's
model type to its builder (`config.py::build_model`). A keyword the
caller sets (`extra_contexts`, `article_dim`, `include_image`) wins over
the variant's default, as in the reference.
"""

from __future__ import annotations

from typing import Tuple

import torch

from news_image_caption_tpu_torch.models.captioner import \
    TransformerFlattened

FACE_DIM = 512
OBJ_DIM = 2048
GLOVE_DIM = 300


def nan_to_mask(feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """NaN-padded feature rows [..., n, dim] -> (the features with every
    row that holds a NaN zeroed, its mask [..., n], True = padding)."""
    mask = torch.isnan(feats).any(dim=-1)
    return feats.masked_fill(mask[..., None], 0.0), mask


def _captioner(extra: Tuple[Tuple[str, int], ...] = (),
               **kw) -> TransformerFlattened:
    kw.setdefault("extra_contexts", extra)
    return TransformerFlattened(**kw)


def transformer_faces(**kw) -> TransformerFlattened:
    face_dim = kw.pop("face_dim", FACE_DIM)
    return _captioner((("faces", face_dim),), **kw)


def transformer_faces_objects(**kw) -> TransformerFlattened:
    face_dim = kw.pop("face_dim", FACE_DIM)
    obj_dim = kw.pop("obj_dim", OBJ_DIM)
    return _captioner((("faces", face_dim), ("obj", obj_dim)), **kw)


def transformer_glove(**kw) -> TransformerFlattened:
    kw.setdefault("article_dim", GLOVE_DIM)
    return _captioner(**kw)


def transformer_no_image(**kw) -> TransformerFlattened:
    kw.setdefault("include_image", False)
    return _captioner(**kw)


VARIANTS = {
    "transformer_faces": transformer_faces,
    "transformer_faces_objects": transformer_faces_objects,
    "transformer_glove": transformer_glove,
    "transformer_no_image": transformer_no_image,
}
