"""The flagship's decoder with other attended contexts, and the pointer
family's variants.

Counterpart of `news_image_caption_tpu/models/variants.py`, with its
defaults and `nan_to_mask`:

- `transformer_faces`: a third context, `faces` [B, n, face_dim]
  (FaceNet embeddings, 512 wide);
- `transformer_faces_objects`: faces, then a fourth, `obj` [B, n,
  obj_dim] (YOLOv3 region features, 2048 wide): Transform-and-Tell's
  full model;
- `transformer_glove`: 300-wide GloVe article features in place of
  RoBERTa's;
- `transformer_no_image`: the article alone;
- the pointer family's (`models/pointer.py::TransformerPointer`):
  `transformer_only_pointer` (no entity head), `transformer_pointer_2`
  (the joint loss (1, 1, 1) by default), `transformer_context_pointer`
  (the caller marks every article token copyable), and
  `transformer_faces_pointer` / `transformer_objects_pointer` over a
  faces or objects captioner. The last two route the decoder's widths
  given at the top level into the captioner (`_split_pointer_kwargs`);
  any other key reaches the pointer, which drops it once it is handed a
  captioner, as the reference does.

The first four return a `TransformerFlattened` (`VARIANTS` maps the
config's model type to its builder), the pointer's a
`TransformerPointer` (`POINTER_VARIANTS`; `config.py::build_model`). A
keyword the caller sets (`extra_contexts`, `article_dim`,
`include_image`, `loss_weights`, `use_entity_head`) wins over the
variant's default, as in the reference.
"""

from __future__ import annotations

from typing import Tuple

import torch

from news_image_caption_tpu_torch.models.captioner import \
    TransformerFlattened
from news_image_caption_tpu_torch.models.pointer import TransformerPointer
from news_image_caption_tpu_torch.utils.registry import MODELS

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


@MODELS.register("transformer_faces")
def transformer_faces(**kw) -> TransformerFlattened:
    face_dim = kw.pop("face_dim", FACE_DIM)
    return _captioner((("faces", face_dim),), **kw)


@MODELS.register("transformer_faces_objects")
def transformer_faces_objects(**kw) -> TransformerFlattened:
    face_dim = kw.pop("face_dim", FACE_DIM)
    obj_dim = kw.pop("obj_dim", OBJ_DIM)
    return _captioner((("faces", face_dim), ("obj", obj_dim)), **kw)


@MODELS.register("transformer_glove")
def transformer_glove(**kw) -> TransformerFlattened:
    kw.setdefault("article_dim", GLOVE_DIM)
    return _captioner(**kw)


@MODELS.register("transformer_no_image")
def transformer_no_image(**kw) -> TransformerFlattened:
    kw.setdefault("include_image", False)
    return _captioner(**kw)


VARIANTS = {
    "transformer_faces": transformer_faces,
    "transformer_faces_objects": transformer_faces_objects,
    "transformer_glove": transformer_glove,
    "transformer_no_image": transformer_no_image,
}


@MODELS.register("transformer_only_pointer")
def transformer_only_pointer(**kw) -> TransformerPointer:
    kw.setdefault("use_entity_head", False)
    return TransformerPointer(**kw)


@MODELS.register("transformer_pointer_2")
def transformer_pointer_2(**kw) -> TransformerPointer:
    kw.setdefault("loss_weights", (1.0, 1.0, 1.0))
    return TransformerPointer(**kw)


@MODELS.register("transformer_context_pointer")
def transformer_context_pointer(**kw) -> TransformerPointer:
    """Copies from the full context: callers pass context_proper_masks =
    (article_ids != pad), so every article token is copyable."""
    return TransformerPointer(**kw)


_DECODER_KEYS = ("vocab_size", "embed_dim", "ffn_dim", "num_heads",
                 "num_layers", "kernel_sizes", "cutoff", "image_dim",
                 "article_dim", "max_positions")
# Read by the pointer's heads as well as the decoder.
_SHARED_KEYS = ("embed_dim", "num_heads", "article_dim")
# What every module of the port is built with.
_BUILD_KEYS = ("device", "dtype", "generator")


def _split_pointer_kwargs(kw):
    """(the pointer's keywords, the captioner's): the decoder widths
    given at the top level go to the captioner, the shared ones to
    both."""
    dec_kw = dict(kw.pop("decoder_kwargs", {}))
    for k in _DECODER_KEYS + _BUILD_KEYS:
        if k in kw:
            v = kw[k] if k in _SHARED_KEYS + _BUILD_KEYS else kw.pop(k)
            dec_kw.setdefault(k, v)
    return kw, dec_kw


@MODELS.register("transformer_faces_pointer")
def transformer_faces_pointer(**kw) -> TransformerPointer:
    face_dim = kw.pop("face_dim", FACE_DIM)
    kw, dec_kw = _split_pointer_kwargs(kw)
    return TransformerPointer(
        captioner=_captioner((("faces", face_dim),), **dec_kw), **kw)


@MODELS.register("transformer_objects_pointer")
def transformer_objects_pointer(**kw) -> TransformerPointer:
    obj_dim = kw.pop("obj_dim", OBJ_DIM)
    kw, dec_kw = _split_pointer_kwargs(kw)
    return TransformerPointer(
        captioner=_captioner((("obj", obj_dim),), **dec_kw), **kw)


POINTER_VARIANTS = {
    "transformer_pointer": TransformerPointer,
    "transformer_only_pointer": transformer_only_pointer,
    "transformer_pointer_2": transformer_pointer_2,
    "transformer_context_pointer": transformer_context_pointer,
    "transformer_faces_pointer": transformer_faces_pointer,
    "transformer_objects_pointer": transformer_objects_pointer,
}
