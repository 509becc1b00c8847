"""The entity captioners of the reference's TGNC module.

Counterpart of the last two builders of
`news_image_caption_tpu/models/tgnc.py`:

- `transformer_entity`: the flagship captioner with a third attended
  context, `entity` [B, n, entity_dim] (1024 wide by default);
- `transformer_entity_pointer`: the pointer (`models/pointer.py`) over
  such a captioner. Its decoder is built from `decoder_kwargs` alone;
  widths given at the top level reach the pointer, which drops them once
  it is handed a captioner, as the reference does, so a narrowed model
  of this type is narrowed through `decoder_kwargs` (the heads' key
  width through the top-level `article_dim`).

TGNC itself (the template-guided decoder) is not ported yet (ROADMAP
Queue 1 item 10b).
"""

from __future__ import annotations

from typing import Dict, Optional

from news_image_caption_tpu_torch.models.captioner import \
    TransformerFlattened
from news_image_caption_tpu_torch.models.pointer import TransformerPointer


def transformer_entity(entity_dim: int = 1024, **kw) -> TransformerFlattened:
    extra = tuple(kw.pop("extra_contexts", ())) + (("entity", entity_dim),)
    return TransformerFlattened(extra_contexts=extra, **kw)


def transformer_entity_pointer(entity_dim: int = 1024,
                               decoder_kwargs: Optional[Dict] = None, *,
                               device, dtype, generator=None,
                               **kw) -> TransformerPointer:
    dk = dict(decoder_kwargs or {})
    extra = tuple(dk.pop("extra_contexts", ())) + (("entity", entity_dim),)
    cap = TransformerFlattened(extra_contexts=extra, device=device,
                               dtype=dtype, generator=generator, **dk)
    return TransformerPointer(captioner=cap, generator=generator, **kw)
