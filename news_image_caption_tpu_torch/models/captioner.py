"""Flagship captioning model: contexts -> dynamic-conv decoder -> caption.

Counterpart of `news_image_caption_tpu/models/captioner.py::
TransformerFlattened` for training (`shift_caption`, `loss_fn`) and
greedy decoding (`_contexts`, `_check_max_len`, `generate`). The
decoder's weights live in the module; `generate` takes the fused decode
weights of `DynamicConvDecoder.decode_weights()` so a server computes
them once.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from news_image_caption_tpu_torch.generation.generator import (
    GenerationConfig, generate_candidates)
from news_image_caption_tpu_torch.models.decoder_flattened import (
    DecodeWeights, DynamicConvDecoder)

LN2 = math.log(2.0)


def shift_caption(caption_ids: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(input_ids, target_ids), both [B, L-1]: the input drops the last
    token, the target is the caption shifted left by one."""
    return caption_ids[:, :-1], caption_ids[:, 1:]


class TransformerFlattened:
    """Greedy captioner around a `DynamicConvDecoder`."""

    def __init__(self, decoder: Optional[DynamicConvDecoder] = None,
                 **decoder_kwargs):
        self.decoder = decoder or DynamicConvDecoder(**decoder_kwargs)

    @staticmethod
    def _contexts(batch: Dict[str, torch.Tensor]):
        return {
            "image": batch["image"],
            "image_mask": batch.get("image_mask"),
            "article": batch["article"],
            "article_mask": batch.get("article_mask"),
        }

    def loss_fn(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None):
        """Per-token loss in bits, (mean_loss, {"loss_sum": summed loss
        in bits, "sample_size": ntokens}); training dropout with a
        generator on the model's device, deterministic without one."""
        inp, tgt = shift_caption(batch["caption_ids"].long())
        loss_sum, ntokens = self.decoder.loss(inp, self._contexts(batch), tgt,
                                              generator)
        loss_bits = loss_sum / LN2
        mean_loss = loss_bits / torch.clamp(ntokens, min=1)
        return mean_loss, {"loss_sum": loss_bits, "sample_size": ntokens}

    def _check_max_len(self, config: GenerationConfig) -> None:
        """Positions past the sinusoidal table would index out of it."""
        mp = self.decoder.max_positions
        if config.max_len > mp:
            raise ValueError(f"max_len {config.max_len} exceeds the "
                             f"decoder's max_positions {mp}")

    @torch.inference_mode()
    def generate(self, batch: Dict[str, torch.Tensor],
                 config: GenerationConfig = GenerationConfig(),
                 weights: Optional[DecodeWeights] = None):
        """Greedy captions: (tokens [B, max_len + 1] int64, log_probs
        [B, max_len] fp32). The context K/V are projected once; each
        step yields the exact top-1 from the adaptive-softmax bands."""
        contexts = self._contexts(batch)
        B = contexts["image"].shape[0]
        device = contexts["image"].device
        self._check_max_len(config)
        if weights is None:
            weights = self.decoder.decode_weights()
        kvs = self.decoder.precompute_kv(contexts)
        caches = self.decoder.init_cache(B, device)
        seed = torch.full((B,), config.bos_id, dtype=torch.long,
                          device=device)

        def step(tok, i):
            return self.decoder.step_topk(tok, i, kvs, caches,
                                          config.sampling_topk, weights)

        return generate_candidates(step, seed, config)
