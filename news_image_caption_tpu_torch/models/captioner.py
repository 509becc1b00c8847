"""Flagship captioning model: contexts -> dynamic-conv decoder -> caption.

Counterpart of `news_image_caption_tpu/models/captioner.py::
TransformerFlattened` for training (`shift_caption`, `loss_fn`), greedy
decoding (`_contexts`, `_check_max_len`, `generate`; `generate_full`
through the full-vocab step), beam search (`generate_beam`,
impl="topk") and the attention maps of given captions
(`attention_maps`). The decoder's weights live in the module; the generate
methods take the fused decode weights of
`DynamicConvDecoder.decode_weights()` so a server computes them once.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from news_image_caption_tpu_torch.generation.generator import (
    GenerationConfig, beam_search_candidates, generate, generate_candidates,
    index_reorder)
from news_image_caption_tpu_torch.models.decoder_flattened import (
    DecodeWeights, DynamicConvDecoder)

LN2 = math.log(2.0)


def shift_caption(caption_ids: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(input_ids, target_ids), both [B, L-1]: the input drops the last
    token, the target is the caption shifted left by one."""
    return caption_ids[:, :-1], caption_ids[:, 1:]


class TransformerFlattened:
    """Greedy and beam captioner around a `DynamicConvDecoder`."""

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

    def _decode_setup(self, batch: Dict[str, torch.Tensor],
                      config: GenerationConfig,
                      weights: Optional[DecodeWeights], beam: int):
        """(kvs, caches, seed, weights): the context K/V projected once
        for the untiled batch B, zero ring-major caches for B * beam rows
        and the bos seed [B]."""
        contexts = self._contexts(batch)
        B = contexts["image"].shape[0]
        device = contexts["image"].device
        self._check_max_len(config)
        if weights is None:
            weights = self.decoder.decode_weights()
        kvs = self.decoder.precompute_kv(contexts)
        caches = self.decoder.init_cache(B * beam, device)
        seed = torch.full((B,), config.bos_id, dtype=torch.long,
                          device=device)
        return kvs, caches, seed, weights

    @torch.inference_mode()
    def generate(self, batch: Dict[str, torch.Tensor],
                 config: GenerationConfig = GenerationConfig(),
                 weights: Optional[DecodeWeights] = None):
        """Greedy captions: (tokens [B, max_len + 1] int64, log_probs
        [B, max_len] fp32). The context K/V are projected once; each
        step yields the exact top-1 from the adaptive-softmax bands."""
        kvs, caches, seed, weights = self._decode_setup(batch, config,
                                                        weights, 1)

        def step(tok, i):
            return self.decoder.step_topk(tok, i, kvs, caches,
                                          config.sampling_topk, weights)

        return generate_candidates(step, seed, config)

    @torch.inference_mode()
    def generate_full(self, batch: Dict[str, torch.Tensor],
                      config: GenerationConfig = GenerationConfig(),
                      weights: Optional[DecodeWeights] = None):
        """`generate` through the full-vocab `step` and the `generate`
        adapter: the same tokens and log-probs, with the [B, V] log-prob
        matrix materialised each step."""
        kvs, caches, seed, weights = self._decode_setup(batch, config,
                                                        weights, 1)

        def step(tok, i):
            return self.decoder.step(tok, i, kvs, caches, weights)

        return generate(step, seed, config)

    @torch.inference_mode()
    def attention_maps(self, batch: Dict[str, torch.Tensor],
                       token_ids: torch.Tensor):
        """[L] list of {context: [B, T, S']} head-averaged attention maps
        over token_ids (typically generated captions); plain PyTorch on
        either device."""
        return self.decoder.attention_maps(token_ids.long(),
                                           self._contexts(batch))

    @torch.inference_mode()
    def generate_beam(self, batch: Dict[str, torch.Tensor],
                      config: GenerationConfig = GenerationConfig(),
                      weights: Optional[DecodeWeights] = None,
                      impl: str = "topk"):
        """Beam-searched captions: (tokens [B, beam, max_len + 1] int64,
        scores [B, beam] fp32), best first by score / length**alpha.

        impl="topk": each step yields every row's exact top-K from the
        adaptive-softmax bands, the combine is K*K wide, and the context
        K/V of the untiled batch are shared by an item's beams
        (`attend_flat_beam`). The ring-major caches [K-1, B*beam, C]
        follow the beams' ancestry by `index_select` on dim 1."""
        if impl in ("shift", "lazy"):
            raise NotImplementedError(
                f"beam impl {impl!r} is not ported yet (ROADMAP Queue 1)")
        if impl != "topk":
            raise ValueError(f"unknown beam impl: {impl!r}")
        K = config.beam_size
        kvs, caches, seed, weights = self._decode_setup(batch, config,
                                                        weights, K)

        def step(tok, i):
            return self.decoder.step_topk(tok, i, kvs, caches, K, weights,
                                          beam=K)

        return beam_search_candidates(step, seed, config,
                                      index_reorder(caches))
