"""Flagship captioning model: contexts -> dynamic-conv decoder -> caption.

Counterpart of `news_image_caption_tpu/models/captioner.py::
TransformerFlattened` (and, through its decoder's contexts, of the
faces, objects, GloVe and no-image variants of `models/variants.py`)
for training (`shift_caption`, `loss_fn`), greedy and top-k sampled
decoding (`_contexts`, `_check_max_len`, `generate`; `generate_full`
through the full-vocab step), exact speculative greedy
(`generate_speculative`), beam search (`generate_beam`, impl="topk",
and the reference's two other cache layouts, "shift" and "lazy") and
the attention maps of given captions (`attention_maps`). The decoder's
weights live in the module; the generate methods take the fused decode
weights of `DynamicConvDecoder.decode_weights()` so a server computes
them once.

`GenerationConfig.quantize_kv` / `quantize_head` are the reference's
opt-in int8 routes: K/V quantized once a generation in `_decode_setup`,
the head's tables once a load (`decode_weights(quantize_head=True)`)
or, where the weights lack them, once a generation; greedy, sampled,
speculative and beam decode all take them.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from news_image_caption_tpu_torch.generation.generator import (
    GenerationConfig, Generators, beam_search, beam_search_candidates,
    generate, generate_candidates, index_reorder)
from news_image_caption_tpu_torch.generation.speculative import (
    commit_conv_caches, ngram_drafts, speculative_greedy)
from news_image_caption_tpu_torch.models.decoder_flattened import (
    DecodeWeights, DynamicConvDecoder)
from news_image_caption_tpu_torch.parallel.collectives import global_sums
from news_image_caption_tpu_torch.utils.registry import MODELS

LN2 = math.log(2.0)
# Contexts beyond image and article that a batch may carry.
EXTRA_CONTEXTS = ("faces", "obj", "entity")


def shift_caption(caption_ids: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(input_ids, target_ids), both [B, L-1]: the input drops the last
    token, the target is the caption shifted left by one."""
    return caption_ids[:, :-1], caption_ids[:, 1:]


@MODELS.register("transformer_flattened")
class TransformerFlattened:
    """Greedy and beam captioner around a `DynamicConvDecoder`."""

    def __init__(self, decoder: Optional[DynamicConvDecoder] = None,
                 **decoder_kwargs):
        self.decoder = decoder or DynamicConvDecoder(**decoder_kwargs)

    @property
    def param_module(self) -> DynamicConvDecoder:
        """The module that holds every parameter: the decoder, whose
        state dict is the checkpoints' `params`."""
        return self.decoder

    @staticmethod
    def _contexts(batch: Dict[str, torch.Tensor]):
        """The batch's contexts and masks: image and article, and the
        faces, objects and entities of the variants where the batch has
        them (`models/variants.py`). A decoder reads only the contexts
        it attends."""
        ctx = {
            "image": batch.get("image"),
            "image_mask": batch.get("image_mask"),
            "article": batch["article"],
            "article_mask": batch.get("article_mask"),
        }
        for extra in EXTRA_CONTEXTS:
            if extra in batch:
                ctx[extra] = batch[extra]
                ctx[f"{extra}_mask"] = batch.get(f"{extra}_mask")
        return ctx

    def loss_fn(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None):
        """Per-token loss in bits, (mean_loss, {"loss_sum": summed loss
        in bits, "sample_size": ntokens}); training dropout with a
        generator on the model's device, deterministic without one."""
        inp, tgt = shift_caption(batch["caption_ids"].long())
        loss_sum, ntokens = self.decoder.loss(inp, self._contexts(batch), tgt,
                                              generator)
        loss_bits, ntokens = global_sums(loss_sum / LN2, ntokens)
        mean_loss = loss_bits / torch.clamp(ntokens, min=1)
        return mean_loss, {"loss_sum": loss_bits, "sample_size": ntokens}

    def decode_weights(self) -> DecodeWeights:
        """The decoder's fused decode weights; compute once per load."""
        return self.decoder.decode_weights()

    def _check_max_len(self, config: GenerationConfig) -> None:
        """Positions past the sinusoidal table would index out of it."""
        mp = self.decoder.max_positions
        if config.max_len > mp:
            raise ValueError(f"max_len {config.max_len} exceeds the "
                             f"decoder's max_positions {mp}")

    def _decode_setup(self, batch: Dict[str, torch.Tensor],
                      config: GenerationConfig,
                      weights: Optional[DecodeWeights], beam: int,
                      quantize: bool = False, ring_major: bool = True):
        """(kvs, caches, seed, weights): the context K/V projected once
        for the untiled batch B, zero caches for B * beam rows
        (ring-major, else the shift layout) and the bos seed [B].
        quantize: the generate methods' own decode, which takes the
        config's int8 routes (the K/V int8 with quantize_kv;
        `head_tables` for quantize_head)."""
        contexts = self._contexts(batch)
        B = contexts["article"].shape[0]         # every variant attends it
        device = contexts["article"].device
        self._check_max_len(config)
        if weights is None:
            weights = self.decoder.decode_weights()
        kvs = self.decoder.precompute_kv(contexts,
                                         quantize and config.quantize_kv)
        caches = self.decoder.init_cache(B * beam, device, ring_major)
        seed = torch.full((B,), config.bos_id, dtype=torch.long,
                          device=device)
        return kvs, caches, seed, weights

    def head_tables(self, config: GenerationConfig,
                    weights: DecodeWeights):
        """The int8 head tables a decode under `config` takes (the
        weights' own, else quantized now), or None for the exact head."""
        if not config.quantize_head:
            return None
        if weights.quant_tables is not None:
            return weights.quant_tables
        return self.decoder.quantized_embed_tables()

    @torch.inference_mode()
    def generate(self, batch: Dict[str, torch.Tensor],
                 config: GenerationConfig = GenerationConfig(),
                 weights: Optional[DecodeWeights] = None,
                 generator: Optional[Generators] = None):
        """Greedy or top-k sampled captions: (tokens [B, max_len + 1]
        int64, log_probs [B, max_len] fp32). The context K/V are
        projected once; each step yields the exact top-k from the
        adaptive-softmax bands. Sampling draws from `generator`, one for
        the batch or one a row (`generation/generator.py::
        gumbel_noise`); without one, from a generator seeded with 0."""
        kvs, caches, seed, weights = self._decode_setup(batch, config,
                                                        weights, 1, True)
        tables = self.head_tables(config, weights)

        def step(tok, i):
            return self.decoder.step_topk(tok, i, kvs, caches,
                                          config.sampling_topk, weights,
                                          tables=tables)

        return generate_candidates(step, seed, config, generator)

    @torch.inference_mode()
    def generate_speculative(self, batch: Dict[str, torch.Tensor],
                             config: GenerationConfig = GenerationConfig(),
                             weights: Optional[DecodeWeights] = None,
                             spec_k: int = 8,
                             draft_source: Optional[torch.Tensor] = None,
                             ngram_n: int = 2):
        """Greedy captions by prompt-lookup speculative decoding: the
        tokens of `generate` with sampling_topk = 1, each verification
        step scoring `spec_k` positions of every row. Drafts continue a
        caption's last `ngram_n` tokens from their first occurrence in
        `draft_source` (default: batch["article_ids"], the article's
        token ids). Returns (tokens [B, max_len + 1], log_probs
        [B, max_len], n_chunks), n_chunks the verification steps run."""
        if config.sampling_topk != 1:
            raise ValueError("speculative decoding is greedy-only "
                             "(sampling_topk must be 1)")
        kvs, caches, seed, weights = self._decode_setup(batch, config,
                                                        weights, 1, True)
        tables = self.head_tables(config, weights)
        source = (draft_source if draft_source is not None
                  else batch["article_ids"]).to(seed.device).long()

        def chunk_fn(toks, pos):
            return self.decoder.step_chunk(toks, pos, kvs, caches, weights,
                                           tables)

        def commit_fn(hs, m, pos):
            commit_conv_caches(caches, hs, m, pos)

        def draft_fn(tokens, pos, finished):
            return ngram_drafts(source, tokens, pos, spec_k - 1, n=ngram_n,
                                pad_id=config.pad_id)

        return speculative_greedy(chunk_fn, commit_fn, seed, config, spec_k,
                                  draft_fn)

    @torch.inference_mode()
    def generate_full(self, batch: Dict[str, torch.Tensor],
                      config: GenerationConfig = GenerationConfig(),
                      weights: Optional[DecodeWeights] = None,
                      generator: Optional[Generators] = None):
        """`generate` through the full-vocab `step` and the `generate`
        adapter: the same tokens and log-probs, with the [B, V] log-prob
        matrix materialised each step (the int8 routes too; the head's
        products then plain ones, as the reference's XLA route)."""
        kvs, caches, seed, weights = self._decode_setup(batch, config,
                                                        weights, 1, True)
        tables = self.head_tables(config, weights)

        def step(tok, i):
            return self.decoder.step(tok, i, kvs, caches, weights,
                                     tables=tables)

        return generate(step, seed, config, generator)

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
        follow the beams' ancestry by `index_select` on dim 1.

        impl="shift" and impl="lazy", the reference's ablations, run the
        full-vocab head (`AdaptiveSoftmax.log_prob`) through
        `beam_search`, over the same layer kernels: "shift" over
        shifted-copy caches [B*beam, K-1, C] whose rows follow the
        ancestry by a gather on dim 0 (`DynamicConvDecoder.step_shift`);
        "lazy" over ring-major caches that stay where they are, the
        ancestry composed into each layer's slot map, m[:, flat_src]
        (`step_beam_lazy`). Neither takes the int8 routes."""
        if impl not in ("topk", "shift", "lazy"):
            raise ValueError(f"unknown beam impl: {impl!r}")
        K = config.beam_size
        kvs, caches, seed, weights = self._decode_setup(
            batch, config, weights, K, impl == "topk", impl != "shift")
        if impl == "shift":
            def step(tok, i):
                return self.decoder.step_shift(tok, i, kvs, caches, weights,
                                               beam=K)

            def reorder(flat_src):
                caches[:] = [c.index_select(0, flat_src) for c in caches]

            return beam_search(step, seed, config, reorder)
        if impl == "lazy":
            maps = self.decoder.init_slot_maps(seed.shape[0] * K,
                                               seed.device)

            def step(tok, i):
                return self.decoder.step_beam_lazy(tok, i, kvs, caches, maps,
                                                   weights, beam=K)

            def reorder(flat_src):
                maps[:] = [m[:, flat_src] for m in maps]

            return beam_search(step, seed, config, reorder)
        tables = self.head_tables(config, weights)

        def step(tok, i):
            return self.decoder.step_topk(tok, i, kvs, caches, K, weights,
                                          beam=K, tables=tables)

        return beam_search_candidates(step, seed, config,
                                      index_reorder(caches))
