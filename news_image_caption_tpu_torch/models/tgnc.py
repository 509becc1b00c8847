"""Template-guided news captioner (TGNC) and the entity captioners.

Counterpart of `news_image_caption_tpu/models/tgnc.py`:

- `ClassificationHead`: the article's `<s>` hidden and the mean of the
  image patches, each dropped out, concatenated, then `dense`, tanh,
  dropout and `out_proj` to `n_templates` logits;
- `TemplateGuidedDecoder`: the flagship's trunk (`layers_{i}`) and one
  more decoder layer of kernel `head_kernel` a template (`head_{i}`),
  each head reading the trunk's output; the heads' outputs are weighted
  by sigmoid(template_logits), in their own dtype, and averaged before
  the tied adaptive softmax (`_mix`);
- `TGNC`: one classifier forward a step feeds both the heads' mix and
  the BCE template loss (`template_loss_weight` > 0 and a batch with
  `template_label`, which `batch_keys` names so the train command moves
  it); the caption loss is in bits. Without `use_template_decoder` the
  captions come from a `TransformerFlattened` under `captioner.`;
- `transformer_entity`: the flagship captioner with a third attended
  context, `entity` [B, n, entity_dim] (1024 wide by default);
- `transformer_entity_pointer`: the pointer (`models/pointer.py`) over
  such a captioner. Its decoder is built from `decoder_kwargs` alone;
  widths given at the top level reach the pointer, which drops them once
  it is handed a captioner, as the reference does, so a narrowed model
  of this type is narrowed through `decoder_kwargs` (the heads' key
  width through the top-level `article_dim`).

`TGNCModule` holds every parameter (`classifier.`, then `decoder.` or
`captioner.`), named as the flax tree so that `models/from_jax.py` maps
the reference's weights by renaming.

Decoding takes its candidates from the adaptive-softmax bands on every
device, greedy and top-k sampled alike (`generate`), and never forms
the full-vocab log-probs: a step is `DynamicConvDecoderLayer.step` for
each trunk layer and for each head on the same trunk output, that is
`decode_conv_block`, `decode_cross_attention` for image and article and
`decode_ffn_block` a layer (nine at the flagship's widths), then the
mix and `AdaptiveSoftmax.topk_log_prob` over the decode weights' head
table (`band_topk_lse` a band). `step_chunk` scores a speculative chunk
(`generate_speculative`, and `ContinuousBatcher.for_tgnc`) through the
layers' `chunk`, its conv inputs laid out trunk then heads for
`commit_conv_caches`. TGNC has no beam search, as the reference has
none.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from news_image_caption_tpu_torch.generation.generator import (
    GenerationConfig, Generators, generate_candidates)
from news_image_caption_tpu_torch.generation.speculative import (
    commit_conv_caches, ngram_drafts, speculative_greedy)
from news_image_caption_tpu_torch.models.captioner import (
    LN2, TransformerFlattened, shift_caption)
from news_image_caption_tpu_torch.models.decoder_flattened import (
    DecodeWeights, DynamicConvDecoder, DynamicConvDecoderLayer, LayerKV,
    _positions)
from news_image_caption_tpu_torch.models.pointer import TransformerPointer
from news_image_caption_tpu_torch.ops.dropout import dropout
from news_image_caption_tpu_torch.ops.linear import Dense
from news_image_caption_tpu_torch.parallel.collectives import (global_mean,
                                                               global_sums)
from news_image_caption_tpu_torch.utils.registry import DECODERS, MODELS


class ClassificationHead(nn.Module):
    """`<s>` text hidden + mean image features -> n_classes logits."""

    def __init__(self, text_dim: int, image_dim: int, hidden: int,
                 n_classes: int, *, device, dtype, generator=None,
                 dropout_rate: float = 0.1):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.dropout = dropout_rate
        self.dense = Dense(text_dim + image_dim, hidden, **kw)
        self.out_proj = Dense(hidden, n_classes, **kw)

    def forward(self, text_hidden: torch.Tensor, image_feats: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """text_hidden [B, S, H] (position 0 is `<s>`); image_feats
        [B, P, C]; dropout with a generator."""
        dtype = self.dense.kernel.dtype
        h = dropout(text_hidden[:, 0, :].to(dtype), self.dropout, generator)
        img = dropout(image_feats.to(dtype).mean(dim=1), self.dropout,
                      generator)
        x = torch.tanh(self.dense(torch.cat([h, img], dim=-1)))
        return self.out_proj(dropout(x, self.dropout, generator))


@DECODERS.register("decoder_tgnc")
class TemplateGuidedDecoder(DynamicConvDecoder):
    """The flagship's decoder (`layers_{i}`, the trunk) with a head layer
    a template over the trunk's output (`head_{i}`), mixed by
    sigmoid(template_logits), then the tied adaptive softmax. Caches,
    `kvs` and decode weights list the trunk's layers, then the heads
    (`all_layers`). It decodes through `step_topk` and `step_chunk`
    alone: the flagship's full-vocab and hidden-state steps and its
    attention maps would read the trunk without the heads, and raise.
    `remat` checkpoints the trunk's layers and the heads alike
    (`ops/dropout.py::remat`); `tie_adaptive_proj` is the flagship's."""

    def __init__(self, *, device, dtype, generator=None,
                 vocab_size: int = 50265, embed_dim: int = 1024,
                 ffn_dim: int = 4096, num_heads: int = 16,
                 num_layers: int = 4,
                 kernel_sizes: Sequence[int] = (3, 7, 15, 31),
                 cutoff: Sequence[int] = (5000, 20000, 50265),
                 tie_adaptive_proj: bool = False, image_dim: int = 2048,
                 article_dim: int = 1024, n_templates: int = 5,
                 head_kernel: int = 31, dropout: float = 0.1,
                 padding_idx: int = 0, target_padding_idx: int = 1,
                 max_positions: int = 512, remat: bool = False):
        assert len(kernel_sizes) >= num_layers
        kw = dict(device=device, dtype=dtype, generator=generator)
        super().__init__(
            vocab_size=vocab_size, embed_dim=embed_dim, ffn_dim=ffn_dim,
            num_heads=num_heads, num_layers=num_layers,
            kernel_sizes=tuple(kernel_sizes[:num_layers]), cutoff=cutoff,
            image_dim=image_dim, article_dim=article_dim,
            padding_idx=padding_idx, target_padding_idx=target_padding_idx,
            max_positions=max_positions, dropout=dropout,
            tie_adaptive_proj=tie_adaptive_proj, remat=remat, **kw)
        self.image_dim = image_dim
        self.n_templates = n_templates
        self.head_kernel = head_kernel
        specs = (("image", image_dim), ("article", article_dim))
        for i in range(n_templates):
            setattr(self, f"head_{i}", DynamicConvDecoderLayer(
                embed_dim, head_kernel, num_heads, ffn_dim, specs,
                dropout=dropout, **kw))

    @property
    def heads(self) -> List[DynamicConvDecoderLayer]:
        return [getattr(self, f"head_{i}") for i in range(self.n_templates)]

    def all_layers(self) -> List[DynamicConvDecoderLayer]:
        return list(self.layers) + self.heads

    def _trunk_only(self, *args, **kwargs):
        raise NotImplementedError(
            "a template-guided decoder reads its heads: decode with "
            "step_topk or step_chunk, teacher force with hidden")

    step = step_with_hidden = step_topk_with_hidden = \
        step_chunk_with_hidden = step_shift = step_beam_lazy = \
        attention_maps = _trunk_only

    def _mix(self, head_outs: List[torch.Tensor],
             template_logits: torch.Tensor) -> torch.Tensor:
        """The heads' outputs [..., D] stacked, each weighted by its
        template's sigmoid(logit) [B, n] in the outputs' dtype, and
        averaged over the heads."""
        X = torch.stack(head_outs, dim=-2)                  # [B, (T,) n, D]
        prob = torch.sigmoid(template_logits.to(X.dtype))
        prob = prob.view(prob.shape[0], *([1] * (X.dim() - 3)),
                         prob.shape[1], 1)
        return (X * prob).mean(dim=-2)

    def hidden(self, token_ids: torch.Tensor,
               contexts: Dict[str, torch.Tensor],
               template_logits: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Teacher-forced mixed hidden states [B, T, D]; training with a
        generator."""
        kvs = self.precompute_kv(contexts)
        x = self._stack(token_ids, kvs, generator)
        outs = [self._layer(head, x, kv, generator)
                for head, kv in zip(self.heads, kvs[self.num_layers:])]
        return self._mix(outs, template_logits)

    def loss(self, token_ids: torch.Tensor, contexts: Dict[str, torch.Tensor],
             template_logits: torch.Tensor, target_ids: torch.Tensor,
             generator: Optional[torch.Generator] = None):
        """(summed adaptive CE fp32, ntokens) of the targets."""
        return self.loss_from_hidden(self.hidden(
            token_ids, contexts, template_logits, generator), target_ids)

    def log_prob(self, token_ids: torch.Tensor,
                 contexts: Dict[str, torch.Tensor],
                 template_logits: torch.Tensor) -> torch.Tensor:
        """Full-vocab log-probs [B, T, V] (teacher forced)."""
        return self.log_prob_from_hidden(
            self.hidden(token_ids, contexts, template_logits))

    # -- incremental decode ------------------------------------------------

    def step_topk(self, token_t: torch.Tensor, step_idx,
                  kvs: List[LayerKV], caches: List[torch.Tensor],
                  template_logits: torch.Tensor, k: int,
                  weights: DecodeWeights):
        """One decode step: the exact top-k candidates (log_probs [B, k]
        fp32, ids [B, k] int64) of the mixed heads, from the bands.
        step_idx: an int, or each row's position (a [B] tensor). The
        caches advance in place."""
        x = self._step_layers(token_t, step_idx, kvs, caches, weights, 1)
        if isinstance(step_idx, torch.Tensor):
            step_idx = _positions(step_idx)
        L = self.num_layers
        outs = [head.step(x, kv, cache, step_idx, w)
                for head, kv, cache, w in zip(self.heads, kvs[L:], caches[L:],
                                              weights.layers[L:])]
        return self.adaptive_softmax.topk_log_prob(
            self._mix(outs, template_logits), k,
            self.embedder.embed_tables(), weights.head_table)

    def step_chunk(self, tokens: torch.Tensor, pos: torch.Tensor,
                   kvs: List[LayerKV], caches: List[torch.Tensor],
                   template_logits: torch.Tensor, weights: DecodeWeights):
        """A greedy chunk (speculative verification) through the mixed
        heads. tokens [B, k]: the last committed token, then drafts; pos
        [B] each row's count of tokens consumed. Returns (log_probs
        [B, k] fp32, argmax_ids [B, k], hs): output t the greedy next
        token given inputs 0..t, as t+1 `step_topk(k=1)` calls give it;
        hs the conv inputs of the trunk's layers, then of each head (a
        head's input is the trunk's output), for `commit_conv_caches`.
        The caches are not advanced."""
        pos = _positions(pos)
        x, hs = self._chunk_layers(tokens, pos, kvs, caches, weights)
        L = self.num_layers
        outs = []
        for head, kv, cache, w in zip(self.heads, kvs[L:], caches[L:],
                                      weights.layers[L:]):
            o, h = head.chunk(x, kv, cache, pos, w)
            outs.append(o)
            hs.append(h)
        v, ids = self.adaptive_softmax.topk_log_prob(
            self._mix(outs, template_logits), 1,
            self.embedder.embed_tables(), weights.head_table)
        return v[..., 0], ids[..., 0], hs


class TGNCModule(nn.Module):
    """Every parameter of a TGNC: `classifier`, then `decoder` (the
    template-guided decoder) or `captioner` (the flattened decoder)."""

    def __init__(self, classifier: ClassificationHead,
                 decoder: Optional[TemplateGuidedDecoder] = None,
                 captioner: Optional[DynamicConvDecoder] = None):
        super().__init__()
        self.classifier = classifier
        if decoder is not None:
            self.decoder = decoder
        else:
            self.captioner = captioner


@MODELS.register("tgnc")
class TGNC:
    """Caption decoder + template classifier."""

    batch_keys = ("template_label",)

    def __init__(self, *, device, dtype=torch.float32, generator=None,
                 captioner: Optional[TransformerFlattened] = None,
                 n_templates: int = 5, image_dim: int = 2048,
                 article_dim: int = 1024, template_loss_weight: float = 0.0,
                 use_template_decoder: bool = False, **decoder_kwargs):
        kw = dict(device=device, dtype=dtype, generator=generator)
        decoder_kwargs.setdefault("image_dim", image_dim)
        decoder_kwargs.setdefault("article_dim", article_dim)
        self.use_template_decoder = use_template_decoder
        self.template_loss_weight = template_loss_weight
        if use_template_decoder:
            self.tg_decoder = TemplateGuidedDecoder(
                n_templates=n_templates, **kw, **decoder_kwargs)
            self.captioner = None
            embed_dim = self.tg_decoder.embed_dim
            img_dim = self.tg_decoder.image_dim
        else:
            self.tg_decoder = None
            self.captioner = captioner or TransformerFlattened(
                **kw, **decoder_kwargs)
            d = self.captioner.decoder
            embed_dim = d.embed_dim
            img_dim = decoder_kwargs["image_dim"]
        classifier = ClassificationHead(
            decoder_kwargs["article_dim"], img_dim, embed_dim, n_templates,
            **kw)
        self.module = TGNCModule(
            classifier, decoder=self.tg_decoder,
            captioner=None if use_template_decoder else
            self.captioner.decoder)

    @property
    def param_module(self) -> TGNCModule:
        return self.module

    @property
    def classifier(self) -> ClassificationHead:
        return self.module.classifier

    @staticmethod
    def _contexts(batch: Dict[str, torch.Tensor]):
        return {"image": batch["image"],
                "image_mask": batch.get("image_mask"),
                "article": batch["article"],
                "article_mask": batch.get("article_mask")}

    def template_logits(self, batch: Dict[str, torch.Tensor],
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
        """The classifier's logits [B, n_templates]."""
        return self.classifier(batch["article"], batch["image"], generator)

    def loss_fn(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None):
        """(caption loss in bits a token + template_loss_weight * the
        BCE, {"loss_sum", "sample_size", "caption_loss" and, with the
        BCE, "template_loss"}); training dropout with a generator."""
        want_bce = (self.template_loss_weight > 0.0
                    and "template_label" in batch)
        template_logits = None
        if self.use_template_decoder or want_bce:
            template_logits = self.template_logits(batch, generator)
        if self.use_template_decoder:
            inp, tgt = shift_caption(batch["caption_ids"].long())
            loss_sum, ntokens = self.tg_decoder.loss(
                inp, self._contexts(batch), template_logits, tgt, generator)
            loss_bits, ntokens = global_sums(loss_sum / LN2, ntokens)
            cap_loss = loss_bits / torch.clamp(ntokens, min=1)
            aux = {"loss_sum": loss_bits, "sample_size": ntokens}
        else:
            cap_loss, aux = self.captioner.loss_fn(batch, generator)
        loss = cap_loss
        if want_bce:
            probs = torch.sigmoid(template_logits.float())
            y = batch["template_label"].float()
            bce = -(y * torch.log(torch.clamp(probs, min=1e-7))
                    + (1 - y) * torch.log(torch.clamp(1 - probs, min=1e-7)))
            t_loss = global_mean(bce)
            aux["template_loss"] = t_loss
            loss = loss + self.template_loss_weight * t_loss
        aux["caption_loss"] = cap_loss
        return loss, aux

    def decode_weights(self) -> DecodeWeights:
        if not self.use_template_decoder:
            return self.captioner.decode_weights()
        return self.tg_decoder.decode_weights()

    def _check_max_len(self, config: GenerationConfig) -> None:
        mp = self.tg_decoder.max_positions
        if config.max_len > mp:
            raise ValueError(f"max_len {config.max_len} exceeds the "
                             f"decoder's max_positions {mp}")

    def prep(self, batch: Dict[str, torch.Tensor]):
        """{"kvs": every layer's context K/V, "template_logits"}: what a
        decode of the batch reads besides the caches, computed once."""
        return {"kvs": self.tg_decoder.precompute_kv(self._contexts(batch)),
                "template_logits": self.template_logits(batch)}

    def _setup(self, batch, config: GenerationConfig,
               weights: Optional[DecodeWeights]):
        self._check_max_len(config)
        device = batch["article"].device
        B = batch["article"].shape[0]
        tree = self.prep(batch)
        caches = self.tg_decoder.init_cache(B, device)
        seed = torch.full((B,), config.bos_id, dtype=torch.long,
                          device=device)
        return tree, caches, seed, weights or self.decode_weights()

    @torch.inference_mode()
    def generate(self, batch: Dict[str, torch.Tensor],
                 config: GenerationConfig = GenerationConfig(),
                 weights: Optional[DecodeWeights] = None,
                 generator: Optional[Generators] = None):
        """Greedy or top-k sampled captions: (tokens [B, max_len + 1]
        int64, log_probs [B, max_len] fp32), each step's candidates the
        exact top-k of the mixed heads from the bands."""
        if not self.use_template_decoder:
            return self.captioner.generate(batch, config, weights, generator)
        tree, caches, seed, weights = self._setup(batch, config, weights)

        def step(tok, i):
            return self.tg_decoder.step_topk(
                tok, i, tree["kvs"], caches, tree["template_logits"],
                config.sampling_topk, weights)

        return generate_candidates(step, seed, config, generator)

    @torch.inference_mode()
    def generate_speculative(self, batch: Dict[str, torch.Tensor],
                             config: GenerationConfig = GenerationConfig(),
                             weights: Optional[DecodeWeights] = None,
                             spec_k: int = 8,
                             draft_source: Optional[torch.Tensor] = None,
                             ngram_n: int = 2):
        """Greedy captions by prompt-lookup speculative decoding through
        the mixed heads: the tokens of `generate` with sampling_topk = 1.
        The trunk's and the heads' rings advance by `commit_conv_caches`.
        Returns (tokens, log_probs, n_chunks)."""
        if config.sampling_topk != 1:
            raise ValueError("speculative decoding is greedy-only "
                             "(sampling_topk must be 1)")
        if not self.use_template_decoder:
            return self.captioner.generate_speculative(
                batch, config, weights, spec_k=spec_k,
                draft_source=draft_source, ngram_n=ngram_n)
        tree, caches, seed, weights = self._setup(batch, config, weights)
        source = (draft_source if draft_source is not None
                  else batch["article_ids"]).to(seed.device).long()

        def chunk_fn(toks, pos):
            return self.tg_decoder.step_chunk(toks, pos, tree["kvs"], caches,
                                              tree["template_logits"],
                                              weights)

        def commit_fn(hs, m, pos):
            commit_conv_caches(caches, hs, m, pos)

        def draft_fn(tokens, pos, finished):
            return ngram_drafts(source, tokens, pos, spec_k - 1, n=ngram_n,
                                pad_id=config.pad_id)

        return speculative_greedy(chunk_fn, commit_fn, seed, config, spec_k,
                                  draft_fn)


@MODELS.register("transformer_entity")
def transformer_entity(entity_dim: int = 1024, **kw) -> TransformerFlattened:
    extra = tuple(kw.pop("extra_contexts", ())) + (("entity", entity_dim),)
    return TransformerFlattened(extra_contexts=extra, **kw)


@MODELS.register("transformer_entity_pointer")
def transformer_entity_pointer(entity_dim: int = 1024,
                               decoder_kwargs: Optional[Dict] = None, *,
                               device, dtype, generator=None,
                               **kw) -> TransformerPointer:
    dk = dict(decoder_kwargs or {})
    extra = tuple(dk.pop("extra_contexts", ())) + (("entity", entity_dim),)
    cap = TransformerFlattened(extra_contexts=extra, device=device,
                               dtype=dtype, generator=generator, **dk)
    return TransformerPointer(captioner=cap, generator=generator, **kw)
