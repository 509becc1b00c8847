"""The pointer family: the flagship captioner with an entity gate and a
copy head over the article.

Counterpart of `news_image_caption_tpu/models/pointer.py`
(`EntitySelfAttention`, `CopyAttentionScores`, `copy_target_prob`,
`copy_distribution`, `TransformerPointer`). The entity gate is a
strictly causal self-attention over the decoder's hidden states (a zero
"attend to nothing" slot first, so position 0 attends only that slot),
a residual LayerNorm and a 2-way `GehringLinear`; the copy head is the
head-averaged attention of the hidden states over the article features
(fp32, a learned bias_k slot and a zero slot, both dropped after the
softmax), masked to the article's proper-noun positions and summed per
token id.

`TransformerPointer` is one `nn.Module` whose children are the
captioner's decoder (`decoder`, so its parameter names are the
flagship's under `decoder.`) and the three heads (`entity_attn`,
`entity_fc`, `copy_attn`); `models/from_jax.py` maps the reference's
{captioner, entity_attn, entity_fc, copy_attn} tree onto it. The
reference's switches: `loss_weights` (gen, entity, copy; (0, 1, 1)
trains the heads only) and `use_entity_head=False`
(`transformer_only_pointer`, which trains and decodes through the
decoder alone).

Decoding: `generate` (greedy or top-k sampled) steps the decoder through
`step_topk_with_hidden`, the generated candidates the exact top-k of the
adaptive-softmax bands (`band_topk_lse` on the card), where the
reference takes them from full-vocab log-probs; `generate_speculative`
and the slot pool (`generation/continuous.py::ContinuousBatcher.
for_pointer`) run `pointer_chunk` / `pointer_commit` over
`step_chunk_with_hidden`, the banded top-1, so greedy and speculative
take their tokens from the same head. Every selection is `stable_topk`
(ties to the lowest id, the `lax.top_k` rule) and the gate compares its
two logits (ties say "generate", as `argmax` does). `copy_distribution`
scatters each position's summed mass over the positions holding its id
rather than adding duplicates with atomics, so a second call on the card
is bit-equal. The heads are plain PyTorch operations on either device.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from news_image_caption_tpu_torch.data.synthetic import POINTER_KEYS
from news_image_caption_tpu_torch.generation.generator import (
    GenerationConfig, Generators, sample_index)
from news_image_caption_tpu_torch.generation.speculative import (
    commit_conv_caches, ngram_drafts, speculative_greedy)
from news_image_caption_tpu_torch.models.captioner import (
    LN2, TransformerFlattened, shift_caption)
from news_image_caption_tpu_torch.models.decoder_flattened import \
    DecodeWeights
from news_image_caption_tpu_torch.ops.band_topk import stable_topk
from news_image_caption_tpu_torch.ops.dropout import dropout
from news_image_caption_tpu_torch.ops.linear import (GehringLinear,
                                                     LayerNorm, initializes,
                                                     new_param, positionwise)
from news_image_caption_tpu_torch.parallel.collectives import global_sums
from news_image_caption_tpu_torch.utils.registry import MODELS

NEG = -1e9

EntityCache = Tuple[torch.Tensor, torch.Tensor]
CopyKeys = Tuple[torch.Tensor, torch.Tensor]
# (conv rings, entity K/V, copied-token table [B, V] bool)
PointerCaches = Tuple[list, EntityCache, torch.Tensor]


class EntitySelfAttention(nn.Module):
    """Strictly causal self-attention with a zero slot, then
    LayerNorm(out + x); the LayerNorm's output is fp32 (flax promotes a
    bf16 input with fp32 parameters)."""

    def __init__(self, embed_dim: int, num_heads: int, *, device, dtype,
                 generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.num_heads = num_heads
        self.in_proj_q = GehringLinear(embed_dim, embed_dim, **kw)
        self.in_proj_k = GehringLinear(embed_dim, embed_dim, **kw)
        self.in_proj_v = GehringLinear(embed_dim, embed_dim, **kw)
        self.out_proj = GehringLinear(embed_dim, embed_dim, **kw)
        self.ln = LayerNorm(embed_dim, device=device, dtype=dtype)

    def _qkv(self, x: torch.Tensor):
        """q (scaled), k, v [B, T, H, hd] of x [B, T, E]."""
        B, T, E = x.shape
        H = self.num_heads
        hd = E // H
        q = self.in_proj_q(x) * (hd ** -0.5)
        return (q.view(B, T, H, hd), self.in_proj_k(x).view(B, T, H, hd),
                self.in_proj_v(x).view(B, T, H, hd))

    def _attend(self, x, q, k, v, valid):
        """Softmax over [the zero slot, the keys valid [.., T, S]] in
        fp32, the probabilities in v's dtype; then out_proj and the
        LayerNorm."""
        B, T, E = x.shape
        scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
        scores = torch.where(valid, scores, NEG)
        zero = scores.new_zeros(scores.shape[:-1] + (1,))
        probs = torch.softmax(torch.cat([zero, scores], dim=-1), dim=-1)
        # The zero slot's value is zero: it takes mass, adds nothing.
        out = torch.einsum("bhts,bshd->bthd", probs[..., 1:].to(v.dtype), v)
        out = self.out_proj(out.reshape(B, T, E))
        return self.ln((out + x).float())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, T, E] -> [B, T, E] fp32; position t attends t' < t."""
        T = x.shape[1]
        q, k, v = self._qkv(x)
        t = torch.arange(T, device=x.device)
        return self._attend(x, q, k, v, t[None, :] < t[:, None])

    def init_cache(self, batch_size: int, max_len: int, device,
                   dtype: torch.dtype) -> EntityCache:
        """Zero K/V rows [B, max_len, H, hd] in the decoder's dtype."""
        E = self.in_proj_k.kernel.shape[1]
        shape = (batch_size, max_len, self.num_heads, E // self.num_heads)
        return (torch.zeros(shape, device=device, dtype=dtype),
                torch.zeros(shape, device=device, dtype=dtype))

    def step(self, x_t: torch.Tensor, pos, cache: EntityCache,
             row=None) -> torch.Tensor:
        """x_t [B, E] at position pos (an int, or each row's [B]
        tensor): its K/V written into cache row `row` (default pos) in
        place, rows < pos attended. Returns [B, E] fp32."""
        k_c, v_c = cache
        q, k, v = self._qkv(x_t[:, None])
        slots = torch.arange(k_c.shape[1], device=x_t.device)
        if isinstance(pos, torch.Tensor):
            rows = torch.arange(x_t.shape[0], device=x_t.device)
            row = pos.long() if row is None else row
            k_c[rows, row] = k[:, 0].to(k_c.dtype)
            v_c[rows, row] = v[:, 0].to(v_c.dtype)
            valid = (slots[None, :] < pos.long()[:, None])[:, None, None]
        else:
            k_c[:, pos] = k[:, 0].to(k_c.dtype)
            v_c[:, pos] = v[:, 0].to(v_c.dtype)
            valid = slots < pos
        return self._attend(x_t[:, None], q, k_c, v_c, valid)[:, 0]

    def chunk(self, x_c: torch.Tensor, pos: torch.Tensor,
              cache: EntityCache) -> torch.Tensor:
        """k positions of each row (speculative verification): x_c
        [B, k, E], pos [B] the position of x_c[:, 0]; output j is the
        `step` of x_c[:, j] at pos + j, its K/V written into cache row
        start + j in place, start = pos moved back so that the window
        stays inside the cache (as `dynamic_update_slice` moves it).
        Rows past a row's committed frontier are never attended and the
        next chunk overwrites them, so a partial commit needs no rewind.
        The steps run one position after the other at a step's shapes,
        so each sums as `step` does. Returns [B, k, E] fp32."""
        B, k, _ = x_c.shape
        start = pos.long().clamp(0, cache[0].shape[1] - k)
        return torch.stack([self.step(x_c[:, j].contiguous(), pos.long() + j,
                                      cache, row=start + j)
                            for j in range(k)], dim=1)


class CopyAttentionScores(nn.Module):
    """Head-averaged attention probabilities of queries [B, L, E] over
    keys [B, S, kdim]: the raw (in, out) projections `q_proj_weight`,
    `k_proj_weight` and `in_proj_bias` [2E], a learned `bias_k` slot and
    a zero slot, softmax in fp32, dropout at `dropout` in training, then
    the mean over heads with the two slots dropped: [B, L, S] fp32."""

    def __init__(self, embed_dim: int, num_heads: int,
                 kdim: Optional[int] = None, dropout: float = 0.1, *,
                 device, dtype, generator=None):
        super().__init__()
        kdim = kdim or embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        E = embed_dim
        self.q_proj_weight = new_param((E, E), device, dtype)
        self.k_proj_weight = new_param((kdim, E), device, dtype)
        self.in_proj_bias = new_param((2 * E,), device, dtype)
        self.bias_k = new_param((1, 1, E), device, dtype)
        if initializes(device):
            with torch.no_grad():
                for w in (self.q_proj_weight, self.k_proj_weight):
                    bound = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
                    w.uniform_(-bound, bound, generator=generator)
                self.in_proj_bias.zero_()
                # flax's xavier_normal scale on (1, 1, E): fan_in 1.
                self.bias_k.normal_(0.0, math.sqrt(2.0 / (1 + E)),
                                    generator=generator)

    def keys(self, key: torch.Tensor,
             key_padding_mask: Optional[torch.Tensor] = None) -> CopyKeys:
        """The projected keys [B, S + 2, E] fp32 (the bias_k slot and the
        zero slot last) and which may be attended [B, S + 2]; the mask
        [B, S] is True at padding. Decoding computes them once a
        request."""
        B, S, _ = key.shape
        E = self.q_proj_weight.shape[0]
        k = key.float() @ self.k_proj_weight.float() \
            + self.in_proj_bias.float()[E:]
        k = torch.cat([k, self.bias_k.float().expand(B, 1, E),
                       k.new_zeros(B, 1, E)], dim=1)
        valid = torch.ones(B, S + 2, dtype=torch.bool, device=key.device)
        if key_padding_mask is not None:
            valid[:, :S] = ~key_padding_mask.to(torch.bool)
        return k, valid

    def attend(self, query: torch.Tensor, keys: CopyKeys,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The probabilities of queries [B, L, E] over `keys`."""
        k, valid = keys
        B, L, E = query.shape
        H = self.num_heads
        q = (query.float() @ self.q_proj_weight.float()
             + self.in_proj_bias.float()[:E]) * ((E // H) ** -0.5)
        scores = torch.einsum("blhd,bshd->bhls", q.view(B, L, H, E // H),
                              k.view(B, k.shape[1], H, E // H))
        scores = torch.where(valid[:, None, None, :], scores, NEG)
        probs = dropout(torch.softmax(scores, dim=-1), self.dropout,
                        generator)
        return probs.mean(dim=1)[:, :, :k.shape[1] - 2]

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        return self.attend(query, self.keys(key, key_padding_mask), generator)


def copy_target_prob(copy_attn: torch.Tensor, context_ids: torch.Tensor,
                     target_ids: torch.Tensor) -> torch.Tensor:
    """p_copy(target) [B, L] = sum_s attn[b, l, s] [ctx[b, s] == tgt[b, l]]."""
    match = context_ids[:, None, :] == target_ids[:, :, None]
    return (copy_attn * match).sum(dim=-1)


def copy_distribution(copy_attn: torch.Tensor, context_ids: torch.Tensor,
                      vocab_size: int) -> torch.Tensor:
    """The copy distribution [B, V] of attention [B, S] over the ids
    [B, S]: each id's mass summed over its positions. Each position's
    sum over the positions with its id (O(S^2) compares) is scattered to
    its id, so duplicates write equal values and the result does not
    depend on the order of the writes."""
    ids = context_ids.long()
    same = ids[:, :, None] == ids[:, None, :]
    mass = (copy_attn[:, None, :] * same).sum(dim=-1)
    dist = copy_attn.new_zeros(copy_attn.shape[0], vocab_size)
    return dist.scatter_(1, ids, mass)


@MODELS.register("transformer_pointer")
class TransformerPointer(nn.Module):
    """Flagship captioner + entity gate + copy head.

    captioner: the `TransformerFlattened` to wrap (the variants' builders
    pass one); without it one is built from `decoder_kwargs` with
    `embed_dim`, `num_heads` and `article_dim`, on `device` in `dtype`.
    The heads live on the decoder's device in its dtype, over its width,
    with `num_heads` heads; the copy head's keys are `article_dim` wide
    (the decoder's by default). `max_entities` is accepted and dropped:
    the copy loss covers every entity index.
    """

    batch_keys = POINTER_KEYS

    def __init__(self, captioner: Optional[TransformerFlattened] = None, *,
                 device=None, dtype=None, generator=None,
                 embed_dim: int = 1024, num_heads: int = 16,
                 article_dim: Optional[int] = None,
                 loss_weights: Sequence[float] = (0.0, 1.0, 1.0),
                 use_entity_head: bool = True,
                 max_entities: Optional[int] = None, **decoder_kwargs):
        super().__init__()
        del max_entities
        if captioner is None:
            decoder_kwargs.setdefault("embed_dim", embed_dim)
            decoder_kwargs.setdefault("num_heads", num_heads)
            if article_dim is not None:
                decoder_kwargs.setdefault("article_dim", article_dim)
            captioner = TransformerFlattened(
                device=device, dtype=dtype, generator=generator,
                **decoder_kwargs)
        self.captioner = captioner
        self.decoder = captioner.decoder
        d = self.decoder
        kw = dict(device=next(d.parameters()).device, dtype=d.dtype,
                  generator=generator)
        E = d.embed_dim
        self.vocab_size = d.vocab_size
        self.article_dim = article_dim or d.article_dim
        self.entity_attn = EntitySelfAttention(E, num_heads, **kw)
        self.entity_fc = GehringLinear(E, 2, **kw)
        self.copy_attn = CopyAttentionScores(E, num_heads,
                                             kdim=self.article_dim, **kw)
        self.loss_weights = tuple(float(w) for w in loss_weights)
        self.use_entity_head = use_entity_head

    @property
    def param_module(self) -> nn.Module:
        """The module that holds every parameter: the pointer itself."""
        return self

    def _contexts(self, batch):
        return self.captioner._contexts(batch)

    def _check_max_len(self, config: GenerationConfig) -> None:
        self.captioner._check_max_len(config)

    def decode_weights(self) -> DecodeWeights:
        """The decoder's fused decode weights; compute once per load."""
        return self.decoder.decode_weights()

    @staticmethod
    def load_pretrained_captioner(state: Dict[str, torch.Tensor],
                                  captioner_state: Dict[str, torch.Tensor]
                                  ) -> Dict[str, torch.Tensor]:
        """Warm start: the pointer's state dict with the decoder's
        entries taken from a captioner's (`TransformerFlattened.decoder`
        state dict, the flagship's checkpoint params)."""
        return {**state, **{f"decoder.{k}": v
                            for k, v in captioner_state.items()}}

    # -- training --------------------------------------------------------

    def _entity_logits(self, x: torch.Tensor) -> torch.Tensor:
        return self.entity_fc(self.entity_attn(x))

    def loss_fn(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None):
        """(loss, aux): loss = the `loss_weights` mix of the generation
        loss (bits per token), the entity gate's loss and the copy loss,
        aux {gen_loss, entity_loss, copy_loss, sample_size}. Besides the
        captioner's keys the batch carries caption_copy_masks [B, Lc]
        (a caption token's entity index: 0 none, i >= 1 the i-th entity,
        -1 ignored), context_proper_masks [B, S] (>= 1 at proper nouns)
        and article_ids [B, S]. Training dropout with a generator."""
        inp, tgt = shift_caption(batch["caption_ids"].long())
        x = self.decoder.hidden(inp, self._contexts(batch), generator)
        loss_sum, ntokens = self.decoder.loss_from_hidden(x, tgt, generator)
        loss_sum, ntokens = global_sums(loss_sum, ntokens)
        gen_loss = loss_sum / LN2 / torch.clamp(ntokens, min=1)
        zero = gen_loss.new_zeros(())
        entity_loss = copy_loss = zero
        if self.use_entity_head:
            L = x.shape[1]
            copy_masks = batch["caption_copy_masks"][:, 1:][:, :L].long()
            ent_tgt = copy_masks.clamp(-1, 1)
            lse = torch.log_softmax(self._entity_logits(x).float(), dim=-1)
            nll = -lse.gather(-1, ent_tgt.clamp(min=0)[..., None])[..., 0]
            valid = ent_tgt >= 0
            ent_sum, n_valid = global_sums(torch.where(valid, nll, 0.0).sum(),
                                           valid.sum())
            entity_loss = (ent_sum / torch.clamp(n_valid, min=1)) / LN2
            attn = self.copy_attn(x, batch["article"],
                                  batch.get("article_mask"), generator)
            attn = attn * (batch["context_proper_masks"] >= 1)[:, None, :]
            p_tgt = copy_target_prob(attn, batch["article_ids"].long(), tgt)
            # A target with no copy mass adds 0, not -log(eps) (the
            # reference fills log-probs only where the mass is positive).
            log_p = torch.where(p_tgt > 0,
                                torch.log(torch.clamp(p_tgt, min=1e-12)), 0.0)
            # Each entity's mean -log p over its tokens, summed over the
            # entities: a one-hot product, a fixed-order sum on the card.
            num = batch["caption_copy_masks"].shape[1] + 1
            on = copy_masks >= 1
            seg = on & (copy_masks < num)     # a larger index is dropped
            onehot = torch.nn.functional.one_hot(
                torch.where(seg, copy_masks, 0), num).float() * seg[..., None]
            sums, cnts, n_on = global_sums(
                (onehot * -log_p[..., None]).sum(dim=(0, 1)),
                onehot.sum(dim=(0, 1)), on.sum())
            per_entity = torch.where(cnts > 0,
                                     sums / torch.clamp(cnts, min=1.0), 0.0)
            copy_loss = per_entity[1:].sum() / LN2
            # A batch without entities adds neither loss (no gradient on
            # the gate), as the reference returns early.
            has_entities = n_on > 0
            entity_loss = torch.where(has_entities, entity_loss, zero)
            copy_loss = torch.where(has_entities, copy_loss, zero)
        wg, we, wc = self.loss_weights
        loss = wg * gen_loss + we * entity_loss + wc * copy_loss
        return loss, {"gen_loss": gen_loss, "entity_loss": entity_loss,
                      "copy_loss": copy_loss, "sample_size": ntokens}

    # -- decoding --------------------------------------------------------

    def pointer_tree(self, batch: Dict[str, torch.Tensor], kvs) -> Dict:
        """What the heads read at decode time: the context K/V `kvs`, the
        copy head's keys over the article (projected once here, as `kvs`
        are), the article's ids and its proper-noun relevance (fp32
        0/1)."""
        copy_keys, copy_valid = self.copy_attn.keys(batch["article"],
                                                    batch.get("article_mask"))
        return {"kvs": kvs, "copy_keys": copy_keys, "copy_valid": copy_valid,
                "context_ids": batch["article_ids"].long(),
                "relevant": (batch["context_proper_masks"] >= 1).float()}

    def pointer_caches(self, batch_size: int, entity_rows: int,
                       device) -> PointerCaches:
        """Zero decode state of B rows: the conv rings, `entity_rows`
        entity K/V rows and the copied-token table."""
        d = self.decoder
        return (d.init_cache(batch_size, device),
                self.entity_attn.init_cache(batch_size, entity_rows, device,
                                            d.dtype),
                torch.zeros(batch_size, self.vocab_size, dtype=torch.bool,
                            device=device))

    @staticmethod
    def clear_pointer_slot(caches: PointerCaches, slot: int) -> None:
        """Zero one row's decode state in place (a pool slot refilled)."""
        conv, (k_c, v_c), copied = caches
        for ring in conv:
            ring[:, slot].zero_()
        k_c[slot].zero_()
        v_c[slot].zero_()
        copied[slot] = False

    def _copy_candidates(self, h: torch.Tensor, tree: Dict, k: int):
        """The top-k of the copy distribution of hidden states h [B, n, E]:
        (probabilities [B, n, k] fp32, ids [B, n, k])."""
        B, n, _ = h.shape
        attn = self.copy_attn.attend(h, (tree["copy_keys"],
                                         tree["copy_valid"]))
        attn = attn * tree["relevant"][:, None, :]
        dist = copy_distribution(attn.reshape(B * n, -1),
                                 tree["context_ids"].repeat_interleave(n, 0),
                                 self.vocab_size)
        p, ids = stable_topk(dist, k)
        return p.view(B, n, k), ids.view(B, n, k)

    def _wants_copy(self, h_ent: torch.Tensor) -> torch.Tensor:
        """The gate: argmax of its two logits is 1 (a tie generates)."""
        logits = self.entity_fc(h_ent)
        return logits[..., 1] > logits[..., 0]

    @torch.inference_mode()
    def generate(self, batch: Dict[str, torch.Tensor],
                 config: GenerationConfig = GenerationConfig(),
                 weights: Optional[DecodeWeights] = None,
                 generator: Optional[Generators] = None):
        """Greedy or top-k sampled captions, copying or generating each
        step: (tokens [B, max_len + 1] int64, copied_flags [B, max_len]
        bool, flags[b, t] marking tokens[b, t + 1] as copied).

        A step's gate reads the entity self-attention of the hidden
        states so far; the copy candidate is drawn from the top-k of the
        copy distribution (its first at top-1), the generated token from
        the exact top-k of the banded log-probs / temp. Copying is
        suppressed where any of the top-k copy probabilities is under
        1e-6 or the candidate was copied before (no re-ranking). A
        copied eos drops its flag. Sampling draws, each step, the copy
        choice then the generated one from `generator` (a generator
        seeded with 0 without one). transformer_only_pointer decodes
        through the captioner alone, flags all False."""
        k = config.sampling_topk
        if not self.use_entity_head:
            tokens, _ = self.captioner.generate(batch, config, weights,
                                                generator)
            return tokens, torch.zeros(tokens.shape[0], config.max_len,
                                       dtype=torch.bool,
                                       device=tokens.device)
        kvs, conv, seed, weights = self.captioner._decode_setup(
            batch, config, weights, 1)
        dev = seed.device
        if k > 1 and generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        tree = self.pointer_tree(batch, kvs)
        B, L = seed.shape[0], config.max_len
        e_cache = self.entity_attn.init_cache(B, L + 1, dev,
                                              self.decoder.dtype)
        copied = torch.zeros(B, self.vocab_size, dtype=torch.bool,
                             device=dev)
        rows = torch.arange(B, device=dev)
        tokens = torch.full((B, L + 1), config.pad_id, dtype=torch.long,
                            device=dev)
        tokens[:, 0] = seed
        flags = torch.zeros(B, L, dtype=torch.bool, device=dev)
        finished = torch.zeros(B, dtype=torch.bool, device=dev)
        cur = seed
        for i in range(L):
            if config.early_exit and bool(finished.all()):
                break
            gen_lp, gen_ids, h = self.decoder.step_topk_with_hidden(
                cur, i, kvs, conv, k, weights)
            want = self._wants_copy(self.entity_attn.step(h, i, e_cache))
            copy_p, copy_ids = (t[:, 0] for t in self._copy_candidates(
                h[:, None], tree, k))
            gen_lp = gen_lp / config.sampling_temp
            if k == 1:
                copy_tok, gen_tok = copy_ids[:, 0], gen_ids[:, 0]
            else:
                c = sample_index(torch.log(torch.clamp(copy_p, min=1e-9)),
                                 generator)
                copy_tok = copy_ids.gather(1, c[:, None])[:, 0]
                g = sample_index(gen_lp, generator)
                gen_tok = gen_ids.gather(1, g[:, None])[:, 0]
            should_copy = (want & (copy_p >= 1e-6).all(dim=1)
                           & ~copied[rows, copy_tok])
            tok = torch.where(should_copy, copy_tok, gen_tok)
            tok = torch.where(finished, config.pad_id, tok)
            copied[rows, copy_tok] |= should_copy
            finished = finished | (tok == config.eos_id)
            flags[:, i] = should_copy & ~finished
            tokens[:, i + 1] = tok
            cur = tok
        return tokens, flags

    def pointer_chunk(self, tokens: torch.Tensor, pos: torch.Tensor,
                      tree: Dict, caches: PointerCaches, eos_id: int,
                      weights: DecodeWeights):
        """One chunked greedy step of the pointer, shared by
        `generate_speculative` and the slot pool. tokens [B, k], pos [B];
        tree from `pointer_tree`; caches from `pointer_caches`, the
        entity K/V rows of the chunk written in place. Returns (log_probs
        [B, k], ids [B, k], aux for `pointer_commit`, copied_flags
        [B, k]): output j copies its top-1 candidate where the gate says
        so, its probability is at least 1e-6 and neither the committed
        table nor an accepted copy earlier in the chunk holds it."""
        conv, e_cache, copied = caches
        lp, gen_ids, h, hs = self.decoder.step_chunk_with_hidden(
            tokens, pos, tree["kvs"], conv, weights)
        # The heads position by position, at a greedy step's shapes.
        want = positionwise(self._wants_copy,
                            self.entity_attn.chunk(h, pos, e_cache))
        cands = [self._copy_candidates(h[:, j:j + 1].contiguous(), tree, 1)
                 for j in range(h.shape[1])]
        copy_p = torch.cat([p for p, _ in cands], dim=1)[..., 0]
        copy_tok = torch.cat([t for _, t in cands], dim=1)[..., 0]
        gate_pre = want & (copy_p >= 1e-6)
        rows = torch.arange(tokens.shape[0], device=tokens.device)[:, None]
        committed = copied[rows, copy_tok]                    # [B, k]
        ids, gates = [], []
        for j in range(tokens.shape[1]):
            dup = committed[:, j]
            for i in range(j):
                dup = dup | (gates[i] & (copy_tok[:, i] == copy_tok[:, j]))
            gates.append(gate_pre[:, j] & ~dup)
            ids.append(torch.where(gates[j], copy_tok[:, j], gen_ids[:, j]))
        ids, gates = torch.stack(ids, dim=1), torch.stack(gates, dim=1)
        return lp, ids, (hs, copy_tok, gates), gates & (ids != eos_id)

    @staticmethod
    def pointer_commit(caches: PointerCaches, aux, m: torch.Tensor,
                       pos: torch.Tensor) -> None:
        """Advance (conv rings, entity K/V, copied table) by each row's
        m verified outputs, in place (the entity rows were written by
        the chunk)."""
        conv, _, copied = caches
        hs, copy_tok, gates = aux
        commit_conv_caches(conv, hs, m, pos)
        k = copy_tok.shape[1]
        mark = gates & (torch.arange(k, device=m.device)[None, :]
                        < m[:, None])
        # An id copied twice in a chunk: every write carries the OR.
        same = copy_tok[:, :, None] == copy_tok[:, None, :]
        mark = (same & mark[:, None, :]).any(dim=-1)
        rows = torch.arange(copy_tok.shape[0], device=m.device)[:, None]
        copied[rows, copy_tok] |= mark

    @torch.inference_mode()
    def generate_speculative(self, batch: Dict[str, torch.Tensor],
                             config: GenerationConfig = GenerationConfig(),
                             weights: Optional[DecodeWeights] = None,
                             spec_k: int = 8,
                             draft_source: Optional[torch.Tensor] = None,
                             ngram_n: int = 2):
        """Exact speculative greedy decode of the pointer: the tokens and
        flags of greedy `pointer_chunk` steps taken one at a time, spec_k
        positions verified a chunk (drafts from `draft_source`, default
        batch["article_ids"]). Returns (tokens [B, max_len + 1],
        copied_flags [B, max_len], n_chunks). transformer_only_pointer
        runs the captioner's, flags all False."""
        if config.sampling_topk != 1:
            raise ValueError("speculative decoding is greedy-only "
                             "(sampling_topk must be 1)")
        if not self.use_entity_head:
            tokens, _, n_chunks = self.captioner.generate_speculative(
                batch, config, weights, spec_k=spec_k,
                draft_source=draft_source, ngram_n=ngram_n)
            return tokens, torch.zeros(tokens.shape[0], config.max_len,
                                       dtype=torch.bool,
                                       device=tokens.device), n_chunks
        kvs, _, seed, weights = self.captioner._decode_setup(
            batch, config, weights, 1)
        tree = self.pointer_tree(batch, kvs)
        # max_len + spec_k entity rows: a chunk's writes never clamp.
        caches = self.pointer_caches(seed.shape[0], config.max_len + spec_k,
                                     seed.device)
        source = (draft_source if draft_source is not None
                  else batch["article_ids"]).to(seed.device).long()

        def chunk_fn(toks, pos):
            return self.pointer_chunk(toks, pos, tree, caches, config.eos_id,
                                      weights)

        def commit_fn(aux, m, pos):
            self.pointer_commit(caches, aux, m, pos)

        def draft_fn(tokens, pos, finished):
            return ngram_drafts(source, tokens, pos, spec_k - 1, n=ngram_n,
                                pad_id=config.pad_id)

        tokens, _, flags, n_chunks = speculative_greedy(
            chunk_fn, commit_fn, seed, config, spec_k, draft_fn,
            collect_flags=True)
        return tokens, flags, n_chunks
