"""Input-feeding LSTM captioner over image and article contexts.

Counterpart of `news_image_caption_tpu/models/decoder_lstm.py`
(`AttentionLayer`, `TorchLSTMCellWithBias`, `LSTMDecoder`,
`LSTMFlattenedModel`, registered as `lstm_flattened` and
`baseline_glove`). Luong-style input feeding: each step reads [the
token's embedding, the previous step's attention output]; stacked LSTM
cells start from learned states `h0_i` / `c0_i`; a dot attention over
the image and one over the article each mix their source and project
[mix, query] through tanh; `attn_proj` fuses the two into the step's
output, which is the next step's input feed and the hidden state of the
tied adaptive softmax (`ops/adaptive.py`, the flagship's head).

`LSTMFlattenedModel` is one `nn.Module` whose parameter names are the
flax tree's (`cells_0.ih.kernel` for `cells_0/ih/kernel`, `h0_0`,
`image_attention.input_proj.scale`, `attn_proj.kernel`, `embedder.*`,
`adaptive_softmax.*`), so `models/from_jax.py::params_from_jax` maps the
reference's weights by renaming alone; it is its own `param_module`.

Training (`loss_fn`) runs the teacher-forced steps as a Python loop over
the caption (the reference's `lax.scan`), loss in bits per token.
Decoding (`generate`, greedy or top-k sampled) takes each step's
candidates from `AdaptiveSoftmax.topk_log_prob` over the tied tables
(`band_topk_lse` three times a step on the card, the head table built
once a load by `decode_weights`), where the reference takes them from
full-vocab log-probs: no [B, V] matrix is formed. The cells and the two
attentions are plain PyTorch on either device, as the reference's are
XLA: the attentions are single-head over 2048 / 1024 / 300-wide sources,
which `decode_cross_attention` does not take.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from news_image_caption_tpu_torch.data.synthetic import LOSS_KEYS
from news_image_caption_tpu_torch.generation.generator import (
    GenerationConfig, Generators, generate_candidates)
from news_image_caption_tpu_torch.models.decoder_flattened import SumEmbedder
from news_image_caption_tpu_torch.ops.adaptive import AdaptiveSoftmax
from news_image_caption_tpu_torch.ops.dropout import dropout
from news_image_caption_tpu_torch.ops.linear import (GehringLinear,
                                                     initializes, new_param)
from news_image_caption_tpu_torch.parallel.collectives import global_sums
from news_image_caption_tpu_torch.utils.registry import DECODERS, MODELS

LN2 = math.log(2.0)
NEG = -1e9


class AttentionLayer(nn.Module):
    """Dot attention: score = source . input_proj(query), padding at
    -1e9, softmax in fp32; out = tanh(output_proj([mix, query]))."""

    def __init__(self, query_dim: int, source_dim: int, output_dim: int, *,
                 device, dtype, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.input_proj = GehringLinear(query_dim, source_dim, **kw)
        self.output_proj = GehringLinear(source_dim + query_dim, output_dim,
                                         **kw)

    def forward(self, query: torch.Tensor, source: torch.Tensor,
                source_mask: Optional[torch.Tensor] = None):
        """query [B, H]; source [B, S, D]; source_mask [B, S], True at
        padding. Returns (out [B, output_dim], attention [B, S])."""
        x = self.input_proj(query)
        scores = torch.einsum("bsd,bd->bs", source, x)
        if source_mask is not None:
            scores = scores.masked_fill(source_mask.to(torch.bool), NEG)
        attn = torch.softmax(scores.float(), dim=-1).to(source.dtype)
        mix = torch.einsum("bs,bsd->bd", attn, source)
        out = torch.tanh(self.output_proj(torch.cat([mix, query], dim=-1)))
        return out, attn


class TorchLSTMCellWithBias(nn.Module):
    """torch.nn.LSTMCell's gates (i, f, g, o) from two biased Dense
    layers, `ih` on the input and `hh` on the hidden state."""

    def __init__(self, input_size: int, hidden_size: int, *, device, dtype,
                 generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator,
                  weight_norm=False)
        self.ih = GehringLinear(input_size, 4 * hidden_size, **kw)
        self.hh = GehringLinear(hidden_size, 4 * hidden_size, **kw)

    def forward(self, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
        i, f, g, o = (self.ih(x) + self.hh(h)).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c


class LSTMState(NamedTuple):
    h: List[torch.Tensor]          # a layer's [B, H]
    c: List[torch.Tensor]
    input_feed: torch.Tensor       # [B, H]


class LSTMWeights(NamedTuple):
    """What a decode reads besides the module: the head band of
    `AdaptiveSoftmax.topk_log_prob` in the compute dtype."""

    head_table: torch.Tensor


@DECODERS.register("lstm_decoder_flattened")
@MODELS.register("baseline_glove")
@MODELS.register("lstm_flattened")
class LSTMFlattenedModel(nn.Module):
    """Embedder, stacked input-feeding cells, the two context attentions
    and the tied adaptive softmax; `loss_fn` and `generate`.

    contexts: image [B, P, image_dim], article [B, S, article_dim] and
    their masks [B, P] / [B, S], True at padding. The head is tied to
    the embedder's tables, so hidden_size must equal embed_dim;
    tie_adaptive_proj ties its tail projections to the embedder's band
    projections too.
    """

    batch_keys = LOSS_KEYS

    def __init__(self, *, device, dtype=torch.float32, generator=None,
                 vocab_size: int = 50265, embed_dim: int = 1024,
                 hidden_size: int = 1024, num_layers: int = 2,
                 cutoff: Sequence[int] = (5000, 20000, 50265),
                 tie_adaptive_proj: bool = False, image_dim: int = 2048,
                 article_dim: int = 1024, dropout_rate: float = 0.1,
                 padding_idx: int = 0, target_padding_idx: int = 1,
                 max_positions: int = 512):
        super().__init__()
        if hidden_size != embed_dim:
            raise ValueError(f"the tied head reads the hidden state: "
                             f"hidden_size {hidden_size} must equal "
                             f"embed_dim {embed_dim}")
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.dtype = dtype
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.dropout_rate = dropout_rate
        self.target_padding_idx = target_padding_idx
        self.max_positions = max_positions
        self.embedder = SumEmbedder(
            vocab_size, embed_dim, cutoff, padding_idx=padding_idx,
            pos_padding_idx=target_padding_idx, max_positions=max_positions,
            **kw)
        for i in range(num_layers):
            in_size = embed_dim + hidden_size if i == 0 else hidden_size
            setattr(self, f"cells_{i}",
                    TorchLSTMCellWithBias(in_size, hidden_size, **kw))
            for name in (f"h0_{i}", f"c0_{i}"):
                p = new_param((1, hidden_size), device, dtype)
                if initializes(device):
                    with torch.no_grad():
                        p.zero_()
                setattr(self, name, p)
        self.image_attention = AttentionLayer(hidden_size, image_dim,
                                              hidden_size, **kw)
        self.article_attention = AttentionLayer(hidden_size, article_dim,
                                                hidden_size, **kw)
        self.attn_proj = GehringLinear(2 * hidden_size, hidden_size, **kw)
        self.adaptive_softmax = AdaptiveSoftmax(
            embed_dim, cutoff, tie_proj=tie_adaptive_proj, **kw)

    @property
    def param_module(self) -> nn.Module:
        """The module that holds every parameter: the model itself."""
        return self

    def _contexts(self, batch: Dict[str, torch.Tensor]):
        """The batch's image and article in the model's dtype, and their
        masks."""
        return {k: (None if batch.get(k) is None else
                    batch[k].to(self.dtype) if batch[k].is_floating_point()
                    else batch[k])
                for k in ("image", "image_mask", "article", "article_mask")}

    def init_state(self, batch_size: int) -> LSTMState:
        h = [getattr(self, f"h0_{i}").expand(batch_size, -1)
             for i in range(self.num_layers)]
        c = [getattr(self, f"c0_{i}").expand(batch_size, -1)
             for i in range(self.num_layers)]
        feed = torch.zeros(batch_size, self.hidden_size,
                           device=h[0].device, dtype=self.dtype)
        return LSTMState(h, c, feed)

    def embed(self, token_t: torch.Tensor, step_idx: int,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """token_t [B] at position step_idx -> [B, E]."""
        x = self.embedder(token_t[:, None], start_pos=step_idx)[:, 0, :]
        return dropout(x, self.dropout_rate, generator)

    def step(self, x_t: torch.Tensor, state: LSTMState,
             contexts: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None):
        """x_t [B, E], already embedded -> (out [B, H], the next state)."""
        rnn_input = torch.cat([x_t, state.input_feed], dim=-1)
        hs, cs = [], []
        for i in range(self.num_layers):
            h, c = getattr(self, f"cells_{i}")(rnn_input, state.h[i],
                                               state.c[i])
            rnn_input = dropout(h, self.dropout_rate, generator)
            hs.append(h)
            cs.append(c)
        img_out, _ = self.image_attention(h, contexts["image"],
                                          contexts.get("image_mask"))
        art_out, _ = self.article_attention(h, contexts["article"],
                                            contexts.get("article_mask"))
        out = dropout(torch.cat([img_out, art_out], dim=-1),
                      self.dropout_rate, generator)
        out = self.attn_proj(out)
        return out, LSTMState(hs, cs, out)

    def hidden(self, token_ids: torch.Tensor,
               contexts: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Teacher-forced outputs [B, T, H] of token_ids [B, T]; training
        with a generator."""
        state = self.init_state(token_ids.shape[0])
        outs = []
        for t in range(token_ids.shape[1]):
            x = self.embed(token_ids[:, t], t, generator)
            out, state = self.step(x, state, contexts, generator)
            outs.append(out)
        return torch.stack(outs, dim=1)

    def loss_fn(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None):
        """Per-token loss in bits, (mean_loss, {"loss_sum": summed loss in
        bits, "sample_size": ntokens}); training dropout with a
        generator on the model's device, deterministic without one."""
        caption = batch["caption_ids"].long()
        inp, tgt = caption[:, :-1], caption[:, 1:]
        x = self.hidden(inp, self._contexts(batch), generator)
        loss_sum, ntokens = self.adaptive_softmax.loss_sum(
            x.reshape(-1, x.shape[-1]), tgt.reshape(-1),
            self.target_padding_idx, self.embedder.embed_tables())
        loss_bits, ntokens = global_sums(loss_sum / LN2, ntokens)
        return (loss_bits / torch.clamp(ntokens, min=1),
                {"loss_sum": loss_bits, "sample_size": ntokens})

    def log_prob(self, token_ids: torch.Tensor,
                 contexts: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Full-vocab log-probs [B, T, V] (teacher forced)."""
        x = self.hidden(token_ids, contexts)
        B, T, H = x.shape
        lp = self.adaptive_softmax.log_prob(x.reshape(B * T, H),
                                            self.embedder.embed_tables())
        return lp.view(B, T, self.vocab_size)

    def decode_weights(self) -> LSTMWeights:
        """The head table of the decode steps; compute once per load."""
        with torch.no_grad():
            return LSTMWeights(self.adaptive_softmax.head_table(
                self.embedder.embed_tables(), self.dtype))

    def _check_max_len(self, config: GenerationConfig) -> None:
        if config.max_len > self.max_positions:
            raise ValueError(f"max_len {config.max_len} exceeds the "
                             f"model's max_positions {self.max_positions}")

    @torch.inference_mode()
    def generate(self, batch: Dict[str, torch.Tensor],
                 config: GenerationConfig = GenerationConfig(),
                 weights: Optional[LSTMWeights] = None,
                 generator: Optional[Generators] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Greedy or top-k sampled captions: (tokens [B, max_len + 1]
        int64, log_probs [B, max_len] fp32). Each step's candidates are
        the exact top-k of the adaptive-softmax bands; sampling draws
        from `generator` (`generation/generator.py::gumbel_noise`),
        without one from a generator seeded with 0."""
        self._check_max_len(config)
        contexts = self._contexts(batch)
        B = contexts["article"].shape[0]
        device = contexts["article"].device
        if weights is None:
            weights = self.decode_weights()
        tables = self.embedder.embed_tables()
        state = [self.init_state(B)]

        def step(tok, i):
            out, state[0] = self.step(self.embed(tok, i), state[0], contexts)
            return self.adaptive_softmax.topk_log_prob(
                out, config.sampling_topk, tables, weights.head_table)

        seed = torch.full((B,), config.bos_id, dtype=torch.long,
                          device=device)
        return generate_candidates(step, seed, config, generator)
