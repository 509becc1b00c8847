"""Dynamic-convolution caption decoder (Transform-and-Tell style).

Counterpart of `news_image_caption_tpu/models/decoder_flattened.py` for
the flagship structure (dynamic conv, GLU, post-LayerNorm, image and
article contexts, tied adaptive softmax): `SumEmbedder`,
`DynamicConvDecoderLayer` (full-sequence forward, with the training
dropouts, and the ring-major decode step) and `DynamicConvDecoder`
(`precompute_kv`, `hidden`, `loss`, `log_prob`, `attention_maps`,
`init_cache`, `step_topk`, and the full-vocab `step` and
`step_with_hidden`).

A training forward takes a `torch.Generator` on the model's device and
drops as the reference does: the embeddings (`dropout`), the conv
block's input (`input_dropout`) and taps (`weight_dropout`), its output
(`dropout`), the attention probabilities (`attention_dropout`), each
context attention's output (`dropout`), the FFN's hidden ReLU
(`relu_dropout`) and output (`dropout`). `use_flash_train` sends the
context attentions through `flash_cross_attention`; it adds no
parameters. generator=None is evaluation.

Parameter names follow the flax tree (`layers.0.image_attn.k_proj.kernel`
for `layers_0/image_attn/k_proj/kernel`), so `models/from_jax.py` maps
the reference's weights by renaming alone.

The decode step runs the port's kernels: `decode_conv_block`,
`decode_cross_attention` (inside `attend_flat_beam`), `decode_ffn_block`
and `band_topk_lse` (inside `topk_log_prob`); the full-vocab `step`
takes the same layer steps and ends in `AdaptiveSoftmax.log_prob`, plain
products outside any kernel as in the reference. Their weights, with the
weight norm folded and cast to the working dtype, come from
`DynamicConvDecoder.decode_weights()`, computed once per model load
rather than once per step. Each wrapper takes its plain PyTorch version
on CPU tensors; on the card it launches its kernel or raises, so a model
the kernels do not admit (fp32, narrow widths, a pointwise conv layer:
`admits*` of the ops modules say why) decodes on the CPU only.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from news_image_caption_tpu_torch.ops.adaptive import (AdaptiveEmbedding,
                                                       AdaptiveSoftmax)
from news_image_caption_tpu_torch.ops.attention import (AttentionKV,
                                                        MultiHeadAttention)
from news_image_caption_tpu_torch.ops.conv import DynamicConv
from news_image_caption_tpu_torch.ops.decode_blocks import (
    decode_conv_block, decode_ffn_block, pack_taps)
from news_image_caption_tpu_torch.ops.dropout import dropout
from news_image_caption_tpu_torch.ops.linear import GehringLinear, LayerNorm
from news_image_caption_tpu_torch.ops.positional import \
    SinusoidalPositionalEmbedding

LayerKV = Dict[str, AttentionKV]


class LayerDecodeWeights(NamedTuple):
    """One layer's fused decode weights (weight norm folded)."""

    conv_w1: torch.Tensor      # [D, 2C]
    conv_b1: torch.Tensor
    conv_wl: torch.Tensor      # [C, H*K], head-major tap predictor
    conv_taps: torch.Tensor    # pack_taps(conv_wl), as the kernel reads it
    conv_w2: torch.Tensor      # [C, D]
    conv_b2: torch.Tensor
    context_w: torch.Tensor    # [n_contexts * D, D]
    context_b: torch.Tensor
    ffn_w1: torch.Tensor       # [D, F]
    ffn_b1: torch.Tensor
    ffn_w2: torch.Tensor       # [F, D]
    ffn_b2: torch.Tensor


class DecodeWeights(NamedTuple):
    layers: List[LayerDecodeWeights]
    head_table: torch.Tensor   # [cutoff0 + n_tails, D]


class SumEmbedder(nn.Module):
    """Adaptive word embedding + sinusoidal positions, summed."""

    def __init__(self, vocab_size: int, embed_dim: int,
                 cutoff: Sequence[int], *, device, dtype, generator=None,
                 padding_idx: int = 0, pos_padding_idx: int = 1,
                 max_positions: int = 512):
        super().__init__()
        assert cutoff[-1] == vocab_size
        self.adaptive = AdaptiveEmbedding(
            cutoff, embed_dim, embed_dim, padding_idx=padding_idx,
            scale_embeds=True, device=device, dtype=dtype,
            generator=generator)
        self.position = SinusoidalPositionalEmbedding(
            embed_dim, padding_idx=pos_padding_idx, init_size=max_positions,
            device=device, dtype=dtype)
        self.n_bands = len(cutoff)

    def forward(self, token_ids: torch.Tensor,
                start_pos: int = 0) -> torch.Tensor:
        return self.adaptive(token_ids) + self.position(token_ids, start_pos)

    def embed_tables(self):
        return [self.adaptive.weights_for_band(i)
                for i in range(self.n_bands)]


class DynamicConvDecoderLayer(nn.Module):
    """Conv block, then one attention per context fused by `context_fc`,
    then the FFN; LayerNorm after each block."""

    def __init__(self, embed_dim: int, kernel_size: int, num_heads: int,
                 ffn_dim: int, context_specs: Sequence[Tuple[str, int]], *,
                 device, dtype, generator=None, dropout: float = 0.1,
                 weight_dropout: float = 0.1, relu_dropout: float = 0.0,
                 input_dropout: float = 0.1, attention_dropout: float = 0.1,
                 use_flash_train: bool = False):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        D = embed_dim
        self.dropout = dropout
        self.relu_dropout = relu_dropout
        self.input_dropout = input_dropout
        self.num_heads = num_heads
        self.kernel_size = kernel_size
        self.context_names = [name for name, _ in context_specs]
        self.linear1 = GehringLinear(D, 2 * D, **kw)
        self.conv = DynamicConv(D, kernel_size, num_heads,
                                weight_dropout=weight_dropout, **kw)
        self.linear2 = GehringLinear(D, D, **kw)
        self.conv_layer_norm = LayerNorm(D, device=device, dtype=dtype)
        for name, kdim in context_specs:
            setattr(self, f"{name}_attn",
                    MultiHeadAttention(D, num_heads, kdim,
                                       dropout=attention_dropout,
                                       use_flash=use_flash_train, **kw))
            setattr(self, f"{name}_attn_ln",
                    LayerNorm(D, device=device, dtype=dtype))
        self.context_fc = GehringLinear(len(context_specs) * D, D, **kw)
        self.fc1 = GehringLinear(D, ffn_dim, **kw)
        self.fc2 = GehringLinear(ffn_dim, D, **kw)
        self.final_layer_norm = LayerNorm(D, device=device, dtype=dtype)

    def _attn(self, name: str) -> MultiHeadAttention:
        return getattr(self, f"{name}_attn")

    def _attn_ln(self, name: str) -> LayerNorm:
        return getattr(self, f"{name}_attn_ln")

    def precompute_kv(self, contexts: Dict[str, torch.Tensor]) -> LayerKV:
        return {name: self._attn(name).precompute_kv(
                    contexts[name], contexts[name],
                    contexts.get(f"{name}_mask"))
                for name in self.context_names}

    def forward(self, x: torch.Tensor, kv: LayerKV,
                generator: Optional[torch.Generator] = None,
                need_attn: bool = False):
        """Full-sequence forward, x [B, T, D]; training with a
        generator. need_attn=True returns (x, {context: head-averaged
        attention [B, T, S']}), the context attentions off the flash
        route; otherwise x alone."""
        def drop(t, rate):
            return dropout(t, rate, generator)

        a, g = self.linear1(drop(x, self.input_dropout)).chunk(2, dim=-1)
        h = self.conv(a * torch.sigmoid(g), generator)
        x = self.conv_layer_norm(x + drop(self.linear2(h), self.dropout))
        parts, attns = [], {}
        for name in self.context_names:
            y = self._attn(name).attend(x, kv[name], generator, need_attn)
            if need_attn:
                y, attns[name] = y
            parts.append(self._attn_ln(name)(x + drop(y, self.dropout)))
        x = self.context_fc(torch.cat(parts, dim=-1))
        y = drop(torch.relu(self.fc1(x)), self.relu_dropout)
        y = drop(self.fc2(y), self.dropout)
        x = self.final_layer_norm(x + y)
        return (x, attns) if need_attn else x

    def decode_weights(self, dtype: torch.dtype) -> LayerDecodeWeights:
        w1, b1 = self.linear1.folded(dtype)
        w2, b2 = self.linear2.folded(dtype)
        cw, cb = self.context_fc.folded(dtype)
        f1, fb1 = self.fc1.folded(dtype)
        f2, fb2 = self.fc2.folded(dtype)
        wl = self.conv.weight_linear.kernel.to(dtype).contiguous()
        return LayerDecodeWeights(w1, b1, wl, pack_taps(wl, self.num_heads),
                                  w2, b2, cw, cb, f1, fb1, f2, fb2)

    def step(self, x_t: torch.Tensor, kv: LayerKV, cache: torch.Tensor,
             t: int, w: LayerDecodeWeights, beam: int = 1) -> torch.Tensor:
        """One decode step, x_t [B*beam, D]. cache [K-1, B*beam, C] is
        the ring-major conv history; the GLU row of step t is written
        into slot t mod (K-1) in place (a pointwise layer, K = 1, has an
        empty one)."""
        y, h = decode_conv_block(x_t, cache, t, w.conv_w1, w.conv_b1,
                                 w.conv_wl, w.conv_w2, w.conv_b2,
                                 self.num_heads, taps=w.conv_taps)
        if self.kernel_size > 1:
            cache[t % (self.kernel_size - 1)] = h
        x = self.conv_layer_norm(y)
        parts = [self._attn_ln(name)(
                     x + self._attn(name).attend_flat_beam(x, kv[name], beam))
                 for name in self.context_names]
        x = torch.cat(parts, dim=-1) @ w.context_w + w.context_b
        y = decode_ffn_block(x, w.ffn_w1, w.ffn_b1, w.ffn_w2, w.ffn_b2)
        return self.final_layer_norm(y)


class DynamicConvDecoder(nn.Module):
    """Decoder stack + tied adaptive softmax.

    contexts (batch first): image [B, P, image_dim], image_mask [B, P]
    and article [B, S, article_dim], article_mask [B, S], masks True at
    padding.
    """

    def __init__(self, *, device, dtype, generator=None,
                 vocab_size: int = 50265, embed_dim: int = 1024,
                 ffn_dim: int = 4096, num_heads: int = 16,
                 num_layers: int = 4,
                 kernel_sizes: Sequence[int] = (3, 7, 15, 31),
                 cutoff: Sequence[int] = (5000, 20000, 50265),
                 image_dim: int = 2048, article_dim: int = 1024,
                 padding_idx: int = 0, target_padding_idx: int = 1,
                 max_positions: int = 512, dropout: float = 0.1,
                 weight_dropout: float = 0.1, relu_dropout: float = 0.0,
                 input_dropout: float = 0.1, attention_dropout: float = 0.1,
                 use_flash_train: bool = False):
        super().__init__()
        assert len(kernel_sizes) == num_layers
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.dtype = dtype
        self.vocab_size = vocab_size
        self.embed_dim = embed_dim
        self.kernel_sizes = tuple(kernel_sizes)
        self.max_positions = max_positions
        self.dropout = dropout
        self.target_padding_idx = target_padding_idx
        self.embedder = SumEmbedder(
            vocab_size, embed_dim, cutoff, padding_idx=padding_idx,
            pos_padding_idx=target_padding_idx, max_positions=max_positions,
            **kw)
        specs = (("image", image_dim), ("article", article_dim))
        self.layers = nn.ModuleList(
            DynamicConvDecoderLayer(
                embed_dim, k, num_heads, ffn_dim, specs, dropout=dropout,
                weight_dropout=weight_dropout, relu_dropout=relu_dropout,
                input_dropout=input_dropout,
                attention_dropout=attention_dropout,
                use_flash_train=use_flash_train, **kw)
            for k in kernel_sizes)
        self.adaptive_softmax = AdaptiveSoftmax(embed_dim, cutoff, **kw)

    def precompute_kv(self, contexts: Dict[str, Optional[torch.Tensor]]
                      ) -> List[LayerKV]:
        contexts = {k: (v.to(self.dtype)
                        if v is not None and v.is_floating_point() else v)
                    for k, v in contexts.items()}
        return [layer.precompute_kv(contexts) for layer in self.layers]

    def hidden(self, token_ids: torch.Tensor,
               contexts: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Teacher-forced hidden states [B, T, D]; training with a
        generator."""
        kvs = self.precompute_kv(contexts)
        x = dropout(self.embedder(token_ids), self.dropout, generator)
        for layer, kv in zip(self.layers, kvs):
            x = layer(x, kv, generator)
        return x

    def loss(self, token_ids: torch.Tensor, contexts: Dict[str, torch.Tensor],
             target_ids: torch.Tensor,
             generator: Optional[torch.Generator] = None):
        """(summed adaptive CE fp32, ntokens) of the targets, padding
        `target_padding_idx` ignored."""
        x = self.hidden(token_ids, contexts, generator)
        return self.adaptive_softmax.loss_sum(
            x.reshape(-1, x.shape[-1]), target_ids.reshape(-1),
            self.target_padding_idx, self.embedder.embed_tables())

    def log_prob(self, token_ids: torch.Tensor,
                 contexts: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Full-vocab log-probs [B, T, V] (teacher forced)."""
        x = self.hidden(token_ids, contexts)
        B, T, D = x.shape
        lp = self.adaptive_softmax.log_prob(x.reshape(B * T, D),
                                            self.embedder.embed_tables())
        return lp.view(B, T, self.vocab_size)

    def attention_maps(self, token_ids: torch.Tensor,
                       contexts: Dict[str, torch.Tensor]
                       ) -> List[Dict[str, torch.Tensor]]:
        """Per layer, {context: attention [B, T, S']} of a teacher-forced
        pass over token_ids (head-averaged; S' counts the bias and zero
        slots). Decoding is deterministic given its tokens, so a pass
        over generated ids gives the attention of the steps that made
        them."""
        kvs = self.precompute_kv(contexts)
        x = self.embedder(token_ids)
        maps = []
        for layer, kv in zip(self.layers, kvs):
            x, attns = layer(x, kv, need_attn=True)
            maps.append(attns)
        return maps

    def init_cache(self, batch_size: int, device) -> List[torch.Tensor]:
        """Zero ring-major conv histories [K-1, B, C], one per layer
        (empty for a pointwise layer)."""
        return [torch.zeros(k - 1, batch_size, self.embed_dim,
                            device=device, dtype=self.dtype)
                for k in self.kernel_sizes]

    def decode_weights(self) -> DecodeWeights:
        """The step's fused weights; compute once per model load."""
        with torch.no_grad():
            tables = self.embedder.embed_tables()
            return DecodeWeights(
                layers=[layer.decode_weights(self.dtype)
                        for layer in self.layers],
                head_table=self.adaptive_softmax.head_table(tables,
                                                            self.dtype))

    def _step_layers(self, token_t: torch.Tensor, step_idx: int,
                     kvs: List[LayerKV], caches: List[torch.Tensor],
                     weights: DecodeWeights, beam: int) -> torch.Tensor:
        """The layers of one decode step: hidden state [B*beam, D]; the
        conv caches advance in place."""
        x = self.embedder(token_t[:, None], start_pos=step_idx)[:, 0, :]
        for layer, kv, cache, w in zip(self.layers, kvs, caches,
                                       weights.layers):
            x = layer.step(x, kv, cache, step_idx, w, beam)
        return x

    def step_topk(self, token_t: torch.Tensor, step_idx: int,
                  kvs: List[LayerKV], caches: List[torch.Tensor], k: int,
                  weights: DecodeWeights, beam: int = 1):
        """One decode step returning the exact top-k candidates.

        token_t [B*beam]; step_idx = tokens already consumed. The conv
        caches advance in place. Returns (cand_log_probs [B*beam, k]
        fp32, cand_ids [B*beam, k] int64).
        """
        x = self._step_layers(token_t, step_idx, kvs, caches, weights, beam)
        return self.adaptive_softmax.topk_log_prob(
            x, k, self.embedder.embed_tables(), weights.head_table)

    def step_with_hidden(self, token_t: torch.Tensor, step_idx: int,
                         kvs: List[LayerKV], caches: List[torch.Tensor],
                         weights: DecodeWeights, beam: int = 1):
        """One decode step with the full-vocab head, the same layer steps
        as `step_topk`. Returns (log_probs [B*beam, V] in the model's
        dtype, hidden [B*beam, D]); the conv caches advance in place.
        With beam > 1, kvs are the untiled batch's (shared K/V)."""
        x = self._step_layers(token_t, step_idx, kvs, caches, weights, beam)
        lp = self.adaptive_softmax.log_prob(x, self.embedder.embed_tables())
        return lp, x

    def step(self, token_t: torch.Tensor, step_idx: int,
             kvs: List[LayerKV], caches: List[torch.Tensor],
             weights: DecodeWeights, beam: int = 1) -> torch.Tensor:
        """`step_with_hidden` without the hidden state: log_probs
        [B*beam, V]."""
        return self.step_with_hidden(token_t, step_idx, kvs, caches,
                                     weights, beam)[0]
