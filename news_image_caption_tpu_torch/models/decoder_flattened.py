"""Dynamic-convolution caption decoder (Transform-and-Tell style).

Counterpart of `news_image_caption_tpu/models/decoder_flattened.py`
with every option of its dataclasses (the layer's conv width, conv type,
GLU, taps, pre- or post-LayerNorm; the decoder's final norm, tail
dropout, tied tail projections, remat and parameter dtype) over its
attended contexts: image (unless `include_image` is False), article,
then `extra_contexts` in order, such as faces and objects
(`models/variants.py`): `SumEmbedder`,
`DynamicConvDecoderLayer` (full-sequence forward, with the training
dropouts, and the ring-major decode step) and `DynamicConvDecoder`
(`precompute_kv`, `hidden`, `loss`, `log_prob`, `attention_maps`,
`init_cache`, `step_topk` at one position or a position a row, the
speculative chunk `step_chunk`, the full-vocab `step` and
`step_with_hidden`, and the full-vocab beam steps of the reference's two
other cache layouts, `step_shift` and `step_beam_lazy` with
`init_slot_maps`; `loss_from_hidden`, `step_topk_with_hidden` and
`step_chunk_with_hidden`, the hidden states' ways in for the pointer
family of `models/pointer.py`).

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
and `band_topk_lse` (inside `topk_log_prob`). A layer whose structure
the conv block's kernel does not take (`fused_decode_ok`: dynamic conv,
GLU, softmaxed taps, post-LayerNorm, conv_dim == embed_dim) runs the
reference's unfused conv step in plain PyTorch over the same ring-major
cache, and a pre-norm layer its FFN so too (`fused_ffn_ok`); the
configuration decides, once, when the decode weights are built. The
full-vocab `step` takes the same layer steps and ends in
`AdaptiveSoftmax.log_prob`, plain products outside any kernel as in the
reference. The kernels' weights, with the
weight norm folded and cast to the working dtype, come from
`DynamicConvDecoder.decode_weights()`, computed once per model load
rather than once per step. Each wrapper takes its plain PyTorch version
on CPU tensors; on the card it launches a kernel or raises: the fast
kernel where its `admits*` holds (the flagship in bf16), else the
generic variant (`csrc/decode_generic.cu`), which takes fp32, narrow
widths and head sizes down to 1, and a pointwise conv layer (K = 1,
no ring), so every model the plain step decodes decodes on the card
(`route_*` of the ops modules choose, by dtype and shapes alone).

The conv block's kernel reads the ring-major layout [K-1, N, C] only,
tap k of a row at position p from slot (p + k) mod (K-1). The shift
layout [N, K-1, C] (oldest first) is copied into a contiguous
ring-major tensor and launched with every row at position 0, so tap k
reads the k-th oldest input; its new cache is the old one shifted by one
with the GLU row appended. The lazy layout keeps a ring-major cache
where it is across beam reorders, with a slot map [K-1, N] a layer
(the physical row of each logical row's input in each slot): each
slot's rows are gathered through the map into a contiguous ring-major
tensor, launched at the step's position, the GLU row written into slot
t mod (K-1) in logical order and that slot's map row reset to the
identity. Both copy the cache once a layer and step.

The opt-in int8 routes (the reference's `quantize_kv` and
`quantize_head`): `precompute_kv(contexts, quantize=True)` quantizes
each attention's K/V once a request (`ops/attention.py::quantize_kv`),
which `attend_flat_beam` / `attend_chunk` send through
`decode_cross_attention_int8`; `quantized_embed_tables()` quantizes the
head's word tables once (`decode_weights(quantize_head=True)` keeps
them beside the fused weights), and every step takes them as `tables=`,
the head then on `band_topk_lse_int8`.

Tensor parallelism (`parallel/partition.py::shard_params` over a mesh's
`model` axis): each attention holds its heads, the FFN its columns of
fc1 and rows of fc2 (the hidden ReLU's dropout drawn whole and sliced),
the embedder and the tied softmax their rows of each band. The decode
weights are the rank's slices: fc2 folded with the whole weight norm,
the FFN run through `decode_ffn_block`'s partial mode and summed over
the ranks (`LayerDecodeWeights.ffn_shard`), the head table the rank's
rows of table0 (the class rows in rank 0's). The conv blocks,
`context_fc` and the LayerNorms are replicated. Every rank runs the
same steps on the same rows, so decode's tokens are the same on each.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from news_image_caption_tpu_torch.ops.adaptive import (
    AdaptiveEmbedding, AdaptiveSoftmax, quantize_embed_tables)
from news_image_caption_tpu_torch.ops.attention import (AttentionKV,
                                                        MultiHeadAttention,
                                                        quantize_kv)
from news_image_caption_tpu_torch.ops.conv import (DynamicConv,
                                                   LightweightConv)
from news_image_caption_tpu_torch.ops.decode_blocks import (
    decode_conv_block, decode_ffn_block, pack_taps)
from news_image_caption_tpu_torch.ops.dropout import dropout, remat
from news_image_caption_tpu_torch.ops.linear import (GehringLinear, LayerNorm,
                                                     positionwise)
from news_image_caption_tpu_torch.ops.positional import \
    SinusoidalPositionalEmbedding
from news_image_caption_tpu_torch.parallel.collectives import reduce_out
from news_image_caption_tpu_torch.parallel.partition import shard_of
from news_image_caption_tpu_torch.utils.registry import DECODERS

LayerKV = Dict[str, AttentionKV]


class LayerDecodeWeights(NamedTuple):
    """One layer's decode weights (weight norm folded). The conv block's
    are None where the layer runs the plain conv step, the FFN's where
    it runs the plain FFN (`DynamicConvDecoderLayer.fused_decode_ok`,
    `fused_ffn_ok`)."""

    conv_w1: Optional[torch.Tensor]      # [D, 2C]
    conv_b1: Optional[torch.Tensor]
    conv_wl: Optional[torch.Tensor]      # [C, H*K], head-major taps
    conv_taps: Optional[torch.Tensor]    # pack_taps(conv_wl)
    conv_w2: Optional[torch.Tensor]      # [C, D]
    conv_b2: Optional[torch.Tensor]
    context_w: torch.Tensor              # [n_contexts * D, D]
    context_b: torch.Tensor
    ffn_w1: Optional[torch.Tensor]       # [D, F]
    ffn_b1: Optional[torch.Tensor]
    ffn_w2: Optional[torch.Tensor]       # [F, D]
    ffn_b2: Optional[torch.Tensor]
    # The model axis of a split FFN (its columns of w1, rows of w2), whose
    # partial sums the step adds over the ranks; None unsplit or at a
    # model axis of one.
    ffn_shard: object = None


class DecodeWeights(NamedTuple):
    layers: List[LayerDecodeWeights]
    head_table: torch.Tensor   # [cutoff0 + n_tails, D]; split, the rank's
    # The int8 head tables (`quantized_embed_tables`), where asked for.
    quant_tables: Optional[list] = None


class SumEmbedder(nn.Module):
    """Adaptive word embedding + sinusoidal positions, summed. The
    tables are stored in `param_dtype` (default `dtype`); the sum is in
    `dtype`."""

    def __init__(self, vocab_size: int, embed_dim: int,
                 cutoff: Sequence[int], *, device, dtype, generator=None,
                 padding_idx: int = 0, pos_padding_idx: int = 1,
                 max_positions: int = 512,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        assert cutoff[-1] == vocab_size
        self.adaptive = AdaptiveEmbedding(
            cutoff, embed_dim, embed_dim, padding_idx=padding_idx,
            scale_embeds=True, device=device, dtype=param_dtype or dtype,
            generator=generator, out_dtype=dtype)
        self.position = SinusoidalPositionalEmbedding(
            embed_dim, padding_idx=pos_padding_idx, init_size=max_positions,
            device=device, dtype=dtype)
        self.n_bands = len(cutoff)

    def forward(self, token_ids: torch.Tensor,
                start_pos: int | torch.Tensor = 0) -> torch.Tensor:
        """start_pos: an int, or a [B, 1] tensor of each row's position
        (a slot pool, a speculative chunk)."""
        return self.adaptive(token_ids) + self.position(token_ids, start_pos)

    def embed_tables(self):
        return [self.adaptive.weights_for_band(i)
                for i in range(self.n_bands)]


CONV_TYPES = {"dynamic": DynamicConv, "lightweight": LightweightConv}


class DynamicConvDecoderLayer(nn.Module):
    """Conv block, then one attention per context fused by `context_fc`,
    then the FFN. The reference's options: `conv_dim` (the conv block's
    width C, default D), `conv_type` ("dynamic" or "lightweight"),
    `decoder_glu` (linear1 to 2C and a GLU, or to C), `weight_softmax`,
    and `normalize_before` (each block's LayerNorm on its input, not on
    its output after the residual). The parameters of the linears, the
    conv and the attentions are stored in `param_dtype` (default
    `dtype`); the LayerNorms' in `dtype`."""

    def __init__(self, embed_dim: int, kernel_size: int, num_heads: int,
                 ffn_dim: int, context_specs: Sequence[Tuple[str, int]], *,
                 device, dtype, generator=None, dropout: float = 0.1,
                 weight_dropout: float = 0.1, relu_dropout: float = 0.0,
                 input_dropout: float = 0.1, attention_dropout: float = 0.1,
                 use_flash_train: bool = False,
                 conv_dim: Optional[int] = None, conv_type: str = "dynamic",
                 decoder_glu: bool = True, weight_softmax: bool = True,
                 normalize_before: bool = False,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if conv_type not in CONV_TYPES:
            raise ValueError(f"conv_type {conv_type!r}: expected one of "
                             f"{sorted(CONV_TYPES)}")
        kw = dict(device=device, dtype=param_dtype or dtype,
                  generator=generator)
        D = embed_dim
        C = conv_dim or D
        self.embed_dim = D
        self.conv_dim = C
        self.conv_type = conv_type
        self.decoder_glu = decoder_glu
        self.weight_softmax = weight_softmax
        self.normalize_before = normalize_before
        self.dropout = dropout
        self.relu_dropout = relu_dropout
        self.input_dropout = input_dropout
        self.num_heads = num_heads
        self.kernel_size = kernel_size
        self.context_names = [name for name, _ in context_specs]
        self.linear1 = GehringLinear(D, (2 if decoder_glu else 1) * C, **kw)
        self.conv = CONV_TYPES[conv_type](
            C, kernel_size, num_heads, weight_softmax=weight_softmax,
            weight_dropout=weight_dropout, **kw)
        self.linear2 = GehringLinear(C, D, **kw)
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

    def fused_decode_ok(self) -> bool:
        """Whether the decode step's conv block runs `decode_conv_block`:
        the flagship's structure, the reference's `fused_decode_ok`
        terms (dynamic conv, GLU, softmaxed taps, post-LayerNorm) with
        the kernel's one width (conv_dim == embed_dim). Decided by the
        configuration alone; otherwise the plain step runs."""
        return (self.conv_type == "dynamic" and self.decoder_glu
                and self.weight_softmax and not self.normalize_before
                and self.conv_dim == self.embed_dim)

    def fused_ffn_ok(self) -> bool:
        """Whether the decode step's FFN runs `decode_ffn_block`: its
        LayerNorm after the residual (the reference's `_ffn_block`)."""
        return not self.normalize_before

    def _attn(self, name: str) -> MultiHeadAttention:
        return getattr(self, f"{name}_attn")

    def _attn_ln(self, name: str) -> LayerNorm:
        return getattr(self, f"{name}_attn_ln")

    def _ln(self, ln: LayerNorm, x: torch.Tensor, before: bool):
        """The reference's `_maybe_ln`: ln(x) where the block's LayerNorm
        sits at this end of it (before or after)."""
        return ln(x) if before == self.normalize_before else x

    def precompute_kv(self, contexts: Dict[str, torch.Tensor],
                      quantize: bool = False) -> LayerKV:
        """Each context's K/V; int8 (`quantize_kv`) with quantize."""
        out = {}
        for name in self.context_names:
            kv = self._attn(name).precompute_kv(contexts[name],
                                                contexts[name],
                                                contexts.get(f"{name}_mask"))
            heads = self._attn(name).local_heads()
            out[name] = quantize_kv(kv, heads) if quantize else kv
        return out

    def _conv_in(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        """The conv block's input to the conv: [LayerNorm,] input
        dropout, linear1[, GLU]."""
        h = self.linear1(dropout(self._ln(self.conv_layer_norm, x, True),
                                 self.input_dropout, generator))
        if self.decoder_glu:
            a, g = h.chunk(2, dim=-1)
            h = a * torch.sigmoid(g)
        return h

    def _ffn(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        """The FFN block, its residual and LayerNorm."""
        y = self.fc1.local(self._ln(self.final_layer_norm, x, True))
        y = dropout(torch.relu(y), self.relu_dropout, generator,
                    part=(-1, shard_of(self.fc1)))
        y = dropout(self.fc2.local(y), self.dropout, generator)
        return self._ln(self.final_layer_norm, x + y, False)

    def forward(self, x: torch.Tensor, kv: LayerKV,
                generator: Optional[torch.Generator] = None,
                need_attn: bool = False):
        """Full-sequence forward, x [B, T, D]; training with a
        generator. need_attn=True returns (x, {context: head-averaged
        attention [B, T, S']}), the context attentions off the flash
        route; otherwise x alone."""
        def drop(t, rate):
            return dropout(t, rate, generator)

        h = self.conv(self._conv_in(x, generator), generator)
        x = self._ln(self.conv_layer_norm,
                     x + drop(self.linear2(h), self.dropout), False)
        parts, attns = [], {}
        for name in self.context_names:
            ln = self._attn_ln(name)
            y = self._attn(name).attend(self._ln(ln, x, True), kv[name],
                                        generator, need_attn)
            if need_attn:
                y, attns[name] = y
            parts.append(self._ln(ln, x + drop(y, self.dropout), False))
        x = self._ffn(self.context_fc(torch.cat(parts, dim=-1)), generator)
        return (x, attns) if need_attn else x

    def decode_weights(self, dtype: torch.dtype) -> LayerDecodeWeights:
        """The step's weights in `dtype`: the fused kernels' folded
        weights where the layer's structure takes them (`fused_decode_ok`,
        `fused_ffn_ok`), None in their place otherwise."""
        conv, ffn, shard = (None,) * 6, (None,) * 4, None
        if self.fused_decode_ok():
            w1, b1 = self.linear1.folded(dtype)
            w2, b2 = self.linear2.folded(dtype)
            wl = self.conv.weight_linear.kernel.to(dtype).contiguous()
            conv = (w1, b1, wl, pack_taps(wl, self.num_heads), w2, b2)
        if self.fused_ffn_ok():
            ffn = self.fc1.folded(dtype) + self.fc2.folded(dtype)
            if self.fc2.split == "row" and shard_of(self.fc2).size > 1:
                shard = shard_of(self.fc2)
        return LayerDecodeWeights(*conv, *self.context_fc.folded(dtype),
                                  *ffn, shard)

    @staticmethod
    def _decode_ffn(x: torch.Tensor, w: LayerDecodeWeights) -> torch.Tensor:
        """`decode_ffn_block` over x's rows: split over more than one
        rank, in its partial mode, the ranks' partial sums added before
        b2 and the residual."""
        reduce = (None if w.ffn_shard is None
                  else lambda t: reduce_out(t, w.ffn_shard))
        return decode_ffn_block(x, w.ffn_w1, w.ffn_b1, w.ffn_w2, w.ffn_b2,
                                reduce=reduce)

    def _conv_step(self, x_t: torch.Tensor, ring: torch.Tensor, t,
                   w: LayerDecodeWeights):
        """The conv block of one token a row over a ring-major cache:
        (its output x [N, D], the conv's input row h [N, C] to write into
        the ring). Through `decode_conv_block` where `w` has the fused
        weights, else the plain step (the reference's unfused step:
        `_conv_block_pre`, the conv's ring step, `_conv_block_post`)."""
        if w.conv_w1 is not None:
            y, h = decode_conv_block(x_t, ring, t, w.conv_w1, w.conv_b1,
                                     w.conv_wl, w.conv_w2, w.conv_b2,
                                     self.num_heads, taps=w.conv_taps)
            return self.conv_layer_norm(y), h
        h = self._conv_in(x_t)
        y = x_t + self.linear2(self.conv.ring_step(h, ring, t))
        return self._ln(self.conv_layer_norm, y, False), h

    def _after_conv(self, x: torch.Tensor, kv: LayerKV,
                    w: LayerDecodeWeights, beam: int) -> torch.Tensor:
        """The context attentions of [B*beam, D] rows over the untiled
        batch's K/V, `context_fc` and the FFN (`decode_ffn_block` where
        `w` has its weights)."""
        parts = []
        for name in self.context_names:
            ln = self._attn_ln(name)
            y = self._attn(name).attend_flat_beam(self._ln(ln, x, True),
                                                  kv[name], beam)
            parts.append(self._ln(ln, x + y, False))
        x = torch.cat(parts, dim=-1) @ w.context_w + w.context_b
        if w.ffn_w1 is None:
            return self._ffn(x)
        return self.final_layer_norm(self._decode_ffn(x, w))

    def step(self, x_t: torch.Tensor, kv: LayerKV, cache: torch.Tensor,
             t, w: LayerDecodeWeights, beam: int = 1) -> torch.Tensor:
        """One decode step, x_t [B*beam, D]. cache [K-1, B*beam, C] is
        the ring-major conv history; t is the step index of every row
        (an int) or each row's position (an int32 [B*beam] tensor on
        x_t's device). The conv input row of a row at position p is
        written into its slot p mod (K-1) in place (a pointwise layer,
        K = 1, has an empty ring)."""
        x, h = self._conv_step(x_t, cache, t, w)
        self._write_ring(cache, t, h)
        return self._after_conv(x, kv, w, beam)

    def step_shift(self, x_t: torch.Tensor, kv: LayerKV,
                   cache: torch.Tensor, w: LayerDecodeWeights,
                   beam: int = 1):
        """One decode step over a shifted-copy cache [N, K-1, C], the
        inputs oldest first: (x [N, D], the new cache)."""
        ring = cache.transpose(0, 1).contiguous()
        x, h = self._conv_step(x_t, ring, 0, w)
        new_cache = torch.cat([cache, h[:, None]], dim=1)[:, 1:]
        return self._after_conv(x, kv, w, beam), new_cache

    def step_lazy_beam(self, x_t: torch.Tensor, kv: LayerKV,
                       cache: torch.Tensor, slot_map: torch.Tensor, t: int,
                       w: LayerDecodeWeights, beam: int) -> torch.Tensor:
        """One decode step over a physically stationary ring-major cache
        [K-1, N, C] read through slot_map [K-1, N]. The cache and the map
        advance in place."""
        Km1 = self.kernel_size - 1
        slots = torch.arange(Km1, device=cache.device)[:, None]
        x, h = self._conv_step(x_t, cache[slots, slot_map], t, w)
        if Km1:
            cache[t % Km1] = h
            slot_map[t % Km1] = torch.arange(h.shape[0],
                                             device=slot_map.device)
        return self._after_conv(x, kv, w, beam)

    def _write_ring(self, cache: torch.Tensor, t, h: torch.Tensor) -> None:
        """Each row's conv input h into its slot t mod (K-1), in place: t
        an int for every row, or an [N] tensor of positions."""
        Km1 = self.kernel_size - 1
        if Km1 == 0:
            return
        if isinstance(t, torch.Tensor):
            rows = torch.arange(h.shape[0], device=h.device)
            cache[t.long() % Km1, rows] = h
        else:
            cache[t % Km1] = h

    def chunk(self, x: torch.Tensor, kv: LayerKV, cache: torch.Tensor,
              pos: torch.Tensor, w: LayerDecodeWeights):
        """k decode steps of each row at once, x [B, k, D], the same math
        as k sequential `step`s: the conv is the layer's only mixing over
        time. pos [B] int32: each row's count of tokens consumed. The
        conv block runs position by position at the rows' positions
        (`decode_conv_block`, or the plain step), over a copy of the ring
        that takes each position's conv input (k one-token steps, so the
        chunk's conv block sums as the sequential steps sum); the
        context attentions' kernel reads a row's k positions at once
        over its K/V, and the FFN's takes the B*k rows at once (both
        kernels sum each row alone); the plain products between them run
        position by position at a step's shapes (`_after_conv_chunk`).
        The cache is not advanced. Returns (x [B, k, D], h [B, k, C]: the
        conv inputs that `commit_conv_caches` writes for the verified
        prefix)."""
        B, k, D = x.shape
        ring = cache.clone() if k > 1 else cache
        xs, hs = [], []
        for j in range(k):
            p = pos + j if j else pos
            y, h = self._conv_step(x[:, j].contiguous(), ring, p, w)
            if j < k - 1:
                self._write_ring(ring, p, h)
            xs.append(y)
            hs.append(h)
        x, h = torch.stack(xs, dim=1), torch.stack(hs, dim=1)
        return self._after_conv_chunk(x, kv, w), h

    def _after_conv_chunk(self, x: torch.Tensor, kv: LayerKV,
                          w: LayerDecodeWeights) -> torch.Tensor:
        """`_after_conv` of k positions a row, x [B, k, D]: the attention
        kernel on a row's k positions at once (`attend_chunk`), the FFN
        kernel on the B*k rows, the LayerNorms on every row (row by row
        in any case), and the products `attend_chunk`'s projections,
        `context_fc` and a plain FFN's position by position, so that each
        position sums as a step's (a library product may sum in another
        order at another row count)."""
        B, k, D = x.shape
        parts = []
        for name in self.context_names:
            ln = self._attn_ln(name)
            y = self._attn(name).attend_chunk(self._ln(ln, x, True), kv[name])
            parts.append(self._ln(ln, x + y, False))
        x = positionwise(lambda r: r @ w.context_w + w.context_b,
                         torch.cat(parts, dim=-1))
        if w.ffn_w1 is None:
            return positionwise(self._ffn, x)
        y = self._decode_ffn(x.reshape(B * k, D), w)
        return self.final_layer_norm(y).view(B, k, D)


def _positions(pos: torch.Tensor) -> torch.Tensor:
    """Rows' positions as the conv block's kernel reads them: int32,
    contiguous (no copy where they are so already)."""
    return pos.to(torch.int32).contiguous()


@DECODERS.register("dynamic_conv_decoder_flattened")
class DynamicConvDecoder(nn.Module):
    """Decoder stack + tied adaptive softmax.

    contexts (batch first): image [B, P, image_dim], image_mask [B, P]
    and article [B, S, article_dim], article_mask [B, S], masks True at
    padding, and each extra context [B, n, dim] with its `{name}_mask`.
    The order of the contexts (image, article, extras) names the layers'
    attentions and fixes the rows of `context_fc`.

    The reference's options: the layers' (`conv_dim`, `conv_type`,
    `decoder_glu`, `weight_softmax`, `normalize_before`), `final_norm`
    (a LayerNorm `layer_norm` after the stack, with normalize_before),
    `adaptive_softmax_dropout` and `tie_adaptive_proj` (the adaptive
    softmax's tail dropout and its tails projected by the embedder's
    band projections), `remat` (each layer of the teacher-forced path
    under `ops/dropout.py::remat`) and `param_dtype`: the parameters
    of the embedder, the layers' linears, convs and attentions and the
    adaptive softmax are stored in it where it is narrower than `dtype`
    (an fp32 model with bf16 parameters); the LayerNorms' stay in
    `dtype`. A model built in bf16 stores every parameter in bf16.
    """

    def __init__(self, *, device, dtype, generator=None,
                 vocab_size: int = 50265, embed_dim: int = 1024,
                 ffn_dim: int = 4096, num_heads: int = 16,
                 num_layers: int = 4,
                 kernel_sizes: Sequence[int] = (3, 7, 15, 31),
                 cutoff: Sequence[int] = (5000, 20000, 50265),
                 image_dim: int = 2048, article_dim: int = 1024,
                 extra_contexts: Sequence[Tuple[str, int]] = (),
                 include_image: bool = True, padding_idx: int = 0,
                 target_padding_idx: int = 1,
                 max_positions: int = 512, dropout: float = 0.1,
                 weight_dropout: float = 0.1, relu_dropout: float = 0.0,
                 input_dropout: float = 0.1, attention_dropout: float = 0.1,
                 use_flash_train: bool = False,
                 conv_dim: Optional[int] = None, conv_type: str = "dynamic",
                 decoder_glu: bool = True, weight_softmax: bool = True,
                 normalize_before: bool = False, final_norm: bool = False,
                 adaptive_softmax_dropout: float = 0.0,
                 tie_adaptive_proj: bool = False, remat: bool = False,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        assert len(kernel_sizes) == num_layers
        pdtype = (param_dtype if param_dtype is not None
                  and torch.finfo(param_dtype).bits < torch.finfo(dtype).bits
                  else dtype)
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.dtype = dtype
        self.vocab_size = vocab_size
        self.embed_dim = embed_dim
        self.article_dim = article_dim
        self.kernel_sizes = tuple(kernel_sizes)
        self.num_layers = num_layers
        self.max_positions = max_positions
        self.dropout = dropout
        self.target_padding_idx = target_padding_idx
        self.remat = remat
        self.embedder = SumEmbedder(
            vocab_size, embed_dim, cutoff, padding_idx=padding_idx,
            pos_padding_idx=target_padding_idx, max_positions=max_positions,
            param_dtype=pdtype, **kw)
        specs = ((("image", image_dim),) if include_image else ()) \
            + (("article", article_dim),) \
            + tuple((name, dim) for name, dim in extra_contexts)
        self.layers = nn.ModuleList(
            DynamicConvDecoderLayer(
                embed_dim, k, num_heads, ffn_dim, specs, dropout=dropout,
                weight_dropout=weight_dropout, relu_dropout=relu_dropout,
                input_dropout=input_dropout,
                attention_dropout=attention_dropout,
                use_flash_train=use_flash_train, conv_dim=conv_dim,
                conv_type=conv_type, decoder_glu=decoder_glu,
                weight_softmax=weight_softmax,
                normalize_before=normalize_before, param_dtype=pdtype, **kw)
            for k in kernel_sizes)
        self.adaptive_softmax = AdaptiveSoftmax(
            embed_dim, cutoff, dropout=adaptive_softmax_dropout,
            tie_proj=tie_adaptive_proj, device=device, dtype=pdtype,
            generator=generator)
        self.layer_norm = (LayerNorm(embed_dim, device=device, dtype=dtype)
                           if normalize_before and final_norm else None)

    def all_layers(self) -> List[DynamicConvDecoderLayer]:
        """Every decoder layer, in the order of `kvs`, caches and decode
        weights (a subclass may add layers after the stack's)."""
        return list(self.layers)

    def precompute_kv(self, contexts: Dict[str, Optional[torch.Tensor]],
                      quantize: bool = False) -> List[LayerKV]:
        """Every layer's context K/V, once a request; int8 K/V with one
        scale a (item, key, head) with quantize (the reference's
        `decode_kv_tree(kvs, quantize=True)`)."""
        contexts = {k: (v.to(self.dtype)
                        if v is not None and v.is_floating_point() else v)
                    for k, v in contexts.items()}
        return [layer.precompute_kv(contexts, quantize)
                for layer in self.all_layers()]

    def hidden(self, token_ids: torch.Tensor,
               contexts: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Teacher-forced hidden states [B, T, D]; training with a
        generator."""
        return self._final(self._stack(token_ids, self.precompute_kv(contexts),
                                       generator))

    def _stack(self, token_ids: torch.Tensor, kvs: List[LayerKV],
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The embedding and the stack's layers, teacher forced (no
        final norm)."""
        x = dropout(self.embedder(token_ids), self.dropout, generator)
        for layer, kv in zip(self.layers, kvs):
            x = self._layer(layer, x, kv, generator)
        return x

    def _layer(self, layer: DynamicConvDecoderLayer, x: torch.Tensor,
               kv: LayerKV, generator: Optional[torch.Generator]):
        """One layer's teacher-forced forward, under `remat` where the
        model asks for it."""
        if self.remat:
            return remat(lambda h: layer(h, kv, generator), generator, x)
        return layer(x, kv, generator)

    def _final(self, x: torch.Tensor) -> torch.Tensor:
        """The final LayerNorm (normalize_before with final_norm)."""
        return x if self.layer_norm is None else self.layer_norm(x)

    def loss(self, token_ids: torch.Tensor, contexts: Dict[str, torch.Tensor],
             target_ids: torch.Tensor,
             generator: Optional[torch.Generator] = None):
        """(summed adaptive CE fp32, ntokens) of the targets, padding
        `target_padding_idx` ignored."""
        return self.loss_from_hidden(self.hidden(token_ids, contexts,
                                                 generator), target_ids,
                                     generator)

    def loss_from_hidden(self, x: torch.Tensor, target_ids: torch.Tensor,
                         generator: Optional[torch.Generator] = None):
        """`loss` of hidden states x [B, T, D] already computed (the
        pointer family reads them too): (summed adaptive CE fp32,
        ntokens); a generator drops the tail projections
        (`adaptive_softmax_dropout`)."""
        return self.adaptive_softmax.loss_sum(
            x.reshape(-1, x.shape[-1]), target_ids.reshape(-1),
            self.target_padding_idx, self.embedder.embed_tables(),
            generator)

    def log_prob(self, token_ids: torch.Tensor,
                 contexts: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Full-vocab log-probs [B, T, V] (teacher forced)."""
        return self.log_prob_from_hidden(self.hidden(token_ids, contexts))

    def log_prob_from_hidden(self, x: torch.Tensor) -> torch.Tensor:
        """Full-vocab log-probs [B, T, V] of hidden states x [B, T, D]."""
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

    def init_cache(self, batch_size: int, device,
                   ring_major: bool = True) -> List[torch.Tensor]:
        """Zero conv histories, one per layer (empty for a pointwise
        layer): ring-major [K-1, B, C], or with ring_major=False the
        shift layout [B, K-1, C]; C the layer's conv_dim."""
        return [torch.zeros(*((layer.kernel_size - 1, batch_size)
                              if ring_major else
                              (batch_size, layer.kernel_size - 1)),
                            layer.conv_dim, device=device, dtype=self.dtype)
                for layer in self.all_layers()]

    def init_slot_maps(self, batch_size: int, device) -> List[torch.Tensor]:
        """Identity slot -> physical row maps [K-1, B] of the lazy
        layout, one per layer."""
        return [torch.arange(batch_size, device=device).repeat(
                    layer.kernel_size - 1, 1)
                for layer in self.layers]

    def decode_weights(self, quantize_head: bool = False) -> DecodeWeights:
        """The step's fused weights; compute once per model load. With
        quantize_head, the int8 head tables too (`quant_tables`)."""
        with torch.no_grad():
            tables = self.embedder.embed_tables()
            return DecodeWeights(
                layers=[layer.decode_weights(self.dtype)
                        for layer in self.all_layers()],
                head_table=self.adaptive_softmax.head_table(tables,
                                                            self.dtype),
                quant_tables=(self.quantized_embed_tables() if quantize_head
                              else None))

    def quantized_embed_tables(self):
        """The head's word tables as int8 with a scale a row, for the
        opt-in quantized decode head: [(QuantTable, proj)] of every
        band (the reference's `quantized_embed_tables`). The tables are
        frozen while decoding, so once a load (or a generation) does."""
        with torch.no_grad():
            return quantize_embed_tables(self.embedder.embed_tables())

    def _head_topk(self, x: torch.Tensor, k: int, weights: DecodeWeights,
                   tables=None):
        """The exact top-k head over the fused head table, or over the
        int8 `tables` where given."""
        if tables is None:
            return self.adaptive_softmax.topk_log_prob(
                x, k, self.embedder.embed_tables(), weights.head_table)
        return self.adaptive_softmax.topk_log_prob(x, k, tables)

    def _step_layers(self, token_t: torch.Tensor, step_idx,
                     kvs: List[LayerKV], caches: List[torch.Tensor],
                     weights: DecodeWeights, beam: int) -> torch.Tensor:
        """The stack's layers of one decode step: hidden state
        [B*beam, D]; their conv caches advance in place. step_idx: an
        int, or each row's position (a [B*beam] tensor)."""
        start = step_idx
        if isinstance(step_idx, torch.Tensor):
            step_idx = _positions(step_idx)
            start = step_idx[:, None]
        x = self.embedder(token_t[:, None], start_pos=start)[:, 0, :]
        for layer, kv, cache, w in zip(self.layers, kvs, caches,
                                       weights.layers):
            x = layer.step(x, kv, cache, step_idx, w, beam)
        return self._final(x)

    def step_topk(self, token_t: torch.Tensor, step_idx,
                  kvs: List[LayerKV], caches: List[torch.Tensor], k: int,
                  weights: DecodeWeights, beam: int = 1, tables=None):
        """One decode step returning the exact top-k candidates.

        token_t [B*beam]; step_idx = tokens already consumed, an int or
        a [B*beam] tensor of each row's (a slot pool's rows sit at
        different depths). The conv caches advance in place. tables: the
        int8 head tables (`quantized_embed_tables`), or None for the
        exact head. Returns (cand_log_probs [B*beam, k] fp32, cand_ids
        [B*beam, k] int64).
        """
        return self.step_topk_with_hidden(token_t, step_idx, kvs, caches, k,
                                          weights, beam, tables)[:2]

    def step_topk_with_hidden(self, token_t: torch.Tensor, step_idx,
                              kvs: List[LayerKV], caches: List[torch.Tensor],
                              k: int, weights: DecodeWeights, beam: int = 1,
                              tables=None):
        """`step_topk` with the step's hidden state: (cand_log_probs,
        cand_ids, hidden [B*beam, D]), the hidden state what the pointer
        family's heads read."""
        x = self._step_layers(token_t, step_idx, kvs, caches, weights, beam)
        v, ids = self._head_topk(x, k, weights, tables)
        return v, ids, x

    def step_chunk(self, tokens: torch.Tensor, pos: torch.Tensor,
                   kvs: List[LayerKV], caches: List[torch.Tensor],
                   weights: DecodeWeights, tables=None):
        """A greedy chunk (speculative verification). tokens [B, k]: the
        last committed token, then k-1 drafts; pos [B] each row's count
        of tokens consumed. Returns (log_probs [B, k] fp32, argmax_ids
        [B, k] int64, hs): output t is the greedy next token given
        inputs 0..t, as t+1 sequential `step_topk(k=1)` calls give it;
        hs[l] [B, k, C] are layer l's conv inputs for
        `commit_conv_caches`. The caches are not advanced. tables: as
        `step_topk`'s."""
        v, ids, _, hs = self.step_chunk_with_hidden(tokens, pos, kvs, caches,
                                                    weights, tables)
        return v, ids, hs

    def step_chunk_with_hidden(self, tokens: torch.Tensor, pos: torch.Tensor,
                               kvs: List[LayerKV],
                               caches: List[torch.Tensor],
                               weights: DecodeWeights, tables=None):
        """`step_chunk` with the chunk's hidden states: (log_probs,
        argmax_ids, hidden [B, k, D], hs), the hidden states what the
        pointer family's heads read. Positions past the embedder's table
        take its last row: only a chunk's tail reaches there, whose
        outputs are never committed."""
        x, hs = self._chunk_layers(tokens, _positions(pos), kvs, caches,
                                   weights)
        v, ids = self._head_topk(x, 1, weights, tables)
        return v[..., 0], ids[..., 0], x, hs

    def _chunk_layers(self, tokens: torch.Tensor, pos: torch.Tensor,
                      kvs: List[LayerKV], caches: List[torch.Tensor],
                      weights: DecodeWeights):
        """The embedding and the stack's layers of a chunk at int32
        positions pos [B]: (hidden [B, k, D], the layers' conv inputs)."""
        k = tokens.shape[1]
        offsets = torch.arange(k, device=pos.device)
        start = (pos[:, None] + offsets).clamp(max=self.max_positions)
        # The embedding's product position by position, as a step's.
        x = torch.cat([self.embedder(tokens[:, j:j + 1],
                                     start_pos=start[:, j:j + 1])
                       for j in range(k)], dim=1)
        hs = []
        for layer, kv, cache, w in zip(self.layers, kvs, caches,
                                       weights.layers):
            x, h = layer.chunk(x, kv, cache, pos, w)
            hs.append(h)
        return self._final(x), hs

    def step_with_hidden(self, token_t: torch.Tensor, step_idx: int,
                         kvs: List[LayerKV], caches: List[torch.Tensor],
                         weights: DecodeWeights, beam: int = 1, tables=None):
        """One decode step with the full-vocab head, the same layer steps
        as `step_topk`. Returns (log_probs [B*beam, V] in the model's
        dtype, hidden [B*beam, D]); the conv caches advance in place.
        With beam > 1, kvs are the untiled batch's (shared K/V). tables:
        the int8 head tables, or None (plain products either way)."""
        x = self._step_layers(token_t, step_idx, kvs, caches, weights, beam)
        lp = self.adaptive_softmax.log_prob(
            x, self.embedder.embed_tables() if tables is None else tables)
        return lp, x

    def step(self, token_t: torch.Tensor, step_idx: int,
             kvs: List[LayerKV], caches: List[torch.Tensor],
             weights: DecodeWeights, beam: int = 1,
             tables=None) -> torch.Tensor:
        """`step_with_hidden` without the hidden state: log_probs
        [B*beam, V]."""
        return self.step_with_hidden(token_t, step_idx, kvs, caches,
                                     weights, beam, tables)[0]

    def step_shift(self, token_t: torch.Tensor, step_idx: int,
                   kvs: List[LayerKV], caches: List[torch.Tensor],
                   weights: DecodeWeights, beam: int = 1) -> torch.Tensor:
        """`step` over shifted-copy caches [B*beam, K-1, C]
        (`init_cache(..., ring_major=False)`): log_probs [B*beam, V];
        each layer's entry of `caches` is replaced by its new cache."""
        x = self.embedder(token_t[:, None], start_pos=step_idx)[:, 0, :]
        for i, (layer, kv, w) in enumerate(zip(self.layers, kvs,
                                                weights.layers)):
            x, caches[i] = layer.step_shift(x, kv, caches[i], w, beam)
        return self.adaptive_softmax.log_prob(self._final(x),
                                              self.embedder.embed_tables())

    def step_beam_lazy(self, token_t: torch.Tensor, step_idx: int,
                       kvs: List[LayerKV], caches: List[torch.Tensor],
                       slot_maps: List[torch.Tensor],
                       weights: DecodeWeights, beam: int) -> torch.Tensor:
        """`step` over ring-major caches that stay where they are across
        beam reorders, read through `slot_maps` (`init_slot_maps`):
        log_probs [B*beam, V]; the caches and maps advance in place."""
        x = self.embedder(token_t[:, None], start_pos=step_idx)[:, 0, :]
        for layer, kv, cache, smap, w in zip(self.layers, kvs, caches,
                                             slot_maps, weights.layers):
            x = layer.step_lazy_beam(x, kv, cache, smap, step_idx, w, beam)
        return self.adaptive_softmax.log_prob(self._final(x),
                                              self.embedder.embed_tables())
