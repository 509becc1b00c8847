"""Multi-head cross-attention over precomputed context K/V.

Counterpart of `news_image_caption_tpu/ops/attention.py`
(MultiHeadAttention: `precompute_kv`, the plain full-sequence
`attend` with its flash route and its head-averaged weights, and
`attend_flat_beam`; `attend_chunk`, a decode chunk's k positions a
row). Context K/V are projected once per request and kept flat,
[B, S', E] with S' = S + 2 (the learned bias_k / bias_v slot and the
zero slot), beside an additive fp32 key bias [B, S'] (0 attendable,
-1e9 padded): the input layout of `decode_cross_attention`.

`quantize_kv` is the reference's `to_decode_kv(quantize=True)` in that
layout (`QuantAttentionKV`: int8 K/V [B, S', E] and one scale a (item,
key, head) [B, S', H]); `attend_positions` and `attend_flat_beam` take
either form, the int8 one through `decode_cross_attention_int8`.

The reference's module options: `use_bias` (the four projections' bias),
`add_bias_kv` and `add_zero_attn` (the two extra slots; without them
S' = S), an additive `attn_mask` [T, S'] on the full-sequence path
(`extend_attn_mask` widens a [T, S] one by the extra slots, `causal_mask`
makes one), and the one-shot `forward(query, key, value)`, which is
self-attention where all three are the same. `GatedLinear` and
`DownsampledMultiHeadAttention` are the reference's fconv-style
modules (strided heads, strict causality, the scalar-bias slot).

Split over a `model` axis of m ranks (`parallel/partition.py`), a
`MultiHeadAttention` holds heads [h0, h0 + H/m): its q/k/v projections
are column-parallel (`local`), so the K/V it precomputes are its heads'
[B, S', E/m], the replicated `bias_k` / `bias_v` slots are sliced to its
heads (their gradient summed over the ranks by `copy_in`), the flash
kernels take h0 and the whole head count for their dropout hash, the
plain path's probability dropout draws every head's mask and keeps the
rank's, and `out_proj` is row-parallel: its partial products summed over
the ranks, its bias added once. The head-averaged weights are the sum
over the ranks of their heads' sums, over H.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from news_image_caption_tpu_torch.ops.decode_attention import (
    decode_cross_attention, decode_cross_attention_int8)
from news_image_caption_tpu_torch.ops.dropout import dropout, row_offset
from news_image_caption_tpu_torch.ops.flash_attention import \
    flash_cross_attention
from news_image_caption_tpu_torch.ops.linear import (GehringLinear,
                                                     XavierLinear,
                                                     initializes, new_param,
                                                     positionwise)
from news_image_caption_tpu_torch.parallel.collectives import (copy_in,
                                                               reduce_out)
from news_image_caption_tpu_torch.parallel.partition import (is_split,
                                                             shard_of)

NEG_INF = -1e9


class AttentionKV(NamedTuple):
    """k, v [B, S', E]; bias [B, S'] fp32, 0 where a slot can be
    attended and -1e9 where it is padding."""

    k: torch.Tensor
    v: torch.Tensor
    bias: torch.Tensor


class QuantAttentionKV(NamedTuple):
    """int8 decode K/V (`quantize_kv`): k_q, v_q [B, S', E] int8;
    k_scale, v_scale [B, S', H] in the model's dtype, one symmetric
    scale a (item, key, head) over the head's dims; bias as
    `AttentionKV`'s. The reference's `QuantDecodeKV` holds the same
    numbers head-major (kT_q [B, H, D, S'], k_scale [B, H, 1, S'])."""

    k_q: torch.Tensor
    k_scale: torch.Tensor
    v_q: torch.Tensor
    v_scale: torch.Tensor
    bias: torch.Tensor


def _quantize_rows(x: torch.Tensor, num_heads: int):
    """The reference's `_quantize_rows` over each head's dims of x
    [B, S', E]: amax in fp32, scale max(amax, 1e-8) / 127, q =
    clip(round-half-even(x / scale), ±127) with that fp32 scale, and
    the scale returned rounded to x's dtype (which dequantization
    multiplies by). A zero row (the zero slot) gets q = 0."""
    B, S, E = x.shape
    x32 = x.float().view(B, S, num_heads, E // num_heads)
    scale = x32.abs().amax(dim=-1, keepdim=True).clamp(min=1e-8) / 127.0
    q = torch.round(x32 / scale).clamp(-127, 127).to(torch.int8)
    return q.view(B, S, E), scale[..., 0].to(x.dtype)


def quantize_kv(kv: AttentionKV, num_heads: int) -> QuantAttentionKV:
    """int8 K/V of one attention, once a request (the reference's
    `to_decode_kv(kv, quantize=True)` in the port's layout)."""
    k_q, k_scale = _quantize_rows(kv.k, num_heads)
    v_q, v_scale = _quantize_rows(kv.v, num_heads)
    return QuantAttentionKV(k_q, k_scale, v_q, v_scale, kv.bias)


def _decode_attention(q: torch.Tensor, kv, num_heads: int) -> torch.Tensor:
    """The decode kernel of kv's form: bf16 K/V or int8 K/V."""
    if isinstance(kv, QuantAttentionKV):
        return decode_cross_attention_int8(q, kv.k_q, kv.k_scale, kv.v_q,
                                           kv.v_scale, kv.bias, num_heads)
    return decode_cross_attention(q, kv.k, kv.v, kv.bias, num_heads)


def attend_positions(q_proj, out_proj, num_heads: int, query: torch.Tensor,
                     kv) -> torch.Tensor:
    """Decode attention of k positions a row, query [B, k, E] over kv of
    the batch B (an `AttentionKV` or a `QuantAttentionKV`): the decode
    kernel takes a row's k positions at once (Q = k), the projections
    run position by position at a step's shapes (`positionwise`), the
    query scaled by head_dim**-0.5 before the kernel. Returns
    [B, k, E]."""
    def scaled(r):
        y = q_proj(r)
        return y * (y.shape[-1] // num_heads) ** -0.5

    q = positionwise(scaled, query)
    return positionwise(out_proj, _decode_attention(q, kv, num_heads))


class MultiHeadAttention(nn.Module):
    """fairseq-style attention with separate key/value input widths
    (`kdim`, `vdim`, default `kdim`), a learned bias_k/bias_v slot
    (`add_bias_kv`) and a zero slot (`add_zero_attn`). `dropout` is the
    attention-probability dropout of training; `use_flash` sends the
    full-sequence path through `flash_cross_attention`."""

    def __init__(self, embed_dim: int, num_heads: int, kdim: int, *,
                 device, dtype, generator=None, dropout: float = 0.0,
                 use_flash: bool = False, vdim: Optional[int] = None,
                 use_bias: bool = True, add_bias_kv: bool = True,
                 add_zero_attn: bool = True):
        super().__init__()
        assert embed_dim % num_heads == 0
        self.dropout = dropout
        self.use_flash = use_flash
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.add_zero_attn = add_zero_attn
        lin = dict(device=device, dtype=dtype, generator=generator,
                   use_bias=use_bias)
        self.q_proj = XavierLinear(embed_dim, embed_dim, **lin)
        self.k_proj = XavierLinear(kdim, embed_dim, **lin)
        self.v_proj = XavierLinear(vdim or kdim, embed_dim, **lin)
        self.out_proj = XavierLinear(embed_dim, embed_dim, **lin)
        self.bias_k = self.bias_v = None
        if add_bias_kv:
            self.bias_k = new_param((1, 1, embed_dim), device, dtype)
            self.bias_v = new_param((1, 1, embed_dim), device, dtype)
            if initializes(device):
                # The scale of flax's xavier_normal on a (1, 1, E) array:
                # fan_in 1, fan_out E.
                std = math.sqrt(2.0 / (1 + embed_dim))
                with torch.no_grad():
                    self.bias_k.normal_(0.0, std, generator=generator)
                    self.bias_v.normal_(0.0, std, generator=generator)

    def local_heads(self) -> int:
        """The heads this rank holds: all of them unsplit, H / m split."""
        return self.q_proj.kernel.shape[1] // self.head_dim

    def _first_head(self) -> int:
        shard = shard_of(self)
        return 0 if shard is None else shard.index * self.local_heads()

    def _slot(self, p: torch.Tensor, E: int) -> torch.Tensor:
        """A replicated bias slot [1, 1, E_whole] cut to this rank's heads'
        E columns."""
        if not is_split(self):
            return p
        shard = shard_of(self)
        return copy_in(p, shard)[..., shard.part(E)]

    def extra_slots(self) -> int:
        """The slots after the keys: bias_k/bias_v, then the zero slot."""
        return int(self.bias_k is not None) + int(self.add_zero_attn)

    def precompute_kv(self, key: torch.Tensor, value: torch.Tensor,
                      key_padding_mask: Optional[torch.Tensor] = None
                      ) -> AttentionKV:
        """key [B, S, kdim], value [B, S, vdim]; key_padding_mask
        [B, S], True = pad."""
        B, S, _ = key.shape
        k = self.k_proj.local(key)
        v = self.v_proj.local(value)
        E = k.shape[-1]
        ks, vs = [k], [v]
        if self.bias_k is not None:
            ks.append(self._slot(self.bias_k, E).to(k.dtype).expand(B, 1, E))
            vs.append(self._slot(self.bias_v, E).to(v.dtype).expand(B, 1, E))
        if self.add_zero_attn:
            zero = torch.zeros(B, 1, E, device=k.device, dtype=k.dtype)
            ks.append(zero)
            vs.append(zero)
        k, v = torch.cat(ks, 1), torch.cat(vs, 1)
        bias = torch.zeros(B, k.shape[1], device=k.device,
                           dtype=torch.float32)
        if key_padding_mask is not None:
            bias[:, :S].masked_fill_(key_padding_mask.to(torch.bool), NEG_INF)
        return AttentionKV(k=k.contiguous(), v=v.contiguous(), bias=bias)

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                attn_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                need_weights: bool = False):
        """One-shot attention: project key and value, then `attend`
        (self-attention with query, key and value the same)."""
        return self.attend(query, self.precompute_kv(key, value,
                                                     key_padding_mask),
                           generator, need_weights, attn_mask)

    def attend(self, query: torch.Tensor, kv: AttentionKV,
               generator: Optional[torch.Generator] = None,
               need_weights: bool = False,
               attn_mask: Optional[torch.Tensor] = None):
        """Full-sequence attention of query [B, T, E] over kv. With a
        generator (training) the probabilities are dropped at rate
        `dropout`; generator=None is evaluation. attn_mask: an additive
        [T, S'] mask (0 allowed, -1e9 not), sized for the extra slots
        (`extend_attn_mask`).

        With `use_flash`, T > 1 and no attn_mask the kernel route runs:
        fp32 scores and softmax, probabilities rounded to the value
        dtype, the dropout seed drawn from the generator (the
        reference's Pallas path). Otherwise the reference's XLA path:
        scores in the compute dtype, softmax in fp32, dropout on the
        rounded probabilities.

        need_weights=True takes the XLA path and returns (output, the
        probabilities averaged over heads [B, T, S'] in the value
        dtype, before dropout); otherwise the output alone."""
        B, T, _ = query.shape
        H, hd = self.local_heads(), self.head_dim
        S = kv.k.shape[1]
        q = self.q_proj.local(query) * (hd ** -0.5)
        if (self.use_flash and T > 1 and not need_weights
                and attn_mask is None):
            p = self.dropout if generator is not None else 0.0
            if p > 0.0:
                seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                                     device=q.device, dtype=torch.int32)
            else:
                seed = torch.zeros(1, device=q.device, dtype=torch.int32)
            out = flash_cross_attention(q.contiguous(), kv.k, kv.v, kv.bias,
                                        seed, H, p, row0=row_offset(),
                                        h0=self._first_head(),
                                        heads_total=self.num_heads)
            return self.out_proj.local(out)
        scores = torch.einsum("bthd,bshd->bhts", q.view(B, T, H, hd),
                              kv.k.view(B, S, H, hd))
        if attn_mask is not None:
            scores = scores + attn_mask.to(scores.dtype)
        scores = scores.float() + kv.bias[:, None, None, :]
        probs = torch.softmax(scores, dim=-1).to(kv.v.dtype)
        weights = None
        if need_weights:
            weights = (probs.mean(dim=1) if not is_split(self) else
                       (reduce_out(probs.float().sum(dim=1), shard_of(self))
                        / self.num_heads).to(probs.dtype))
        probs = dropout(probs, self.dropout, generator,
                        part=(1, shard_of(self)))
        out = torch.einsum("bhts,bshd->bthd", probs, kv.v.view(B, S, H, hd))
        out = self.out_proj.local(out.reshape(B, T, H * hd))
        return (out, weights) if need_weights else out

    def attend_chunk(self, query: torch.Tensor, kv) -> torch.Tensor:
        """`attend_positions` through this attention's projections: each
        position sums as `attend_flat_beam` at beam 1 does."""
        return attend_positions(self.q_proj.local, self.out_proj.local,
                                self.local_heads(), query, kv)

    def attend_flat_beam(self, query: torch.Tensor, kv,
                         beam: int) -> torch.Tensor:
        """Single-step attention of query [B*beam, E] (beam-major within
        an item) over kv of the untiled batch B (an `AttentionKV` or a
        `QuantAttentionKV`): the beams of one item share its K/V.
        Returns [B*beam, E]."""
        BK = query.shape[0]
        q = self.q_proj.local(query) * (self.head_dim ** -0.5)
        E = q.shape[-1]
        out = _decode_attention(q.view(BK // beam, beam, E).contiguous(), kv,
                                self.local_heads())
        return self.out_proj.local(out.view(BK, E))


def extend_attn_mask(attn_mask: torch.Tensor,
                     extra_slots: int) -> torch.Tensor:
    """attn_mask [T, S] with `extra_slots` allowed (zero) columns
    appended, for the bias and zero slots."""
    if extra_slots == 0:
        return attn_mask
    pad = attn_mask.new_zeros(attn_mask.shape[0], extra_slots)
    return torch.cat([attn_mask, pad], dim=1)


def causal_mask(T: int, dtype: torch.dtype = torch.float32,
                device=None) -> torch.Tensor:
    """[T, T] additive causal mask: 0 at s <= t, -1e9 after."""
    i = torch.arange(T, device=device)
    return torch.where(i[None, :] <= i[:, None], 0.0, NEG_INF).to(dtype)


class GatedLinear(nn.Module):
    """Weight-normalized linear stack with GLUs between: fc1 (in -> 4 *
    features), GLU, fc2 (2 * features -> 2 * features), GLU, fc3
    (features -> features). `dropout` scales the layers' init."""

    def __init__(self, in_features: int, features: int, *, device, dtype,
                 generator=None, use_bias: bool = True, dropout: float = 0.0):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator,
                  use_bias=use_bias, dropout=dropout)
        self.fc1 = GehringLinear(in_features, 4 * features, **kw)
        self.fc2 = GehringLinear(2 * features, 2 * features, **kw)
        self.fc3 = GehringLinear(features, features, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = nn.functional.glu(self.fc1(x), dim=-1)
        x = nn.functional.glu(self.fc2(x), dim=-1)
        return self.fc3(x)


class DownsampledMultiHeadAttention(nn.Module):
    """fconv-style multi-head attention (the reference's
    `DownsampledMultiHeadAttention`). With `downsample`, head i attends
    only to source positions s = 0 mod (i + 1), through its own
    projections `q{i}`, `k{i}`, `v{i}` (embed -> head_dim) and `o{i}`,
    then `out_proj`; the strided heads are a mask over the full
    sequence, as in the reference. Without it, `q`, `k`, `v` and
    `out_proj`. `gated` makes the projections `GatedLinear`s;
    `project_input=False` leaves the inputs unprojected. `forward`
    returns (out [B, T, out_channels], head 0's attention [B, T, S(+1)]
    with `downsample`, the heads' mean without). The attention's scores
    are fp32; `mask_future_timesteps` is strict (s < t); a row with no
    source attends to nothing (zeros); `use_scalar_bias` prepends a slot
    of score 0 and value 0. The reference's `use_bias` field is read by
    none of its layers, so it has no counterpart here."""

    def __init__(self, out_channels: int, embed_dim: int, num_heads: int, *,
                 device, dtype, generator=None, kdim: Optional[int] = None,
                 vdim: Optional[int] = None, dropout: float = 0.0,
                 project_input: bool = True, gated: bool = False,
                 downsample: bool = False):
        super().__init__()
        assert embed_dim % num_heads == 0
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.project_input = project_input
        self.downsample = downsample
        kw = dict(device=device, dtype=dtype, generator=generator)
        proj = GatedLinear if gated else GehringLinear
        widths = (("q", embed_dim), ("k", kdim or embed_dim),
                  ("v", vdim or embed_dim))
        H, hd = num_heads, self.head_dim
        if downsample:
            if project_input:
                for name, width in widths:
                    for i in range(H):
                        setattr(self, f"{name}{i}", proj(width, hd, **kw))
            for i in range(H):
                setattr(self, f"o{i}", GehringLinear(hd, hd, **kw))
        elif project_input:
            for name, width in widths:
                setattr(self, name, proj(width, embed_dim, **kw))
        self.out_proj = GehringLinear(embed_dim, out_channels, **kw)

    def _project(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """[B, L, width] -> [B, L, H, head_dim]."""
        B, L = x.shape[:2]
        H = self.num_heads
        if not self.project_input:
            return x.reshape(B, L, H, self.head_dim)
        if self.downsample:
            return torch.stack([getattr(self, f"{name}{i}")(x)
                                for i in range(H)], dim=2)
        return getattr(self, name)(x).reshape(B, L, H, self.head_dim)

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor, mask_future_timesteps: bool = False,
                key_padding_mask: Optional[torch.Tensor] = None,
                use_scalar_bias: bool = False,
                generator: Optional[torch.Generator] = None):
        B, T, _ = query.shape
        S = key.shape[1]
        H, hd = self.num_heads, self.head_dim
        q = self._project("q", query) * (hd ** -0.5)
        k = self._project("k", key)
        v = self._project("v", value)
        scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
        neg = torch.tensor(NEG_INF, dtype=scores.dtype, device=q.device)
        s_pos = torch.arange(S, device=q.device)
        if self.downsample:
            stride = torch.arange(1, H + 1, device=q.device)[:, None]
            valid = (s_pos[None, :] % stride) == 0           # [H, S]
            scores = torch.where(valid[None, :, None, :], scores, neg)
        if mask_future_timesteps:
            t_pos = torch.arange(T, device=q.device) + (S - T)
            strict = s_pos[None, :] < t_pos[:, None]         # [T, S]
            scores = torch.where(strict[None, None], scores, neg)
        if key_padding_mask is not None:
            scores = torch.where(key_padding_mask.to(torch.bool)
                                 [:, None, None, :], neg, scores)
        if use_scalar_bias:
            scores = torch.cat([scores.new_zeros(B, H, T, 1), scores], -1)
            v = torch.cat([v.new_zeros(B, 1, H, hd), v], dim=1)
        probs = torch.softmax(scores, dim=-1)
        no_valid = (scores <= NEG_INF / 2).all(dim=-1, keepdim=True)
        probs = torch.where(no_valid, 0.0, probs).to(v.dtype)
        probs = dropout(probs, self.dropout, generator)
        attn = torch.einsum("bhts,bshd->bthd", probs, v)     # [B, T, H, hd]
        if self.downsample:
            heads = [getattr(self, f"o{i}")(attn[:, :, i]) for i in range(H)]
            return self.out_proj(torch.cat(heads, dim=-1)), probs[:, 0]
        return (self.out_proj(attn.reshape(B, T, self.embed_dim)),
                probs.mean(dim=1))
