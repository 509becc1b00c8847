"""Multi-head cross-attention over precomputed context K/V.

Counterpart of `news_image_caption_tpu/ops/attention.py`
(MultiHeadAttention: `precompute_kv`, the plain full-sequence
`attend` with its flash route and its head-averaged weights, and
`attend_flat_beam`). Context K/V are projected once per request and kept
flat, [B, S', E] with S' = S + 2 (the learned bias_k / bias_v slot and
the zero slot), beside an additive fp32 key bias
[B, S'] (0 attendable, -1e9 padded): the input layout of
`decode_cross_attention`.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from news_image_caption_tpu_torch.ops.decode_attention import \
    decode_cross_attention
from news_image_caption_tpu_torch.ops.dropout import dropout
from news_image_caption_tpu_torch.ops.flash_attention import \
    flash_cross_attention
from news_image_caption_tpu_torch.ops.linear import (XavierLinear,
                                                     initializes, new_param)

NEG_INF = -1e9


class AttentionKV(NamedTuple):
    """k, v [B, S', E]; bias [B, S'] fp32, 0 where a slot can be
    attended and -1e9 where it is padding."""

    k: torch.Tensor
    v: torch.Tensor
    bias: torch.Tensor


class MultiHeadAttention(nn.Module):
    """fairseq-style attention with separate key/value input width,
    a learned bias_k/bias_v slot and a zero slot. `dropout` is the
    attention-probability dropout of training; `use_flash` sends the
    full-sequence path through `flash_cross_attention`."""

    def __init__(self, embed_dim: int, num_heads: int, kdim: int, *,
                 device, dtype, generator=None, dropout: float = 0.0,
                 use_flash: bool = False):
        super().__init__()
        assert embed_dim % num_heads == 0
        self.dropout = dropout
        self.use_flash = use_flash
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        lin = dict(device=device, dtype=dtype, generator=generator)
        self.q_proj = XavierLinear(embed_dim, embed_dim, **lin)
        self.k_proj = XavierLinear(kdim, embed_dim, **lin)
        self.v_proj = XavierLinear(kdim, embed_dim, **lin)
        self.out_proj = XavierLinear(embed_dim, embed_dim, **lin)
        self.bias_k = new_param((1, 1, embed_dim), device, dtype)
        self.bias_v = new_param((1, 1, embed_dim), device, dtype)
        if initializes(device):
            # The scale of flax's xavier_normal on a (1, 1, E) array:
            # fan_in 1, fan_out E.
            std = math.sqrt(2.0 / (1 + embed_dim))
            with torch.no_grad():
                self.bias_k.normal_(0.0, std, generator=generator)
                self.bias_v.normal_(0.0, std, generator=generator)

    def precompute_kv(self, key: torch.Tensor, value: torch.Tensor,
                      key_padding_mask: Optional[torch.Tensor] = None
                      ) -> AttentionKV:
        """key/value [B, S, kdim]; key_padding_mask [B, S], True = pad."""
        B, S, _ = key.shape
        k = self.k_proj(key)
        v = self.v_proj(value)
        E = self.embed_dim
        zero = torch.zeros(B, 1, E, device=k.device, dtype=k.dtype)
        k = torch.cat([k, self.bias_k.to(k.dtype).expand(B, 1, E), zero], 1)
        v = torch.cat([v, self.bias_v.to(v.dtype).expand(B, 1, E), zero], 1)
        bias = torch.zeros(B, S + 2, device=k.device, dtype=torch.float32)
        if key_padding_mask is not None:
            bias[:, :S].masked_fill_(key_padding_mask.to(torch.bool), NEG_INF)
        return AttentionKV(k=k.contiguous(), v=v.contiguous(), bias=bias)

    def attend(self, query: torch.Tensor, kv: AttentionKV,
               generator: Optional[torch.Generator] = None,
               need_weights: bool = False):
        """Full-sequence attention of query [B, T, E] over kv. With a
        generator (training) the probabilities are dropped at rate
        `dropout`; generator=None is evaluation.

        With `use_flash` and T > 1 the kernel route runs: fp32 scores
        and softmax, probabilities rounded to the value dtype, the
        dropout seed drawn from the generator (the reference's Pallas
        path). Otherwise the reference's XLA path: scores in the compute
        dtype, softmax in fp32, dropout on the rounded probabilities.

        need_weights=True takes the XLA path and returns (output, the
        probabilities averaged over heads [B, T, S'] in the value
        dtype, before dropout); otherwise the output alone."""
        B, T, _ = query.shape
        H, hd = self.num_heads, self.head_dim
        S = kv.k.shape[1]
        q = self.q_proj(query) * (hd ** -0.5)
        if self.use_flash and T > 1 and not need_weights:
            p = self.dropout if generator is not None else 0.0
            if p > 0.0:
                seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                                     device=q.device, dtype=torch.int32)
            else:
                seed = torch.zeros(1, device=q.device, dtype=torch.int32)
            out = flash_cross_attention(q.contiguous(), kv.k, kv.v, kv.bias,
                                        seed, H, p)
            return self.out_proj(out)
        scores = torch.einsum("bthd,bshd->bhts", q.view(B, T, H, hd),
                              kv.k.view(B, S, H, hd))
        scores = scores.float() + kv.bias[:, None, None, :]
        probs = torch.softmax(scores, dim=-1).to(kv.v.dtype)
        weights = probs.mean(dim=1) if need_weights else None
        probs = dropout(probs, self.dropout, generator)
        out = torch.einsum("bhts,bshd->bthd", probs, kv.v.view(B, S, H, hd))
        out = self.out_proj(out.reshape(B, T, self.embed_dim))
        return (out, weights) if need_weights else out

    def attend_flat_beam(self, query: torch.Tensor, kv: AttentionKV,
                         beam: int) -> torch.Tensor:
        """Single-step attention of query [B*beam, E] (beam-major within
        an item) over kv of the untiled batch B: the beams of one item
        share its K/V. Returns [B*beam, E]."""
        BK, E = query.shape
        q = self.q_proj(query) * (self.head_dim ** -0.5)
        out = decode_cross_attention(q.view(BK // beam, beam, E).contiguous(),
                                     kv.k, kv.v, kv.bias, self.num_heads)
        return self.out_proj(out.view(BK, E))
