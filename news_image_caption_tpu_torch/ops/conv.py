"""Dynamic depthwise convolution (Wu et al. 2019), plain PyTorch.

Counterpart of `news_image_caption_tpu/ops/conv.py::DynamicConv`: the
full-sequence causal shift-accumulate (teacher forcing and training,
with dropout on the softmaxed taps) and the ring decode step
`step_ring`, kept as the reference math. The decoder's
decode path runs the fused `decode_conv_block` instead, over a
ring-major cache.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from news_image_caption_tpu_torch.ops.dropout import dropout
from news_image_caption_tpu_torch.ops.linear import XavierLinear


class DynamicConv(nn.Module):
    """Depthwise conv whose K taps are predicted per (position, head)
    by `weight_linear`, softmaxed over the taps and, in training,
    dropped at rate `weight_dropout`."""

    def __init__(self, input_size: int, kernel_size: int, num_heads: int,
                 *, device, dtype, generator=None,
                 weight_dropout: float = 0.0):
        super().__init__()
        assert input_size % num_heads == 0
        self.weight_dropout = weight_dropout
        self.num_heads = num_heads
        self.kernel_size = kernel_size
        self.weight_linear = XavierLinear(
            input_size, num_heads * kernel_size, use_bias=False,
            device=device, dtype=dtype, generator=generator)

    def _weights(self, x: torch.Tensor,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        w = self.weight_linear(x)
        w = w.view(x.shape[:-1] + (self.num_heads, self.kernel_size))
        w = torch.softmax(w.float(), dim=-1).to(w.dtype)
        return dropout(w, self.weight_dropout, generator)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Causal forward, x [B, T, C]:
        out[b,t,c] = sum_k w[b,t,h(c),k] * x[b, t-K+1+k, c]."""
        B, T, C = x.shape
        H, K = self.num_heads, self.kernel_size
        w = self._weights(x, generator)                     # [B, T, H, K]
        xh = F.pad(x.view(B, T, H, C // H), (0, 0, 0, 0, K - 1, 0))
        out = torch.zeros(B, T, H, C // H, device=x.device, dtype=x.dtype)
        for k in range(K):
            out = out + w[..., k:k + 1] * xh[:, k:k + T]
        return out.reshape(B, T, C)

    def step_ring(self, x_t: torch.Tensor, cache: torch.Tensor, t: int):
        """Ring decode step. x_t [B, C]; cache [B, K-1, C] where slot
        s mod (K-1) holds input x_s (zeros before the sequence start).
        Returns (out [B, C], cache with x_t written at slot t mod K-1)."""
        B, C = x_t.shape
        H, K = self.num_heads, self.kernel_size
        R, Km1 = C // H, K - 1
        w = self._weights(x_t)                              # [B, H, K]
        k_for_slot = (torch.arange(Km1, device=x_t.device) - t) % Km1
        w_hist = w[:, :, k_for_slot]                        # [B, H, K-1]
        hist = cache.view(B, Km1, H, R)
        out = torch.einsum("bhk,bkhr->bhr", w_hist, hist).reshape(B, C)
        out = out + w[:, :, Km1:].expand(B, H, R).reshape(B, C) * x_t
        new_cache = cache.clone()
        new_cache[:, t % Km1] = x_t
        return out, new_cache
