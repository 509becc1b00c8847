"""Dynamic depthwise convolution (Wu et al. 2019).

Counterpart of `news_image_caption_tpu/ops/conv.py::DynamicConv`: the
full-sequence causal forward by one of three routes, as the reference
chooses them, and the decode steps kept as the reference math: the
shift step `step` over a cache [B, K-1, C] oldest first (`init_cache`),
the ring step `step_ring`, and the lazy ring step `step_ring_lazy`,
which reads each slot's rows through a slot map. The routes:
- `"shift"` (default): a K-term shift-accumulate in x's dtype
  (`_shift_accumulate`); the decoder's train and teacher-forced paths
  take it, with dropout on the softmaxed taps;
- `"band"`: the taps expanded into a [B, H, T, T] band matrix and one
  batched matmul (`_band_matmul`), where T >= K;
- `"pallas"`: the kernel `ops/dynamic_conv.py::dynamic_conv` (fp32
  sums, one rounding), where T % 128 == 0, the reference kernel's
  tiling; forward only, as in the reference.
The routes the rule does not admit fall back to the shift route. The
decoder's decode path runs the fused `decode_conv_block` instead, over
a ring-major cache.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from news_image_caption_tpu_torch.ops.dropout import dropout
from news_image_caption_tpu_torch.ops.dynamic_conv import \
    dynamic_conv_autograd
from news_image_caption_tpu_torch.ops.linear import (XavierLinear,
                                                     initializes, new_param)

METHODS = ("shift", "band", "pallas")


def _shift_accumulate(x: torch.Tensor, w: torch.Tensor,
                      K: int) -> torch.Tensor:
    """out[b,t,h,r] = sum_k w[b,t,h,k] * x[b,t-K+1+k,h,r] (zeros before
    t = 0), accumulated in x's dtype. x [B, T, H, R]; w [B, T, H, K]."""
    T = x.shape[1]
    xp = F.pad(x, (0, 0, 0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for k in range(K):
        out = out + w[..., k:k + 1] * xp[:, k:k + T]
    return out


def _band_matmul(x: torch.Tensor, w: torch.Tensor, K: int) -> torch.Tensor:
    """The same sum as one batched matmul: band[b,h,t,s] =
    w[b,t,h,s-t+K-1] inside the band, else 0. x [B, T, H, R]."""
    B, T, H, _ = x.shape
    t = torch.arange(T, device=x.device)
    offset = t[None, :] - t[:, None] + (K - 1)              # [T, T]
    in_band = (offset >= 0) & (offset <= K - 1)
    index = offset.clamp(0, K - 1).expand(B, H, T, T)
    band = torch.gather(w.permute(0, 2, 1, 3), 3, index)    # [B, H, T, T]
    band = torch.where(in_band, band, torch.zeros((), dtype=band.dtype,
                                                  device=band.device))
    out = torch.einsum("bhts,bhsr->bhtr", band, x.permute(0, 2, 1, 3))
    return out.permute(0, 2, 1, 3)


class DynamicConv(nn.Module):
    """Depthwise conv whose K taps are predicted per (position, head)
    by `weight_linear`, softmaxed over the taps (`weight_softmax`) and,
    in training, dropped at rate `weight_dropout`. `use_bias` is the
    bias of `weight_linear`; `conv_bias` adds a learned per-channel bias
    to the output."""

    def __init__(self, input_size: int, kernel_size: int, num_heads: int,
                 *, device, dtype, generator=None,
                 weight_softmax: bool = True, weight_dropout: float = 0.0,
                 use_bias: bool = False, conv_bias: bool = False,
                 method: str = "shift"):
        super().__init__()
        assert input_size % num_heads == 0
        if method not in METHODS:
            raise ValueError(f"DynamicConv: method {method!r}, expected one"
                             f" of {METHODS}")
        self.weight_softmax = weight_softmax
        self.weight_dropout = weight_dropout
        self.num_heads = num_heads
        self.kernel_size = kernel_size
        self.method = method
        self.weight_linear = XavierLinear(
            input_size, num_heads * kernel_size, use_bias=use_bias,
            device=device, dtype=dtype, generator=generator)
        self.conv_bias = (new_param((input_size,), device, dtype)
                          if conv_bias else None)
        if conv_bias and initializes(device):
            with torch.no_grad():
                self.conv_bias.zero_()

    def _weights(self, x: torch.Tensor,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        w = self.weight_linear(x)
        w = w.view(x.shape[:-1] + (self.num_heads, self.kernel_size))
        if self.weight_softmax:
            w = torch.softmax(w.float(), dim=-1).to(w.dtype)
        return dropout(w, self.weight_dropout, generator)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None,
                query: torch.Tensor | None = None) -> torch.Tensor:
        """Causal forward, x [B, T, C]:
        out[b,t,c] = sum_k w[b,t,h(c),k] * x[b, t-K+1+k, c], the taps
        predicted from `query` (x by default)."""
        B, T, C = x.shape
        H, K = self.num_heads, self.kernel_size
        w = self._weights(x if query is None else query, generator)
        if self.method == "pallas" and T % 128 == 0:
            out = dynamic_conv_autograd(x.contiguous(), w.contiguous(), H)
        else:
            xh = x.reshape(B, T, H, C // H)
            if self.method == "band" and T >= K:
                out = _band_matmul(xh, w, K)
            else:
                out = _shift_accumulate(xh, w, K)
            out = out.reshape(B, T, C)
        if self.conv_bias is not None:
            out = out + self.conv_bias.to(out.dtype)
        return out

    def step_ring(self, x_t: torch.Tensor, cache: torch.Tensor, t: int):
        """Ring decode step. x_t [B, C]; cache [B, K-1, C] where slot
        s mod (K-1) holds input x_s (zeros before the sequence start).
        Returns (out [B, C], cache with x_t written at slot t mod K-1).
        A pointwise conv (K = 1) has no history: w * x_t, cache as it
        came."""
        B, C = x_t.shape
        H, K = self.num_heads, self.kernel_size
        R, Km1 = C // H, K - 1
        w = self._weights(x_t)                              # [B, H, K]
        if K == 1:
            out = w.expand(B, H, R).reshape(B, C) * x_t
            if self.conv_bias is not None:
                out = out + self.conv_bias.to(out.dtype)
            return out, cache
        k_for_slot = (torch.arange(Km1, device=x_t.device) - t) % Km1
        w_hist = w[:, :, k_for_slot]                        # [B, H, K-1]
        hist = cache.view(B, Km1, H, R)
        out = torch.einsum("bhk,bkhr->bhr", w_hist, hist).reshape(B, C)
        out = out + w[:, :, Km1:].expand(B, H, R).reshape(B, C) * x_t
        if self.conv_bias is not None:
            out = out + self.conv_bias.to(out.dtype)
        new_cache = cache.clone()
        new_cache[:, t % Km1] = x_t
        return out, new_cache

    def init_cache(self, batch_size: int, device,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Zero history [B, K-1, C] for `step` and `step_ring_lazy`."""
        return torch.zeros(batch_size, self.kernel_size - 1,
                           self.weight_linear.kernel.shape[0],
                           device=device, dtype=dtype)

    def step(self, x_t: torch.Tensor, cache: torch.Tensor):
        """Shift decode step. x_t [B, C]; cache [B, K-1, C], the previous
        inputs oldest first. Returns (out [B, C], the cache shifted by
        one with x_t last)."""
        B, C = x_t.shape
        H, K = self.num_heads, self.kernel_size
        w = self._weights(x_t)                              # [B, H, K]
        hist = torch.cat([cache, x_t[:, None, :]], dim=1)    # [B, K, C]
        out = torch.einsum("bhk,bkhr->bhr", w,
                           hist.view(B, K, H, C // H)).reshape(B, C)
        if self.conv_bias is not None:
            out = out + self.conv_bias.to(out.dtype)
        return out, hist[:, 1:]

    def step_ring_lazy(self, x_t: torch.Tensor, cache: torch.Tensor,
                       slot_map: torch.Tensor, t: int):
        """Ring step over a cache that stays in physical row order
        across beam reorders. x_t [B, C]; cache [B, K-1, C]; slot_map
        [K-1, B]: the physical row that holds each logical row's input
        in that slot (beam search composes it with the ancestry instead
        of moving the cache). Returns (out [B, C], the cache with x_t
        written at slot t mod (K-1) in logical order, the slot map with
        that slot's row reset to the identity)."""
        B, C = x_t.shape
        H, K = self.num_heads, self.kernel_size
        R, Km1 = C // H, K - 1
        w = self._weights(x_t)                              # [B, H, K]
        if K == 1:
            out = w.expand(B, H, R).reshape(B, C) * x_t
            if self.conv_bias is not None:
                out = out + self.conv_bias.to(out.dtype)
            return out, cache, slot_map
        slots = torch.arange(Km1, device=x_t.device)
        w_hist = w[:, :, (slots - t) % Km1]                 # [B, H, K-1]
        hist = cache[slot_map.T.long(), slots[None, :]]     # [B, K-1, C]
        out = torch.einsum("bhk,bkhr->bhr", w_hist,
                           hist.view(B, Km1, H, R)).reshape(B, C)
        out = out + w[:, :, Km1:].expand(B, H, R).reshape(B, C) * x_t
        if self.conv_bias is not None:
            out = out + self.conv_bias.to(out.dtype)
        j = t % Km1
        new_cache = cache.clone()
        new_cache[:, j] = x_t
        new_map = slot_map.clone()
        new_map[j] = torch.arange(B, device=slot_map.device,
                                  dtype=slot_map.dtype)
        return out, new_cache, new_map
