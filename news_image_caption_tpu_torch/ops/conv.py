"""Dynamic and lightweight depthwise convolutions (Wu et al. 2019).

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
a ring-major cache, where its layer has the flagship's structure.

`LightweightConv` is the reference's `LightweightConv`: K learned taps a
head shared by every position, softmaxed over the taps in fp32 and
rounded to the parameters' dtype (`weight_softmax`), dropped in training
at `weight_dropout`, then cast to the input's dtype. Its full-sequence
forward is the shift-accumulate; `step` and `chunk` read a cache
[B, K-1, C] oldest first as the reference's do; its `step_ring` reads
the ring-major cache [K-1, N, C] of the port's decoder.

`ring_step(x_t, ring, t)` of both convolutions is the output of one
decode step over a ring-major cache [K-1, N, C], without writing it:
tap k of a row at position p reads slot (p + k) mod (K-1), t an int for
every row or an [N] tensor of each row's position. The decoder's layers
whose structure the fused conv block kernel does not take run it
(`models/decoder_flattened.py`).
"""

from __future__ import annotations

import math

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


def _slot_taps(t, Km1: int, device) -> torch.Tensor:
    """The tap index of each ring slot: (slot - t) mod (K-1), [K-1] for
    an int t, [N, K-1] for a tensor of positions."""
    slots = torch.arange(Km1, device=device)
    if isinstance(t, torch.Tensor):
        return (slots[None, :] - t.long()[:, None]) % Km1
    return (slots - t) % Km1


def _ring_sum(w: torch.Tensor, x_t: torch.Tensor, ring: torch.Tensor, t,
              conv_bias) -> torch.Tensor:
    """sum over the ring's slots of tap * input, then the current input's
    tap, then the bias: w [N, H, K] or [H, K] (shared by the rows), x_t
    [N, C], ring [K-1, N, C]."""
    N, C = x_t.shape
    H, K = w.shape[-2:]
    R, Km1 = C // H, K - 1
    w = w.expand(N, H, K)
    out = w[:, :, Km1:].expand(N, H, R).reshape(N, C) * x_t
    if Km1:
        taps = _slot_taps(t, Km1, x_t.device)
        taps = taps.expand(N, Km1)[:, None, :].expand(N, H, Km1)
        w_hist = torch.gather(w, 2, taps)                   # [N, H, K-1]
        hist = torch.einsum("nhk,knhr->nhr", w_hist,
                            ring.view(Km1, N, H, R)).reshape(N, C)
        out = hist + out
    if conv_bias is not None:
        out = out + conv_bias.to(out.dtype)
    return out


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

    def ring_step(self, x_t: torch.Tensor, ring: torch.Tensor,
                  t) -> torch.Tensor:
        """One decode step's output [N, C] over a ring-major cache
        [K-1, N, C] (the module docstring), the cache not written."""
        w = self._weights(x_t)                              # [N, H, K]
        return _ring_sum(w, x_t, ring, t, self.conv_bias)

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


class LightweightConv(nn.Module):
    """Depthwise conv with K learned taps a head (`weight` [H, K]),
    shared by every position."""

    def __init__(self, input_size: int, kernel_size: int, num_heads: int,
                 *, device, dtype, generator=None,
                 weight_softmax: bool = True, weight_dropout: float = 0.0,
                 conv_bias: bool = False):
        super().__init__()
        assert input_size % num_heads == 0
        self.input_size = input_size
        self.num_heads = num_heads
        self.kernel_size = kernel_size
        self.weight_softmax = weight_softmax
        self.weight_dropout = weight_dropout
        self.weight = new_param((num_heads, kernel_size), device, dtype)
        self.conv_bias = (new_param((input_size,), device, dtype)
                          if conv_bias else None)
        if initializes(device):
            bound = math.sqrt(6.0 / (num_heads + kernel_size))
            with torch.no_grad():
                self.weight.uniform_(-bound, bound, generator=generator)
                if conv_bias:
                    self.conv_bias.zero_()

    def _weights(self, dtype: torch.dtype,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        """The taps [H, K]: softmaxed in fp32 and rounded to the
        parameters' dtype, dropped, then in `dtype`."""
        w = self.weight
        if self.weight_softmax:
            w = torch.softmax(w.float(), dim=-1).to(w.dtype)
        return dropout(w, self.weight_dropout, generator,
                       batched=False).to(dtype)

    def _bias(self, out: torch.Tensor) -> torch.Tensor:
        if self.conv_bias is None:
            return out
        return out + self.conv_bias.to(out.dtype)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Causal forward, x [B, T, C]: out[b,t,c] = sum_k w[h(c),k] *
        x[b, t-K+1+k, c]."""
        B, T, C = x.shape
        H, K = self.num_heads, self.kernel_size
        w = self._weights(x.dtype, generator)
        out = _shift_accumulate(x.reshape(B, T, H, C // H),
                                w.expand(B, T, H, K), K)
        return self._bias(out.reshape(B, T, C))

    def init_cache(self, batch_size: int, device,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Zero history [B, K-1, C] for `step` and `chunk`."""
        return torch.zeros(batch_size, self.kernel_size - 1,
                           self.input_size, device=device, dtype=dtype)

    def step(self, x_t: torch.Tensor, cache: torch.Tensor,
             generator: torch.Generator | None = None):
        """Shift decode step. x_t [B, C]; cache [B, K-1, C] oldest
        first. Returns (out [B, C], the cache shifted by one with x_t
        last)."""
        B, C = x_t.shape
        H, K = self.num_heads, self.kernel_size
        w = self._weights(x_t.dtype, generator)
        hist = torch.cat([cache, x_t[:, None, :]], dim=1)    # [B, K, C]
        out = torch.einsum("hk,bkhr->bhr", w,
                           hist.view(B, K, H, C // H)).reshape(B, C)
        return self._bias(out), hist[:, 1:]

    def chunk(self, x_c: torch.Tensor, cache: torch.Tensor,
              generator: torch.Generator | None = None) -> torch.Tensor:
        """k sequential `step`s at once: x_c [B, k, C] after the cache
        [B, K-1, C] (oldest first). The taps' products summed in fp32,
        rounded once to x_c's dtype. Returns out [B, k, C]; the cache is
        not advanced."""
        B, k, C = x_c.shape
        H, K = self.num_heads, self.kernel_size
        R = C // H
        w = self._weights(x_c.dtype, generator).float()
        full = torch.cat([cache, x_c], dim=1).view(B, K - 1 + k, H, R)
        out = torch.zeros(B, k, H, R, device=x_c.device)
        for j in range(K):
            out = out + w[None, None, :, j, None] * full[:, j:j + k].float()
        return self._bias(out.to(x_c.dtype).reshape(B, k, C))

    def ring_step(self, x_t: torch.Tensor, ring: torch.Tensor,
                  t) -> torch.Tensor:
        """One decode step's output [N, C] over a ring-major cache
        [K-1, N, C] (the module docstring), the cache not written."""
        return _ring_sum(self._weights(x_t.dtype), x_t, ring, t,
                         self.conv_bias)

    def step_ring(self, x_t: torch.Tensor, ring: torch.Tensor, t):
        """Ring decode step over the ring-major cache [K-1, N, C]:
        (out [N, C], a copy of the cache with x_t in slot t mod (K-1)).
        A pointwise conv (K = 1) has an empty ring."""
        out = self.ring_step(x_t, ring, t)
        Km1 = self.kernel_size - 1
        if Km1 == 0:
            return out, ring
        new = ring.clone()
        if isinstance(t, torch.Tensor):
            new[t.long() % Km1, torch.arange(x_t.shape[0],
                                             device=x_t.device)] = x_t
        else:
            new[t % Km1] = x_t
        return out, new
