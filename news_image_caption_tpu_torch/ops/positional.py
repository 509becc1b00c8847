"""Pad-aware sinusoidal positional embeddings.

Counterpart of `news_image_caption_tpu/ops/positional.py`: the
sinusoidal embedder, the learned one (`LearnedPositionalEmbedding`), and
the Gen-2 family's `interleaved_sinusoidal_table`.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from news_image_caption_tpu_torch.ops.linear import initializes, new_param


def make_positions(token_ids: torch.Tensor, padding_idx: int,
                   start_pos: int | torch.Tensor = 0) -> torch.Tensor:
    """Non-pad token at column j -> padding_idx + 1 + j + start_pos;
    pad tokens -> padding_idx (the all-zero row). Right padding."""
    T = token_ids.shape[1]
    cols = torch.arange(T, device=token_ids.device)[None, :]
    positions = cols + padding_idx + 1 + start_pos
    return torch.where(token_ids != padding_idx, positions,
                       torch.full_like(positions, padding_idx))


def sinusoidal_table(n_embeds: int, embed_dim: int,
                     padding_idx: int | None = None) -> np.ndarray:
    """[sin(t/ts) || cos(t/ts)] concatenated (tensor2tensor layout)."""
    max_ts, min_ts = 10000.0, 1.0
    n_timescales = embed_dim // 2
    increment = math.log(max_ts / min_ts) / max(n_timescales - 1, 1)
    inv_timescales = min_ts * np.exp(np.arange(n_timescales) * -increment)
    scaled_time = np.arange(n_embeds)[:, None] * inv_timescales[None, :]
    signal = np.concatenate([np.sin(scaled_time), np.cos(scaled_time)],
                            axis=1)
    if embed_dim % 2 == 1:
        signal = np.concatenate([signal, np.zeros((n_embeds, 1))], axis=1)
    if padding_idx is not None:
        signal[padding_idx, :] = 0
    return signal.astype(np.float32)


def interleaved_sinusoidal_table(max_len: int, d_model: int) -> np.ndarray:
    """Annotated-Transformer layout, pe[:, 0::2] = sin and pe[:, 1::2] =
    cos; positions from 0, no padding row (the Gen-2 family)."""
    pe = np.zeros((max_len, d_model))
    position = np.arange(max_len)[:, None].astype(np.float64)
    div_term = np.exp(np.arange(0, d_model, 2)
                      * -(math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe.astype(np.float32)


class SinusoidalPositionalEmbedding(nn.Module):
    """Fixed table of init_size + padding_idx + 2 rows (room for
    position padding_idx + 1 + init_size); a buffer, not a weight."""

    def __init__(self, embedding_dim: int, *, device, dtype,
                 padding_idx: int = 1, init_size: int = 512):
        super().__init__()
        self.padding_idx = padding_idx
        self.out_dtype = dtype
        n = init_size + padding_idx + 2
        table = torch.from_numpy(sinusoidal_table(n, embedding_dim,
                                                  padding_idx))
        self.register_buffer("table", table.to(device), persistent=False)

    def forward(self, token_ids: torch.Tensor,
                start_pos: int | torch.Tensor = 0) -> torch.Tensor:
        positions = make_positions(token_ids, self.padding_idx, start_pos)
        return self.table[positions].to(self.out_dtype)


class LearnedPositionalEmbedding(nn.Module):
    """Pad-aware learned positions: `embedding` [max_positions +
    padding_idx + 2, dim] in `dtype`, drawn normal(0, 0.1) with the
    padding row zero; looked up at `make_positions` and cast to
    `out_dtype` (default `dtype`)."""

    def __init__(self, max_positions: int, embedding_dim: int, *, device,
                 dtype, generator=None, padding_idx: int = 1,
                 out_dtype: torch.dtype | None = None):
        super().__init__()
        self.padding_idx = padding_idx
        self.out_dtype = out_dtype or dtype
        self.embedding = new_param(
            (max_positions + padding_idx + 2, embedding_dim), device, dtype)
        if initializes(device):
            with torch.no_grad():
                self.embedding.normal_(0.0, 0.1, generator=generator)
                self.embedding[padding_idx] = 0.0

    def forward(self, token_ids: torch.Tensor,
                start_pos: int | torch.Tensor = 0) -> torch.Tensor:
        positions = make_positions(token_ids, self.padding_idx, start_pos)
        return self.embedding[positions].to(self.out_dtype)
