"""Greedy decode loop over a candidate-producing step.

Counterpart of `news_image_caption_tpu/generation/generator.py`
(`GenerationConfig`, `generate_candidates`) for greedy decoding
(`sampling_topk == 1`). The reference's `lax.scan` / `lax.while_loop`
becomes a Python loop: with `early_exit` it stops as soon as every row
has emitted eos (one host read of the finished mask per step); the
outputs are the same either way, since finished rows emit pad with
log-prob 0.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import torch


@dataclass(frozen=True)
class GenerationConfig:
    max_len: int = 100
    eos_id: int = 2
    pad_id: int = 1
    bos_id: int = 0
    sampling_topk: int = 1
    sampling_temp: float = 1.0
    # Mark rows whose seed is eos as finished from the start.
    init_finished: bool = True
    # Stop once every row has finished (same outputs, fewer steps).
    early_exit: bool = False


def generate_candidates(step_fn: Callable, seed: torch.Tensor,
                        config: GenerationConfig
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy generation.

    step_fn(token_t [B], step_idx) -> (cand_lp [B, k], cand_ids [B, k])
    with the candidates the exact top-k, best first; step_fn owns its
    decode state. seed [B] is the first input token. Returns
    (tokens [B, max_len + 1] int64 with the seed first, log_probs
    [B, max_len] fp32).
    """
    if config.sampling_topk != 1:
        raise NotImplementedError(
            "only greedy decoding (sampling_topk == 1) is ported")
    B = seed.shape[0]
    L = config.max_len
    tokens = torch.full((B, L + 1), config.pad_id, dtype=torch.long,
                        device=seed.device)
    tokens[:, 0] = seed
    lps = torch.zeros(B, L, dtype=torch.float32, device=seed.device)
    if config.init_finished:
        finished = seed == config.eos_id
    else:
        finished = torch.zeros(B, dtype=torch.bool, device=seed.device)
    cur = seed
    for i in range(L):
        if config.early_exit and bool(finished.all()):
            break
        cand_lp, cand_ids = step_fn(cur, i)
        sel_lp = cand_lp[:, 0] / config.sampling_temp
        next_tok = torch.where(finished, config.pad_id, cand_ids[:, 0])
        lps[:, i] = torch.where(finished, 0.0, sel_lp.float())
        tokens[:, i + 1] = next_tok
        finished = finished | (next_tok == config.eos_id)
        cur = next_tok
    return tokens, lps
