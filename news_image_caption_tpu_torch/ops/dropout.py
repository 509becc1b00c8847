"""Elementwise dropout drawn from an explicit generator.

Counterpart of `news_image_caption_tpu/ops/dropout.py`. A training
forward hands one `torch.Generator` (on the tensors' device) down the
model; `generator=None` means evaluation, where dropout is the
identity. The bits differ from JAX's (another generator), the law is
the same: keep with probability 1 - rate, kept values scaled by
1 / (1 - rate).
"""

from __future__ import annotations

from typing import Optional

import torch


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    if rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))
