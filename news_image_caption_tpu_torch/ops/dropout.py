"""Elementwise dropout drawn from an explicit generator.

Counterpart of `news_image_caption_tpu/ops/dropout.py`. A training
forward hands one `torch.Generator` (on the tensors' device) down the
model; `generator=None` means evaluation, where dropout is the
identity. The bits differ from JAX's (another generator), the law is
the same: keep with probability 1 - rate, kept values scaled by
1 / (1 - rate). `remat` checkpoints a layer with its draws replayed.
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


def remat(fn, generator: Optional[torch.Generator], *args):
    """fn(*args) under `torch.utils.checkpoint` (non-reentrant): its
    activations are recomputed in the backward pass instead of kept.
    The checkpoint saves and restores the global RNGs only, so the draws
    fn makes from `generator` (dropout masks, a flash seed) are replayed
    here: the generator's state before the forward is set again for the
    recompute, and its state after the forward is restored once the
    recompute ends, so the recomputed layer draws what the forward drew
    and later draws are those of a run without checkpoints. Without
    autograd it is fn(*args)."""
    if not torch.is_grad_enabled():
        return fn(*args)
    from torch.utils.checkpoint import checkpoint
    before = None if generator is None else generator.get_state()
    calls = []

    def run(*inputs):
        if not calls or generator is None:
            calls.append(1)
            return fn(*inputs)
        after = generator.get_state()
        generator.set_state(before)
        try:
            return fn(*inputs)
        finally:
            generator.set_state(after)

    return checkpoint(run, *args, use_reentrant=False)
