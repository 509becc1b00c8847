"""BertAdam and its warmup-linear schedule.

Counterpart of `news_image_caption_tpu/training/optim.py::bert_adam`
and `warmup_linear_schedule` (the flagship's optimizer): each tensor's
gradient clipped to `max_grad_norm` by its own norm (not the global
norm), Adam moments without bias correction, decoupled weight decay
added to the update, the update scaled by -lr(n).

As in optax's `scale_by_learning_rate`, n counts the updates applied so
far, starting at 0: lr(0) = 0 under the warmup, so the first update
moves no weight. A skipped step (the train step's non-finite guard)
does not call `apply`, so neither n nor the moments advance.

The update runs in place on fp32 master tensors, with `torch._foreach`
ops (a few launches for all tensors rather than several per tensor).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

import torch


def warmup_linear_schedule(lr: float, t_total: int, warmup: float = 0.05
                           ) -> Callable[[int], float]:
    """pytorch-pretrained-bert `warmup_linear`: x / warmup, then 1 - x,
    with x = min(n / t_total, 1)."""

    def schedule(step: int) -> float:
        x = min(step / t_total, 1.0)
        mult = x / warmup if x < warmup else 1.0 - x
        return lr * max(mult, 0.0)

    return schedule


@dataclass
class BertAdamState:
    count: int                 # updates applied
    mu: List[torch.Tensor]     # first moments, fp32
    nu: List[torch.Tensor]     # second moments, fp32


class BertAdam:
    """`init(master)` -> state; `apply(grads, state, master)` updates
    master and state in place."""

    def __init__(self, lr_schedule: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.98, eps: float = 1e-6,
                 weight_decay: float = 1e-5,
                 max_grad_norm: Optional[float] = 0.1):
        self.lr_schedule = lr_schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm

    def init(self, master: List[torch.Tensor]) -> BertAdamState:
        return BertAdamState(count=0,
                             mu=[torch.zeros_like(p) for p in master],
                             nu=[torch.zeros_like(p) for p in master])

    def apply(self, grads: List[torch.Tensor], state: BertAdamState,
              master: List[torch.Tensor]) -> None:
        """One update from fp32 grads (clipped in place)."""
        lr = self.lr_schedule(state.count)
        if self.max_grad_norm is not None:
            norms = torch.stack(torch._foreach_norm(grads))
            scale = torch.clamp(self.max_grad_norm
                                / torch.clamp(norms, min=1e-12), max=1.0)
            torch._foreach_mul_(grads, list(scale.unbind()))
        torch._foreach_mul_(state.mu, self.b1)
        torch._foreach_add_(state.mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(state.nu, self.b2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1.0 - self.b2)
        denom = torch._foreach_sqrt(state.nu)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(state.mu, denom)
        if self.weight_decay:
            torch._foreach_add_(updates, master, alpha=self.weight_decay)
        torch._foreach_add_(master, updates, alpha=-lr)
        state.count += 1


def make_bert_adam(lr: float, t_total: int, warmup: float = 0.05,
                   **kw) -> BertAdam:
    return BertAdam(warmup_linear_schedule(lr, t_total, warmup), **kw)
