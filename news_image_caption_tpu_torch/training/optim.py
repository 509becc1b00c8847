"""BertAdam and its warmup-linear schedule; Noam's and Gen-1's Adam.

Counterpart of `news_image_caption_tpu/training/optim.py::bert_adam`
and `warmup_linear_schedule` (the flagship's optimizer): each tensor's
gradient clipped to `max_grad_norm` by its own norm (not the global
norm), Adam moments without bias correction, decoupled weight decay
added to the update, the update scaled by -lr(n). And of `noam_adam`
and `noam_schedule` (the Gen-2 family's): optax's `scale_by_adam` (bias
correction, b1 0.9, b2 0.98, eps 1e-9, no decay, no clipping) scaled by
-lr(n), lr(n) = factor * model_size^-0.5 * min(s^-0.5, s *
warmup^-1.5) with s = max(n, 1). And of `gen1_adam` and
`step_decay_schedule` (the Gen-1 family's): each gradient element
clamped to ±grad_clip_value, then the same Adam (b1 0.8, b2 0.999, eps
1e-8), scaled by the step-decayed rate.

As in optax's `scale_by_learning_rate`, n counts the updates applied so
far, starting at 0: lr(0) = 0 under the warmup, so the first update
moves no weight (Noam's s = max(n, 1) makes its first two updates' rates
equal). A skipped step (the train step's non-finite guard) does not
call `apply`, so neither n nor the moments advance.

The update runs in place on fp32 master tensors, with `torch._foreach`
ops (a few launches for all tensors rather than several per tensor). A
parameter stored narrower than fp32 (a bf16 `param_dtype` under the
fp32 precision) is updated as optax updates such a leaf: every
operation in its dtype, the constants rounded to it.
BertAdam's `moment_dtype` (the reference's opt-in, e.g. bfloat16) stores
the first moments in that dtype: a step computes b1 * mu + (1 - b1) * g
in fp32 and rounds it once on store, and the update divides the stored
mu, widened back to fp32, by sqrt(nu) + eps; the second moments stay
fp32.

Under tensor parallelism (`parallel/partition.py`) a tensor the model
ranks split is clipped by the norm of the whole tensor, the square root
of the sum over the ranks of their slices' squared norms; a replicated
tensor keeps its own (`parallel/collectives.py::whole_norms`). The
train step says which are split: `apply(..., split=(flags, group))`,
one flag for each tensor it hands the optimizer.

`accumulate_gradients(tx, every)` is optax's `MultiSteps` (the
reference's `accumulate_gradients`): the mean gradient of `every`
micro-batches reaches `tx` once a window.

`mask_frozen(tx, frozen_collections)` is the reference's `mask_frozen`
(optax's `masked`): `tx` sees only the parameters outside the frozen
top-level collections (`trainable_names`), so the frozen ones take no
decay, hold no moments and stay as they are. The train state applies the
mask (`training/train_step.py`): it hands the optimizer those parameters
alone, and their gradients alone.

An optimizer state goes to and from a checkpoint as a dict of ints and
named tensors (`state_dict(names)`, `load_state_dict(tree, names)`),
the names being the parameters' in the order `init` saw them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from news_image_caption_tpu_torch.parallel.collectives import whole_norms
from news_image_caption_tpu_torch.training.checkpoint import restore


def warmup_linear_schedule(lr: float, t_total: int, warmup: float = 0.05
                           ) -> Callable[[int], float]:
    """pytorch-pretrained-bert `warmup_linear`: x / warmup, then 1 - x,
    with x = min(n / t_total, 1), in float32 as the reference's jitted
    train step computes it: XLA turns both divisions by a constant into
    products with the float32 reciprocal, so at the warmup's end
    (n = warmup * t_total) x can land one unit under `warmup` and the
    rate stays on the ramp (e.g. lr at n = 10 of t_total 100, warmup
    0.1)."""
    f32 = np.float32
    inv_total, inv_warmup = f32(1) / f32(t_total), f32(1) / f32(warmup)

    def schedule(step: int) -> float:
        x = min(f32(step) * inv_total, f32(1))
        mult = x * inv_warmup if x < f32(warmup) else f32(1) - x
        return float(f32(lr) * max(mult, f32(0)))

    return schedule


def _named(tensors: List[torch.Tensor], names: Sequence[str]):
    return dict(zip(names, tensors))


@dataclass
class BertAdamState:
    count: int                 # updates applied
    mu: List[torch.Tensor]     # first moments, fp32 or moment_dtype
    nu: List[torch.Tensor]     # second moments, fp32

    def state_dict(self, names: Sequence[str]) -> Dict[str, Any]:
        return {"count": self.count, "mu": _named(self.mu, names),
                "nu": _named(self.nu, names)}

    def load_state_dict(self, tree: Dict[str, Any],
                        names: Sequence[str]) -> None:
        if set(tree) != {"count", "mu", "nu"}:
            raise ValueError(f"opt_state: checkpoint keys {sorted(tree)} "
                             "are not a BertAdam state")
        self.count = restore(self.count, tree["count"], "count")
        for key in ("mu", "nu"):
            restore(_named(getattr(self, key), names), tree[key], key)


class BertAdam:
    """`init(master)` -> state; `apply(grads, state, master)` updates
    master and state in place."""

    def __init__(self, lr_schedule: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.98, eps: float = 1e-6,
                 weight_decay: float = 1e-5,
                 max_grad_norm: Optional[float] = 0.1,
                 moment_dtype: Optional[torch.dtype] = None):
        self.lr_schedule = lr_schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.moment_dtype = moment_dtype

    def init(self, master: List[torch.Tensor]) -> BertAdamState:
        return BertAdamState(
            count=0,
            mu=[torch.zeros_like(p, dtype=self.moment_dtype or p.dtype)
                for p in master],
            nu=[torch.zeros_like(p) for p in master])

    def apply(self, grads: List[torch.Tensor], state: BertAdamState,
              master: List[torch.Tensor], split=None) -> None:
        """One update from fp32 grads (clipped in place): fp32 masters
        at once, a narrower parameter by `_apply_in_dtype`. split: None,
        or (flags, group) with one flag a tensor, true where the model
        ranks of `group` split it (its clip takes the whole norm)."""
        lr = self.lr_schedule(state.count)

        def pick(at):
            return None if split is None else ([split[0][i] for i in at],
                                               split[1])

        wide = []
        for i, p in enumerate(master):
            if p.dtype == torch.float32:
                wide.append(i)
            else:
                self._apply_in_dtype(grads[i], state.mu[i], state.nu[i], p,
                                     lr, pick([i]))
        if wide:
            self._apply_fp32([grads[i] for i in wide],
                             [state.mu[i] for i in wide],
                             [state.nu[i] for i in wide],
                             [master[i] for i in wide], lr, pick(wide))
        state.count += 1

    def _apply_fp32(self, grads: List[torch.Tensor], mus: List[torch.Tensor],
                    nus: List[torch.Tensor], master: List[torch.Tensor],
                    lr: float, split=None) -> None:
        if self.max_grad_norm is not None:
            norms = whole_norms(torch.stack(torch._foreach_norm(grads)),
                                split)
            scale = torch.clamp(self.max_grad_norm
                                / torch.clamp(norms, min=1e-12), max=1.0)
            torch._foreach_mul_(grads, list(scale.unbind()))
        if self.moment_dtype is None:
            torch._foreach_mul_(mus, self.b1)
            torch._foreach_add_(mus, grads, alpha=1.0 - self.b1)
            mu = mus
        else:
            # b1 * mu + (1 - b1) * g in fp32, rounded once on store; the
            # update reads the stored (rounded) mu, widened again.
            mu = [torch.empty_like(m, dtype=torch.float32) for m in mus]
            torch._foreach_copy_(mu, mus)
            torch._foreach_mul_(mu, self.b1)
            torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - self.b1))
            torch._foreach_copy_(mus, mu)
            torch._foreach_copy_(mu, mus)
        torch._foreach_mul_(nus, self.b2)
        torch._foreach_addcmul_(nus, grads, grads, value=1.0 - self.b2)
        denom = torch._foreach_sqrt(nus)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(mu, denom)
        if self.weight_decay:
            torch._foreach_add_(updates, master, alpha=self.weight_decay)
        torch._foreach_add_(master, updates, alpha=-lr)

    def _apply_in_dtype(self, g: torch.Tensor, mu: torch.Tensor,
                        nu: torch.Tensor, p: torch.Tensor, lr: float,
                        split=None) -> None:
        """The update of a parameter stored narrower than fp32 (bf16
        parameters under the fp32 precision): as optax computes it on
        such a leaf, every operation in the parameter's dtype with the
        constants (b1, b2, eps, the decay, the rate) rounded to it; the
        clip's norm in fp32, its scale rounded; split: its one flag and
        the group, as `apply`'s."""
        dt = p.dtype

        def c(x):
            return torch.tensor(x, dtype=dt, device=p.device)

        g = g.to(dt)
        if self.max_grad_norm is not None:
            norm = whole_norms(torch.linalg.vector_norm(g.float())[None],
                               split)[0]
            g = g * torch.clamp(self.max_grad_norm
                                / torch.clamp(norm, min=1e-12), max=1.0).to(dt)
        mu.copy_(mu * c(self.b1) + g * c(1.0 - self.b1))
        nu.copy_(nu * c(self.b2) + g * c(1.0 - self.b2) * g)
        u = mu / (torch.sqrt(nu) + c(self.eps))
        if self.weight_decay:
            u = u + p * c(self.weight_decay)
        p.add_(u * c(-lr))


def make_bert_adam(lr: float, t_total: int, warmup: float = 0.05,
                   **kw) -> BertAdam:
    return BertAdam(warmup_linear_schedule(lr, t_total, warmup), **kw)


def noam_schedule(model_size: int, factor: float = 1.0, warmup: int = 30000
                  ) -> Callable[[int], float]:
    """The Annotated Transformer's rate at update count n, in float32 as
    the reference's jitted step computes it."""
    f32 = np.float32
    scale = f32(factor * model_size ** -0.5)
    slope = f32(warmup ** -1.5)

    def schedule(step: int) -> float:
        s = f32(max(step, 1))
        return float(scale * min(s ** f32(-0.5), s * slope))

    return schedule


class ScheduledAdam:
    """optax `chain([clip(clip_value)], scale_by_adam(b1, b2, eps),
    scale_by_learning_rate(lr_schedule))`: each gradient element clamped
    to ±clip_value where one is given, then Adam with bias correction at
    update t = n + 1, the rate read at n. `init` / `apply` as
    `BertAdam`'s, over the same state (count, mu, nu)."""

    def __init__(self, lr_schedule: Callable[[int], float], b1: float,
                 b2: float, eps: float, clip_value: Optional[float] = None):
        self.lr_schedule = lr_schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.clip_value = clip_value

    def init(self, master: List[torch.Tensor]) -> BertAdamState:
        return BertAdamState(count=0,
                             mu=[torch.zeros_like(p) for p in master],
                             nu=[torch.zeros_like(p) for p in master])

    def apply(self, grads: List[torch.Tensor], state: BertAdamState,
              master: List[torch.Tensor], split=None) -> None:
        """split is `BertAdam.apply`'s; no norm is taken here."""
        lr = self.lr_schedule(state.count)
        t = np.float32(state.count + 1)
        f32 = np.float32
        bc1 = float(f32(1) - f32(self.b1) ** t)
        bc2 = float(f32(1) - f32(self.b2) ** t)
        if self.clip_value is not None:
            torch._foreach_clamp_min_(grads, -self.clip_value)
            torch._foreach_clamp_max_(grads, self.clip_value)
        torch._foreach_mul_(state.mu, self.b1)
        torch._foreach_add_(state.mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(state.nu, self.b2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1.0 - self.b2)
        denom = torch._foreach_div(state.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(state.mu, bc1)
        torch._foreach_div_(updates, denom)
        torch._foreach_add_(master, updates, alpha=-lr)
        state.count += 1

    def _apply_in_dtype(self, g: torch.Tensor, mu: torch.Tensor,
                        nu: torch.Tensor, p: torch.Tensor, lr: float) -> None:
        """The update of a parameter stored narrower than fp32 (bf16
        parameters under the fp32 precision): as optax computes it on
        such a leaf, every operation in the parameter's dtype with the
        constants (b1, b2, eps, the decay, the rate) rounded to it; the
        clip's norm in fp32, its scale rounded."""
        dt = p.dtype

        def c(x):
            return torch.tensor(x, dtype=dt, device=p.device)

        g = g.to(dt)
        if self.max_grad_norm is not None:
            norm = torch.linalg.vector_norm(g.float())
            g = g * torch.clamp(self.max_grad_norm
                                / torch.clamp(norm, min=1e-12), max=1.0).to(dt)
        mu.copy_(mu * c(self.b1) + g * c(1.0 - self.b1))
        nu.copy_(nu * c(self.b2) + g * c(1.0 - self.b2) * g)
        u = mu / (torch.sqrt(nu) + c(self.eps))
        if self.weight_decay:
            u = u + p * c(self.weight_decay)
        p.add_(u * c(-lr))


class NoamAdam(ScheduledAdam):
    """optax `chain(scale_by_adam(b1, b2, eps), scale_by_learning_rate(
    noam_schedule))`, the Gen-2 family's optimizer."""

    def __init__(self, model_size: int, factor: float = 1.0,
                 warmup: int = 30000, b1: float = 0.9, b2: float = 0.98,
                 eps: float = 1e-9):
        super().__init__(noam_schedule(model_size, factor, warmup), b1, b2,
                         eps)


def step_decay_schedule(lr: float, decay_start: int, decay_every: int,
                        decay_rate: float = 0.8) -> Callable[[int], float]:
    """The Gen-1 trainer's step decay: lr * decay_rate ** ((n -
    decay_start) // decay_every) from decay_start on (the power at 0
    before it), in float32 as the reference's jitted step computes it; a
    negative decay_start never decays."""
    f32 = np.float32

    def schedule(step: int) -> float:
        if decay_start < 0:
            return float(f32(lr))
        frac = max(step - decay_start, 0) // max(decay_every, 1)
        return float(f32(lr) * f32(decay_rate) ** f32(frac))

    return schedule


def gen1_adam(lr: float, decay_start: int, decay_every: int,
              decay_rate: float = 0.8, grad_clip_value: float = 5.0,
              b1: float = 0.8, b2: float = 0.999, eps: float = 1e-8
              ) -> ScheduledAdam:
    """The Gen-1 trainer's optimizer: each gradient element clamped to
    ±grad_clip_value, then Adam, then the step decay."""
    return ScheduledAdam(step_decay_schedule(lr, decay_start, decay_every,
                                             decay_rate),
                         b1, b2, eps, clip_value=grad_clip_value)


def mask_frozen(tx, frozen_collections: Sequence[str]):
    """`tx` with the frozen top-level collections (the first component of
    a parameter's name) left out: it records them as `tx.frozen`, and the
    train state hands `tx` the other parameters alone
    (`trainable_names`)."""
    tx.frozen = tuple(frozen_collections)
    return tx


def trainable_names(tx, names: Sequence[str]) -> List[str]:
    """The names among `names` that `tx` updates: all but those of a
    collection it masks."""
    frozen = getattr(tx, "frozen", ())
    return [n for n in names if n.split(".", 1)[0] not in frozen]


@dataclass
class MultiStepsState:
    mini_step: int                   # micro-batches in the open window
    gradient_step: int               # windows applied
    inner_opt_state: Any
    acc_grads: List[torch.Tensor]    # running mean gradient, fp32

    def state_dict(self, names: Sequence[str]) -> Dict[str, Any]:
        return {"mini_step": self.mini_step,
                "gradient_step": self.gradient_step,
                "inner_opt_state": self.inner_opt_state.state_dict(names),
                "acc_grads": _named(self.acc_grads, names)}

    def load_state_dict(self, tree: Dict[str, Any],
                        names: Sequence[str]) -> None:
        if set(tree) != {"mini_step", "gradient_step", "inner_opt_state",
                         "acc_grads"}:
            raise ValueError(f"opt_state: checkpoint keys {sorted(tree)} "
                             "are not an accumulation state")
        self.mini_step = restore(0, tree["mini_step"], "mini_step")
        self.gradient_step = restore(0, tree["gradient_step"],
                                     "gradient_step")
        self.inner_opt_state.load_state_dict(tree["inner_opt_state"], names)
        restore(_named(self.acc_grads, names), tree["acc_grads"],
                "acc_grads")


class MultiSteps:
    """optax.MultiSteps: each call folds the gradient into the window's
    running mean, acc + (g - acc) / (mini_step + 1); the last call of a
    window hands the mean to the wrapped optimizer, which updates the
    parameters (and advances its own count) once a window, and clears
    the mean. In between, the parameters stay as they are."""

    def __init__(self, inner, every: int):
        self.inner = inner
        self.every = every
        self.frozen = getattr(inner, "frozen", ())

    def init(self, master: List[torch.Tensor]) -> MultiStepsState:
        return MultiStepsState(
            mini_step=0, gradient_step=0,
            inner_opt_state=self.inner.init(master),
            acc_grads=[torch.zeros_like(p, dtype=torch.float32)
                       for p in master])

    def apply(self, grads: List[torch.Tensor], state: MultiStepsState,
              master: List[torch.Tensor], split=None) -> None:
        delta = torch._foreach_sub(grads, state.acc_grads)
        torch._foreach_div_(delta, float(state.mini_step + 1))
        torch._foreach_add_(state.acc_grads, delta)
        if state.mini_step < self.every - 1:
            state.mini_step += 1
            return
        self.inner.apply(state.acc_grads, state.inner_opt_state, master,
                         split)
        torch._foreach_zero_(state.acc_grads)
        state.mini_step = 0
        state.gradient_step += 1


def accumulate_gradients(tx, every: int):
    """Average gradients over `every` micro-batches and apply `tx` once
    a window; every <= 1 is `tx` itself."""
    if every <= 1:
        return tx
    return MultiSteps(tx, every)
