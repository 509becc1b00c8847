"""O2 mixed-precision train step and eval step.

Counterpart of `news_image_caption_tpu/training/train_step.py`
(`TrainState`, `create_o2_train_state`, `make_train_step(...,
o2_master=True)`, `make_eval_step`), on one device. The model holds the
stored parameters in the compute dtype (bf16 for the flagship); the
fp32 master copy and the optimizer moments live in the optimizer state.
A step runs forward and backward in the compute dtype, casts the
gradients to fp32, updates the master and writes it back into the
stored parameters.

A step whose loss or global gradient norm is not finite leaves the
parameters and the optimizer state untouched and reports skipped = 1;
the step counter still advances. Deciding that reads one flag on the
host per step (the JAX step decides on the device with `lax.cond`).

The state's tensors are updated in place, as the JAX step donates its
state: the state passed in is the state returned.

Each phase runs inside a `torch.profiler.record_function` span
(`train_step.forward`, `.backward`, `.guard`, `.optimizer`), so a
profile attributes host and device time to them; with no profiler
running the four spans cost about 60 µs of host time a step (15 µs
each on an H100 machine's host, 0.1% of a flagship step).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from news_image_caption_tpu_torch.training.optim import BertAdam


@dataclass
class TrainState:
    step: int
    params: Dict[str, torch.Tensor]   # the model's stored parameters
    opt_state: Dict[str, Any]         # {"master": {name: fp32}, "inner": BertAdamState}


def create_o2_train_state(model: nn.Module, tx: BertAdam) -> TrainState:
    """State over `model`'s parameters, stored in the dtype the model was
    built in; the master copy is their fp32 value."""
    params = dict(model.named_parameters())
    master = {k: p.detach().float().clone() for k, p in params.items()}
    return TrainState(step=0, params=params,
                      opt_state={"master": master,
                                 "inner": tx.init(list(master.values()))})


def cast_floats(batch: Dict[str, torch.Tensor], dtype: torch.dtype):
    return {k: (v.to(dtype) if v is not None and v.is_floating_point() else v)
            for k, v in batch.items()}


def _step_generator(device, seed: int, step: int) -> torch.Generator:
    """The dropout generator of one step, seeded from (seed, step) as the
    JAX step folds the step into its key."""
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + step) % (1 << 63))


def make_train_step(loss_fn: Callable, tx: BertAdam,
                    compute_dtype: torch.dtype = torch.bfloat16) -> Callable:
    """loss_fn(batch, generator) -> (loss, aux), over the model whose
    parameters the state holds. Returns step(state, batch, seed) ->
    (state, metrics): metrics hold loss, grad_norm (global, fp32) and
    aux as device tensors, and skipped as an int."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             seed: int = 0) -> Tuple[TrainState, Dict[str, Any]]:
        params = list(state.params.values())
        for p in params:
            p.grad = None
        generator = _step_generator(params[0].device, seed, state.step)
        with record_function("train_step.forward"):
            loss, aux = loss_fn(cast_floats(batch, compute_dtype), generator)
        with record_function("train_step.backward"):
            loss.backward()
            grads = [torch.zeros_like(p, dtype=torch.float32)
                     if p.grad is None else p.grad.float() for p in params]
            for p in params:
                p.grad = None
            grad_norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
        with record_function("train_step.guard"):
            good = bool(torch.isfinite(loss) & torch.isfinite(grad_norm))
        if good:
            master = list(state.opt_state["master"].values())
            with record_function("train_step.optimizer"), torch.no_grad():
                tx.apply(grads, state.opt_state["inner"], master)
                torch._foreach_copy_(params, master)
        metrics = {"loss": loss.detach(), "grad_norm": grad_norm,
                   "skipped": int(not good),
                   **{k: v.detach() for k, v in aux.items()}}
        state.step += 1
        return state, metrics

    return step


def make_eval_step(loss_fn: Callable,
                   compute_dtype: torch.dtype = torch.bfloat16) -> Callable:
    """eval_step(batch) -> {"loss", **aux}: the deterministic loss under
    the train step's precision."""

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        loss, aux = loss_fn(cast_floats(batch, compute_dtype), None)
        return {"loss": loss, **aux}

    return eval_step
