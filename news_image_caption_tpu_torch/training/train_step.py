"""Train state, train step and eval step in three precisions.

Counterpart of `news_image_caption_tpu/training/train_step.py`
(`TrainState`, `create_train_state`, `create_o2_train_state`,
`make_train_step`, `make_eval_step`), on one device or data-parallel
over a rank mesh (below). The checkpointed
layout of each precision is the reference's:

- fp32 (`create_train_state`): `params` are the model's fp32
  parameters, `opt_state` the optimizer's state over them;
- bf16 (`create_train_state(..., compute=)`): `params` and the optimizer
  stay fp32; forward and backward run on a bf16 copy of the model, whose
  parameters (`TrainState.compute`, not checkpointed) are written from
  `params` after each update and after a load;
- bf16_o2 (`create_o2_train_state`): `params` are the model's stored
  bf16 parameters, `opt_state = {"master": fp32 copy, "inner": the
  optimizer's state}`; an update writes the master back into them.

An optimizer that masks frozen collections (`training/optim.py::
mask_frozen`, the pipeline's encoders) sees only the other parameters
(`TrainState.trainable`): the step takes no gradient of the frozen ones,
the optimizer holds no state for them, and in bf16 the per-step refresh
of the compute copy writes the trainable ones alone. The checkpoint's
`params` still hold every parameter.

Gradients reach the optimizer as fp32. With `guard_nonfinite` a step
whose loss or global gradient norm is not finite leaves the parameters
and the optimizer state untouched and reports skipped = 1; deciding that
reads one flag on the host per step (the JAX step decides on the device
with `lax.cond`). Without it the step reads nothing on the host. The
step counter advances either way.

The state's tensors are updated in place, as the JAX step donates its
state: the state passed in is the state returned. `in_update` is true
while the optimizer writes them, so a caller that catches a failure
there knows the state is torn (the JAX step's deleted donated buffers).

With a mesh (`make_train_step(..., mesh=)`) the step is data-parallel
over the mesh's `data` axis: the batch is the rank's rows of the global
batch (`parallel/distributed.py::place_local`), dropout draws the global
batch's masks and keeps the rank's rows (`parallel/collectives.py::
global_rows`, the flash kernels' hash from the rank's first row), the
loss is the global batch's on every rank, and the fp32 gradients are
summed over the data ranks before the norm, the guard and the
optimizer, one all-reduce in place over one flat buffer whose views
they are (`parallel/collectives.py::GradientBuffer`), so every rank
makes the same update and the same skip decision. Each family's loss is a
ratio of sums over the batch, and it all-reduces those sums
(`global_sums`) before dividing, so the global loss is exact rather
than a mean of the ranks' means: the flagship, its variants and the
online pipeline (`models/captioner.py`), the LSTM and Gen-2 take the
summed loss over the summed count of target tokens; the pointer family
the generation loss so, the entity loss the summed NLL over the summed
count of labelled tokens and the copy loss each entity's summed -log p
over its summed count (present on any rank); TGNC the caption loss so
and the template BCE as its global mean (`global_mean`); Gen-1 the
masked NLL over the summed mask, and scheduled sampling
(`compat/train.py`'s, whose draws are per local row) raises under data
parallelism.
Each rank's gradient is that of its own terms of the sums divided by
the global counts, so the ranks' gradients add up to the global loss's.
With one rank every reduction is the identity and the step computes the
single process's values bit for bit.

Over a mesh's `model` axis (tensor parallelism) the model holds its
rank's slices (`parallel/partition.py::shard_params`) and the state
records them (`TrainState.split`). The collectives inside the model
give a replicated parameter the same gradient on every model rank and
a split one its slice's, so the gradients are still summed over the
`data` axis alone; the per-tensor clip and the global gradient norm
take each split tensor's whole norm (`parallel/collectives.py::
whole_norms`; the optimizer is told which tensors are split). `state_dict()` gathers the split tensors whole (every
model rank calls it), so a single-file checkpoint holds the one-process
layout; `load_state_dict` takes the rank's slices of whole tensors;
`sharded_state_dict()` keeps the slices, with their offsets, for the
sharded store.

Each phase runs inside a `torch.profiler.record_function` span
(`train_step.forward`, `.backward`, `.guard`, `.optimizer`), so a
profile attributes host and device time to them; with no profiler
running the four spans cost about 60 µs of host time a step (15 µs
each on an H100 machine's host, 0.1% of a flagship step).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from news_image_caption_tpu_torch.parallel.collectives import (
    GradientBuffer, data_parallel, whole_norms)
from news_image_caption_tpu_torch.parallel.mesh import DATA_AXIS, axis_group
from news_image_caption_tpu_torch.parallel.partition import (gather_params,
                                                             shard_of,
                                                             sharded_tensors,
                                                             slice_params)
from news_image_caption_tpu_torch.training.checkpoint import restore
from news_image_caption_tpu_torch.training.optim import trainable_names


@dataclass
class TrainState:
    step: int
    params: Dict[str, torch.Tensor]   # the stored parameters
    opt_state: Any                    # optimizer state, or {"master", "inner"}
    compute: Optional[Dict[str, torch.Tensor]] = None   # bf16 copy (bf16)
    in_update: bool = False
    # The parameters the optimizer updates, in its order (None: all).
    trainable: Optional[List[str]] = None
    # ({name: split dim}, ModelShard) of a model split over model ranks.
    split: Optional[Tuple[Dict[str, int], Any]] = None

    @property
    def o2(self) -> bool:
        return isinstance(self.opt_state, dict)

    @property
    def opt_names(self) -> List[str]:
        return list(self.params) if self.trainable is None \
            else self.trainable

    def _local_state_dict(self) -> Dict[str, Any]:
        names = self.opt_names
        if self.o2:
            opt = {"master": dict(self.opt_state["master"]),
                   "inner": self.opt_state["inner"].state_dict(names)}
        else:
            opt = self.opt_state.state_dict(names)
        return {"step": self.step, "params": dict(self.params),
                "opt_state": opt}

    def state_dict(self) -> Dict[str, Any]:
        """{"step", "params", "opt_state"}: ints and named tensors, the
        split ones gathered whole (a collective over the model ranks)."""
        tree = self._local_state_dict()
        return tree if self.split is None else gather_params(tree,
                                                             *self.split)

    def sharded_state_dict(self) -> Dict[str, Any]:
        """`state_dict` with the split tensors this rank's slices, as
        `DTensor`s that carry their offsets."""
        tree = self._local_state_dict()
        return tree if self.split is None else sharded_tensors(tree,
                                                               *self.split)

    def load_state_dict(self, tree: Dict[str, Any]) -> None:
        """Copy a checkpoint of the same precision into this state (whole
        tensors; a split state takes its slices)."""
        if set(tree) != {"step", "params", "opt_state"}:
            raise ValueError(f"state: checkpoint keys {sorted(tree)}")
        if self.split is not None:
            tree = slice_params(tree, *self.split)
        names = self.opt_names
        self.step = restore(self.step, tree["step"], "step")
        restore(self.params, tree["params"], "params")
        opt = tree["opt_state"]
        if self.o2:
            if set(opt) != {"master", "inner"}:
                raise ValueError(f"opt_state: checkpoint keys {sorted(opt)}"
                                 ", expected an O2 state's")
            restore(self.opt_state["master"], opt["master"], "master")
            self.opt_state["inner"].load_state_dict(opt["inner"], names)
        else:
            self.opt_state.load_state_dict(opt, names)
        self.in_update = False
        write_compute(self)


def write_compute(state: TrainState,
                  names: Optional[List[str]] = None) -> None:
    """Write the fp32 params `names` (default: all) into the bf16
    model's (bf16 precision)."""
    if state.compute is not None:
        names = list(state.params) if names is None else names
        with torch.no_grad():
            torch._foreach_copy_([state.compute[n] for n in names],
                                 [state.params[n] for n in names])


def _trainable(tx, params: Dict[str, torch.Tensor]) -> Optional[List[str]]:
    names = trainable_names(tx, list(params))
    return None if len(names) == len(params) else names


def _split(model: nn.Module):
    """({name: split dim}, ModelShard) where `shard_params` split the
    model over more than one model rank, else None."""
    shard = shard_of(model)
    splits = getattr(model, "model_splits", None)
    if shard is None or shard.size == 1 or not splits:
        return None
    return dict(splits), shard


def create_train_state(model: nn.Module, tx,
                       compute: Optional[nn.Module] = None) -> TrainState:
    """State over `model`'s fp32 parameters. With `compute` (the same
    model built in bf16), forward and backward run there: its parameters
    are written from the fp32 ones now, and the trainable ones after
    each update."""
    params = dict(model.named_parameters())
    trainable = _trainable(tx, params)
    state = TrainState(step=0, params=params,
                       opt_state=tx.init([params[n] for n in
                                          trainable or params]),
                       compute=(None if compute is None
                                else dict(compute.named_parameters())),
                       trainable=trainable, split=_split(model))
    write_compute(state)
    return state


def create_o2_train_state(model: nn.Module, tx,
                          master: Optional[nn.Module] = None) -> TrainState:
    """O2 state over `model`'s parameters, stored in the dtype the model
    was built in. The master copy is their fp32 value, or `master`'s
    parameters (the same model in fp32) cloned, which are then written
    into the stored ones."""
    params = dict(model.named_parameters())
    source = params if master is None else dict(master.named_parameters())
    fp32 = {k: p.detach().float().clone() for k, p in source.items()}
    with torch.no_grad():
        torch._foreach_copy_(list(params.values()), list(fp32.values()))
    trainable = _trainable(tx, params)
    return TrainState(step=0, params=params,
                      opt_state={"master": fp32, "inner": tx.init(
                          [fp32[n] for n in trainable or fp32])},
                      trainable=trainable, split=_split(model))


def cast_floats(batch: Dict[str, torch.Tensor], dtype: torch.dtype):
    return {k: (v.to(dtype) if v is not None and v.is_floating_point() else v)
            for k, v in batch.items()}


def _step_generator(device, seed: int, step: int) -> torch.Generator:
    """The dropout generator of one step, seeded from (seed, step) as the
    JAX step folds the step into its key."""
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + step) % (1 << 63))


def _update(state: TrainState, tx, grads) -> None:
    """The optimizer's in-place update of `state` from fp32 grads."""
    state.in_update = True
    names = state.opt_names
    # An unsplit state calls `apply(grads, state, master)` as any
    # optimizer takes it; a split one adds which tensors are split.
    split = split_flags(state)
    kw = {} if split is None else {"split": split}
    with record_function("train_step.optimizer"), torch.no_grad():
        if state.o2:
            master = [state.opt_state["master"][n] for n in names]
            tx.apply(grads, state.opt_state["inner"], master, **kw)
            torch._foreach_copy_([state.params[n] for n in names], master)
        else:
            tx.apply(grads, state.opt_state,
                     [state.params[n] for n in names], **kw)
            write_compute(state, names)
    state.in_update = False


def split_flags(state: TrainState):
    """(flags, group): for each tensor the optimizer is handed, whether
    the model ranks of `group` split it; None for an unsplit state."""
    if state.split is None:
        return None
    splits, shard = state.split
    return [n in splits for n in state.opt_names], shard.group


def global_batch(mesh, batch: Dict[str, Any]):
    """The context in which `batch`, this rank's rows, is a part of the
    global batch over the mesh's `data` axis (a null context without a
    mesh)."""
    if mesh is None:
        return contextlib.nullcontext()
    return data_parallel(mesh, next(v for v in batch.values()
                                    if v is not None).shape[0])


def make_train_step(loss_fn: Callable, tx,
                    compute_dtype: torch.dtype = torch.bfloat16,
                    guard_nonfinite: bool = True, mesh=None) -> Callable:
    """loss_fn(batch, generator) -> (loss, aux), over the model whose
    parameters the state holds (its `compute` copy where it has one).
    Returns step(state, batch, seed) -> (state, metrics): metrics hold
    loss, grad_norm (global, fp32) and aux as device tensors, and
    skipped as an int. mesh: data-parallel over its `data` axis (see
    the module note)."""

    buffers: List[GradientBuffer] = []     # the mesh's, made at step 0

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             seed: int = 0) -> Tuple[TrainState, Dict[str, Any]]:
        source = state.compute or state.params
        model_params = [source[n] for n in state.opt_names]
        for p in model_params:
            p.grad = None
        generator = _step_generator(model_params[0].device, seed, state.step)
        with global_batch(mesh, batch):
            with record_function("train_step.forward"):
                loss, aux = loss_fn(cast_floats(batch, compute_dtype),
                                    generator)
            with record_function("train_step.backward"):
                loss.backward()
        with record_function("train_step.backward"):
            if mesh is None:
                grads = [torch.zeros_like(p, dtype=torch.float32)
                         if p.grad is None else p.grad.float()
                         for p in model_params]
            else:
                if not buffers or not buffers[0].fits(model_params):
                    buffers[:] = [GradientBuffer(model_params)]
                grads = buffers[0].fill([p.grad for p in model_params])
                buffers[0].all_reduce(axis_group(mesh, DATA_AXIS))
            for p in model_params:
                p.grad = None
            grad_norm = torch.linalg.vector_norm(whole_norms(
                torch.stack(torch._foreach_norm(grads)), split_flags(state)))
        good = True
        if guard_nonfinite:
            with record_function("train_step.guard"):
                good = bool(torch.isfinite(loss) & torch.isfinite(grad_norm))
        if good:
            _update(state, tx, grads)
        metrics = {"loss": loss.detach(), "grad_norm": grad_norm,
                   "skipped": int(not good),
                   **{k: v.detach() for k, v in aux.items()}}
        state.step += 1
        return state, metrics

    return step


def make_eval_step(loss_fn: Callable,
                   compute_dtype: torch.dtype = torch.bfloat16,
                   mesh=None) -> Callable:
    """eval_step(batch) -> {"loss", **aux}: the deterministic loss under
    the train step's precision; with a mesh, the global batch's."""

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        with global_batch(mesh, batch):
            loss, aux = loss_fn(cast_floats(batch, compute_dtype), None)
        return {"loss": loss, **aux}

    return eval_step
