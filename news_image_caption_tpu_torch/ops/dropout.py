"""Elementwise dropout drawn from an explicit generator.

Counterpart of `news_image_caption_tpu/ops/dropout.py`. A training
forward hands one `torch.Generator` (on the tensors' device) down the
model; `generator=None` means evaluation, where dropout is the
identity. The bits differ from JAX's (another generator), the law is
the same: keep with probability 1 - rate, kept values scaled by
1 / (1 - rate). `remat` checkpoints a layer with its draws replayed.

Under data parallelism a rank holds rows [first, first + n) of a global
batch of `total` rows (`parallel/collectives.py::global_rows`, entered
by the data-parallel train and eval steps). A batched draw is then made
at the global batch's shape from the step's generator, seeded alike on
every rank, and the rank keeps its rows, so the masks, and the
generator's state after them, are the single process's. `row_offset` is
the first row, which the flash kernels add to their row index in the
dropout hash.
"""

from __future__ import annotations

from typing import Optional

import torch

from news_image_caption_tpu_torch.parallel.collectives import batch_rows


def row_offset() -> int:
    """The first global row of this process's batch (0 outside
    `global_rows`)."""
    rows = batch_rows()
    return 0 if rows is None else rows.first


def _uniform(shape, generator, device, batched: bool,
             part=None) -> torch.Tensor:
    if part is not None and part[1] is not None and part[1].size > 1:
        dim, shard = part
        dim %= len(shape)
        whole = list(shape)
        whole[dim] *= shard.size
        u = _uniform(whole, generator, device, batched)
        return u.narrow(dim, shard.index * shape[dim], shape[dim])
    rows = batch_rows()
    if rows is None or not batched:
        return torch.rand(shape, generator=generator, device=device)
    first, n, total = rows.first, rows.n, rows.total
    if shape[0] % n:
        raise ValueError(f"dropout over {tuple(shape)}: dim 0 is not a "
                         f"multiple of the batch's {n} rows")
    per = shape[0] // n
    full = torch.rand((total * per,) + tuple(shape[1:]), generator=generator,
                      device=device)
    return full[first * per:(first + n) * per]


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator],
            batched: bool = True, part=None) -> torch.Tensor:
    """x dropped at `rate`. batched: dim 0 runs over the batch's rows
    (a multiple of them where rows are flattened batch-major); false for
    a tensor shared by every row (a module's taps). part: (dim, shard)
    for x a model rank's slice along dim of a split activation."""
    if rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = _uniform(x.shape, generator, x.device, batched, part) < keep
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
