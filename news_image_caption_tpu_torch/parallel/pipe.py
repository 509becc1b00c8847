"""Pipeline parallelism: the GPipe fill-drain schedule over a mesh axis.

Counterpart of `news_image_caption_tpu/parallel/pipe.py`. A stack of L
shape-homogeneous layers is cut into P stages along the `pipe` axis and
each rank holds only its stage's L / P layers (`stage_layers` and
`stack_layers` with the mesh take only those: the memory the reference
saves by its `in_specs`). The batch is cut into M microbatches and the
schedule is the reference's: M + P - 1 ticks; at tick t stage 0 feeds
microbatch t (the last one again while draining; that lane is never
committed), every stage applies its layers to what it holds, stage
P - 1 commits
microbatch t - (P - 1), and every stage hands its result to the next in
one `ppermute` hop. Bubble lanes compute on zeros and are never
committed, so outputs and, through autograd, gradients are those of the
sequential loop. The committed outputs are summed over the axis
(`psum`), so every rank ends with them; bool leaves ride as int8, as in
the reference, and come back as int8.

The carry is a pytree of [B_loc, ...] tensors, the rank's rows (its
`data` slice); `stage_fn(layer, carry) -> carry` applies one layer (its
parameters, or the layer's module), so side inputs such as the
encoder's pad mask ride along.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch
from torch.utils._pytree import (tree_flatten, tree_leaves, tree_map,
                                 tree_unflatten)

from news_image_caption_tpu_torch.parallel.collectives import (ppermute,
                                                               psum)
from news_image_caption_tpu_torch.parallel.mesh import (DATA_AXIS, PIPE_AXIS,
                                                        axis_index,
                                                        axis_size)

StageFn = Callable[[Any, Any], Any]


def stage_layers(layers: Sequence[Any], mesh=None,
                 axis_name: str = PIPE_AXIS) -> list:
    """This rank's stage of `layers`: with a mesh that has `axis_name`,
    layers [i L/P, (i + 1) L/P) of L (ValueError where L % P != 0), else
    all of them."""
    layers = list(layers)
    if mesh is not None and axis_name in mesh.mesh_dim_names:
        n_stage = axis_size(mesh, axis_name)
        if len(layers) % n_stage:
            raise ValueError(f"{len(layers)} layers not divisible by "
                             f"{axis_name}={n_stage} stages")
        per = len(layers) // n_stage
        i = axis_index(mesh, axis_name)
        layers = layers[i * per:(i + 1) * per]
    return layers


def stack_layers(layer_params: Sequence[Any], mesh=None,
                 axis_name: str = PIPE_AXIS) -> Any:
    """Per-layer parameter pytrees stacked along a new leading layer dim:
    this rank's stage of them (`stage_layers`)."""
    return tree_map(lambda *xs: torch.stack(xs, dim=0),
                    *stage_layers(layer_params, mesh, axis_name))


class _Tie(torch.autograd.Function):
    """out unchanged, with `ends` joined to its graph: the backward pass
    hands them zero gradients. Every hop's backward is a point-to-point
    exchange that the neighbour waits on, so every rank must run all of
    them, also those whose received value no later computation reads
    (stage 0's, and every stage's last)."""

    @staticmethod
    def forward(ctx, out, *ends):
        ctx.ends = [(e.shape, e.dtype, e.device) for e in ends]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g,) + tuple(torch.zeros(s, dtype=d, device=v)
                            for s, d, v in ctx.ends)


def _num(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int8) if x.dtype == torch.bool else x


def pipeline_apply(stage_fn: StageFn, stage_params: Any, carry: Any, *,
                   mesh, n_micro: int, axis_name: str = PIPE_AXIS,
                   batch_axis: Optional[str] = DATA_AXIS) -> Any:
    """This stage's layers applied in the pipeline to `carry`, the
    rank's rows; returns the carry after all L layers on every rank of
    the axis. stage_params: the stage's layers stacked (leading dim
    L / P, `stack_layers(..., mesh)`), or a list of them, one each
    (`stage_layers(..., mesh)`, such as the stage's modules); stage_fn
    takes one. The global batch (rows times the `batch_axis` size) must
    split into n_micro microbatches that split over `batch_axis`.
    Differentiable."""
    names = mesh.mesh_dim_names
    if axis_name not in names:
        raise ValueError(f"mesh {names} has no axis {axis_name!r}")
    n_stage, idx = axis_size(mesh, axis_name), axis_index(mesh, axis_name)
    rows = tree_leaves(carry)[0].shape[0]
    d = axis_size(mesh, batch_axis) if batch_axis in names else 1
    batch = rows * d
    if batch % n_micro:
        raise ValueError(f"batch {batch} not divisible by "
                         f"n_micro={n_micro}")
    if rows % n_micro:
        raise ValueError(
            f"microbatch {batch // n_micro} not divisible by "
            f"{batch_axis}={d} (batch {batch}, n_micro {n_micro})")
    micro = tree_map(lambda x: x.reshape((n_micro, rows // n_micro)
                                         + x.shape[1:]), carry)
    if isinstance(stage_params, list):
        layers = stage_params
    else:
        layers = [tree_map(lambda p, j=j: p[j], stage_params)
                  for j in range(tree_leaves(stage_params)[0].shape[0])]
    perm = [(i, i + 1) for i in range(n_stage - 1)]
    state = tree_map(lambda x: torch.zeros_like(x[0]), micro)
    committed, received = [], []
    for t in range(n_micro + n_stage - 1):
        h = (tree_map(lambda x: x[min(t, n_micro - 1)], micro) if idx == 0
             else state)
        for layer in layers:
            h = stage_fn(layer, h)
        if idx == n_stage - 1 and t >= n_stage - 1:
            committed.append(h)
        leaves, spec = tree_flatten(h)
        moved = ppermute(leaves, mesh, axis_name, perm)
        received += [m for m in moved if m.requires_grad]
        state = tree_unflatten(moved, spec)
    if idx == n_stage - 1:
        outs = tree_map(lambda *hs: torch.stack([_num(h) for h in hs]),
                        *committed)
    else:
        outs = tree_map(lambda x: torch.zeros_like(_num(x)), micro)
    if received:
        outs = tree_map(lambda o: _Tie.apply(o, *received)
                        if o.is_floating_point() else o, outs)
    outs = tree_map(lambda o: psum(o, mesh, axis_name), outs)
    return tree_map(lambda x: x.reshape((rows,) + x.shape[2:]), outs)
