"""Collectives over a mesh axis, differentiable, and the data-parallel
reductions of a loss.

JAX's `lax.ppermute`, `lax.psum` and `lax.all_gather` have transpose
rules; these are their counterparts as `torch.autograd.Function`s over
`torch.distributed`, so ring attention and the pipeline are written as
the reference writes them and autograd runs their backward passes:

- `ppermute(xs, mesh, axis, perm)` sends each tensor of `xs` from axis
  coordinate i to j for every (i, j) in `perm` (one
  `batch_isend_irecv`, so a ring of two, where the next rank is the
  previous one, cannot deadlock); a rank no pair sends to gets zeros.
  Its backward sends the gradients along the inverse permutation.
- `psum(x, mesh, axis)` and `all_gather(x, mesh, axis, dim)` give every
  rank of the axis the same (replicated) value. Their backward takes
  the rank's cotangent as the replicated output's, as JAX transposes a
  replicated output: psum's passes it through, all_gather's keeps the
  rank's slice.

`global_rows(first, n, total, group, mesh)` says, for the code inside
it, that this process's batch is rows [first, first + n) of a global
batch of `total` rows split over the data ranks of `group` on `mesh`;
`data_parallel(mesh, rows)` enters it for a rank that placed its rows
over the mesh's `data` axis (the data-parallel train and eval steps).
`batch_rows()` reads it: dropout draws the global batch's masks and
keeps the rank's rows (`ops/dropout.py`), and `global_sums` makes a
loss of the global batch on every data rank: a loss family computes its
sums and counts, calls `global_sums` on them and forms its mean from
the results. The values are all-reduced over the data ranks and each
rank's gradient flows to its own terms only (sum + (x - x.detach())),
so the data ranks' gradients add up to the global loss's; outside
`global_rows`, or without a group, the tensors come back as they are.
`GradientBuffer` holds a step's fp32 gradients as views of one flat
buffer, which the data ranks sum with one all-reduce in place.

The `model` axis (tensor parallelism, `parallel/partition.py`) takes a
`ModelShard` rather than the mesh: `copy_in` (identity forward, psum
backward) where a replicated activation enters a rank's split
computation, `reduce_out` (psum forward, identity backward) where the
ranks' partial sums leave it, `gather_out` for a split output that must
be whole, `axis_max` and `vocab_gather` for the split logsumexps and the
top-k merge, and `whole_norms` for the per-tensor and global gradient
norms of split tensors. With those in place a replicated
parameter's gradient comes out the same on every model rank, so the
train step sums gradients over the `data` axis alone.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from news_image_caption_tpu_torch.parallel.mesh import (DATA_AXIS,
                                                        axis_group,
                                                        axis_index,
                                                        axis_ranks,
                                                        axis_size)


def _exchange(xs: Sequence[torch.Tensor], ranks: List[int], me: int,
              perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """One hop of `perm` (axis coordinates) for every tensor of xs; bool
    tensors travel as uint8."""
    dst = [j for i, j in perm if i == me]
    src = [i for i, j in perm if j == me]
    bufs, ops = [], []
    for x in xs:
        wire = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
        buf = torch.zeros_like(wire)
        for j in dst:
            ops.append(dist.P2POp(dist.isend, wire, ranks[j]))
        for i in src:
            ops.append(dist.P2POp(dist.irecv, buf, ranks[i]))
        bufs.append(buf)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return [b.to(x.dtype) if x.dtype == torch.bool else b
            for b, x in zip(bufs, xs)]


class _PPermute(torch.autograd.Function):

    @staticmethod
    def forward(ctx, ranks, me, perm, *xs):
        ctx.args = (ranks, me, perm)
        ctx.floats = [x.is_floating_point() for x in xs]
        outs = _exchange(xs, ranks, me, perm)
        ctx.mark_non_differentiable(*[o for o, f in zip(outs, ctx.floats)
                                      if not f])
        ctx.likes = [torch.empty((0,), dtype=o.dtype, device=o.device)
                     for o in outs]
        ctx.shapes = [o.shape for o in outs]
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        ranks, me, perm = ctx.args
        back = [(j, i) for i, j in perm]
        moved = [torch.zeros(s, dtype=like.dtype, device=like.device)
                 if g is None else g
                 for g, s, like, f in zip(grads, ctx.shapes, ctx.likes,
                                          ctx.floats) if f]
        moved = iter(_exchange(moved, ranks, me, back))
        return (None, None, None) + tuple(next(moved) if f else None
                                          for f in ctx.floats)


def ppermute(xs: Sequence[torch.Tensor], mesh, axis_name: str,
             perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """xs moved along `perm`, pairs (i, j) of coordinates on the axis."""
    if not perm:
        return list(xs)
    ranks = axis_ranks(mesh, axis_name)
    return list(_PPermute.apply(ranks, axis_index(mesh, axis_name),
                                tuple(perm), *xs))


class _PSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, group, x):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return None, g


def psum(x: torch.Tensor, mesh, axis_name: str) -> torch.Tensor:
    """The sum of x over the axis, on every rank of it."""
    if axis_size(mesh, axis_name) == 1:
        return x
    return _PSum.apply(axis_group(mesh, axis_name), x)


class _AllGather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, group, n, index, dim, x):
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        ctx.args = (index, dim, x.shape[dim])
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        index, dim, size = ctx.args
        return None, None, None, None, g.narrow(dim, index * size, size)


def all_gather(x: torch.Tensor, mesh, axis_name: str, dim: int
               ) -> torch.Tensor:
    """The axis's shards of x concatenated along `dim` in coordinate
    order, on every rank of it."""
    n = axis_size(mesh, axis_name)
    if n == 1:
        return x
    return _AllGather.apply(axis_group(mesh, axis_name), n,
                            axis_index(mesh, axis_name), dim, x)


class _CopyIn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return None, g


def copy_in(x: torch.Tensor, shard) -> torch.Tensor:
    """x entering the model ranks' split computation: the identity, its
    gradient summed over the `model` axis (each rank's part of the
    gradient of a replicated input). `shard`: a `parallel/partition.py::
    ModelShard`, or None."""
    if shard is None or shard.size == 1:
        return x
    return _CopyIn.apply(shard.group, x)


def reduce_out(x: torch.Tensor, shard) -> torch.Tensor:
    """The sum of the model ranks' partial x, replicated: psum forward,
    identity backward (the replicated output's gradient is each rank's
    part's)."""
    if shard is None or shard.size == 1:
        return x
    return _PSum.apply(shard.group, x)


def gather_out(x: torch.Tensor, shard, dim: int) -> torch.Tensor:
    """The model ranks' slices of x concatenated along `dim` in rank
    order, replicated; its backward keeps the rank's slice."""
    if shard is None or shard.size == 1:
        return x
    return _AllGather.apply(shard.group, shard.size, shard.index, dim, x)


def axis_max(x: torch.Tensor, shard) -> torch.Tensor:
    """The elementwise max of x over the model ranks (no gradient)."""
    if shard is None or shard.size == 1:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=shard.group)
    return out


def vocab_gather(x: torch.Tensor, shard) -> torch.Tensor:
    """[size, *x.shape]: every model rank's x in rank order (no
    gradient): the top-k merge's per-rank candidates and logsumexps."""
    if shard is None or shard.size == 1:
        return x[None]
    parts = [torch.empty_like(x) for _ in range(shard.size)]
    dist.all_gather(parts, x.contiguous(), group=shard.group)
    return torch.stack(parts)


def whole_norms(norms: torch.Tensor, split=None) -> torch.Tensor:
    """Per-tensor norms [n] made whole. split: None, or (flags, group),
    flags saying for each of the n tensors whether the model ranks of
    `group` split it: a split tensor's norm is the square root of the
    sum over the ranks of their squared norms, a replicated one's its
    own."""
    if split is None or not any(split[0]):
        return norms
    flags, group = split
    mask = torch.tensor(list(flags), device=norms.device)
    part = torch.where(mask, norms.float() * norms.float(), 0.0)
    dist.all_reduce(part, group=group)
    return torch.where(mask, torch.sqrt(part), norms.float()).to(norms.dtype)


ALIGN_ELEMS = 128           # 512 bytes: a fresh allocation's alignment


class GradientBuffer:
    """fp32 gradients as views of one flat buffer, laid out once for a
    list of parameters, so the data ranks sum them with one all-reduce
    in place: no gather into a bucket and no copy back. Each view starts
    at a multiple of ALIGN_ELEMS, aligned as a tensor of its own would
    be, so the kernels that read it take the paths they take on one."""

    def __init__(self, params: Sequence[torch.Tensor]):
        self.shapes = [tuple(p.shape) for p in params]
        offsets, n = [], 0
        for p in params:
            offsets.append(n)
            n += -(-p.numel() // ALIGN_ELEMS) * ALIGN_ELEMS
        self.flat = torch.zeros(n, dtype=torch.float32,
                                device=params[0].device)
        self.views = [self.flat[o:o + p.numel()].view(p.shape)
                      for o, p in zip(offsets, params)]

    def fits(self, params: Sequence[torch.Tensor]) -> bool:
        """Whether the buffer was laid out for `params`' shapes."""
        return (self.shapes == [tuple(p.shape) for p in params]
                and params[0].device == self.flat.device)

    def fill(self, grads: Sequence[Optional[torch.Tensor]]
             ) -> List[torch.Tensor]:
        """The views holding `grads` in fp32 (zeros for None)."""
        have = [(v, g) for v, g in zip(self.views, grads) if g is not None]
        none = [v for v, g in zip(self.views, grads) if g is None]
        if have:
            torch._foreach_copy_([v for v, _ in have], [g for _, g in have])
        if none:
            torch._foreach_zero_(none)
        return self.views

    def all_reduce(self, group) -> None:
        """Sum the buffer over `group` in place."""
        dist.all_reduce(self.flat, group=group)


@dataclass(frozen=True)
class GlobalRows:
    """This process's batch as a part of a global one: rows [first,
    first + n) of `total`, over the data ranks of `group` (None: nothing
    to reduce) on `mesh`."""
    first: int
    n: int
    total: int
    group: Any = None
    mesh: Any = None


_ROWS: List[GlobalRows] = []


@contextlib.contextmanager
def global_rows(first: int, n: int, total: int, group=None, mesh=None):
    """Within: this process's batch is rows [first, first + n) of
    `total`, split over the data ranks of `group` on `mesh`."""
    _ROWS.append(GlobalRows(first, n, total, group, mesh))
    try:
        yield
    finally:
        _ROWS.pop()


def data_parallel(mesh, rows: int):
    """`global_rows` of a rank that holds `rows` rows of the global batch
    placed over the mesh's `data` axis (`distributed.place_local`)."""
    return global_rows(axis_index(mesh, DATA_AXIS) * rows, rows,
                       axis_size(mesh, DATA_AXIS) * rows,
                       axis_group(mesh, DATA_AXIS), mesh)


def batch_rows() -> Optional[GlobalRows]:
    """The innermost `global_rows` in force, None outside them."""
    return _ROWS[-1] if _ROWS else None


def global_sums(*xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Each x summed over the data ranks, in x's dtype (the sum taken in
    fp64, exact for counts), its gradient flowing to this rank's x;
    outside `global_rows` or without its group, xs as they are."""
    rows = batch_rows()
    if rows is None or rows.group is None:
        return xs
    flat = torch.cat([x.detach().reshape(-1).to(torch.float64) for x in xs])
    dist.all_reduce(flat, group=rows.group)
    out, at = [], 0
    for x in xs:
        total = flat[at:at + x.numel()].view(x.shape).to(x.dtype)
        at += x.numel()
        out.append(total + (x - x.detach()) if x.requires_grad else total)
    return tuple(out)


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of x's elements over the data ranks' x (x.mean() where
    `global_sums` has nothing to reduce)."""
    rows = batch_rows()
    if rows is None or rows.group is None:
        return x.mean()
    total, count = global_sums(x.sum(), torch.tensor(float(x.numel()),
                                                     device=x.device))
    return total / count
