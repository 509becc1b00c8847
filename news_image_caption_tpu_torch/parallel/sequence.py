"""Sequence (context) parallelism: a rank's share of the article axis.

Counterpart of `news_image_caption_tpu/parallel/sequence.py`. JAX
constrains a global [B, S, ...] array to shard S over the `context`
axis; here a rank holds its rows of the batch with the whole sequence,
and `shard_article_axis` keeps its S / context slice (the slice the JAX
device at its coordinate holds), `replicate_sequence` gathers the slices
back. Both are the identity on a mesh without a `context` axis. Ring
attention (`parallel/ring.py`) runs on the slices.
"""

from __future__ import annotations

import torch

from news_image_caption_tpu_torch.parallel.collectives import all_gather
from news_image_caption_tpu_torch.parallel.mesh import (CONTEXT_AXIS,
                                                        axis_index,
                                                        axis_size)


def shard_article_axis(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's slice of [B, S, ...] along S (dim 1); ValueError where
    S does not split evenly over the context ranks."""
    if CONTEXT_AXIS not in mesh.mesh_dim_names:
        return x
    n = axis_size(mesh, CONTEXT_AXIS)
    S = x.shape[1]
    if S % n:
        raise ValueError(f"sequence length {S} not divisible by "
                         f"{CONTEXT_AXIS}={n}")
    return x.narrow(1, axis_index(mesh, CONTEXT_AXIS) * (S // n), S // n)


def replicate_sequence(x: torch.Tensor, mesh) -> torch.Tensor:
    """The whole sequence again from every rank's slice (dim 1)."""
    if CONTEXT_AXIS not in mesh.mesh_dim_names:
        return x
    return all_gather(x, mesh, CONTEXT_AXIS, 1)
