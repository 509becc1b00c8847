"""Ring attention: exact sequence-parallel attention over a mesh axis.

Counterpart of `news_image_caption_tpu/parallel/ring.py`. Each rank of
the `context` axis holds a slice of the sequence of Q, K and V and of the
key mask (`parallel/sequence.py::shard_article_axis`); the K / V / mask
blocks rotate around the axis (`parallel/collectives.py::ppermute`, one
hop a step) and each rank folds every block into its queries' output by
the reference's online-softmax recurrence, in fp32: running max m,
normalizer l and unnormalized output o, rescaled by exp(m - m_new) (0
while m is still -inf), masked keys at the dense path's -1e9 rather than
-inf, so a fully padded row averages uniformly and no NaN appears. The
result is dense attention's up to fp32 reassociation, and autograd runs
the backward through the rotations.

The products are `torch.einsum`, as the reference computes them in XLA
outside any Pallas kernel. Layout as `models/roberta.py::RobertaLayer`
with a ring mesh: q / k / v [B_loc, S_loc, heads, head_dim], pad_mask
[B_loc, S_loc] True at keys to attend.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from news_image_caption_tpu_torch.parallel.collectives import ppermute
from news_image_caption_tpu_torch.parallel.mesh import (CONTEXT_AXIS,
                                                        axis_size)

_MASK_FILL = -1e9   # the dense path's fill (models/roberta.py)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   pad_mask: torch.Tensor, mesh, *,
                   axis_name: str = CONTEXT_AXIS,
                   scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q kᵀ scale, keys masked) v over the whole sequence, for
    this rank's slice of queries, in v's dtype. The rows are this rank's
    already, so no batch axis is named; ValueError where the mesh has no
    `axis_name`."""
    if axis_name not in mesh.mesh_dim_names:
        raise ValueError(f"mesh {mesh.mesh_dim_names} has no axis "
                         f"{axis_name!r}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    n = axis_size(mesh, axis_name)
    B, S, H, D = q.shape
    in_dtype = v.dtype
    qf = q.float()
    m = torch.full((B, H, S), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=q.device)
    o = torch.zeros((B, S, H, D), dtype=torch.float32, device=q.device)
    perm = [(j, (j + 1) % n) for j in range(n)]
    for step in range(n):
        s = torch.einsum("bthd,bshd->bhts", qf, k.float()) * scale
        s = torch.where(pad_mask[:, None, None, :], s, _MASK_FILL)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.where(torch.isinf(m), 0.0, torch.exp(m - m_new))
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhts,bshd->bthd", p.to(in_dtype).float(),
                          v.float())
        o = o * alpha.transpose(1, 2)[..., None] + pv
        m = m_new
        if step < n - 1:
            k, v, pad_mask = ppermute((k, v, pad_mask), mesh, axis_name,
                                      perm)
    return (o / l.transpose(1, 2)[..., None]).to(in_dtype)


def dense_reference(q, k, v, pad_mask, scale=None) -> torch.Tensor:
    """The unsharded computation ring_attention reproduces (the
    encoder's dense attention)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    s = torch.where(pad_mask[:, None, None, :], s, _MASK_FILL)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bshd->bthd", p.float(), v.float()).to(v.dtype)
