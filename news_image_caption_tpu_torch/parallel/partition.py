"""Tensor parallelism: the partition rules and each rank's slices.

Counterpart of `news_image_caption_tpu/parallel/partition.py`. The
reference's rules are regexes over flax paths with a `PartitionSpec`
each, the first match winning and anything unmatched replicated; XLA
then partitions the program and inserts the collectives. Here the rules
are the same regexes over the port's parameter names, which mirror the
flax tree (`layers.0.image_attn.k_proj.kernel`), with the spec as a
tuple of axis names a dim. Kernels are (in, out) in both packages, so
each rule splits the dim the reference's splits and no leaf is
transposed:

- attention: q/k/v column-parallel (the output dim, so the heads) with
  their biases, `out_proj` row-parallel (the input dim);
- FFN: `fc1` column-parallel with its bias and weight-norm scale, `fc2`
  row-parallel;
- the adaptive embedding's band tables `embed_i` by rows and the untied
  softmax tables `untied_head` / `untied_tail_i` by the vocabulary dim.

`shard_params(module, mesh)` keeps this rank's slice of every parameter
the rules split and gives every submodule the rank's `ModelShard` (its
coordinate and the size of the `model` axis, the axis's process group
and the mesh), by which the modules run their split forms with explicit
collectives (`ops/linear.py`, `ops/attention.py`, `ops/adaptive.py`,
`models/decoder_flattened.py`). A dim that the axis does not divide
raises ValueError naming the parameter, as JAX's `device_put` refuses
such a leaf: the flagship's last band table (30265 rows) splits over no
model axis above 1, in either package. `gather_params` puts the whole
tensors back together (the single-file checkpoints), `slice_params`
takes the rank's slices of whole ones (a load), and
`sharded_tensors` wraps the slices with their offsets for
`torch.distributed.checkpoint`.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from news_image_caption_tpu_torch.parallel.mesh import (MODEL_AXIS,
                                                        axis_group,
                                                        axis_index,
                                                        axis_size)

Spec = Tuple[Optional[str], ...]

# (name regex, spec): first match wins; the reference's DEFAULT_RULES.
DEFAULT_RULES: List[Tuple[str, Spec]] = [
    # Attention: column-parallel QKV, row-parallel output.
    (r"(q_proj|k_proj|v_proj)\.kernel$", (None, MODEL_AXIS)),
    (r"(q_proj|k_proj|v_proj)\.bias$", (MODEL_AXIS,)),
    (r"out_proj\.kernel$", (MODEL_AXIS, None)),
    # FFN: column-parallel fc1, row-parallel fc2.
    (r"fc1\.kernel$", (None, MODEL_AXIS)),
    (r"fc1\.(bias|scale)$", (MODEL_AXIS,)),
    (r"fc2\.kernel$", (MODEL_AXIS, None)),
    # Adaptive embedding / softmax band tables: vocab-sharded.
    (r"embed_\d+$", (MODEL_AXIS, None)),
    (r"untied_(head|tail_\d+)$", (None, MODEL_AXIS)),
]


def spec_for_name(name: str, rules=None) -> Spec:
    """The spec of the first rule matching the parameter name, () (all
    replicated) where none does."""
    for pattern, spec in (rules or DEFAULT_RULES):
        if re.search(pattern, name):
            return spec
    return ()


def split_dim(spec: Spec, ndim: int) -> Optional[int]:
    """The dim a spec splits over the `model` axis (the spec cut to the
    tensor's rank, as the reference cuts it), or None."""
    spec = spec[:ndim]
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


@dataclass(frozen=True)
class ModelShard:
    """This rank's place on the `model` axis: coordinate `index` of
    `size`, the axis's process group (None with one rank) and the mesh
    (None where made without one, as on the meta device)."""
    index: int
    size: int
    group: Any = None
    mesh: Any = None

    def part(self, n_local: int) -> slice:
        """This rank's slice of a dim whose slices are n_local long."""
        return slice(self.index * n_local, (self.index + 1) * n_local)


def model_shard(mesh) -> ModelShard:
    """The rank's `ModelShard` on `mesh`."""
    size = axis_size(mesh, MODEL_AXIS)
    return ModelShard(axis_index(mesh, MODEL_AXIS), size,
                      axis_group(mesh, MODEL_AXIS) if size > 1 else None,
                      mesh)


def shard_of(module: nn.Module) -> Optional[ModelShard]:
    """The `ModelShard` `shard_params` gave the module, or None (read
    from the instance's own attributes: no `nn.Module.__getattr__` miss
    on the decode step's hot path)."""
    return module.__dict__.get("model_shard")


def is_split(module: nn.Module) -> bool:
    """Whether the module runs split over more than one rank."""
    shard = shard_of(module)
    return shard is not None and shard.size > 1


def _owners() -> tuple:
    """The module types that run a split parameter: the linears, the
    adaptive embedding and the adaptive softmax."""
    from news_image_caption_tpu_torch.ops.adaptive import (AdaptiveEmbedding,
                                                           AdaptiveSoftmax)
    from news_image_caption_tpu_torch.ops.linear import (Dense, GehringLinear,
                                                         XavierLinear)
    return (XavierLinear, GehringLinear, Dense, AdaptiveEmbedding,
            AdaptiveSoftmax)


def plan_splits(module: nn.Module, size: int, rules=None) -> Dict[str, int]:
    """{parameter name: split dim} of the rules over the module; the
    ValueError of the first dim the axis does not divide."""
    splits = {}
    for name, p in module.named_parameters():
        dim = split_dim(spec_for_name(name, rules), p.dim())
        if dim is None:
            continue
        if p.shape[dim] % size:
            raise ValueError(
                f"{name} of shape {tuple(p.shape)} cannot be split over the "
                f"model axis: the global size of its dimension {dim} should "
                f"be divisible by {size}, but it is equal to {p.shape[dim]}")
        splits[name] = dim
    return splits


def shard_params(module: nn.Module, mesh_or_shard,
                 rules=None) -> Dict[str, int]:
    """Keep this rank's slice of every parameter the rules split and give
    every submodule the rank's `ModelShard` (`shard_of`); returns
    {name: split dim}, which the module keeps as `model_splits`. Every
    rank calls it with the same whole parameters. ValueError, before
    anything changes, for a dim the `model` axis does not divide;
    NotImplementedError, over more than one rank, for a split parameter
    of a module that has no split form. With an axis of one nothing is
    sliced and the modules run their split forms at one rank."""
    shard = (mesh_or_shard if isinstance(mesh_or_shard, ModelShard)
             else model_shard(mesh_or_shard))
    splits = plan_splits(module, shard.size, rules)
    owners = _owners()
    for name in splits if shard.size > 1 else ():
        owner = module.get_submodule(name.rpartition(".")[0])
        if not isinstance(owner, owners):
            raise NotImplementedError(
                f"{name}: the rules split it, but {type(owner).__name__} has "
                "no split form")
    if shard.size > 1:
        for name, dim in splits.items():
            path, _, attr = name.rpartition(".")
            owner = module.get_submodule(path)
            p = getattr(owner, attr)
            n = p.shape[dim] // shard.size
            local = p.detach().narrow(dim, shard.index * n, n).clone()
            setattr(owner, attr, nn.Parameter(local,
                                              requires_grad=p.requires_grad))
    for name, dim in splits.items():
        path, _, attr = name.rpartition(".")
        if attr == "kernel":
            module.get_submodule(path).split = ("column" if dim == 1
                                                else "row")
    for m in module.modules():
        m.model_shard = shard
    module.model_splits = dict(splits)
    return dict(splits)


def _splits_of(tree: Any, splits: Dict[str, int], fn, key: str = "") -> Any:
    """tree with fn(tensor, dim) applied to every tensor whose key names a
    split parameter (params, the O2 master, the optimizer's moments)."""
    if isinstance(tree, dict):
        return {k: _splits_of(v, splits, fn, k) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and key in splits:
        return fn(tree, splits[key])
    return tree


def gather_params(tree: Any, splits: Dict[str, int],
                  shard: ModelShard) -> Any:
    """The tree with every split tensor gathered whole over the `model`
    axis (every rank of it calls); others as they are."""
    if shard.size == 1:
        return tree

    def gather(t, dim):
        parts = [torch.empty_like(t) for _ in range(shard.size)]
        dist.all_gather(parts, t.detach().contiguous(), group=shard.group)
        return torch.cat(parts, dim=dim)

    return _splits_of(tree, splits, gather)


def slice_params(tree: Any, splits: Dict[str, int],
                 shard: ModelShard) -> Any:
    """The tree with every split tensor cut to this rank's slice."""
    if shard.size == 1:
        return tree
    return _splits_of(tree, splits, lambda t, dim: t.narrow(
        dim, shard.index * (t.shape[dim] // shard.size),
        t.shape[dim] // shard.size))


def sharded_tensors(tree: Any, splits: Dict[str, int],
                    shard: ModelShard) -> Any:
    """The tree with every split tensor a `DTensor` over the shard's mesh,
    sliced along the `model` axis and replicated along the others, so
    that `torch.distributed.checkpoint` writes each slice with its
    offsets (and each slice once)."""
    if shard.size == 1:
        return tree
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = shard.mesh

    def wrap(t, dim):
        placements = [Shard(dim) if name == MODEL_AXIS else Replicate()
                      for name in mesh.mesh_dim_names]
        return DTensor.from_local(t, mesh, placements, run_check=False)

    return _splits_of(tree, splits, wrap)
