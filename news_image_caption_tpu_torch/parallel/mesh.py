"""The rank mesh: data, model, context and pipe axes over the ranks.

Counterpart of `news_image_caption_tpu/parallel/mesh.py` (`MeshConfig`,
`make_mesh`, the axis names). A JAX mesh lays devices out as
`np.asarray(devices).reshape(shape)`; here one process drives one device
(`parallel/__init__.py`), so the mesh is a `torch.distributed.device_mesh.
DeviceMesh` over the ranks laid out the same way, row-major: rank r sits
where JAX's device r sits and holds the slice that device held. The axes
are the reference's, in its order, `data` and `model` always and
`context` and `pipe` only where larger than 1 (trailing singleton axes
are dropped, so a (data, model) mesh stays two-dimensional).

A process that has joined no process group gets a world of one: a group
of one rank made on a `HashStore`, gloo on the CPU and NCCL on the card
(`parallel/distributed.py::ensure_world`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
CONTEXT_AXIS = "context"
PIPE_AXIS = "pipe"


@dataclass(frozen=True)
class MeshConfig:
    data: int = -1      # -1: all remaining ranks
    model: int = 1
    context: int = 1    # sequence-parallel axis (parallel/ring.py)
    pipe: int = 1       # pipeline-parallel axis (parallel/pipe.py)


def mesh_layout(config: MeshConfig, n: int) -> Tuple[List[int], List[str]]:
    """(shape, axis names) of `config` over n ranks; ValueError where the
    product does not cover them."""
    model, context, pipe = config.model, config.context, config.pipe
    data = (config.data if config.data != -1
            else n // (model * context * pipe))
    if data * model * context * pipe != n:
        raise ValueError(f"mesh {data}x{model}x{context}x{pipe} does not "
                         f"cover {n} devices")
    shape, names = [data, model], [DATA_AXIS, MODEL_AXIS]
    if context > 1:
        shape.append(context)
        names.append(CONTEXT_AXIS)
    if pipe > 1:
        shape.append(pipe)
        names.append(PIPE_AXIS)
    return shape, names


def make_mesh(config: MeshConfig = MeshConfig(),
              device_type: Optional[str] = None):
    """The `DeviceMesh` of `config` over every rank of the world (every
    rank calls), its axes named as the reference's. device_type: "cuda"
    or "cpu"; default the card's where the world's backend is NCCL, else
    the CPU's."""
    from news_image_caption_tpu_torch.parallel.distributed import \
        ensure_world
    from torch.distributed.device_mesh import init_device_mesh
    if device_type is None:
        device_type = ("cuda" if dist.is_initialized()
                       and dist.get_backend() == "nccl" else "cpu")
    ensure_world(torch.device(device_type))
    shape, names = mesh_layout(config, dist.get_world_size())
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def axis_size(mesh, name: str) -> int:
    """The size of axis `name`, 1 where the mesh has no such axis."""
    names = mesh.mesh_dim_names
    return mesh.size(names.index(name)) if name in names else 1


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate along axis `name` (0 without the axis)."""
    names = mesh.mesh_dim_names
    return mesh.get_local_rank(name) if name in names else 0


def axis_ranks(mesh, name: str) -> List[int]:
    """The global ranks of this rank's line along axis `name`, in
    coordinate order."""
    names = mesh.mesh_dim_names
    coord = mesh.get_coordinate()
    index = [slice(None) if n == name else c for n, c in zip(names, coord)]
    return [int(r) for r in mesh.mesh[tuple(index)].reshape(-1).tolist()]


def axis_group(mesh, name: str):
    """The process group of this rank's line along axis `name`."""
    return mesh.get_group(name)


def data_coordinates(mesh) -> torch.Tensor:
    """Each rank's coordinate along the mesh's `data` axis, indexed by
    rank."""
    grid = mesh.mesh
    d = mesh.mesh_dim_names.index(DATA_AXIS)
    along = [1] * grid.dim()
    along[d] = grid.shape[d]
    coord = torch.empty(grid.numel(), dtype=torch.long)
    coord[grid.reshape(-1)] = torch.arange(grid.shape[d]).view(
        along).expand(grid.shape).reshape(-1)
    return coord


def check_rows_shared(row_mesh, mesh, axis_name: str, what: str) -> None:
    """ValueError unless the ranks of every line of `mesh` along
    `axis_name` hold the same rows of the batch: the same coordinate on
    `row_mesh`'s `data` axis, over which each rank placed its rows
    (`distributed.place_local`). `what` names `mesh` in the message.
    Every rank reads the whole layout, so every rank raises or none."""
    if axis_name not in mesh.mesh_dim_names:
        return
    grid = mesh.mesh.movedim(mesh.mesh_dim_names.index(axis_name), -1)
    lines = data_coordinates(row_mesh)[grid.reshape(-1, grid.shape[-1])]
    if bool((lines != lines[:, :1]).any()):
        raise ValueError(
            f"{what}: the ranks of a {axis_name!r} line "
            f"{grid.reshape(-1, grid.shape[-1]).tolist()} hold rows at "
            f"data coordinates {lines.tolist()} of the data-parallel mesh "
            f"{dict(zip(row_mesh.mesh_dim_names, row_mesh.mesh.shape))}, "
            f"so they would work on different articles; give that mesh "
            f"(trainer.mesh) the same {axis_name!r} axis")
