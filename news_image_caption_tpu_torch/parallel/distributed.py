"""Process bootstrap and per-rank data placement.

Counterpart of `news_image_caption_tpu/parallel/distributed.py`. Every
rank runs the same program on its own device (`parallel/__init__.py`):

1. `initialize()`: idempotent `torch.distributed.init_process_group`,
   from an explicit spec (`coordinator_address` "host:port", or any
   `scheme://` init method such as `file:///path`, with `num_processes`
   and `process_id`), or from the `RANK` / `WORLD_SIZE` environment
   torchrun sets. NCCL on the card and gloo on the CPU, chosen by the
   device and never as a fallback; the card's process takes
   `cuda:LOCAL_RANK`. An explicit spec that fails raises; with no spec
   and no cluster it is a single process, as in the reference.
2. `shard_iterator()`: the reference's round-robin slice of a batch
   stream, verbatim; its default index and count are the node's (a JAX
   host is a node of ranks here), so with one node it is the identity.
3. `place_local()`: the counterpart of `device_put_global`: each rank
   keeps its rows of the batch along the mesh's `data` axis, on its
   device.

`ensure_world` gives a process that joined no group a world of one rank
on a `HashStore`, so a mesh can always be made.
"""

from __future__ import annotations

import datetime
import itertools
import logging
import os
from typing import Any, Dict, Iterable, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from news_image_caption_tpu_torch.parallel.mesh import (DATA_AXIS, axis_index,
                                                        axis_size)

_owned = False      # whether this module made the default group


def _backend(device: torch.device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _init(device: torch.device, **kwargs) -> None:
    global _owned
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(local_rank())
        kwargs["device_id"] = torch.device("cuda", local_rank())
    dist.init_process_group(_backend(device), **kwargs)
    _owned = True


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               device: Any = "cpu", timeout: Optional[float] = None) -> None:
    """Join the run's process group, once per process, before making
    meshes. device: the process's device type (the card's selects NCCL
    and `cuda:LOCAL_RANK`). timeout: seconds to wait for the other
    ranks (default torch's). A second call is a no-op."""
    if dist.is_initialized():
        return
    kw = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=timeout)}
    if coordinator_address is not None or num_processes is not None:
        if coordinator_address is None or num_processes is None \
                or process_id is None:
            raise ValueError(
                "trainer.distributed: give coordinator_address, "
                "num_processes and process_id together")
        method = (coordinator_address if "://" in coordinator_address
                  else f"tcp://{coordinator_address}")
        os.environ.setdefault("LOCAL_RANK", str(process_id))
        _init(device, init_method=method, world_size=int(num_processes),
              rank=int(process_id), **kw)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        _init(device, init_method="env://", **kw)
    else:
        logging.getLogger("distributed").info(
            "no multi-process cluster detected; running single-process")


def ensure_world(device: Any = "cpu") -> None:
    """A world of one rank (a `HashStore` group) where this process has
    joined none."""
    if not dist.is_initialized():
        _init(device, store=dist.HashStore(), rank=0, world_size=1)


def shutdown() -> None:
    """End the process group this module made, if any."""
    global _owned
    if _owned and dist.is_initialized():
        dist.destroy_process_group()
    _owned = False


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    """This process's device index on its node."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def node_index() -> int:
    return int(os.environ.get("GROUP_RANK", 0))


def node_count() -> int:
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size()))
    return max(1, world_size() // max(local, 1))


def any_rank(flag: bool, group=None) -> bool:
    """Whether `flag` is set on any rank of `group` (default the world;
    every rank calls). The flag is a CPU tensor, so `group` is a gloo
    group (`dist.new_group(backend="gloo")` under NCCL) and the host
    waits on no device."""
    if world_size() == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))])
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())


def shard_iterator(batches: Iterable, index: Optional[int] = None,
                   count: Optional[int] = None) -> Iterator:
    """Round-robin slice of a batch stream for this node.

    Every node constructs the SAME epoch iterator (same seed) and
    consumes batches index, index+count, ... — disjoint coverage with
    deterministic resume. A ragged tail (epoch length not divisible by
    count) is DROPPED so every node sees the same number of batches —
    unequal counts would desynchronize the loops and hang the
    collectives of the extra step."""
    index = node_index() if index is None else index
    count = node_count() if count is None else count
    if count == 1:
        return iter(batches)

    def even_slices() -> Iterator:
        it = iter(batches)
        while True:
            group = list(itertools.islice(it, count))
            if len(group) < count:
                return
            yield group[index]

    return even_slices()


def local_rows(mesh, batch_rows: int) -> slice:
    """This rank's rows of a node's batch of `batch_rows`: equal slices
    along the mesh's `data` axis (ValueError where they are not)."""
    per_node = max(1, axis_size(mesh, DATA_AXIS) // node_count())
    if batch_rows % per_node:
        raise ValueError(f"batch of {batch_rows} rows does not split "
                         f"evenly over data={per_node} ranks")
    n = batch_rows // per_node
    i = axis_index(mesh, DATA_AXIS) % per_node
    return slice(i * n, (i + 1) * n)


def place_local(batch: Dict[str, np.ndarray], mesh, device: Any
                ) -> Dict[str, torch.Tensor]:
    """This rank's rows (`local_rows`) of every host array of `batch`
    (rows first) on `device`, as `data/loader.py::device_batch` places
    a batch."""
    from news_image_caption_tpu_torch.data.loader import device_batch
    rows = local_rows(mesh, next(iter(batch.values())).shape[0])
    return device_batch({k: v[rows] for k, v in batch.items()}, device)
