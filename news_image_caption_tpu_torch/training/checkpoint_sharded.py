"""Sharded checkpoint store: a directory a step, written by every rank.

Counterpart of `news_image_caption_tpu/training/checkpoint_sharded.py::
ShardedCheckpointStore`, over `torch.distributed.checkpoint` (DCP)
rather than orbax. A checkpoint is `ckpt_{step}/`: DCP's `.metadata` and
one `__{rank}_0.distcp` file a rank. The ranks of a run hold the same
(replicated) state, and DCP's planner gives each tensor to one rank to
write, so a save is spread over the ranks; every rank must call `save`.
A load reads DCP's metadata and takes every tensor from whichever file
holds it, so a store saved on N ranks loads on M (each rank reads on its
own; no collective).

The surface and `meta.json` are `CheckpointStore`'s and the reference's
sharded store's: latest / best / keep-N, `load(target, which)`,
`load_with_fallback`, `read`, `load_averaged`, and asynchronous saves.
`save(blocking=False)` copies the state to host memory and returns;
`async_save` writes it on DCP's thread, and the store's worker thread
finalizes the meta entry only after the write, in submission order.
Best is the pinned step, not a copy: its directory is exempt from
retention. The bookkeeping runs on every rank after a barrier; rank 0
alone writes `meta.json` and removes directories. A state split over
model ranks (tensor parallelism) is written as its slices, each a
`DTensor` with its offsets (`TrainState.sharded_state_dict`), each slice
once; a load reads whole tensors from them, in one process too, and a
split state takes its slices of those.

DCP's collectives run on the writer's thread, so the store keeps a gloo
group of its own (made collectively in the constructor), apart from the
collectives of the training. A directory written by the JAX package's
store (orbax) is refused: its way into the port is
`models/from_jax.py::state_from_jax`.
"""

from __future__ import annotations

import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from news_image_caption_tpu_torch.parallel.distributed import rank
from news_image_caption_tpu_torch.training.checkpoint import (
    CheckpointStore, _load_into, _tree_of, to_host)

# Files of an orbax (OCDBT) checkpoint directory.
ORBAX_MARKERS = ("manifest.ocdbt", "_CHECKPOINT_METADATA", "_METADATA",
                 "ocdbt.process_0")


def _host_stager():
    """An `AsyncStager` for a state the store has already copied to host
    memory: DCP writes it as it is."""
    from torch.distributed.checkpoint.staging import AsyncStager

    class HostCopy(AsyncStager):
        _synchronize_after_execute = False

        def stage(self, state_dict):
            return state_dict

    return HostCopy()


class ShardedCheckpointStore(CheckpointStore):
    def __init__(self, directory: str, keep: int = 10,
                 best_metric: str = "loss", maximize: bool = False):
        super().__init__(os.path.abspath(directory), keep=keep,
                         best_metric=best_metric, maximize=maximize)
        self._group = (dist.new_group(backend="gloo")
                       if dist.is_initialized() else None)
        self._main = rank() == 0

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step}")

    def save(self, state: Any, step: int,
             metrics: Optional[Dict[str, float]] = None,
             blocking: bool = True) -> str:
        """Collective save of `state` (a `TrainState` or a tree) as step
        `step`. blocking=False returns once the state is copied to host
        memory; the write and the meta update follow in the background
        (`wait()` drains them and raises their first error)."""
        import torch.distributed.checkpoint as dcp
        self.wait()
        t = time.perf_counter()
        host = to_host(state.sharded_state_dict()
                       if hasattr(state, "sharded_state_dict")
                       else _tree_of(state))
        record = {"step": step, "snapshot_s": time.perf_counter() - t}
        with self._lock:
            self.timings.append(record)
        path = self._path(step)
        t = time.perf_counter()
        if blocking:
            dcp.save(host, checkpoint_id=path, process_group=self._group)
            self._finalize(None, step, metrics, record, t)
            return path
        written = dcp.async_save(host, checkpoint_id=path,
                                 process_group=self._group,
                                 async_stager=_host_stager())
        written = getattr(written, "upload_completion", written)
        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ckpt-writer")
        fut = self._executor.submit(self._finalize, written, step, metrics,
                                    record, t)
        with self._lock:
            self._pending.append(fut)
        return path

    def _finalize(self, written, step: int,
                  metrics: Optional[Dict[str, float]],
                  record: Dict[str, float], t: float) -> None:
        """After the write (`written`, DCP's future, or None for a
        blocking save): the meta entry, best and retention."""
        if written is not None:
            written.result()            # surfaces write errors
        if self._group is not None:
            dist.barrier(group=self._group)
        with self._lock:
            entry = {"step": step, "metrics": metrics or {}}
            self.meta["checkpoints"] = [
                c for c in self.meta["checkpoints"] if c["step"] != step
            ] + [entry]
            val = (metrics or {}).get(self.best_metric)
            if val is not None:
                best = self.meta.get("best")
                better = (best is None
                          or (val > best["value"] if self.maximize
                              else val < best["value"]))
                if better:
                    self.meta["best"] = {"step": step, "value": float(val)}
            ckpts = sorted(self.meta["checkpoints"], key=lambda c: c["step"])
            best = self.meta.get("best")
            best_step = None if best is None else best["step"]
            old = ckpts[:-self.keep]
            self.meta["checkpoints"] = sorted(
                ckpts[-self.keep:] + [c for c in old
                                      if c["step"] == best_step],
                key=lambda c: c["step"])
            if self._main:
                for victim in old:
                    if victim["step"] != best_step:
                        shutil.rmtree(self._path(victim["step"]),
                                      ignore_errors=True)
                self._write_meta()
            record["write_s"] = time.perf_counter() - t
            record["write_end"] = time.perf_counter()

    def _step_path(self, which: Any) -> str:
        self.wait()
        if which == "latest":
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.dir}")
        elif which == "best":
            best = self.meta.get("best")
            if best is None:
                raise FileNotFoundError(f"no best entry in {self.dir}")
            step = best["step"]
        else:
            step = int(which)
        path = self._path(step)
        if not os.path.exists(os.path.join(path, ".metadata")):
            if os.path.isdir(path) and any(
                    os.path.exists(os.path.join(path, m))
                    for m in ORBAX_MARKERS):
                raise ValueError(
                    f"{path} is an orbax checkpoint of the JAX package's "
                    "sharded store, which the port does not read: carry "
                    "its state across with models/from_jax.py::"
                    "state_from_jax and save it in a port store")
            raise FileNotFoundError(f"no checkpoint at {path}")
        return path

    def read(self, which: Any = "latest", key: Optional[str] = None) -> Any:
        """The tree checkpoint `which` holds, on the host (its entry `key`
        alone where given), built from DCP's metadata."""
        import torch.distributed.checkpoint as dcp
        from torch.distributed.checkpoint.metadata import \
            TensorStorageMetadata
        reader = dcp.FileSystemReader(self._step_path(which))
        meta = reader.read_metadata()
        paths = meta.planner_data
        flat = {fqn: (torch.empty(m.size, dtype=m.properties.dtype)
                      if isinstance(m, TensorStorageMetadata) else None)
                for fqn, m in meta.state_dict_metadata.items()
                if key is None or paths[fqn][0] == key}
        dcp.load(flat, storage_reader=reader, no_dist=True)
        tree: Dict[str, Any] = {}
        for fqn, value in flat.items():
            node = tree
            for part in paths[fqn][:-1]:
                node = node.setdefault(part, {})
            node[paths[fqn][-1]] = value
        return tree if key is None else tree[key]

    def load(self, target: Any, which: Any = "latest") -> Any:
        """Restore checkpoint `which` into `target` (a `TrainState` or a
        tree of tensors), read straight into its tensors."""
        import torch.distributed.checkpoint as dcp
        tree = _tree_of(target)
        dcp.load(tree, checkpoint_id=self._step_path(which), no_dist=True)
        return _load_into(target, tree)
