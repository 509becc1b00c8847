"""Checkpoint store: latest / best / keep-N with metadata, torch format.

Counterpart of `news_image_caption_tpu/training/checkpoint.py::
CheckpointStore`, with its surface and its `meta.json` layout
(`{"checkpoints": [{"step", "metrics"}], "best": {"step", "value"}}`).
The files are the port's own: `ckpt_{step}.pt` and `best.pt`, each a
`torch.save` of plain dicts of tensors and ints, loadable with
`torch.load(..., weights_only=True)`.

A state is saved through its `state_dict()` (a `TrainState`) or as such
a tree itself, and loaded through its `load_state_dict(tree)` or into
the tree's tensors in place: the train step updates its state in place,
so the model whose parameters the state holds sees a load. `restore`
checks every key, shape and dtype against the target.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import torch


def to_host(tree: Any) -> Any:
    """A copy of `tree` with every tensor copied to host memory. It must
    be a real copy: the caller goes on updating its tensors in place
    while a background writer serializes this one."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    return tree


def check_layout(target: Any, tree: Any, path: str = "state") -> None:
    """ValueError unless `tree` has `target`'s structure: the same dict
    keys, tensors of the same shape and dtype, ints where it has ints."""
    if isinstance(target, torch.Tensor):
        if not isinstance(tree, torch.Tensor) or tree.shape != target.shape \
                or tree.dtype != target.dtype:
            got = (f"{tree.dtype} {tuple(tree.shape)}"
                   if isinstance(tree, torch.Tensor) else type(tree).__name__)
            raise ValueError(f"{path}: checkpoint holds {got}, expected "
                             f"{target.dtype} {tuple(target.shape)}")
    elif isinstance(target, dict):
        if not isinstance(tree, dict) or set(tree) != set(target):
            have = sorted(tree) if isinstance(tree, dict) else tree
            raise ValueError(f"{path}: checkpoint keys {have}, expected "
                             f"{sorted(target)}")
        for k in target:
            check_layout(target[k], tree[k], f"{path}/{k}")
    elif isinstance(target, int) and not isinstance(tree, int):
        raise ValueError(f"{path}: checkpoint holds {tree!r}, expected an int")


def _copy_into(target: Any, tree: Any) -> Any:
    if isinstance(target, torch.Tensor):
        with torch.no_grad():
            target.copy_(tree)
        return target
    if isinstance(target, dict):
        return {k: _copy_into(target[k], tree[k]) for k in target}
    return tree


def restore(target: Any, tree: Any, path: str = "state") -> Any:
    """`tree` poured into `target`'s structure: tensors copied into
    `target`'s in place, dicts walked, scalars taken from `tree`, after
    `check_layout` (ValueError on any mismatch, before anything is
    copied). Returns the restored tree."""
    check_layout(target, tree, path)
    return _copy_into(target, tree)


def _tree_of(state: Any) -> Any:
    return state.state_dict() if hasattr(state, "state_dict") else state


def _load_into(target: Any, tree: Any) -> Any:
    if hasattr(target, "load_state_dict"):
        target.load_state_dict(tree)
        return target
    return restore(target, tree)


def _average(trees: List[Any]) -> Any:
    """The reference's `avg`: floating leaves summed in fp64, divided and
    cast back to their dtype; other leaves from the newest tree."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _average([t[k] for t in trees]) for k in first}
    if isinstance(first, torch.Tensor) and first.is_floating_point():
        acc = torch.zeros(first.shape, dtype=torch.float64)
        for t in trees:
            acc += t.to(torch.float64)
        return (acc / len(trees)).to(first.dtype)
    return trees[-1]


class CheckpointStore:
    def __init__(self, directory: str, keep: int = 10,
                 best_metric: str = "loss", maximize: bool = False):
        self.dir = directory
        self.keep = keep
        self.best_metric = best_metric
        self.maximize = maximize
        os.makedirs(directory, exist_ok=True)
        self._meta_path = os.path.join(directory, "meta.json")
        self.meta: Dict[str, Any] = {"checkpoints": [], "best": None}
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                self.meta = json.load(f)
        # Async saves: one worker thread writes in submission order; the
        # lock guards meta and `timings` against reader/writer races.
        self._executor: Optional[ThreadPoolExecutor] = None
        self._pending: list = []
        self._lock = threading.Lock()
        # One record a save: its step, the host snapshot's seconds, the
        # write's seconds and the host clock (perf_counter) at its end.
        self.timings: List[Dict[str, float]] = []

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step}.pt")

    def _write_meta(self):
        with open(self._meta_path, "w") as f:
            json.dump(self.meta, f, indent=1)

    def save(self, state: Any, step: int,
             metrics: Optional[Dict[str, float]] = None,
             blocking: bool = True) -> str:
        """Write a step checkpoint.

        blocking=False returns as soon as the state is copied to host
        memory; serialization, disk writes and meta updates happen on
        one background worker, in submission order. After `save`
        returns the caller may update its tensors. Call `wait()` to
        drain pending writes and surface any write error."""
        t = time.perf_counter()
        host_state = to_host(_tree_of(state))
        record = {"step": step, "snapshot_s": time.perf_counter() - t}
        with self._lock:
            self.timings.append(record)
        path = self._path(step)
        if blocking:
            # Drain queued async writes first: a queued write for the
            # same step would otherwise land after this one and clobber
            # its meta entry.
            self.wait()
            self._commit(host_state, path, step, metrics, record)
            return path
        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ckpt-writer")
        fut = self._executor.submit(
            self._commit, host_state, path, step, metrics, record)
        with self._lock:
            self._pending.append(fut)
        return path

    def _commit(self, host_state: Any, path: str, step: int,
                metrics: Optional[Dict[str, float]],
                record: Optional[Dict[str, float]] = None) -> None:
        t = time.perf_counter()
        # Write-then-rename: a crash mid-write never leaves a truncated
        # ckpt_N.pt for load_with_fallback to trip on.
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            torch.save(host_state, f)
        os.replace(tmp, path)
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
                    best_path = os.path.join(self.dir, "best.pt")
                    shutil.copyfile(path, best_path + ".tmp")
                    os.replace(best_path + ".tmp", best_path)
            # Retention: keep the newest N.
            ckpts = sorted(self.meta["checkpoints"], key=lambda c: c["step"])
            while len(ckpts) > self.keep:
                victim = ckpts.pop(0)
                p = self._path(victim["step"])
                if os.path.exists(p):
                    os.remove(p)
            self.meta["checkpoints"] = ckpts
            self._write_meta()
            if record is not None:
                record["write_s"] = time.perf_counter() - t
                record["write_end"] = time.perf_counter()

    def wait(self) -> None:
        """Drain pending async saves; re-raises the first write error.
        Every drained future is awaited before raising, so an early
        failure does not discard the later writes."""
        with self._lock:
            pending, self._pending = self._pending, []
        first: Optional[BaseException] = None
        for fut in pending:
            try:
                fut.result()
            except BaseException as e:
                if first is None:
                    first = e
        if first is not None:
            raise first

    def latest_step(self) -> Optional[int]:
        self.wait()
        if not self.meta["checkpoints"]:
            return None
        return max(c["step"] for c in self.meta["checkpoints"])

    def read(self, which: Any = "latest", key: Optional[str] = None) -> Any:
        """The tree checkpoint `which` ('latest', 'best' or a step) holds,
        on the host, or its entry `key`. The file is mapped, so only the
        tensors the caller touches are read from disk."""
        self.wait()
        if which == "latest":
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.dir}")
            path = self._path(step)
        elif which == "best":
            path = os.path.join(self.dir, "best.pt")
        else:
            path = self._path(int(which))
        tree = torch.load(path, map_location="cpu", weights_only=True,
                          mmap=True)
        return tree if key is None else tree[key]

    def load(self, target: Any, which: Any = "latest") -> Any:
        """Restore into `target`: which is 'latest', 'best' or a step."""
        return _load_into(target, self.read(which))

    def load_with_fallback(self, target: Any):
        """Restore the newest readable checkpoint, falling back to older
        ones on corruption. Returns (state, step)."""
        self.wait()
        steps = sorted((c["step"] for c in self.meta["checkpoints"]),
                       reverse=True)
        last_err: Optional[Exception] = None
        for step in steps:
            try:
                tree = self.read(step)
            except Exception as e:  # corrupt or missing file
                last_err = e
                continue
            return _load_into(target, tree), step
        raise FileNotFoundError(
            f"no readable checkpoint in {self.dir}") from last_err

    def best_value(self) -> Optional[float]:
        self.wait()
        b = self.meta.get("best")
        return None if b is None else b["value"]

    def load_averaged(self, target: Any, last_n: Optional[int] = None,
                      steps: Optional[list] = None) -> Any:
        """Restore the element-wise average of several checkpoints
        (fairseq's average_checkpoints): floating tensors averaged in
        fp64 and cast back, ints (step counters) from the newest.

        last_n: the newest N retained checkpoints; steps: an explicit
        list (overrides last_n)."""
        return _load_into(target, self.read_averaged(last_n, steps))

    def read_averaged(self, last_n: Optional[int] = None,
                      steps: Optional[list] = None,
                      key: Optional[str] = None) -> Any:
        """The tree `load_averaged` restores, on the host; with `key`,
        only that entry of each checkpoint is read and averaged."""
        self.wait()
        if steps is None:
            avail = sorted(c["step"] for c in self.meta["checkpoints"])
            if not avail:
                raise FileNotFoundError(f"no checkpoints in {self.dir}")
            steps = avail[-(last_n or len(avail)):]
        return _average([self.read(s, key) for s in sorted(steps)])
