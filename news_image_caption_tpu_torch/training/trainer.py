"""Training loop with validation, checkpoint and patience callbacks.

Counterpart of `news_image_caption_tpu/training/trainer.py` (`Trainer`,
`TrainerConfig`): per-epoch train and validation, checkpoints under
`<serialization_dir>/checkpoints` (keep-N, best, asynchronous writes),
patience and early stop on the validation metric, the non-finite batch
skip, `metrics.jsonl` records with the reference's keys (and, for a
pointer model, the window's mean `gen_loss`, `entity_loss` and
`copy_loss` beside the loss, as the reference's trainer logs them),
TensorBoard
scalars every `summary_interval` steps, `recover` from the latest
checkpoint, a blocking checkpoint tagged `preempted` on SIGTERM, and the
out-of-memory batch skip. Every logged record is also kept in `history`.

The host reads the device every `log_every` steps (the window's mean
loss) and, with `skip_nan_batches`, once a step (the train step's
guard). `input_wait` is the share of the epoch's wall the loop spent
waiting on the batch iterator. With `profile_steps > 0`, steps
[profile_start, profile_start + profile_steps) are traced by
`torch.profiler` (`utils/profiling.py`) into
`<serialization_dir>/profile`: the window opens at the first step at or
past `profile_start` (a recovered run that resumes past it still traces
its first `profile_steps` steps), closes `profile_steps` steps after it
opened, with the device synchronized first so the trace holds the
window's device work, and is closed on any exit.

`checkpoint_format` "sharded" keeps the checkpoints in `training/
checkpoint_sharded.py::ShardedCheckpointStore` (a directory a step,
every rank writing its share), "msgpack" in the single-file store. With
a mesh (`Trainer(..., mesh=)`) the steps are data-parallel
(`training/train_step.py`): every rank runs the loop on its rows, rank 0
alone writes `metrics.jsonl`, TensorBoard and the profile, every rank
takes part in a sharded save (the single-file store is written by rank 0
alone, from the whole tensors every model rank gathers where the model
is split over a `model` axis), and a SIGTERM on any rank stops every
rank at the same step.
"""

from __future__ import annotations

import gc
import json
import logging
import os
import signal
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch
import torch.distributed as dist

from news_image_caption_tpu_torch.parallel.distributed import (any_rank,
                                                               rank,
                                                               world_size)
from news_image_caption_tpu_torch.training.checkpoint import CheckpointStore
from news_image_caption_tpu_torch.training.preemption import \
    PreemptionHandler
from news_image_caption_tpu_torch.training.train_step import (
    TrainState, make_eval_step, make_train_step)
from news_image_caption_tpu_torch.utils.logging import setup_logger
from news_image_caption_tpu_torch.utils.profiling import (start_trace,
                                                          stop_trace)

# A pointer model's loss components, logged beside its loss.
PARTS = ("gen_loss", "entity_loss", "copy_loss")
# mixed_precision -> the dtype the model computes in.
PRECISIONS = {"fp32": torch.float32, "bf16": torch.bfloat16,
              "bf16_o2": torch.bfloat16}


@dataclass
class TrainerConfig:
    num_epochs: int = 10
    patience: Optional[int] = None          # epochs without val improvement
    keep_checkpoints: int = 10
    validation_metric: str = "loss"         # on the val set
    maximize_metric: bool = False
    log_every: int = 40
    serialization_dir: str = "runs/default"
    skip_nan_batches: bool = True
    # "fp32": full precision; "bf16": fp32 stored params, bf16 compute
    # copy; "bf16_o2": bf16 stored params, fp32 master in the optimizer
    # state. The caller builds the matching state
    # (train_step.create_train_state / create_o2_train_state).
    mixed_precision: str = "fp32"
    # Skip an out-of-memory batch, collect garbage, keep training; give
    # up after this many consecutive ones.
    max_consecutive_oom: int = 3
    summary_interval: int = 512             # TensorBoard; 0 disables
    # Profiler window: steps [profile_start, profile_start +
    # profile_steps) into <serialization_dir>/profile (0 steps = off).
    profile_start: int = 2
    profile_steps: int = 0
    seed: int = 0
    # "msgpack": the single-file store; "sharded": a directory a step.
    checkpoint_format: str = "msgpack"


class Trainer:
    def __init__(self, loss_fn: Callable, tx, config: TrainerConfig,
                 mesh=None):
        if config.mixed_precision not in PRECISIONS:
            raise ValueError(f"mixed_precision {config.mixed_precision!r}:"
                             " the port has fp32, bf16 and bf16_o2")
        dtype = PRECISIONS[config.mixed_precision]
        self.config = config
        self.train_step = make_train_step(
            loss_fn, tx, compute_dtype=dtype,
            guard_nonfinite=config.skip_nan_batches, mesh=mesh)
        # Validation runs under the train step's precision.
        self.eval_step = make_eval_step(loss_fn, compute_dtype=dtype,
                                        mesh=mesh)
        if config.checkpoint_format == "sharded":
            from news_image_caption_tpu_torch.training.checkpoint_sharded \
                import ShardedCheckpointStore as store_type
        elif config.checkpoint_format == "msgpack":
            store_type = CheckpointStore
        else:
            raise ValueError(f"unknown checkpoint_format "
                             f"{config.checkpoint_format!r}; use 'msgpack' "
                             "or 'sharded'")
        # Rank 0 writes the logs; every rank saves a sharded checkpoint,
        # rank 0 alone the single file every rank would write alike.
        self.main = rank() == 0
        self.saves = self.main or config.checkpoint_format == "sharded"
        # The ranks agree on preemption each step on the host: a gloo
        # group, made before the store's.
        self._flags = (dist.new_group(backend="gloo")
                       if world_size() > 1 else None)
        self.store = store_type(
            os.path.join(config.serialization_dir, "checkpoints"),
            keep=config.keep_checkpoints,
            best_metric=config.validation_metric,
            maximize=config.maximize_metric)
        # Rank 0 reports for every rank.
        self.logger = setup_logger(
            "trainer", logging.INFO if self.main else logging.WARNING)
        self._metrics_path = os.path.join(config.serialization_dir,
                                          "metrics.jsonl")
        os.makedirs(config.serialization_dir, exist_ok=True)
        self._tb = None            # lazy SummaryWriter
        self._last_summary_step = -(10 ** 12)
        self.history: List[Dict[str, Any]] = []
        # Host clock (perf_counter): each epoch's (start, end), each
        # train step's seconds.
        self.epoch_times: List[tuple] = []
        self.step_seconds: List[float] = []
        self._prof = None          # the running profiler, if any
        self._prof_done = False
        self._prof_started_at = 0

    def _log_metrics(self, record: Dict[str, Any]) -> None:
        self.history.append(record)
        if not self.main:
            return
        with open(self._metrics_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def _tb_scalars(self, step: int, scalars, force: bool = False) -> None:
        """Scalars to TensorBoard every `summary_interval` steps."""
        interval = self.config.summary_interval
        if interval <= 0 or not self.main:
            return
        if not force and step - self._last_summary_step < interval:
            return
        self._last_summary_step = step
        if self._tb is None:
            from news_image_caption_tpu_torch.utils.tensorboard import \
                SummaryWriter
            self._tb = SummaryWriter(
                os.path.join(self.config.serialization_dir, "log"))
        self._tb.add_scalars([(t, v) for t, v in scalars
                              if isinstance(v, (int, float))], step)
        self._tb.flush()

    def train(self, state: TrainState,
              train_batches: Callable[[int], Iterable],
              val_batches: Optional[Callable[[int], Iterable]] = None,
              recover: bool = False) -> TrainState:
        """train_batches(epoch) / val_batches(epoch) -> iterables of
        batches of tensors on the model's device."""
        start_epoch = 0
        if recover:
            step = self.store.latest_step()
            if step is not None:
                self.store.load(state, "latest")
                start_epoch = int(next(
                    (c["metrics"].get("epoch", 0)
                     for c in self.store.meta["checkpoints"]
                     if c["step"] == step), 0))
                self.logger.info("recovered step=%s epoch=%s", step,
                                 start_epoch)
        guard = PreemptionHandler((signal.SIGTERM,))
        try:
            with guard:
                state = self._run_epochs(state, train_batches, val_batches,
                                         start_epoch,
                                         self.store.best_value(), guard)
        finally:
            if self._prof is not None:
                stop_trace(self._prof)
                self._prof = None
        # Surface any async write error before declaring success.
        self.store.wait()
        if self._tb is not None:
            self._tb.close()
            self._tb = None
        return state

    def _profile_tick(self, step: int, last_loss=None) -> None:
        """Open or close the profiler window at a step's edge. It opens
        at the first step >= profile_start (not ==, so a recovered run
        resuming past it still traces) and closes profile_steps steps
        after the step it opened at."""
        cfg = self.config
        if cfg.profile_steps <= 0 or self._prof_done or not self.main:
            return
        if self._prof is None and step >= cfg.profile_start:
            logdir = os.path.join(cfg.serialization_dir, "profile")
            self.logger.info("profiling steps %d..%d -> %s", step,
                             step + cfg.profile_steps, logdir)
            self._prof = start_trace(logdir)
            self._prof_started_at = step
        elif (self._prof is not None
              and step >= self._prof_started_at + cfg.profile_steps):
            if last_loss is not None and last_loss.is_cuda:
                # The window holds its steps' device work.
                torch.cuda.synchronize(last_loss.device)
            stop_trace(self._prof)
            self._prof = None
            self._prof_done = True
            self.logger.info("profile trace written")

    def _run_epochs(self, state, train_batches, val_batches, start_epoch,
                    best, guard: PreemptionHandler) -> TrainState:
        cfg = self.config
        epochs_since_best = 0
        for epoch in range(start_epoch, cfg.num_epochs):
            t_epoch = time.perf_counter()
            n_batches = total_tokens = consecutive_oom = 0
            window: list = []
            preempted = False
            t_input = 0.0
            batch_iter = iter(train_batches(epoch))
            while True:
                t_fetch = time.perf_counter()
                batch = next(batch_iter, None)
                t_input += time.perf_counter() - t_fetch
                if batch is None:
                    break
                if self._preempted(guard):
                    preempted = True
                    break
                self._profile_tick(state.step)
                t_step = time.perf_counter()
                try:
                    state, metrics = self.train_step(state, batch, cfg.seed)
                except torch.OutOfMemoryError as e:
                    consecutive_oom += 1
                    self.logger.warning(
                        "OOM batch skipped (%d consecutive): %s",
                        consecutive_oom, str(e).splitlines()[0])
                    if consecutive_oom >= cfg.max_consecutive_oom:
                        raise
                    gc.collect()
                    torch.cuda.empty_cache()
                    state = self._revive_if_torn(state)
                    continue
                self.step_seconds.append(time.perf_counter() - t_step)
                self._profile_tick(state.step, metrics["loss"])
                consecutive_oom = 0
                n_batches += 1
                window.append((metrics["loss"],
                               metrics.get("sample_size", 0),
                               metrics["skipped"],
                               [metrics[k] for k in PARTS if k in metrics]))
                if n_batches % cfg.log_every == 0:
                    losses, sizes, skips, parts = zip(*window)
                    window = []
                    # The window's mean loss and parts: one host read.
                    means = torch.stack([torch.stack(losses).float().mean()]
                                        + [torch.stack(p).float().mean()
                                           for p in zip(*parts)]).tolist()
                    loss = means[0]
                    total_tokens += int(sum(int(s) for s in sizes))
                    n_skipped = int(sum(skips))
                    dt = time.perf_counter() - t_epoch
                    if n_skipped and cfg.skip_nan_batches:
                        self.logger.warning(
                            "%d NaN/inf-loss batches skipped", n_skipped)
                    input_wait = t_input / max(dt, 1e-9)
                    self.logger.info(
                        "epoch %d step %d loss %.4f (%.1f tok/s, input "
                        "wait %.1f%%)", epoch, state.step, loss,
                        total_tokens / max(dt, 1e-9), 100.0 * input_wait)
                    self._log_metrics({
                        "epoch": epoch, "step": state.step, "loss": loss,
                        **dict(zip([k for k in PARTS if k in metrics],
                                   means[1:])),
                        "skipped": n_skipped,
                        "input_wait": round(input_wait, 4),
                        "split": "train"})
                    self._tb_scalars(state.step, [
                        ("train/loss", loss),
                        ("train/tokens_per_sec",
                         total_tokens / max(dt, 1e-9)),
                        ("train/input_wait", input_wait),
                        ("train/skipped_batches", n_skipped)])
            if preempted or self._preempted(guard):
                # Eviction imminent: persist now (blocking: the process
                # may not live long enough for an async write), tagged
                # with the epoch in progress so --recover restarts it
                # from this exact state.
                self.logger.warning(
                    "preemption signal %s: checkpointing at step %d and "
                    "exiting cleanly", guard.signum, state.step)
                self._save(state, {"epoch": epoch, "preempted": True},
                           blocking=True)
                self.epoch_times.append((t_epoch, time.perf_counter()))
                return state
            val_metrics: Dict[str, float] = {}
            if val_batches is not None:
                val_metrics = self.evaluate(val_batches(epoch))
                self._log_metrics({"epoch": epoch, "step": state.step,
                                   "split": "val", **val_metrics})
                self.logger.info("epoch %d val %s", epoch, val_metrics)
                self._tb_scalars(state.step,
                                 [(f"validation/{k}", v)
                                  for k, v in val_metrics.items()],
                                 force=True)
            # Async: the write overlaps the next epoch.
            self._save(state, {"epoch": epoch + 1, **val_metrics},
                       blocking=False)
            self.epoch_times.append((t_epoch, time.perf_counter()))
            if cfg.patience is not None and val_metrics:
                val = val_metrics.get(cfg.validation_metric)
                improved = (best is None or (val > best if cfg.maximize_metric
                                             else val < best))
                if improved:
                    best = val
                    epochs_since_best = 0
                else:
                    epochs_since_best += 1
                    if epochs_since_best >= cfg.patience:
                        self.logger.info(
                            "early stop: no %s improvement in %d epochs",
                            cfg.validation_metric, cfg.patience)
                        break
        return state

    def _save(self, state: TrainState, metrics: Dict[str, Any],
              blocking: bool) -> None:
        """Checkpoint the state at its step. A state split over model
        ranks is gathered whole on every rank for the single-file store
        (a collective), which rank 0 writes; the sharded store takes
        each rank's slices (`TrainState.sharded_state_dict`)."""
        tree = state
        if state.split is not None and \
                self.config.checkpoint_format != "sharded":
            tree = state.state_dict()
        if self.saves:
            self.store.save(tree, state.step, metrics, blocking=blocking)

    def _preempted(self, guard: PreemptionHandler) -> bool:
        """Whether SIGTERM reached this rank, or with several ranks any
        of them (one flag all-reduced a step on the host's gloo group, so
        the host never waits on the device for it)."""
        if self._flags is None:
            return guard.triggered
        return any_rank(guard.triggered, self._flags)

    def _revive_if_torn(self, state: TrainState) -> TrainState:
        """A failure inside the optimizer's in-place update leaves the
        state torn: restore it from the newest readable checkpoint."""
        if not state.in_update:
            return state
        if self.store.latest_step() is None:
            raise RuntimeError(
                "train state torn by a failed optimizer update and no "
                "checkpoint exists to restore from")
        self.logger.warning("restoring train state from the latest "
                            "checkpoint after a failed optimizer update")
        state, _ = self.store.load_with_fallback(state)
        return state

    def evaluate(self, batches: Iterable) -> Dict[str, float]:
        """The validation loss (bits per token) over `batches`."""
        total_loss, total_size, n = 0.0, 0, 0
        for batch in batches:
            m = self.eval_step(batch)
            size = int(m.get("sample_size", 1))
            total_loss += float(m["loss"]) * size
            total_size += size
            n += 1
        return {"loss": total_loss / max(total_size, 1), "n_batches": n}
