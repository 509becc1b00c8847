"""The training loop's core.

Counterpart of `news_image_caption_tpu/training/trainer.py::Trainer`
without checkpoints, TensorBoard, preemption, profiling or gradient
accumulation: epochs of train steps, the window-mean loss every
`log_every` steps (the loop's only host reads besides the step's
non-finite guard), and the validation loss through the eval step at the
end of each epoch. Every logged record is also kept in `history`.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch

from news_image_caption_tpu_torch.training.optim import BertAdam
from news_image_caption_tpu_torch.training.train_step import (
    TrainState, make_eval_step, make_train_step)

PRECISIONS = {"bf16_o2": torch.bfloat16, "fp32": torch.float32}


@dataclass
class TrainerConfig:
    num_epochs: int = 1
    log_every: int = 40
    # "bf16_o2": bf16 stored params, fp32 master in the optimizer state
    # (the model must be built in bf16); "fp32": full precision.
    mixed_precision: str = "bf16_o2"
    seed: int = 0


class Trainer:
    def __init__(self, loss_fn: Callable, tx: BertAdam,
                 config: TrainerConfig):
        if config.mixed_precision not in PRECISIONS:
            raise ValueError(f"mixed_precision {config.mixed_precision!r}:"
                             f" the port has {sorted(PRECISIONS)}")
        dtype = PRECISIONS[config.mixed_precision]
        self.config = config
        self.train_step = make_train_step(loss_fn, tx, compute_dtype=dtype)
        self.eval_step = make_eval_step(loss_fn, compute_dtype=dtype)
        self.history: List[Dict[str, Any]] = []
        self.logger = logging.getLogger("trainer")

    def train(self, state: TrainState,
              train_batches: Callable[[int], Iterable],
              val_batches: Optional[Callable[[int], Iterable]] = None
              ) -> TrainState:
        """train_batches(epoch) / val_batches(epoch) -> iterables of
        batches of tensors on the model's device."""
        cfg = self.config
        for epoch in range(cfg.num_epochs):
            t_epoch = time.perf_counter()
            window: list = []
            for batch in train_batches(epoch):
                state, m = self.train_step(state, batch, cfg.seed)
                window.append((m["loss"], m["sample_size"], m["skipped"]))
                if len(window) == cfg.log_every:
                    self._log_train(epoch, state, window, t_epoch)
                    window = []
            if val_batches is not None:
                record = {"epoch": epoch, "step": state.step, "split": "val",
                          **self.evaluate(val_batches(epoch))}
                self.history.append(record)
                self.logger.info("epoch %d val %s", epoch, record)
        return state

    def _log_train(self, epoch, state, window, t_epoch) -> None:
        losses, sizes, skips = zip(*window)
        record = {"epoch": epoch, "step": state.step, "split": "train",
                  "loss": torch.stack(losses).float().mean().item(),
                  "tokens": int(torch.stack(sizes).sum().item()),
                  "skipped": int(sum(skips)),
                  "seconds": time.perf_counter() - t_epoch}
        if record["skipped"]:
            self.logger.warning("%d non-finite batches skipped",
                                record["skipped"])
        self.history.append(record)
        self.logger.info("epoch %d step %d loss %.4f", epoch, state.step,
                         record["loss"])

    def evaluate(self, batches: Iterable) -> Dict[str, float]:
        """Validation loss in bits per token over `batches`."""
        total, size, n = 0.0, 0, 0
        for batch in batches:
            m = self.eval_step(batch)
            s = int(m["sample_size"])
            total += float(m["loss"]) * s
            size += s
            n += 1
        return {"loss": total / max(size, 1), "n_batches": n}
