"""Profiling and tracing hooks.

Counterpart of `news_image_caption_tpu/utils/profiling.py`, on
`torch.profiler` where the reference uses `jax.profiler`:

- `trace(logdir)`: a context manager around `start_trace` /
  `stop_trace`: a `torch.profiler.profile` over the CPU and, where the
  card is present, CUDA activities, written into `logdir` as a Chrome
  trace (`<host>_<pid>.<ns>.pt.trace.json`, loadable by TensorBoard's
  profiler plugin or chrome://tracing). On the card its kernel events
  name the port's CUDA kernels (`flash_fwd_kernel`, ...).
- `annotate(name)`: `torch.profiler.record_function`, a host span that
  also marks the device work launched inside it.
- `StepTimer`: step time and tokens/sec with EMA smoothing; the watched
  value is read on the host first, so the interval includes the device
  work that produced it.
- `MetricsLogger`: an append-only JSONL scalar sink, a copy of the
  reference's (`tests/test_torch_profiling_loaders.py` holds the two
  equal).
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.profiler import (ProfilerActivity, profile, record_function,
                            supported_activities, tensorboard_trace_handler)


def start_trace(logdir: str) -> profile:
    """A running profiler whose trace goes into `logdir` when it stops."""
    activities = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
                  if a in supported_activities()
                  and (a != ProfilerActivity.CUDA
                       or torch.cuda.is_available())]
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(logdir))
    prof.start()
    return prof


def stop_trace(prof: profile) -> None:
    """Stop `prof` and write its trace."""
    prof.stop()


@contextlib.contextmanager
def trace(logdir: str):
    prof = start_trace(logdir)
    try:
        yield prof
    finally:
        stop_trace(prof)


def annotate(name: str):
    return record_function(name)


def _read_on_host(watched: Any) -> None:
    if isinstance(watched, torch.Tensor):
        watched.detach().cpu()
    else:
        np.asarray(watched)


class StepTimer:
    """Wall-clock + tokens/sec with EMA smoothing."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.step_time: Optional[float] = None
        self.tokens_per_sec: Optional[float] = None
        self._last: Optional[float] = None

    def tick(self, watched: Any = None, tokens: int = 0) -> Dict[str, float]:
        """Call once per step. `watched` is read on the host so the
        measured interval includes the device work (launches are
        asynchronous; without the read the interval under-reports)."""
        if watched is not None:
            _read_on_host(watched)
        now = time.perf_counter()
        out: Dict[str, float] = {}
        if self._last is not None:
            dt = now - self._last
            self.step_time = (dt if self.step_time is None
                              else self.ema * self.step_time
                              + (1 - self.ema) * dt)
            out["step_time_s"] = self.step_time
            if tokens:
                tps = tokens / dt
                self.tokens_per_sec = (
                    tps if self.tokens_per_sec is None
                    else self.ema * self.tokens_per_sec
                    + (1 - self.ema) * tps)
                out["tokens_per_sec"] = self.tokens_per_sec
        self._last = now
        return out


class MetricsLogger:
    """Append-only JSONL scalar sink with optional flush cadence."""

    def __init__(self, path: str, flush_every: int = 1):
        self.path = path
        self.flush_every = flush_every
        self._buf = []
        self._f = open(path, "a")

    def log(self, step: int, **scalars):
        rec = {"step": step, "time": time.time(), **{
            k: (float(v) if hasattr(v, "__float__") else v)
            for k, v in scalars.items()}}
        self._buf.append(json.dumps(rec))
        if len(self._buf) >= self.flush_every:
            self.flush()

    def flush(self):
        if self._buf:
            self._f.write("\n".join(self._buf) + "\n")
            self._f.flush()
            self._buf = []

    def close(self):
        self.flush()
        self._f.close()
