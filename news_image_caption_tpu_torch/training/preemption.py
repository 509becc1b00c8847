"""Graceful-preemption handling for long training runs.

A copy of `news_image_caption_tpu/training/preemption.py`: the port
imports nothing of the JAX package.
`tests/test_torch_training_copies.py` holds the two equal.

TPU pods (and any preemptible/spot VM) receive SIGTERM shortly before
eviction. The reference has no analog — a killed run loses everything
since its last epoch-boundary torch.save (callback_apex_trainer
checkpoint callback). Here the trainer polls a signal-set flag at
batch boundaries (a host-side bool check, no device sync), writes a
final checkpoint, and returns cleanly so `-r/--recover` resumes from
the preemption point instead of the last epoch boundary.
"""

from __future__ import annotations

import signal
import threading
from typing import Iterable, Optional


class PreemptionHandler:
    """Context manager that latches termination signals into a flag.

    Usage:
        with PreemptionHandler() as guard:
            for batch in batches:
                if guard.triggered:
                    ...checkpoint + exit...

    The previous handlers are restored on exit. Installing signal
    handlers is only legal in the main thread; elsewhere this
    degrades to an inert guard (``triggered`` stays False) so library
    code can use it unconditionally (e.g. under a serving worker
    thread).
    """

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._event = threading.Event()
        self._previous: dict = {}
        self._installed = False
        self.signum: Optional[int] = None   # which signal fired

    @property
    def triggered(self) -> bool:
        return self._event.is_set()

    def _on_signal(self, signum, frame):
        self.signum = signum
        self._event.set()

    def __enter__(self) -> "PreemptionHandler":
        try:
            for s in self._signals:
                self._previous[s] = signal.signal(s, self._on_signal)
            self._installed = True
        except ValueError:
            # Not the main thread: signal.signal is forbidden. Run
            # inert rather than failing the caller.
            self._previous.clear()
        return self

    def __exit__(self, *exc):
        if self._installed:
            for s, old in self._previous.items():
                signal.signal(s, old)
            self._previous.clear()
            self._installed = False
        return False
