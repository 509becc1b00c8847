"""Host -> device input pipeline with background prefetch.

Counterpart of `news_image_caption_tpu/data/loader.py::DeviceLoader`:
a background thread draws the next host batches and places them on the
device while the current step runs, with the same bounded queue,
prefetch depth, stop event and error hand-off. On the card a batch's
arrays go through pinned memory and `non_blocking` copies
(`torch.from_numpy(x).pin_memory().to(device, non_blocking=True)`),
enqueued on the default stream, so the step that reads them is ordered
after them; on the CPU each array is copied. Arrays keep their dtype: the
online pipeline's raw uint8 images travel as they are (a quarter of
their float size) and are normalized on the device
(`models/pipeline.py::Gen3Pipeline.encode`). float16, the shards' disk
format, is the one exception: `host_tensor` makes it bfloat16 with the
bits of the reference's `ml_dtypes` cast (round to nearest even, a NaN
the quiet NaN of its sign), as the reference's shard dataset delivers
it.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterable, Iterator

import numpy as np
import torch


PREFETCH = 2    # batches placed ahead of the consumer


def f16_bf16_bits(a: np.ndarray) -> np.ndarray:
    """The bfloat16 bits (uint16) of float16 `a`, as `ml_dtypes` casts
    float16 to bfloat16: through float32, rounded to nearest even; a NaN
    becomes the quiet NaN 0x7FC0 with its sign."""
    bits = a.astype(np.float32).view(np.uint32)
    rne = (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16
    nan = ((bits >> 16) & 0x8000) | 0x7FC0
    return np.where(np.isnan(a), nan, rne).astype(np.uint16)


def host_tensor(a: np.ndarray) -> torch.Tensor:
    """A host tensor of `a`: float16 as bfloat16 (`f16_bf16_bits`),
    other dtypes as they are (a view where `a` is contiguous)."""
    if a.dtype == np.float16:
        return torch.from_numpy(f16_bf16_bits(a).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


class DeviceLoader:
    """Wrap a host batch iterator with prefetch + device placement."""

    def __init__(self, batches: Iterable[Dict[str, np.ndarray]], device):
        self._batches = batches
        self._device = torch.device(device)

    def _put(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in batch.items():
            t = host_tensor(v)
            if self._device.type == "cuda":
                out[k] = t.pin_memory().to(self._device, non_blocking=True)
            else:
                out[k] = t.clone()
        return out

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        sentinel = object()
        err: list = []
        # A consumer that stops mid-epoch (preemption, an exception)
        # finalizes this generator; without the stop event the worker
        # would block in q.put forever, pinning PREFETCH + 1 batches.
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for b in self._batches:
                    if not put_or_stop(self._put(b)):
                        return
            except Exception as e:  # handed to the consumer
                err.append(e)
            finally:
                put_or_stop(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            stop.set()
