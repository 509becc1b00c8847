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

`FixedStepsLoader` (a fixed number of steps an epoch over an endless
stream of batches, resumed at epoch E by index arithmetic) and
`TokenBucketBatcher` (batches capped by size and by padded tokens, each
padded to a fixed bucket length) are plain Python, copies of the
reference's; `tests/test_torch_profiling_loaders.py` holds them equal.
"""

from __future__ import annotations

import inspect
import itertools
import queue
import threading
from typing import Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch


PREFETCH = 2    # batches placed ahead of the consumer
_EXHAUSTED = object()


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


def device_batch(batch: Dict[str, np.ndarray], device
                 ) -> Dict[str, torch.Tensor]:
    """Every host array of `batch` on `device` (`host_tensor`): through
    pinned memory and a non-blocking copy on the card, copied on the
    CPU."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = host_tensor(v)
        if device.type == "cuda":
            out[k] = t.pin_memory().to(device, non_blocking=True)
        else:
            out[k] = t.clone()
    return out


class DeviceLoader:
    """Wrap a host batch iterator with prefetch + device placement. With
    a mesh, each batch is the global one and the rank places its rows
    along the mesh's `data` axis (`parallel/distributed.py::
    place_local`), as the reference's loader places a data-sharded
    global batch."""

    def __init__(self, batches: Iterable[Dict[str, np.ndarray]], device,
                 mesh=None):
        self._batches = batches
        self._device = torch.device(device)
        self._mesh = mesh

    def _put(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        if self._mesh is None:
            return device_batch(batch, self._device)
        from news_image_caption_tpu_torch.parallel.distributed import \
            place_local
        return place_local(batch, self._mesh, self._device)

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


class FixedStepsLoader:
    """Fixed steps-per-epoch over an endless batch stream with
    fast-forward resume.

    Gen-2's LoaderWrapper with its start_idx resume: an "epoch" is
    exactly `steps_per_epoch` batches regardless of dataset size, and
    resuming at epoch E fast-forwards the underlying stream by
    E * steps_per_epoch batches (deterministic batch order).

    Fast-forward is INDEX ARITHMETIC when the per-seed batch count is
    known (Gen-2 fast-forwards its dataset by start_idx =
    epoch*steps*batch): with `batches_per_seed`, resuming at epoch E jumps
    straight to (seed, offset) = divmod(E*steps, batches_per_seed)
    instead of materializing every skipped batch. If `make_batches`
    also accepts a `start` keyword, even the intra-seed offset is
    skipped dataset-side and ZERO batches are materialized.
    """

    def __init__(self, make_batches: Callable[..., Iterable],
                 steps_per_epoch: int,
                 batches_per_seed: Optional[int] = None):
        """make_batches(seed[, start]) -> finite iterable of batches;
        the stream chains seeds 0, 1, 2, ... endlessly."""
        self.make_batches = make_batches
        self.steps_per_epoch = steps_per_epoch
        self.batches_per_seed = batches_per_seed
        self._accepts_start = self._check_accepts_start(make_batches)

    @staticmethod
    def _check_accepts_start(fn) -> bool:
        # Only an EXPLICIT `start` parameter counts: a **kwargs
        # factory that ignores unknown keywords would silently skip
        # zero batches and replay trained data on resume.
        try:
            params = inspect.signature(fn).parameters
        except (TypeError, ValueError):
            return False
        return "start" in params

    def _stream_from(self, seed: int, offset: int):
        consecutive_empty = 0
        while True:
            used_start = False
            consumed = 0
            # The start= fast path needs a KNOWN per-seed batch count:
            # with batches_per_seed the offset is < one seed by
            # construction, so a short seed cannot silently swallow
            # part of the skip (which the factory-side skip could not
            # report back).
            if (offset and self._accepts_start
                    and self.batches_per_seed):
                it = iter(self.make_batches(seed, start=offset))
                used_start = True
                offset = 0
            else:
                it = iter(self.make_batches(seed))
                while offset:                    # materializing skip
                    if next(it, _EXHAUSTED) is _EXHAUSTED:
                        break                    # seed shorter than skip
                    offset -= 1
                    consumed += 1
            yielded = False
            for b in it:
                yielded = True
                yield b
            if yielded or used_start or consumed:
                consecutive_empty = 0
            else:
                consecutive_empty += 1
                if consecutive_empty >= 2:
                    raise ValueError("make_batches produced no batches")
            seed += 1

    def epoch(self, epoch_index: int) -> Iterator:
        """Batches for one epoch, fast-forwarding past prior epochs."""
        skip = epoch_index * self.steps_per_epoch
        if self.batches_per_seed:
            seed, offset = divmod(skip, self.batches_per_seed)
        else:
            seed, offset = 0, skip
        stream = self._stream_from(seed, offset)
        for _ in range(self.steps_per_epoch):
            yield next(stream)


class TokenBucketBatcher:
    """Bucket-by-num-tokens batch shaping, static-shape friendly.

    AllenNLP's bucket iterator with `maximum_samples_per_batch:
    ["num_tokens", 16384]` (Transform-and-Tell's goodnews config): sort
    a lookahead window by length, group into batches capped by BOTH
    `batch_size` and padded-token budget (batch_len * bucket_len <=
    max_tokens).

    Each batch pads to the smallest FIXED bucket length that fits its
    longest instance, so the train step sees a handful of shapes instead
    of one per batch.
    """

    def __init__(self, length_fn: Callable[[Dict], int],
                 batch_size: int = 16,
                 max_tokens: Optional[int] = 16384,
                 bucket_lengths: Iterable[int] = (32, 64, 128, 256, 512),
                 window: int = 6000):
        self.length_fn = length_fn
        self.batch_size = batch_size
        self.max_tokens = max_tokens
        self.bucket_lengths = sorted(bucket_lengths)
        self.window = window

    def bucket_for(self, length: int) -> int:
        for b in self.bucket_lengths:
            if length <= b:
                return b
        # No bucket fits: collate would SILENTLY truncate to the
        # largest bucket; instances must be pre-truncated (the
        # indexer's max_len) or the caller must widen bucket_lengths.
        raise ValueError(
            f"instance length {length} exceeds the largest bucket "
            f"{self.bucket_lengths[-1]}")

    def batches(self, instances: Iterable) -> Iterator[tuple]:
        """Yields (list_of_instances, bucket_len)."""
        it = iter(instances)
        while True:
            chunk = list(itertools.islice(it, self.window))
            if not chunk:
                return
            chunk.sort(key=self.length_fn)
            batch: list = []
            bucket = self.bucket_lengths[0]
            for inst in chunk:
                blen = self.bucket_for(self.length_fn(inst))
                grown = max(bucket, blen)
                over_tokens = (self.max_tokens is not None and
                               (len(batch) + 1) * grown > self.max_tokens)
                if batch and (len(batch) >= self.batch_size
                              or over_tokens):
                    yield batch, bucket
                    batch, bucket = [], self.bucket_lengths[0]
                    grown = blen
                batch.append(inst)
                bucket = max(grown, blen)
            if batch:
                yield batch, bucket
