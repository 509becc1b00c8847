"""Client: PUSH jobs to the server, SUBscribe for results.

Counterpart of `news_image_caption_tpu/serving/client.py`, on the
port's own sockets (`serving/transport.py`): UUID identity, job ids,
timeouts on the wall clock, results in submission order for pipelined
streams.
"""

from __future__ import annotations

import time
import uuid
from typing import Any, Dict

import numpy as np

from news_image_caption_tpu_torch.serving import transport
from news_image_caption_tpu_torch.serving.messages import pack, unpack


class CaptioningClient:
    def __init__(self, frontend_addr: str, sink_pub_addr: str,
                 timeout_ms: int = 30000):
        """The SUB registers its filter with the sink before `connect`
        returns, so no result can be published before the client
        listens for it (no settle sleep)."""
        self.identity = uuid.uuid4().hex.encode()
        self.timeout_ms = timeout_ms
        self._push = transport.Socket(transport.PUSH)
        self._push.connect(frontend_addr)
        self._sub = transport.Socket(transport.SUB)
        self._sub.subscribe(self.identity)
        self._sub.connect(sink_pub_addr)
        self._job_counter = 0

    def _submit(self, job: Dict[str, Any]) -> bytes:
        self._job_counter += 1
        job_id = str(self._job_counter).encode()
        self._push.send_multipart([self.identity, job_id] + pack(job))
        return job_id

    def caption(self, job: Dict[str, np.ndarray],
                timeout_ms: int = None) -> Dict[str, Any]:
        """Send one job, block for its result (or raise TimeoutError).

        `_stats` is a RESERVED key (the worker telemetry RPC — see
        `stats()`); a job carrying a truthy `_stats` returns worker
        stats instead of a caption. External entry points (the HTTP
        proxy) strip it from user payloads.

        timeout_ms overrides the client-wide timeout for this call.
        """
        job_id = self._submit(job)
        # Wall-clock deadline, not iteration counting: a stale frame
        # (from a timed-out earlier job) makes poll() return
        # immediately, and charging a full poll step per frame would
        # silently shrink the budget by 100 ms each.
        budget_ms = self.timeout_ms if timeout_ms is None else timeout_ms
        deadline = time.monotonic() + budget_ms / 1000.0
        while time.monotonic() < deadline:
            if self._sub.poll(100):
                frames = self._sub.recv_multipart()
                if frames[0] == self.identity and frames[1] == job_id:
                    result = unpack(frames[2:])
                    if "error" in result:
                        raise RuntimeError(result["error"])
                    return result
        raise TimeoutError(
            f"no result for job {job_id!r} within {budget_ms}ms")

    def stats(self, timeout_ms: int = 5000) -> Dict[str, Any]:
        """Worker telemetry via the `_stats` job RPC (rides the normal
        job routing; with several workers the ventilator delivers it
        to ONE of them round-robin — call repeatedly to sample the
        pool). Workers report {mode, worker_id, jobs_served, uptime_s,
        kernel_launches}.

        Uses its own short timeout (default 5 s) so telemetry polls
        never inherit a long job timeout — the HTTP proxy serializes
        all RPCs through one lock, and a slow stats call would block
        /encode for the whole client timeout otherwise."""
        return self.caption({"_stats": True}, timeout_ms=timeout_ms)

    def caption_stream(self, jobs, window: int = 2):
        """Pipelined captioning: keep up to `window` jobs in flight
        and yield results in submission order.

        With window >= 2 the worker's ingest thread stages job N+1
        (unpack + host->device transfer) while job N decodes, so
        steady-state throughput approaches max(transfer, decode)
        instead of their sum."""
        jobs = iter(jobs)
        pending = {}       # job_id bytes -> submission index
        results = {}       # submission index -> result
        next_yield = 0
        n_sent = 0

        def submit():
            nonlocal n_sent
            try:
                job = next(jobs)
            except StopIteration:
                return False
            pending[self._submit(job)] = n_sent
            n_sent += 1
            return True

        more = True
        while more and len(pending) < window:
            more = submit()
        while pending or more:
            deadline = time.monotonic() + self.timeout_ms / 1000.0
            got = False
            while time.monotonic() < deadline:
                if self._sub.poll(100):
                    frames = self._sub.recv_multipart()
                    if (frames[0] == self.identity
                            and frames[1] in pending):
                        idx = pending.pop(frames[1])
                        result = unpack(frames[2:])
                        if "error" in result:
                            raise RuntimeError(result["error"])
                        results[idx] = result
                        got = True
                        break
            if not got:
                raise TimeoutError(
                    f"no result within {self.timeout_ms}ms "
                    f"({len(pending)} in flight)")
            if more:
                more = submit()
            while next_yield in results:
                yield results.pop(next_yield)
                next_yield += 1

    def close(self):
        self._push.close()
        self._sub.close()
