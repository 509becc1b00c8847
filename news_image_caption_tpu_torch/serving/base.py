"""Ventilator / sink serving architecture.

Counterpart of `news_image_caption_tpu/serving/base.py`, on the port's
own sockets (`serving/transport.py`) in place of zmq: a PULL frontend
receives client jobs, a PUSH backend fans them out to worker processes,
a Sink process PUBlishes results back to subscribed clients; ServerCmd
control protocol; a monitor that respawns dead workers; graceful
shutdown.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import shutil
import tempfile
import threading
import time
from typing import Callable, List, Optional

from news_image_caption_tpu_torch.serving import transport
from news_image_caption_tpu_torch.utils.logging import setup_logger


class ServerCmd:
    terminate = b"TERMINATE"
    show_config = b"SHOW_CONFIG"
    new_job = b"REGISTER"


def auto_bind(sock: transport.Socket, created_dirs: Optional[list] = None
              ) -> str:
    """Bind to a socket file in a new temporary directory.

    created_dirs: pass a list to record the directory for cleanup —
    otherwise every bind leaks one tellax-ipc-* directory."""
    tmp_dir = tempfile.mkdtemp(prefix="tellax-ipc-")
    if created_dirs is not None:
        created_dirs.append(tmp_dir)
    addr = f"ipc://{tmp_dir}/socket"
    sock.bind(addr)
    return addr


def _addr_dir(addr: str) -> str:
    return os.path.dirname(addr[len("ipc://"):])


# CUDA state does not survive fork: workers start with spawn.
_MP = multiprocessing.get_context("spawn")


class Sink(_MP.Process):
    """Collects worker results and PUBlishes them to clients."""

    def __init__(self, receive_addr_queue):
        super().__init__()
        self._addr_queue = receive_addr_queue
        self.daemon = True

    def run(self):
        dirs: List[str] = []
        receiver = transport.Socket(transport.PULL)
        recv_addr = auto_bind(receiver, dirs)
        publisher = transport.Socket(transport.PUB)
        pub_addr = auto_bind(publisher, dirs)
        self._addr_queue.put((recv_addr, pub_addr))
        try:
            while True:
                frames = receiver.recv_multipart()
                if frames[0] == ServerCmd.terminate:
                    break
                # frames: [client_id, *payload]
                publisher.send_multipart(frames)
        finally:
            receiver.close(linger=0)
            publisher.close(linger=1000)
            for d in dirs:
                shutil.rmtree(d, ignore_errors=True)


class CaptionServer:
    """Ventilator: client PULL frontend -> worker PUSH backend."""

    def __init__(self, worker_factory: Callable, num_workers: int = 1):
        """A liveness thread respawns any worker process that dies
        (segfault, OOM-kill, device loss, a CUDA error), keeping serving
        capacity up. Jobs already queued to the dead worker are lost
        (clients see a timeout and retry) — the respawn restores
        capacity, it does not replay."""
        self.worker_factory = worker_factory
        self.num_workers = num_workers
        # PER-WORKER crash-loop bound: a deterministically-failing
        # worker (bad checkpoint, device already held) must not
        # respawn forever; the budget resets after 60s of survival.
        self.max_respawns = 20
        self.logger = setup_logger("server")
        self._procs: List[multiprocessing.Process] = []
        self._workers: List[multiprocessing.Process] = []
        # Created in __init__ so stop() is safe before/without start().
        self._stop = threading.Event()
        self._stopped = False
        self._ipc_dirs: List[str] = []
        self.respawn_count = 0
        self.frontend_addr: Optional[str] = None
        self.sink_pub_addr: Optional[str] = None
        self._sink_recv_addr: Optional[str] = None
        self._thread: Optional[threading.Thread] = None
        self._monitor: Optional[threading.Thread] = None

    def start(self):
        frontend = transport.Socket(transport.PULL)
        self.frontend_addr = auto_bind(frontend, self._ipc_dirs)

        addr_q = _MP.Queue()
        sink = Sink(addr_q)
        sink.start()
        self._procs.append(sink)
        # Bounded get + liveness check: a Sink that dies during
        # startup (bind failure, full /tmp, spawn import error) must
        # raise instead of hanging the caller forever.
        while True:
            try:
                sink_recv_addr, self.sink_pub_addr = addr_q.get(timeout=1.0)
                break
            except queue.Empty:
                if not sink.is_alive():
                    frontend.close(linger=0)
                    raise RuntimeError(
                        f"sink process died during startup "
                        f"(exitcode {sink.exitcode})")
        self._sink_recv_addr = sink_recv_addr

        # Bounded send so the relay can observe _stop even when every
        # worker is wedged and their outboxes are full.
        backend = transport.Socket(transport.PUSH, send_timeout_ms=200)
        backend_addr = auto_bind(backend, self._ipc_dirs)

        self._backend_addr = backend_addr
        for i in range(self.num_workers):
            w = self.worker_factory(worker_id=i,
                                    receive_addr=backend_addr,
                                    sink_addr=sink_recv_addr)
            w.start()
            self._workers.append(w)

        def relay():
            try:
                while True:
                    if frontend.poll(200):
                        frames = frontend.recv_multipart()
                        if frames[0] == ServerCmd.terminate:
                            # Full shutdown, not just this thread (a
                            # half-dead server would keep respawning
                            # workers).
                            self._stop.set()
                            threading.Thread(target=self.stop,
                                             daemon=True).start()
                            break
                        while not self._stop.is_set():
                            try:
                                backend.send_multipart(frames)
                                break
                            except transport.Again:  # workers wedged:
                                continue             # retry, stay stoppable
                    if self._stop.is_set():
                        break
            finally:
                frontend.close(linger=0)
                backend.close(linger=0)

        self._thread = threading.Thread(target=relay, daemon=True)
        self._thread.start()

        def monitor():
            # PER-WORKER respawn budgets: one crash-looping worker
            # must not burn the budget shared by healthy workers, and
            # a worker that survives 60s after a respawn earns its
            # budget back. A worker whose budget is spent is given up
            # on individually; the monitor keeps serving the others.
            delay = 1.0
            counts = [0] * len(self._workers)
            last = [0.0] * len(self._workers)
            given_up = set()
            while not self._stop.wait(delay):
                for i, w in enumerate(self._workers):
                    if (w.is_alive() or self._stop.is_set()
                            or i in given_up):
                        continue
                    now = time.monotonic()
                    if counts[i] and now - last[i] >= 60.0:
                        counts[i] = 0   # survived long enough: reset
                    if counts[i] >= self.max_respawns:
                        self.logger.error(
                            "worker %d died but its respawn budget "
                            "(%d) is spent — a deterministic "
                            "failure? Giving up on this worker.",
                            i, self.max_respawns)
                        given_up.add(i)
                        continue
                    self.logger.warning(
                        "worker %d died (exitcode %s); respawning",
                        i, w.exitcode)
                    nw = self.worker_factory(
                        worker_id=i,
                        receive_addr=self._backend_addr,
                        sink_addr=self._sink_recv_addr)
                    nw.start()
                    self._workers[i] = nw
                    counts[i] += 1
                    self.respawn_count += 1
                    # Exponential backoff when deaths come fast
                    # (crash loop), reset once a worker survives.
                    delay = (min(delay * 2, 30.0)
                             if now - last[i] < 10.0 else 1.0)
                    last[i] = now

        self._monitor = threading.Thread(target=monitor, daemon=True)
        self._monitor.start()
        self.logger.info("server up: frontend=%s workers=%d",
                         self.frontend_addr, self.num_workers)
        return self

    def stop(self):
        if self._stopped:
            return
        self._stopped = True
        self._stop.set()
        me = threading.current_thread()
        if self._thread is not None and self._thread is not me:
            self._thread.join(timeout=2)
        if self._monitor is not None and self._monitor is not me:
            # Generous join: a mid-respawn spawn can take seconds;
            # snapshotting workers BEFORE the monitor finishes would
            # leak the freshly respawned process.
            self._monitor.join(timeout=15)
        # Tell the sink to stop, and give it a moment to remove its
        # socket directories.
        if self._sink_recv_addr is not None:
            s = transport.Socket(transport.PUSH, send_timeout_ms=1000)
            try:
                s.connect(self._sink_recv_addr, timeout_s=1.0)
                s.send_multipart([ServerCmd.terminate])
            except (OSError, transport.Again):
                pass
            finally:
                s.close(linger=1000)
            for p in self._procs:
                p.join(timeout=2)
        for p in self._procs + self._workers:
            p.terminate()
            p.join(timeout=2)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        # The sink's directories too, in case it did not exit cleanly.
        for addr in (self._sink_recv_addr, self.sink_pub_addr):
            if addr is not None:
                self._ipc_dirs.append(_addr_dir(addr))
        for d in self._ipc_dirs:
            shutil.rmtree(d, ignore_errors=True)
        self._ipc_dirs.clear()
