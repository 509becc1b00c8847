"""Message sockets for the serving stack, on AF_UNIX stream sockets.

The reference's serving stack (`news_image_caption_tpu/serving/`) runs
over pyzmq. The port does not depend on pyzmq: it carries the few zmq
socket roles that serving uses on the standard library alone, with one
implementation everywhere:

- PUSH -> PULL, fan-in: many PUSH sockets connect to one bound PULL,
  which reads from all of them (clients to the server's frontend,
  workers to the sink);
- PUSH -> PULL, fan-out: one bound PUSH hands each message to the next
  connected PULL in turn, skipping one whose outbox is full (the
  server's backend to its workers);
- PUB -> SUB: a bound PUB sends each message to every connected SUB
  with a prefix of its first frame (the sink to the clients).

Messages are lists of byte strings (`send_multipart`/`recv_multipart`).
Addresses keep zmq's form, `ipc://<path>`, the path a socket file that
`bind` creates and `close` removes.

A connection opens with a hello: the connecting socket's role and, for
a SUB, its prefixes. The bound socket registers the peer before it
answers, so when `connect` returns the PULL is in the round robin, or
the subscription is in place: there is no slow-joiner window in which a
PUB drops a SUB's first messages.

On the stream a message is a header (the frame count and each frame's
length, little-endian) followed by the frames, written together with
`sendmsg` from their own buffers, never joined into one. Each
connection has a reader thread (it reads messages on a PULL or SUB, and
waits for the peer's end on a PUSH or PUB) and, on a PUSH or PUB, a
writer thread that drains the connection's outbox of at most `HWM`
messages. A PUSH waits for room up to `send_timeout_ms` and then raises
`Again` (zmq's SNDTIMEO); a PUB drops a message for a subscriber whose
outbox is full, as zmq's PUB does at its high-water mark. A peer that
goes away is dropped with what its outbox held, as zmq drops a pipe.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time
from collections import deque
from typing import Iterable, List, Optional

PUSH, PULL, PUB, SUB = "push", "pull", "pub", "sub"
# The role a connecting socket must have for each role that binds.
_CONNECTS_TO = {PULL: PUSH, PUSH: PULL, PUB: SUB}
_HELLO = b"nic-transport-1"
_COUNT = struct.Struct("<I")
_MAX_FRAMES = 4096
_HANDSHAKE_S = 10.0
# Messages an outbox (a PUSH's or PUB's, one a connection) or the inbox
# (a PULL's or SUB's, shared by its connections) holds. A full inbox
# stops reading, so its senders block in turn. A flagship B=16 job is
# 40 MB, so this also bounds a socket's memory.
HWM = 100


class Again(Exception):
    """A send found no room within the socket's send timeout."""


class Closed(OSError):
    """The socket was closed while, or before, it was used."""


def _path(addr: str) -> str:
    if not addr.startswith("ipc://"):
        raise ValueError(f"address {addr!r}: only ipc://<path> is supported")
    return addr[len("ipc://"):]


def _send_frames(sock: socket.socket, frames: List[bytes]) -> None:
    header = _COUNT.pack(len(frames)) + struct.pack(
        f"<{len(frames)}Q", *(len(f) for f in frames))
    views = [memoryview(header)] + [memoryview(f).cast("B") for f in frames
                                    if len(f)]
    while views:
        n = sock.sendmsg(views)
        while n:
            if n >= len(views[0]):
                n -= len(views[0])
                views.pop(0)
            else:
                views[0] = views[0][n:]
                n = 0


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks, got = [], 0
    while got < n:
        chunk = sock.recv(n - got, socket.MSG_WAITALL)
        if not chunk:
            raise EOFError("peer closed the connection")
        chunks.append(chunk)
        got += len(chunk)
    return chunks[0] if len(chunks) == 1 else b"".join(chunks)


def _recv_frames(sock: socket.socket) -> List[bytes]:
    (count,) = _COUNT.unpack(_recv_exact(sock, _COUNT.size))
    if not 0 < count <= _MAX_FRAMES:
        raise ValueError(f"bad frame count {count}")
    lengths = struct.unpack(f"<{count}Q", _recv_exact(sock, 8 * count))
    return [_recv_exact(sock, n) if n else b"" for n in lengths]


class _Peer:
    """One connection: its socket, outbox and subscription prefixes."""

    def __init__(self, sock: socket.socket, prefixes: Iterable[bytes] = ()):
        self.sock = sock
        self.prefixes = tuple(prefixes)
        self.out: deque = deque()   # messages not yet fully written
        self.alive = True
        self.users = 0              # peer threads still running

    def wants(self, first: bytes) -> bool:
        return any(first.startswith(p) for p in self.prefixes)


class Socket:
    """One socket of a role (PUSH, PULL, PUB or SUB) that either binds
    an address or connects to one.

    send_timeout_ms: how long a PUSH's send waits for room in an outbox
    (`HWM` messages); None waits for ever.
    """

    def __init__(self, kind: str, send_timeout_ms: Optional[int] = None):
        if kind not in (PUSH, PULL, PUB, SUB):
            raise ValueError(f"unknown socket kind {kind!r}")
        self.kind = kind
        self.hwm = HWM
        self.send_timeout_ms = send_timeout_ms
        self._cond = threading.Condition()
        self._peers: List[_Peer] = []
        self._inbox: deque = deque()
        self._next = 0            # the PUSH round robin's next peer
        self._prefixes: List[bytes] = []
        self._closed = False
        self._used = False        # bound or connected
        self._bound_path: Optional[str] = None

    # -- setup -------------------------------------------------------

    def subscribe(self, prefix: bytes) -> None:
        """A SUB's filter: it receives the messages whose first frame
        starts with one of its prefixes. Set before `connect`."""
        if self.kind != SUB:
            raise ValueError("subscribe is for SUB sockets")
        if self._used:
            raise RuntimeError("subscribe before connect")
        self._prefixes.append(bytes(prefix))

    def bind(self, addr: str) -> None:
        if self.kind not in _CONNECTS_TO:
            raise ValueError(f"a {self.kind.upper()} socket connects only")
        self._start_use()
        path = _path(addr)
        listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            listener.bind(path)
            listener.listen(64)
            listener.settimeout(0.2)
        except OSError:
            listener.close()
            raise
        self._bound_path = path
        self._thread(self._accept_loop, listener)

    def connect(self, addr: str, timeout_s: float = 10.0) -> None:
        """Connect and register with the bound socket; returns once the
        peer has registered this one (retrying a missing or refusing
        address up to timeout_s)."""
        if self.kind == PUB:
            raise ValueError("a PUB socket binds only")
        self._start_use()
        path = _path(addr)
        deadline = time.monotonic() + timeout_s
        while True:
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                sock.connect(path)
                break
            except (FileNotFoundError, ConnectionRefusedError):
                sock.close()
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.05)
        try:
            sock.settimeout(_HANDSHAKE_S)
            _send_frames(sock, [_HELLO, self.kind.encode(), *self._prefixes])
            reply = _recv_frames(sock)
            if reply[0] != b"ok":
                raise ConnectionError(
                    f"{addr}: {b' '.join(reply).decode(errors='replace')}")
            sock.settimeout(None)
        except BaseException:
            sock.close()
            raise
        peer = _Peer(sock)
        with self._cond:
            if self._closed:
                sock.close()
                raise Closed("socket closed")
            self._peers.append(peer)
        self._run_peer(peer)

    def _start_use(self) -> None:
        with self._cond:
            if self._closed:
                raise Closed("socket closed")
            if self._used:
                raise RuntimeError("a socket binds or connects once")
            self._used = True

    def _thread(self, target, *args) -> None:
        threading.Thread(target=target, args=args, daemon=True).start()

    def _accept_loop(self, listener: socket.socket) -> None:
        # The listener is closed here, by the one thread that uses it,
        # within 0.2 s of `close` (which removes its file at once).
        try:
            while not self._closed:
                try:
                    conn, _ = listener.accept()
                except socket.timeout:
                    continue
                self._thread(self._admit, conn)
        except OSError:
            pass
        finally:
            listener.close()

    def _admit(self, conn: socket.socket) -> None:
        """A bound socket's side of the hello: check the role, register
        the peer, then answer."""
        try:
            conn.settimeout(_HANDSHAKE_S)
            hello = _recv_frames(conn)
            want = _CONNECTS_TO[self.kind]
            if hello[0] != _HELLO or hello[1] != want.encode():
                _send_frames(conn, [b"error", b"a %s socket takes %s "
                                    b"connections" % (self.kind.encode(),
                                                      want.encode())])
                conn.close()
                return
        except (OSError, EOFError, ValueError, IndexError, struct.error):
            conn.close()
            return
        peer = _Peer(conn, hello[2:])
        with self._cond:
            if self._closed:
                conn.close()
                return
            self._peers.append(peer)
            self._cond.notify_all()
        try:
            _send_frames(conn, [b"ok"])
            conn.settimeout(None)
        except OSError:
            with self._cond:
                self._peers.remove(peer)
                peer.alive = False
            conn.close()
            return
        self._run_peer(peer)

    def _run_peer(self, peer: _Peer) -> None:
        sends = self.kind in (PUSH, PUB)
        with self._cond:
            peer.users = 2 if sends else 1
        if sends:
            self._thread(self._write_loop, peer)
        self._thread(self._read_loop, peer)

    # -- peer threads ------------------------------------------------

    def _read_loop(self, peer: _Peer) -> None:
        try:
            while True:
                frames = _recv_frames(peer.sock)
                if self.kind not in (PULL, SUB):
                    return          # a PUSH's or PUB's peer sends nothing
                with self._cond:
                    while (len(self._inbox) >= self.hwm and peer.alive
                           and not self._closed):
                        self._cond.wait()
                    if not peer.alive or self._closed:
                        return
                    self._inbox.append(frames)
                    self._cond.notify_all()
        except (OSError, EOFError, ValueError, struct.error):
            pass
        finally:
            self._drop(peer)

    def _write_loop(self, peer: _Peer) -> None:
        try:
            while True:
                with self._cond:
                    while peer.alive and not peer.out:
                        self._cond.wait()
                    if not peer.alive:
                        return
                    frames = peer.out[0]
                _send_frames(peer.sock, frames)
                with self._cond:
                    peer.out.popleft()
                    self._cond.notify_all()
        except OSError:
            pass
        finally:
            self._drop(peer)

    def _drop(self, peer: _Peer) -> None:
        """Called by each of a peer's threads as it ends: the first
        takes the peer out and wakes the other, the last closes its
        socket (so no thread uses a closed descriptor)."""
        with self._cond:
            if peer.alive:
                peer.alive = False
                peer.out.clear()
                if peer in self._peers:
                    self._peers.remove(peer)
                self._cond.notify_all()
            peer.users -= 1
            last = peer.users == 0
        try:
            peer.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        if last:
            peer.sock.close()

    # -- messages ----------------------------------------------------

    def send_multipart(self, frames: List[bytes]) -> None:
        if self.kind not in (PUSH, PUB):
            raise ValueError(f"a {self.kind.upper()} socket does not send")
        frames = list(frames)
        if not frames:
            raise ValueError("a message has at least one frame")
        with self._cond:
            if self.kind == PUB:
                self._check_open()
                for p in self._peers:
                    if p.wants(frames[0]) and len(p.out) < self.hwm:
                        p.out.append(frames)
                self._cond.notify_all()
                return
            deadline = (None if self.send_timeout_ms is None else
                        time.monotonic() + self.send_timeout_ms / 1e3)
            while True:
                self._check_open()
                n = len(self._peers)
                for i in range(n):
                    p = self._peers[(self._next + i) % n]
                    if len(p.out) < self.hwm:
                        p.out.append(frames)
                        self._next = (self._next + i + 1) % n
                        self._cond.notify_all()
                        return
                left = None if deadline is None else deadline - time.monotonic()
                if left is not None and left <= 0:
                    raise Again(f"no room to send within "
                                f"{self.send_timeout_ms} ms")
                self._cond.wait(left)

    def poll(self, timeout_ms: Optional[int] = None) -> bool:
        """True once a message is waiting (PULL, SUB), within timeout_ms
        (None: wait for ever)."""
        with self._cond:
            self._cond.wait_for(lambda: self._inbox or self._closed,
                                None if timeout_ms is None
                                else timeout_ms / 1e3)
            return bool(self._inbox)

    def recv_multipart(self) -> List[bytes]:
        if self.kind not in (PULL, SUB):
            raise ValueError(f"a {self.kind.upper()} socket does not receive")
        with self._cond:
            while not self._inbox:
                self._check_open()
                self._cond.wait()
            frames = self._inbox.popleft()
            self._cond.notify_all()
            return frames

    def _check_open(self) -> None:
        if self._closed:
            raise Closed("socket closed")

    # -- teardown ----------------------------------------------------

    def close(self, linger: Optional[int] = None) -> None:
        """Close every connection and remove a bound socket's file.
        linger: how long, in ms, to wait first for the outboxes to be
        written (0: drop them; None: wait while their peers live)."""
        with self._cond:
            if self._closed:
                return
            if linger != 0:
                deadline = (None if linger is None
                            else time.monotonic() + linger / 1e3)
                while any(p.out for p in self._peers):
                    left = (None if deadline is None
                            else deadline - time.monotonic())
                    if left is not None and left <= 0:
                        break
                    self._cond.wait(left)
            self._closed = True
            peers = list(self._peers)
            self._cond.notify_all()
        for p in peers:
            try:
                p.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        if self._bound_path is not None:
            try:
                os.unlink(self._bound_path)
            except FileNotFoundError:
                pass
