"""Dependency-free TensorBoard scalar logging.

A copy of `news_image_caption_tpu/utils/tensorboard.py`: the port
imports nothing of the JAX package.
`tests/test_torch_training_copies.py` holds the two equal.

Capability parity target: the reference's `log_to_tensorboard`
callback (ttl/expt/goodnews/5_transformer_roberta/
config.yaml:160-163, `summary_interval: 512`) and Gen-1's tf.summary
scalars (train.py:21-28,199-204). It needs neither TensorFlow nor
tensorboardX: it writes the TensorBoard event-file format directly:

- TFRecord framing: <len:u64le> <masked_crc32c(len):u32le> <payload>
  <masked_crc32c(payload):u32le>.
- Payload = `Event` protobuf (event.proto), hand-encoded on the wire:
  Event{wall_time=1:double, step=2:int64, file_version=3:string,
  summary=5:Summary}; Summary{value=1:repeated Value};
  Value{tag=1:string, simple_value=2:float}.
- CRC32C (Castagnoli) with TensorFlow's rotate-and-add masking.

`read_events` parses the files back (used by tests and by anyone
without TensorBoard installed); files load in stock TensorBoard.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Iterator, List, NamedTuple, Optional, Tuple

# ----------------------------------------------------------------------
# CRC32C (Castagnoli, polynomial 0x82F63B78, reflected) + TF masking.
# ----------------------------------------------------------------------

_CRC_TABLE: List[int] = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 if _c & 1 else 0)
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


_MASK_DELTA = 0xA282EAD8


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


# ----------------------------------------------------------------------
# Minimal protobuf wire encoding (only what Event needs).
# ----------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _int64(field: int, v: int) -> bytes:
    if v < 0:
        v += 1 << 64
    return _key(field, 0) + _varint(v)


def _bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _encode_event(wall_time: float, step: Optional[int] = None,
                  file_version: Optional[str] = None,
                  scalars: Optional[List[Tuple[str, float]]] = None
                  ) -> bytes:
    msg = _double(1, wall_time)
    if step is not None:
        msg += _int64(2, step)
    if file_version is not None:
        msg += _bytes(3, file_version.encode())
    if scalars:
        summary = b""
        for tag, value in scalars:
            val = _bytes(1, tag.encode()) + _float(2, float(value))
            summary += _bytes(1, val)
        msg += _bytes(5, summary)
    return msg


def _frame(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", masked_crc32c(header))
            + payload + struct.pack("<I", masked_crc32c(payload)))


# ----------------------------------------------------------------------
# Writer / reader
# ----------------------------------------------------------------------

class SummaryWriter:
    """Append-only TensorBoard scalar writer.

    with SummaryWriter(logdir) as w:
        w.add_scalar("train/loss", 2.3, step=100)
    """

    _seq = 0   # per-process uniquifier

    def __init__(self, logdir: str, filename_suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        # pid + sequence keep two writers created in the same second
        # (parallel runs, back-to-back trainers in tests) from
        # appending interleaved frames to one file.
        SummaryWriter._seq += 1
        name = "events.out.tfevents.%010d.%s.%d.%d%s" % (
            int(time.time()), socket.gethostname(), os.getpid(),
            SummaryWriter._seq, filename_suffix)
        self.path = os.path.join(logdir, name)
        self._f = open(self.path, "ab")
        # TensorBoard requires a leading file_version event.
        self._write(_encode_event(time.time(),
                                  file_version="brain.Event:2"))

    def _write(self, payload: bytes):
        self._f.write(_frame(payload))

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: Optional[float] = None):
        self._write(_encode_event(wall_time or time.time(),
                                  step=int(step),
                                  scalars=[(tag, value)]))

    def add_scalars(self, scalars: List[Tuple[str, float]], step: int,
                    wall_time: Optional[float] = None):
        """One event carrying several (tag, value) pairs."""
        self._write(_encode_event(wall_time or time.time(),
                                  step=int(step), scalars=scalars))

    def flush(self):
        self._f.flush()

    def close(self):
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ScalarEvent(NamedTuple):
    wall_time: float
    step: int
    tag: str
    value: float


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _decode_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val = struct.unpack_from("<d", buf, pos)[0]
            pos += 8
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            val = buf[pos:pos + n]
            pos += n
        elif wire == 5:
            val = struct.unpack_from("<f", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def read_events(path: str, verify_crc: bool = True
                ) -> List[ScalarEvent]:
    """Parse scalar events back out of a TensorBoard event file."""
    out: List[ScalarEvent] = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        (length,) = struct.unpack_from("<Q", data, pos)
        (len_crc,) = struct.unpack_from("<I", data, pos + 8)
        payload = data[pos + 12:pos + 12 + length]
        (crc,) = struct.unpack_from("<I", data, pos + 12 + length)
        if verify_crc:
            if masked_crc32c(data[pos:pos + 8]) != len_crc:
                raise ValueError(f"length CRC mismatch at {pos}")
            if masked_crc32c(payload) != crc:
                raise ValueError(f"payload CRC mismatch at {pos}")
        pos += 12 + length + 4
        wall_time, step, summary = 0.0, 0, None
        for field, _, val in _decode_fields(payload):
            if field == 1:
                wall_time = float(val)
            elif field == 2:
                step = int(val)
            elif field == 5:
                summary = val
        if summary is None:
            continue
        for field, _, val in _decode_fields(summary):
            if field != 1:
                continue
            tag, simple = "", None
            for f2, _, v2 in _decode_fields(val):
                if f2 == 1:
                    tag = v2.decode()
                elif f2 == 2:
                    simple = float(v2)
            if simple is not None:
                out.append(ScalarEvent(wall_time, step, tag, simple))
    return out
