"""Python bindings for the C++ shard reader (ctypes, no pybind11).

Counterpart of `news_image_caption_tpu/data/native_loader.py` (`MAGIC`,
`get_lib`, `write_shard`, `NativeShardLoader`): the same file format,
batches and pool semantics; `tests/test_torch_shards.py` holds the two
equal. The reader is the port's own copy of the C++ source,
`native/shard_reader.cc`. On first use in a process `get_lib` compiles
it with `g++` (the reference Makefile's flags) into
`news_image_caption_tpu_torch/_build/`, named by a hash of the source
and flags, so a checkout builds its own reader once and an edited
source builds anew. Without `g++`, or when the build fails, it raises:
there is no Python reader to fall back to.

Shard format "NICS1": fixed-size records; a JSON sidecar (`.schema`)
describes the fields packed into each record so Python can view the
raw batch buffer as named numpy arrays with zero copies.

Usage:
    write_shard("train-000.nics", {"caption_ids": ..., "image": ...})
    loader = NativeShardLoader(["train-000.nics"], batch_size=16)
    for batch in loader.epoch(shuffle=True, seed=0):
        ...  # dict of numpy views
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import struct
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterator, Sequence

import numpy as np

MAGIC = 0x31453434950
PACKAGE = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE / "native" / "shard_reader.cc"
BUILD_DIR = PACKAGE / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")

_lock = threading.Lock()
_lib = None


def build() -> Path:
    """Compile `native/shard_reader.cc` into the library for this
    source hash, unless it exists already; returns its path."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    out = BUILD_DIR / f"libshard_reader_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found (set CXX or put g++ on PATH); the "
                           "shard reader is built from native/shard_reader.cc")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.so.tmp")
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the shard reader failed "
                           f"({res.returncode}):\n{res.stderr[-8000:]}")
    os.replace(tmp, out)
    return out


def get_lib():
    """Load (building if needed) the native library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.shard_open.restype = ctypes.c_void_p
        lib.shard_open.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                   ctypes.c_int]
        lib.shard_num_records.restype = ctypes.c_long
        lib.shard_num_records.argtypes = [ctypes.c_void_p]
        lib.shard_record_bytes.restype = ctypes.c_long
        lib.shard_record_bytes.argtypes = [ctypes.c_void_p]
        lib.shard_start.restype = ctypes.c_int
        lib.shard_start.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                    ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_long,
                                    ctypes.c_int]
        lib.shard_start_soa.restype = ctypes.c_int
        lib.shard_start_soa.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                        ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_long,
                                        ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_long),
                                        ctypes.c_int]
        lib.shard_next.restype = ctypes.c_long
        lib.shard_next.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_uint8),
                                   ctypes.c_long]
        lib.shard_stop.argtypes = [ctypes.c_void_p]
        lib.shard_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def write_shard(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """Write a fixed-record shard + JSON schema sidecar.

    Every array's leading dim is the record count; trailing dims and
    dtypes define the record layout.
    """
    n = None
    schema = []
    for k, a in arrays.items():
        a = np.ascontiguousarray(a)
        if n is None:
            n = a.shape[0]
        assert a.shape[0] == n, f"{k}: leading dim mismatch"
        schema.append({"name": k, "dtype": str(a.dtype),
                       "shape": list(a.shape[1:])})
    record_bytes = sum(
        int(np.dtype(f["dtype"]).itemsize * max(np.prod(f["shape"]), 1))
        for f in schema)
    # One vectorized interleave instead of n * len(fields) Python
    # tobytes() calls: view each field as (n, field_bytes) uint8 and
    # concatenate along the record axis.
    flat = [np.ascontiguousarray(arrays[spec["name"]])
            .reshape(n, -1).view(np.uint8).reshape(n, -1)
            for spec in schema]
    records = np.concatenate(flat, axis=1)
    assert records.shape[1] == record_bytes
    with open(path, "wb") as f:
        f.write(struct.pack("<QQQ", MAGIC, n, record_bytes))
        f.write(records.tobytes())
    with open(path + ".schema", "w") as f:
        json.dump({"record_bytes": record_bytes, "fields": schema}, f)


class NativeShardLoader:
    """Threaded native prefetch over one or more shards."""

    def __init__(self, paths: Sequence[str], batch_size: int,
                 n_threads: int = 2, n_slots: int = 4,
                 drop_last: bool = True, soa: bool = True,
                 pool_size: int = 8):
        """soa=True (default): the C++ workers deinterleave records
        into per-field contiguous regions, so each yielded field array
        is a ZERO-COPY view of a staging buffer. Buffers rotate
        through a pool of `pool_size`; a yielded batch stays valid
        until `pool_size` further batches have been drawn (consumers
        that hold batches longer — unusual — should copy or set
        soa=False for the always-copied AoS path).
        """
        self.paths = list(paths)
        self.batch_size = batch_size
        self.n_threads = n_threads
        self.n_slots = n_slots
        self.drop_last = drop_last
        self.soa = soa
        self.pool_size = max(2, pool_size)
        with open(self.paths[0] + ".schema") as f:
            self.schema = json.load(f)
        lib = get_lib()
        arr = (ctypes.c_char_p * len(self.paths))(
            *[p.encode() for p in self.paths])
        self._h = lib.shard_open(arr, len(self.paths))
        self._epoch_gen = 0
        if not self._h:
            raise OSError(f"failed to open shards: {self.paths}")
        assert lib.shard_record_bytes(self._h) == \
            self.schema["record_bytes"], "schema/shard mismatch"

    def _handle(self):
        if not self._h:
            raise ValueError("loader is closed")
        return self._h

    def __len__(self):
        return get_lib().shard_num_records(self._handle())

    def _field_sizes(self):
        return [int(np.dtype(f["dtype"]).itemsize
                    * max(np.prod(f["shape"]), 1))
                for f in self.schema["fields"]]

    def _view(self, buf: np.ndarray, n: int) -> Dict[str, np.ndarray]:
        """Reinterpret the raw [n, record_bytes] buffer as field arrays."""
        out = {}
        offset = 0
        rb = self.schema["record_bytes"]
        flat = buf[:n * rb].reshape(n, rb)
        for f in self.schema["fields"]:
            dt = np.dtype(f["dtype"])
            size = int(dt.itemsize * max(np.prod(f["shape"]), 1))
            field = flat[:, offset:offset + size]
            out[f["name"]] = np.ascontiguousarray(field).view(dt).reshape(
                [n] + f["shape"])
            offset += size
        return out

    def _view_soa(self, buf: np.ndarray, n: int) -> Dict[str, np.ndarray]:
        """Zero-copy field views of an SoA-filled staging buffer
        (field f occupies [offset_f, offset_f + n * size_f); offsets
        are strided by the FULL batch_size, so partial batches still
        start each field at the same place)."""
        out = {}
        offset = 0
        for f, size in zip(self.schema["fields"], self._field_sizes()):
            dt = np.dtype(f["dtype"])
            out[f["name"]] = buf[offset:offset + n * size].view(
                dt).reshape([n] + f["shape"])
            offset += self.batch_size * size
        return out

    def epoch(self, shuffle: bool = True, seed: int = 0
              ) -> Iterator[Dict[str, np.ndarray]]:
        lib = get_lib()
        rb = self.schema["record_bytes"]
        # Epoch generation token: a stale generator's deferred
        # finalization (GC of an abandoned iterator) must not stop
        # the CURRENTLY running epoch or touch a closed handle.
        self._epoch_gen = getattr(self, "_epoch_gen", 0) + 1
        my_gen = self._epoch_gen
        if self.soa:
            sizes = self._field_sizes()
            arr = (ctypes.c_long * len(sizes))(*sizes)
            rc = lib.shard_start_soa(
                self._handle(), self.batch_size, self.n_threads,
                self.n_slots,
                int(shuffle), seed, int(self.drop_last), arr,
                len(sizes))
            if rc < 0:
                raise ValueError("field sizes do not sum to "
                                 "record_bytes (schema mismatch)")
            pool = [np.empty(self.batch_size * rb, np.uint8)
                    for _ in range(self.pool_size)]
        else:
            lib.shard_start(self._handle(), self.batch_size,
                            self.n_threads, self.n_slots,
                            int(shuffle), seed, int(self.drop_last))
            pool = [np.empty(self.batch_size * rb, np.uint8)]
        view = self._view_soa if self.soa else self._view
        k = 0
        try:
            while True:
                if not self._h or self._epoch_gen != my_gen:
                    break      # closed / superseded mid-iteration
                buf = pool[k % len(pool)]
                ptr = buf.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_uint8))
                n = lib.shard_next(self._h, ptr, buf.nbytes)
                if n == 0:
                    break
                k += 1
                yield view(buf, int(n))
        finally:
            if self._h and self._epoch_gen == my_gen:
                lib.shard_stop(self._h)

    def close(self):
        if self._h:
            get_lib().shard_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
