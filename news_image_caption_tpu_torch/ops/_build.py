"""Build and load the port's CUDA kernels.

`function(name, argtypes)` returns a C entry point of the kernel
library. On first use in a process, every `csrc/*.cu` is compiled with
`nvcc` for `sm_90a` (one `nvcc` per source, all started together) and
linked into one shared library under
`news_image_caption_tpu_torch/_build/`, named by a hash of the sources
and flags, so a checkout builds its own kernels once and an edited
source builds anew. The library has a plain C interface and is bound
with `ctypes`: pointers pass as `c_void_p`, sizes as `c_int`, and every
entry point returns a `cudaError_t` that `check` turns into an
exception.

Nothing here runs at import time: the CPU tests import every module of
the port on machines with no `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Sequence

import torch

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

P = ctypes.c_void_p
I = ctypes.c_int
# Shared memory one block of the card can use (csrc/common.cuh).
MAX_SMEM_BYTES = 232448
# Multiprocessors of an H100: the card the kernels' `admits` predicates
# answer for where the caller names none.
H100_SMS = 132
# The dtypes the generic decode kernels take, by their entry points'
# dtype codes (csrc/decode_generic.cu).
GENERIC_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest(flags: Sequence[str]) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH);"
                       " the port's kernels are built from csrc/ with it")


def build(extra_flags: Sequence[str] = ()) -> Path:
    """Compile csrc/*.cu into the library for this source hash, unless
    it exists already; returns its path. extra_flags (a -D of a
    development build) give a library of their own."""
    flags = (*NVCC_FLAGS, *extra_flags)
    out = BUILD_DIR / f"libnic_kernels_{_digest(flags)}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objs.append(obj)
        procs.append((src.name, subprocess.Popen(
            [nvcc, *flags, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors = []
    for name, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name} ({proc.returncode}):\n{err[-8000:]}")
    tmp = out.with_name(f"{tag}.so.tmp")
    if not errors:
        res = subprocess.run([nvcc, *flags, "-shared", "-o", str(tmp),
                              *map(str, objs)], capture_output=True, text=True)
        if res.returncode != 0:
            errors.append(f"link ({res.returncode}):\n{res.stderr[-8000:]}")
    for obj in objs:
        obj.unlink(missing_ok=True)
    if errors:
        raise RuntimeError("nvcc failed: " + "\n".join(errors))
    os.replace(tmp, out)
    return out


def lib(extra_flags: Sequence[str] = ()) -> ctypes.CDLL:
    """The process's kernel library, built on first use. extra_flags
    count only on that first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build(extra_flags)))
            handle.nic_error_string.argtypes = [I]
            handle.nic_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def function(name: str, argtypes: Sequence):
    fn = getattr(lib(), name)
    fn.argtypes = list(argtypes)
    fn.restype = I
    return fn


def check(code: int, what: str) -> None:
    if code != 0:
        msg = lib().nic_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptxas_info() -> str:
    """What `nvcc -Xptxas -v` says of every kernel (registers, spills,
    static shared memory), the lines of the compiler as they come."""
    nvcc = _nvcc()
    out = []
    for src in sorted(CSRC.glob("*.cu")):
        res = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", os.devnull,
             str(src)], capture_output=True, text=True)
        out.append(f"== {src.name} (nvcc exit {res.returncode})\n{res.stderr}")
    return "\n".join(out)


def sms_of(device) -> int:
    """Multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def require(cond: bool, what: str) -> None:
    """Raise ValueError for an input the kernel does not take."""
    if not cond:
        raise ValueError(what)


if __name__ == "__main__":     # python3 -m news_image_caption_tpu_torch.ops._build
    print(ptxas_info())
