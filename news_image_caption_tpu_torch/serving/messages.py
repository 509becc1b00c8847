"""Wire format: JSON header + raw numpy buffers as multipart frames.

A copy of `news_image_caption_tpu/serving/messages.py`: the port imports
nothing of the JAX package. `tests/test_torch_serving.py` holds the two
packages' frames equal for the same dicts.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List

import numpy as np


def pack(obj: Dict[str, Any]) -> List[bytes]:
    """Dict (values: JSON-able or np.ndarray) -> multipart frames."""
    header: Dict[str, Any] = {"keys": {}}
    frames: List[bytes] = [b""]  # placeholder for header
    for k, v in obj.items():
        if isinstance(v, np.ndarray):
            # Wire dtypes must be vanilla-numpy decodable: a client
            # without ml_dtypes cannot np.frombuffer('bfloat16')
            # (attention maps from a bf16 model ship that way).
            # bf16 -> f32 is value-exact.
            if v.dtype.name == "bfloat16":
                v = v.astype(np.float32)
            header["keys"][k] = {
                "kind": "ndarray", "dtype": str(v.dtype),
                "shape": list(v.shape), "frame": len(frames)}
            frames.append(np.ascontiguousarray(v).tobytes())
        else:
            header["keys"][k] = {"kind": "json", "value": v}
    frames[0] = json.dumps(header).encode()
    return frames


def unpack(frames: List[bytes]) -> Dict[str, Any]:
    header = json.loads(frames[0])
    out: Dict[str, Any] = {}
    for k, meta in header["keys"].items():
        if meta["kind"] == "ndarray":
            buf = frames[meta["frame"]]
            out[k] = np.frombuffer(buf, dtype=meta["dtype"]).reshape(
                meta["shape"])
        else:
            out[k] = meta["value"]
    return out
