"""Carry the reference's weights across to the port.

`params_from_jax(tree, module)` maps a JAX/flax parameter tree (numpy
leaves, flax names such as `layers_0/image_attn/k_proj/kernel`) onto
the state dict of the port's `DynamicConvDecoder`, whose parameter
names mirror the flax tree (`layers.0.image_attn.k_proj.kernel`).
Kernels are (in, out) in both packages, so no leaf is transposed.

`load_npz(path)` reads the `.npz` layout of the reference server
(`news_image_caption_tpu/serving/worker.py::unflatten_params`):
'/'-joined keys, bf16 leaves stored as 2-byte void (`V2`), read here
through an int16 view, without `ml_dtypes`.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

_LAYER = re.compile(r"^layers_(\d+)$")


def torch_key(path: str) -> str:
    """'layers_0/image_attn/k_proj/kernel' -> 'layers.0.image_attn.k_proj.kernel'."""
    parts = []
    for p in path.split("/"):
        m = _LAYER.match(p)
        parts.extend(["layers", m.group(1)] if m else [p])
    return ".".join(parts)


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def to_tensor(leaf) -> torch.Tensor:
    """numpy (incl. ml_dtypes bfloat16 and raw V2) or torch leaf -> tensor."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    arr = np.asarray(leaf)
    if not arr.flags.writeable:      # e.g. a view of a JAX array
        arr = arr.copy()
    if arr.dtype.name == "bfloat16" or arr.dtype == np.dtype("V2"):
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_jax(tree: Mapping[str, Any],
                    module: nn.Module) -> Dict[str, torch.Tensor]:
    """State dict for `module` from a flax param tree (with or without
    the top-level 'params' collection). Strict: a missing, unused or
    misshapen key raises ValueError."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    mapped = {torch_key(path): leaf for path, leaf in _flatten(tree).items()}
    expected = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    missing = sorted(set(expected) - set(mapped))
    unused = sorted(set(mapped) - set(expected))
    bad = sorted(k for k in set(expected) & set(mapped)
                 if tuple(np.shape(mapped[k])) != expected[k])
    if missing or unused or bad:
        raise ValueError(f"params_from_jax: missing {missing}, unused "
                         f"{unused}, shape mismatch {bad}")
    return {k: to_tensor(mapped[k]) for k in expected}


def load_npz(path: str) -> Dict[str, Any]:
    """Nested param tree from a '/'-joined flat .npz (torch leaves)."""
    tree: Dict[str, Any] = {}
    with np.load(path) as flat:
        for key in flat.files:
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = to_tensor(flat[key])
    return tree
