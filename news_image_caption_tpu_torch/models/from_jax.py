"""Carry the reference's weights across to the port.

`params_from_jax(tree, module)` maps a JAX/flax parameter tree (numpy
leaves, flax names such as `layers_0/image_attn/k_proj/kernel`) onto
the state dict of a port module whose parameter names mirror the flax
tree (`layers.0.image_attn.k_proj.kernel`): the `DynamicConvDecoder`,
the LSTM captioner (`cells_0.ih.kernel`, `h0_0`), the Gen-2
transformer (`layers.0.norm_0.a_2`, `embed.embedding`) and the Gen-1
captioners (`core.rnn.ih_0.kernel`, `logit.kernel`; convolutions'
kernels in flax's layout in both packages). The decoder's options'
parameters map by their flax names too: a `LightweightConv`'s
`conv.weight`, the final `layer_norm`, untied tables `untied_head` and
`untied_tail_{i}`, a learned position table's `embedding`, a
`GatedLinear`'s `fc1`-`fc3` and a `DownsampledMultiHeadAttention`'s
`q{i}` / `k{i}` / `v{i}` / `o{i}` (or `q` / `k` / `v`) and `out_proj`.
Kernels are (in, out) in both packages, so no leaf is transposed: the
copy head's raw `q_proj_weight` [E, E] and `k_proj_weight` [kdim, E]
are used as `x @ W` in both too. A pointer's variables
{captioner, entity_attn, entity_fc, copy_attn}, each with its own
`params` collection, map onto `models/pointer.py::TransformerPointer`,
the captioner's under `decoder.`. TGNC's variables {classifier,
decoder} (or {classifier, captioner} without the template decoder) map
onto `models/tgnc.py::TGNCModule` under the same names; its heads keep
flax's `head_{i}`. The online pipeline's variables
{captioner, resnet, roberta, weighted_sum} map onto `models/pipeline.py::
Gen3Pipeline` the same way, its encoders' leaves into PyTorch's layout:
conv kernels HWIO -> OIHW and Dense kernels transposed, as `weight`;
`Embed.embedding` and a LayerNorm's `scale` as `weight`; the frozen
BatchNorm's four leaves and `bert_weight` as they are. The detectors'
bare variables (`PNet`, `RNet`, `ONet`, `InceptionResnetV1`,
`YoloV3SPP` of `models/facenet.py` and `models/yolov3.py`, whose
classes set `torch_layout`) map the same way: every kernel as `weight`,
OIHW or [out, in]; biases, the PReLU slopes and the frozen BatchNorm's
leaves as they are.

`state_from_jax(tree, state)` carries a whole JAX `TrainState` (as
flax's state dict) into the port's `training/train_step.py::TrainState`:
the step, the params, the O2 master and the optimizer chain's Adam
moments and count (BertAdam's, or Noam's `scale_by_adam` and schedule),
so a run resumed in the port continues JAX's trajectory.

An optax `masked` state (the pipeline's optimizer) is read through its
`inner_state`: the frozen leaves' `MaskedNode`s are empty, so the moments
cover the trainable parameters alone, as the port's do.

`encoder_state(tree, collection)` maps one encoder's tree, unchecked
(the `port` command's bundled encoders). `flax_view(module)` is the
inverse of `params_from_jax`: the port
model's parameters as the reference's flax variables, the init tree onto
which the `port` command grafts a ported reference checkpoint.

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
# Collections whose leaves are stored in PyTorch's layout.
_TORCH_LAYOUT = ("resnet", "roberta")


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
    misshapen key raises ValueError. A module with `torch_layout` set
    (the detectors of `models/facenet.py` and `models/yolov3.py`) takes
    every kernel in PyTorch's layout, as `weight`."""
    return _mapped(tree, {k: tuple(v.shape)
                          for k, v in module.state_dict().items()},
                   getattr(module, "torch_layout", False))


def _strip(tree: Mapping[str, Any]) -> Mapping[str, Any]:
    return tree["params"] if set(tree) == {"params"} else tree


def _mapped(tree: Mapping[str, Any], expected: Dict[str, tuple],
            torch_layout: bool = False) -> Dict[str, torch.Tensor]:
    tree = _strip(tree)
    if "classifier" in tree:
        # TGNC's variables: each part its own collection, named as the
        # port's (`classifier.`, then `decoder.` or `captioner.`).
        tree = {k: _strip(v) for k, v in tree.items()}
    elif "captioner" in tree:
        # The pointer's variables: each part its own collection, the
        # captioner's params the port's `decoder.`.
        tree = {("decoder" if k == "captioner" else k): _strip(v)
                for k, v in tree.items()}
    mapped = dict(_torch_layout(torch_key(path), leaf, torch_layout)
                  for path, leaf in _flatten(tree).items())
    missing = sorted(set(expected) - set(mapped))
    unused = sorted(set(mapped) - set(expected))
    bad = sorted(k for k in set(expected) & set(mapped)
                 if tuple(np.shape(mapped[k])) != expected[k])
    if missing or unused or bad:
        raise ValueError(f"params_from_jax: missing {missing}, unused "
                         f"{unused}, shape mismatch {bad}")
    return {k: to_tensor(mapped[k]) for k in expected}


def _torch_layout(key: str, leaf, detector: bool = False):
    """(key, leaf) of an encoder's or a detector's leaf in PyTorch's
    layout: a kernel (HWIO conv or [in, out] Dense) as `weight` (OIHW or
    [out, in]), an encoder's embedding table and a LayerNorm's scale as
    `weight`; other keys, and the FrozenBatchNorm's `scale`, as they
    are."""
    parts = key.split(".")
    if not detector and parts[0] not in _TORCH_LAYOUT:
        return key, leaf
    name = parts[-1]
    if name == "kernel":
        perm = (3, 2, 0, 1) if np.ndim(leaf) == 4 else (1, 0)
        leaf = (leaf.permute(perm).contiguous()
                if isinstance(leaf, torch.Tensor)
                else np.ascontiguousarray(np.transpose(leaf, perm)))
    elif not (name == "embedding"
              or (name == "scale" and parts[0] == "roberta")):
        return key, leaf
    return ".".join(parts[:-1] + ["weight"]), leaf


def encoder_state(tree: Mapping[str, Any],
                  collection: str) -> Dict[str, torch.Tensor]:
    """A ResNet's or RoBERTa's flax tree (`collection` "resnet" or
    "roberta", with or without its 'params') as the port encoder's state
    dict in PyTorch's layout. Unchecked: `load_state_dict` checks it
    against the encoder it is loaded into."""
    out = {}
    for path, leaf in _flatten(_strip(tree)).items():
        key, leaf = _torch_layout(torch_key(f"{collection}/{path}"), leaf)
        out[key[len(collection) + 1:]] = to_tensor(leaf)
    return out


def flax_view(module: nn.Module) -> Dict[str, Any]:
    """`module`'s parameters as the reference's flax variables (float32
    numpy leaves): the inverse of `params_from_jax`, so
    `params_from_jax(flax_view(m), m)` is `m`'s state dict. A model of
    parts (the pointer, the pipeline, TGNC: parameters under `decoder.`,
    `captioner.` or `classifier.`) is a tree of collections, one a part,
    the pointer's and the pipeline's `decoder` named `captioner`; any
    other model is {"params": tree}. `layers.{i}` is `layers_{i}`; the
    encoders' leaves are in flax's layout (conv kernels HWIO, Dense
    kernels [in, out], `embedding`, a LayerNorm's `scale`)."""
    flat = {}
    for key, t in module.state_dict().items():
        path, leaf = _flax_layout(module, key,
                                  t.detach().float().cpu().numpy())
        flat[path] = leaf
    tops = {p.split("/")[0] for p in flat}
    if tops & {"decoder", "captioner", "classifier"}:
        rename = ({} if "classifier" in tops
                  else {"decoder": "captioner"})
        grouped = {}
        for path, leaf in flat.items():
            top, rest = path.split("/", 1)
            grouped[f"{rename.get(top, top)}/params/{rest}"] = leaf
        flat = grouped
    else:
        flat = {f"params/{p}": v for p, v in flat.items()}
    tree: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = tree
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf
    return tree


def _flax_layout(module: nn.Module, key: str, leaf: np.ndarray):
    """('/'-joined flax path, leaf) of the port's parameter `key`: the
    inverse of `torch_key` and `_torch_layout`."""
    parts = key.split(".")
    path = []
    for p in parts:
        if p.isdigit() and path and path[-1] == "layers":
            path[-1] = f"layers_{p}"
        else:
            path.append(p)
    if parts[0] in _TORCH_LAYOUT and parts[-1] == "weight":
        owner = type(module.get_submodule(".".join(parts[:-1]))).__name__
        if owner == "Embed":
            path[-1] = "embedding"
        elif leaf.ndim == 1:
            path[-1] = "scale"
        else:
            path[-1] = "kernel"
            leaf = np.ascontiguousarray(np.transpose(
                leaf, (2, 3, 1, 0) if leaf.ndim == 4 else (1, 0)))
    return "/".join(path), leaf


def _adam_from_jax(chain: Mapping[str, Any], expected):
    """The port's Adam state dict (count, mu, nu) from optax's chain
    state, BertAdam's (clip -> adam without bias correction -> decayed
    weights -> learning rate) or Noam's (scale_by_adam -> learning
    rate): the adam stage's moments, the learning-rate stage's count."""
    stages = [chain[k] for k in sorted(chain, key=int)]
    adam = [s for s in stages if set(s) == {"count", "mu", "nu"}]
    counts = [s for s in stages if set(s) == {"count"}]
    if len(adam) != 1 or not counts:
        raise ValueError("state_from_jax: opt_state is not an Adam chain "
                         f"(stages {[sorted(s) for s in stages]})")
    return {"count": int(np.asarray(counts[-1]["count"])),
            "mu": _mapped(adam[0]["mu"], expected),
            "nu": _mapped(adam[0]["nu"], expected)}


def state_from_jax(tree: Mapping[str, Any], state):
    """Copy a JAX `TrainState` into the port's `state` of the same
    precision, in place, and return it. `tree` is the JAX state as
    flax's state dict (`flax.serialization.to_state_dict`, or a
    reference checkpoint read back with `msgpack_restore`): {"step",
    "params", "opt_state"}, the O2 opt_state {"master", "inner"}."""
    expected = {k: tuple(v.shape) for k, v in state.params.items()}
    trained = {k: expected[k] for k in state.opt_names}
    opt = tree["opt_state"]

    def inner(chain):
        if set(chain) == {"inner_state"}:      # optax.masked
            chain = chain["inner_state"]
        return _adam_from_jax(chain, trained)

    if set(opt) == {"master", "inner"}:
        opt_state = {"master": _mapped(opt["master"], expected),
                     "inner": inner(opt["inner"])}
    else:
        opt_state = inner(opt)
    state.load_state_dict({"step": int(np.asarray(tree["step"])),
                           "params": _mapped(tree["params"], expected),
                           "opt_state": opt_state})
    return state


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
