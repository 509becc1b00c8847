"""Port a reference Transform-and-Tell decoder checkpoint to a flax-named
parameter tree.

A copy of `news_image_caption_tpu/models/port_tell.py` (numpy only): the
port imports nothing of the JAX package. `tests/test_torch_port_command.py`
holds the two equal. The tree it returns is the reference's
`DynamicConvDecoder` tree; `models/from_jax.py::params_from_jax` maps it
onto the port's decoder.

Maps the PyTorch state dict of the reference's
`dynamic_conv_decoder_flattened` decoder (a `best.th` from
ttl/tell/commands/evaluate.py:61-63, keys prefixed
`decoder.`) onto the flax parameter tree.

Reference layouts handled:
- AdaptiveEmbedding bands: `embedder.token_embedder_adaptive.
  embeddings.{i}.0.weight` [band_v, d] + `.1.weight` [out, d]
  (token_embedders/adaptive.py:37-45);
- GehringLinear weight norm: `weight_g` [out, 1] + `weight_v`
  [out, in] (linear.py:8-34; torch weight_norm dim=0) — ported as
  our (kernel=v.T [in, out], scale=g) pair so the effective weight
  g * v/||v|| is bit-identical;
- fairseq MultiHeadAttention packing: packed `in_proj_weight`
  [3E, E] when kdim == vdim == embed_dim (the article attention),
  separate `{q,k,v}_proj_weight` otherwise (the image attention);
  `in_proj_bias` [3E] is always packed q|k|v
  (attention/multi_head.py:236-246,488-520);
- DynamicConv1dTBC weight predictor: `conv.weight_linear.weight`
  [H*K, C], no bias (convolutions/dynamic.py:41-48);
- AdaptiveSoftmax with tie_adaptive_weights: only `head.class_proj`
  and per-tail down-projections `tail.{i}.0.weight` are owned; the
  word tables are tied to the embedder (softmax.py:84-137). Duplicate
  tied keys (`head.word_proj*`, `tail.{i}.2.weight`) are ignored.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

__all__ = ["port_tell_decoder"]


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float32)


class _KeyTracker:
    """Tracks which state-dict keys were consumed, for a final audit."""

    def __init__(self, sd: Dict[str, Any], prefix: str):
        self.sd = {k[len(prefix):]: v for k, v in sd.items()
                   if k.startswith(prefix)}
        self.used = set()

    def take(self, key: str) -> np.ndarray:
        if key not in self.sd:
            raise KeyError(f"reference checkpoint missing key: {key!r}")
        self.used.add(key)
        return _np(self.sd[key])

    def has(self, key: str) -> bool:
        return key in self.sd

    def unused(self) -> list:
        skip_suffixes = ("version", "_float_tensor",
                         "token_embedder_position.weights")
        skip_fragments = ("head.word_proj", ".tail.")
        out = []
        for k in self.sd:
            if k in self.used:
                continue
            if any(k.endswith(s) for s in skip_suffixes):
                continue
            if any(f in k for f in skip_fragments) and k.endswith(".weight"):
                # tied duplicates serialized by TiedLinear (softmax.py:36-50)
                continue
            out.append(k)
        return sorted(out)


def _port_gehring(tr: _KeyTracker, key: str,
                  bias: bool = True) -> Dict[str, np.ndarray]:
    out = {
        "kernel": tr.take(f"{key}.weight_v").T,
        "scale": tr.take(f"{key}.weight_g").reshape(-1),
    }
    if bias:
        out["bias"] = tr.take(f"{key}.bias")
    return out


def _port_layer_norm(tr: _KeyTracker, key: str) -> Dict[str, np.ndarray]:
    return {"scale": tr.take(f"{key}.weight"),
            "bias": tr.take(f"{key}.bias")}


def _port_mha(tr: _KeyTracker, key: str, embed_dim: int
              ) -> Dict[str, Any]:
    b = tr.take(f"{key}.in_proj_bias")
    if tr.has(f"{key}.in_proj_weight"):
        w = tr.take(f"{key}.in_proj_weight")           # [3E, E]
        qw, kw, vw = (w[:embed_dim], w[embed_dim:2 * embed_dim],
                      w[2 * embed_dim:])
    else:
        qw = tr.take(f"{key}.q_proj_weight")           # [E, E]
        kw = tr.take(f"{key}.k_proj_weight")           # [E, kdim]
        vw = tr.take(f"{key}.v_proj_weight")           # [E, vdim]
    out = {
        "q_proj": {"kernel": qw.T, "bias": b[:embed_dim]},
        "k_proj": {"kernel": kw.T, "bias": b[embed_dim:2 * embed_dim]},
        "v_proj": {"kernel": vw.T, "bias": b[2 * embed_dim:]},
        "out_proj": {"kernel": tr.take(f"{key}.out_proj.weight").T,
                     "bias": tr.take(f"{key}.out_proj.bias")},
        "bias_k": tr.take(f"{key}.bias_k"),
        "bias_v": tr.take(f"{key}.bias_v"),
    }
    return out


def port_tell_decoder(state_dict: Dict[str, Any],
                      num_layers: int = 4,
                      embed_dim: int = 1024,
                      n_bands: int = 3,
                      context_names: Sequence[str] = ("image", "article"),
                      prefix: str = "decoder.",
                      strict: bool = True,
                      template: Optional[Dict] = None
                      ) -> Tuple[Dict, list]:
    """Convert a reference decoder state dict to DynamicConvDecoder params.

    Returns ({"params": tree}, unused_keys). With `strict`, raises if any
    non-tied reference key was not consumed (catches silent drift when a
    checkpoint carries modules this porter doesn't know about). Pass the
    variant's extra contexts via `context_names`, e.g.
    ("image", "article", "faces", "obj") for the faces/objects family
    (decoder_faces_objects.py:252-276).

    `template`: optional params pytree from `model.init` — when given,
    ported leaves are shape-checked against it.
    """
    tr = _KeyTracker(state_dict, prefix)

    adaptive = {}
    for i in range(n_bands):
        base = f"embedder.token_embedder_adaptive.embeddings.{i}"
        adaptive[f"embed_{i}"] = tr.take(f"{base}.0.weight")
        adaptive[f"proj_{i}"] = tr.take(f"{base}.1.weight").T

    params: Dict[str, Any] = {"embedder": {"adaptive": adaptive}}

    for li in range(num_layers):
        lk = f"layers.{li}"
        layer = {
            "linear1": _port_gehring(tr, f"{lk}.linear1"),
            "conv": {"weight_linear": {
                "kernel": tr.take(f"{lk}.conv.weight_linear.weight").T}},
            "linear2": _port_gehring(tr, f"{lk}.linear2"),
            "conv_layer_norm": _port_layer_norm(tr, f"{lk}.conv_layer_norm"),
            "context_fc": _port_gehring(tr, f"{lk}.context_fc"),
            "fc1": _port_gehring(tr, f"{lk}.fc1"),
            "fc2": _port_gehring(tr, f"{lk}.fc2"),
            "final_layer_norm": _port_layer_norm(
                tr, f"{lk}.final_layer_norm"),
        }
        for cname in context_names:
            layer[f"{cname}_attn"] = _port_mha(
                tr, f"{lk}.context_attns.{cname}", embed_dim)
            layer[f"{cname}_attn_ln"] = _port_layer_norm(
                tr, f"{lk}.context_attn_lns.{cname}")
        params[f"layers_{li}"] = layer

    softmax = {"class_proj": tr.take(
        "adaptive_softmax.head.class_proj.weight").T}
    for i in range(1, n_bands):
        softmax[f"tail_proj_{i}"] = tr.take(
            f"adaptive_softmax.tail.{i - 1}.0.weight").T
    params["adaptive_softmax"] = softmax

    if tr.has("layer_norm.weight"):
        params["layer_norm"] = _port_layer_norm(tr, "layer_norm")

    unused = tr.unused()
    if strict and unused:
        raise ValueError(
            f"unported reference keys (pass strict=False to ignore): "
            f"{unused[:10]}{'...' if len(unused) > 10 else ''}")

    if template is not None:
        _check_shapes(template.get("params", template), params, path="")

    return {"params": params}, unused


def _check_shapes(template: Dict, ported: Dict, path: str) -> None:
    for key, tval in template.items():
        p = f"{path}/{key}"
        if key not in ported:
            raise ValueError(f"porter produced no value for {p}")
        pval = ported[key]
        if isinstance(tval, dict):
            _check_shapes(tval, pval, p)
        else:
            if tuple(tval.shape) != tuple(np.shape(pval)):
                raise ValueError(
                    f"shape mismatch at {p}: model {tuple(tval.shape)} "
                    f"vs ported {tuple(np.shape(pval))}")
