"""Port full reference `best.th` checkpoints across the model family.

A copy of `news_image_caption_tpu/models/port_checkpoint.py` (numpy
only; the reference's `models/resnet.py::port_torch_resnet` copied in):
the port imports nothing of the JAX package.
`tests/test_torch_port_command.py` holds the two equal. Its trees are
the reference's flax trees; the `port` command grafts them onto the port
model's own parameters seen in flax naming
(`models/from_jax.py::flax_view`) and loads the result through
`params_from_jax`.

`port_tell_decoder` (port_tell.py) handles the shared dynamic-conv
decoder. This module adds the remaining reference modules so one call
maps any shipped variant's checkpoint onto flax-named parameters:

- pointer/entity family (transformer_pointer.py:27-313 and variants):
  the `entity_fc` binary head, the gated `SelfAttention` entity module
  (self_attention.py:10-74 + downsampled_single_head.py:12-229), and
  the raw copy-attention projections (`in_proj_weight`/`in_proj_bias`/
  `bias_k`/`out_proj`, transformer_pointer.py:80-92);
- tgnc (tgnc.py:19-120 + decoder_tgnc.py:20-244): ClassificationHead
  + the 5 per-template head layers;
- fairseq-layout RoBERTa (`roberta.large` sentence encoder, the
  article encoder of transformer_flattened.py:205-221): this one maps
  the fairseq `decoder.sentence_encoder.*` layout a reference
  checkpoint bundle would actually carry;
- torchvision-layout ResNet (`port_torch_resnet`);
- `port_checkpoint`: detects the family from the state-dict keys and
  returns everything portable in one dict.

Key-consumption is strict by default: every reference key must be
either ported, a documented tied duplicate, or a documented dead
parameter (the gated SelfAttention's inner projections exist in the
state dict but are never executed because `project_input=False`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from news_image_caption_tpu_torch.models.port_tell import (
    _KeyTracker, _np, _port_gehring, _port_layer_norm, port_tell_decoder)

__all__ = ["port_pointer_model", "port_tgnc_model",
           "port_fairseq_roberta", "port_torch_resnet", "port_checkpoint",
           "assemble_for_init", "merge_into_init"]

# bert_weight_2 exists in the reference's context/entity-pointer
# variants but its only read is commented out
# (transformer_context_pointer.py:243) — a dead parameter. The porter
# consumes it (so strict accounting passes) and reports the drop.
_BERT_WEIGHT_2_NOTE = ("bert_weight_2 (dead in the reference: only "
                       "use is commented out, "
                       "transformer_context_pointer.py:243)")


def _port_dense(tr: _KeyTracker, key: str,
                bias: bool = True) -> Dict[str, np.ndarray]:
    """Plain torch nn.Linear -> flax Dense."""
    out = {"kernel": tr.take(f"{key}.weight").T}
    if bias:
        out["bias"] = tr.take(f"{key}.bias")
    return out


def _consume_gated_linear(tr: _KeyTracker, key: str) -> None:
    """Mark a GatedLinear's keys consumed WITHOUT porting.

    The entity SelfAttention is built with `project_input=False`
    (transformer_pointer.py:91-92 passes only gated=True), so the
    inner GatedLinear q/k/v stacks (downsampled_single_head.py:38-53)
    are never executed — dead parameters that a real best.th still
    serializes. GatedLinear = Sequential(GehringLinear, GLU,
    GehringLinear, GLU, GehringLinear) -> param indices 0, 2, 4.
    """
    for i in (0, 2, 4):
        for suffix in ("weight_g", "weight_v", "bias"):
            k = f"{key}.{i}.{suffix}"
            if tr.has(k):
                tr.take(k)


def port_entity_self_attention(tr: _KeyTracker, key: str
                               ) -> Dict[str, Any]:
    """Reference gated SelfAttention -> EntitySelfAttention params.

    Live path (self_attention.py:39-65 with project_input=False):
    outer q/k/v GehringLinears, single-softmax multi-head attention
    with scalar-bias slot, the inner module's out_proj, then
    LayerNorm(out + residual).
    """
    params = {
        "in_proj_q": _port_gehring(tr, f"{key}.in_proj_q"),
        "in_proj_k": _port_gehring(tr, f"{key}.in_proj_k"),
        "in_proj_v": _port_gehring(tr, f"{key}.in_proj_v"),
        "out_proj": _port_gehring(
            tr, f"{key}.attention.attention_module.out_proj"),
        "ln": _port_layer_norm(tr, f"{key}.ln"),
    }
    # Dead inner projections (project_input=False): in_proj_q is a
    # bare GatedLinear; in_proj_k/v are Sequential([GatedLinear]).
    mod = f"{key}.attention.attention_module"
    _consume_gated_linear(tr, f"{mod}.in_proj_q")
    _consume_gated_linear(tr, f"{mod}.in_proj_k.0")
    _consume_gated_linear(tr, f"{mod}.in_proj_v.0")
    return params


def port_copy_attention(tr: _KeyTracker, embed_dim: int = 1024
                        ) -> Dict[str, Any]:
    """Model-level copy projections -> CopyAttentionScores params.

    Reference (transformer_pointer.py:80-92): fused (q, k)
    `in_proj_weight` [2E, E] + `in_proj_bias` [2E] + `bias_k`
    [1, 1, E] + `out_proj` GehringLinear (serialized but unused by
    the score path — ported for completeness).
    """
    w = tr.take("in_proj_weight")            # [2E, E], rows = (q | k)
    return {
        "q_proj_weight": w[:embed_dim].T,
        "k_proj_weight": w[embed_dim:].T,
        "in_proj_bias": tr.take("in_proj_bias"),
        "bias_k": tr.take("bias_k"),
        "out_proj": _port_gehring(tr, "out_proj"),
    }


_ENCODER_PREFIXES = ("resnet.", "roberta.", "textmodel.")


def _split_encoders(state_dict: Dict[str, Any]
                    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Split model-own keys from the frozen encoder submodules the
    reference serializes alongside (resnet152 + fairseq roberta)."""
    own, enc = {}, {}
    for k, v in state_dict.items():
        (enc if k.startswith(_ENCODER_PREFIXES) else own)[k] = v
    return own, enc


def port_pointer_model(state_dict: Dict[str, Any],
                       num_layers: int = 4,
                       embed_dim: int = 1024,
                       n_bands: int = 3,
                       context_names: Sequence[str] = ("image",
                                                       "article"),
                       strict: bool = True) -> Tuple[Dict, list]:
    """Reference transformer_pointer-family best.th -> TransformerPointer
    variables ({captioner, entity_attn, entity_fc, copy_attn}).

    Handles transformer_only_pointer too (no entity modules in the
    state dict -> no entity entries in the output). Encoder submodule
    keys (resnet./roberta.) are split off; port them separately with
    port_torch_resnet / port_fairseq_roberta.
    """
    own, _ = _split_encoders(state_dict)
    captioner, dec_unused = port_tell_decoder(
        own, num_layers=num_layers, embed_dim=embed_dim,
        n_bands=n_bands, context_names=context_names, strict=False)

    tr = _KeyTracker(own, prefix="")
    # consume the decoder.* keys port_tell_decoder already handled
    for k in tr.sd:
        if k.startswith("decoder."):
            tr.used.add(k)

    variables: Dict[str, Any] = {"captioner": captioner}
    if tr.has("entity_fc.weight_v"):
        variables["entity_fc"] = {
            "params": _port_gehring(tr, "entity_fc")}
        variables["entity_attn"] = {
            "params": port_entity_self_attention(tr, "entity_attn")}
    variables["copy_attn"] = {
        "params": port_copy_attention(tr, embed_dim)}

    if tr.has("bert_weight"):                      # weigh_bert option
        variables["extras"] = {"bert_weight": tr.take("bert_weight")}
    dead = []
    if tr.has("bert_weight_2"):
        # Dead in the reference: its only use is commented out
        # (transformer_context_pointer.py:243) — consume it so strict
        # mode passes, but surface the drop in the unused report.
        tr.take("bert_weight_2")
        dead.append(_BERT_WEIGHT_2_NOTE)

    unused = [k for k in tr.unused() if not k.startswith("decoder.")]
    unused += [f"decoder.{k}" for k in dec_unused]
    if strict and unused:
        raise ValueError(f"unported pointer-model keys: {unused[:10]}"
                         f"{'...' if len(unused) > 10 else ''}")
    return variables, unused + dead


def port_tgnc_model(state_dict: Dict[str, Any],
                    num_layers: int = 4,
                    embed_dim: int = 1024,
                    n_bands: int = 3,
                    n_templates: int = 5,
                    strict: bool = True) -> Tuple[Dict, list]:
    """Reference tgnc best.th -> TGNC(use_template_decoder=True)
    variables ({classifier, decoder} [+ extras.bert_weight]).

    The tgnc decoder = trunk `decoder.layers.{i}` + per-template
    `decoder.head{t}.0` layers (decoder_tgnc.py:62-107), all with the
    flattened layer's key structure; the repo's TemplateGuidedDecoder
    names them layers_{i} / head_{t}.
    """
    own, _ = _split_encoders(state_dict)
    tr = _KeyTracker(own, prefix="")

    # Trunk + embedder + adaptive softmax via the shared decoder
    # porter (head layers are unknown to it -> strict=False here,
    # strictness re-checked at the end).
    dec_vars, dec_unused = port_tell_decoder(
        own, num_layers=num_layers, embed_dim=embed_dim,
        n_bands=n_bands, strict=False)
    dec_params = dec_vars["params"]
    # Mark only the keys the shared decoder porter ACTUALLY consumed
    # — blanket-marking every decoder.* key would let strict=True
    # silently pass over unported trunk weights (e.g. a checkpoint
    # with more layers than num_layers). Template-head prefixes
    # ("decoder.head{t}.", NOT adaptive_softmax.head.*) are ported
    # below.
    import re
    head_re = re.compile(r"^decoder\.head\d+\.")
    dec_unused_set = {f"decoder.{k}" for k in dec_unused}
    for k in tr.sd:
        if (k.startswith("decoder.") and not head_re.match(k)
                and k not in dec_unused_set):
            tr.used.add(k)

    # Per-template heads: decoder.head{t}.0.* == one flattened layer.
    from news_image_caption_tpu_torch.models.port_tell import _port_mha
    sub = {k: v for k, v in own.items() if head_re.match(k)}
    for t in range(n_templates):
        head_sd = {f"decoder.layers.0.{k.split('.0.', 1)[1]}": v
                   for k, v in sub.items()
                   if k.startswith(f"decoder.head{t}.0.")}
        htr = _KeyTracker(head_sd, prefix="decoder.")
        lk = "layers.0"
        layer = {
            "linear1": _port_gehring(htr, f"{lk}.linear1"),
            "conv": {"weight_linear": {"kernel": htr.take(
                f"{lk}.conv.weight_linear.weight").T}},
            "linear2": _port_gehring(htr, f"{lk}.linear2"),
            "conv_layer_norm": _port_layer_norm(
                htr, f"{lk}.conv_layer_norm"),
            "context_fc": _port_gehring(htr, f"{lk}.context_fc"),
            "fc1": _port_gehring(htr, f"{lk}.fc1"),
            "fc2": _port_gehring(htr, f"{lk}.fc2"),
            "final_layer_norm": _port_layer_norm(
                htr, f"{lk}.final_layer_norm"),
        }
        for cname in ("image", "article"):
            layer[f"{cname}_attn"] = _port_mha(
                htr, f"{lk}.context_attns.{cname}", embed_dim)
            layer[f"{cname}_attn_ln"] = _port_layer_norm(
                htr, f"{lk}.context_attn_lns.{cname}")
        dec_params[f"head_{t}"] = layer
        # Propagate only the keys the head porter ACTUALLY consumed —
        # blanket-marking every decoder.head{t}.0.* key would let
        # strict=True silently pass over unported head weights (the
        # same trap the trunk handling above avoids).
        for u in htr.used:
            tr.used.add(f"decoder.head{t}.0."
                        + u[len("layers.0."):])

    classifier = {
        "dense": _port_dense(tr, "classifier.dense"),
        "out_proj": _port_dense(tr, "classifier.out_proj"),
    }
    variables: Dict[str, Any] = {"decoder": {"params": dec_params},
                                 "classifier": {"params": classifier}}
    if tr.has("bert_weight"):
        variables["extras"] = {"bert_weight": tr.take("bert_weight")}

    unused = tr.unused()
    if strict and unused:
        raise ValueError(f"unported tgnc keys: {unused[:10]}"
                         f"{'...' if len(unused) > 10 else ''}")
    return variables, unused


# ----------------------------------------------------------------------
# fairseq-layout RoBERTa
# ----------------------------------------------------------------------

def port_fairseq_roberta(state_dict: Dict[str, Any],
                         num_layers: int = 24,
                         prefix: Optional[str] = None) -> Dict:
    """fairseq `roberta.large` state dict -> RobertaEncoder params.

    The reference stores the article encoder as a fairseq hub module
    (`torch.hub.load('pytorch/fairseq:2f7e3f3323', 'roberta.large')`,
    transformer_flattened.py:205-221), so its checkpoints carry the
    `decoder.sentence_encoder.*` key layout — packed `in_proj_weight`
    self-attention, `fc1/fc2` FFN, `emb_layer_norm` — not the HF
    layout `models/roberta.py::state_from_hf` reads. Both describe the same
    computation; this maps keys 1:1 onto the repo's RobertaEncoder:

      embed_tokens.weight              -> word_embeddings
      embed_positions.weight           -> position_embeddings
      emb_layer_norm.{weight,bias}     -> embed_ln
      layers.{i}.self_attn.in_proj_*   -> q/k/v (split [3E] rows)
      layers.{i}.self_attn.out_proj    -> attn_out
      layers.{i}.self_attn_layer_norm  -> attn_ln
      layers.{i}.fc1 / fc2             -> inter / out
      layers.{i}.final_layer_norm      -> out_ln

    fairseq has no token-type embedding; HF's is zeros for RoBERTa,
    so `token_type_embedding` is set to zeros. `lm_head.*` keys (the
    MLM head, unused by feature extraction) are ignored.
    """
    sd = {k: _np(v) for k, v in state_dict.items()}
    if prefix is None:
        for cand in ("roberta.model.decoder.sentence_encoder.",
                     "textmodel.model.decoder.sentence_encoder.",
                     "model.decoder.sentence_encoder.",
                     "decoder.sentence_encoder.",
                     "sentence_encoder.", ""):
            if f"{cand}embed_tokens.weight" in sd:
                prefix = cand
                break
        else:
            raise KeyError("no fairseq sentence_encoder keys found "
                           "(embed_tokens.weight missing under every "
                           "known prefix)")

    def take(k):
        return sd[prefix + k]

    def lin(k):
        return {"kernel": take(f"{k}.weight").T,
                "bias": take(f"{k}.bias")}

    def ln(k):
        return {"scale": take(f"{k}.weight"),
                "bias": take(f"{k}.bias")}

    word = take("embed_tokens.weight")
    p: Dict[str, Any] = {
        "word_embeddings": {"embedding": word},
        "position_embeddings": {"embedding":
                                take("embed_positions.weight")},
        "token_type_embedding": np.zeros((word.shape[1],), np.float32),
        "embed_ln": ln("emb_layer_norm"),
    }
    for i in range(num_layers):
        base = f"layers.{i}"
        E = word.shape[1]
        if f"{prefix}{base}.self_attn.in_proj_weight" in sd:
            w = take(f"{base}.self_attn.in_proj_weight")   # [3E, E]
            b = take(f"{base}.self_attn.in_proj_bias")
            q = {"kernel": w[:E].T, "bias": b[:E]}
            k = {"kernel": w[E:2 * E].T, "bias": b[E:2 * E]}
            v = {"kernel": w[2 * E:].T, "bias": b[2 * E:]}
        else:   # newer fairseq: separate q/k/v projections
            q = lin(f"{base}.self_attn.q_proj")
            k = lin(f"{base}.self_attn.k_proj")
            v = lin(f"{base}.self_attn.v_proj")
        p[f"layer_{i}"] = {
            "q": q, "k": k, "v": v,
            "attn_out": lin(f"{base}.self_attn.out_proj"),
            "attn_ln": ln(f"{base}.self_attn_layer_norm"),
            "inter": lin(f"{base}.fc1"),
            "out": lin(f"{base}.fc2"),
            "out_ln": ln(f"{base}.final_layer_norm"),
        }
    return {"params": p}


# ----------------------------------------------------------------------
# torchvision-layout ResNet

DEPTHS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
          101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def _conv(w) -> np.ndarray:
    # torch OIHW -> flax HWIO
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def port_torch_resnet(state_dict: Dict[str, Any], depth: int = 152,
                      num_stages: int = 4) -> Dict:
    """torchvision resnet state_dict -> ResNetTrunk params (flax names
    and layout; the reference's `models/resnet.py::port_torch_resnet`)."""
    sd = {k: np.asarray(v) for k, v in state_dict.items()}
    p: Dict[str, Any] = {}

    def bn(prefix):
        return {"scale": sd[f"{prefix}.weight"],
                "bias": sd[f"{prefix}.bias"],
                "mean": sd[f"{prefix}.running_mean"],
                "var": sd[f"{prefix}.running_var"]}

    p["conv1"] = {"kernel": _conv(sd["conv1.weight"])}
    p["bn1"] = bn("bn1")
    blocks = DEPTHS[depth]
    for stage in range(num_stages):
        for b in range(blocks[stage]):
            t = f"layer{stage + 1}.{b}"
            f = f"layer{stage + 1}_{b}"
            entry = {}
            n_convs = 3 if depth >= 50 else 2
            for ci in range(1, n_convs + 1):
                entry[f"conv{ci}"] = {
                    "kernel": _conv(sd[f"{t}.conv{ci}.weight"])}
                entry[f"bn{ci}"] = bn(f"{t}.bn{ci}")
            if f"{t}.downsample.0.weight" in sd:
                entry["downsample_conv"] = {
                    "kernel": _conv(sd[f"{t}.downsample.0.weight"])}
                entry["downsample_bn"] = bn(f"{t}.downsample.1")
            p[f] = entry
    return {"params": p}


# ----------------------------------------------------------------------
# unified entry point
# ----------------------------------------------------------------------

def port_checkpoint(state_dict: Dict[str, Any],
                    num_layers: int = 4,
                    embed_dim: int = 1024,
                    n_bands: int = 3,
                    strict: bool = True) -> Dict[str, Any]:
    """Map a full reference `best.th` (any shipped variant) to repo
    params. Detects the family from the keys:

      classifier.dense.*        -> tgnc
      in_proj_weight (copy)     -> pointer family
      otherwise                 -> flattened/faces/objects family
        (attended context names inferred from
         decoder.layers.0.context_attns.*)

    Returns {"model": <family>, "variables": ..., "unused": [...]}
    plus "roberta"/"resnet" entries when the checkpoint bundles the
    frozen encoders (the reference serializes them as submodules).
    """
    sd = dict(state_dict)
    # tolerate DataParallel 'module.' wrapping
    if sd and all(k.startswith("module.") for k in sd):
        sd = {k[len("module."):]: v for k, v in sd.items()}
    own, enc = _split_encoders(sd)

    out: Dict[str, Any] = {}
    if any(k.startswith("classifier.dense") for k in own):
        # Infer the template count from the decoder.head{t}.0.* keys
        # (decoder_tgnc.py builds one ModuleList per template).
        import re as _re
        heads = {int(m.group(1)) for k in own
                 for m in [_re.match(r"decoder\.head(\d+)\.", k)] if m}
        variables, unused = port_tgnc_model(
            own, num_layers=num_layers, embed_dim=embed_dim,
            n_bands=n_bands,
            n_templates=(1 + max(heads)) if heads else 5,
            strict=strict)
        out.update(model="tgnc", variables=variables, unused=unused)
    elif "in_proj_weight" in own:
        ctx = _context_names(own)
        variables, unused = port_pointer_model(
            own, num_layers=num_layers, embed_dim=embed_dim,
            n_bands=n_bands, context_names=ctx, strict=strict)
        name = ("transformer_pointer" if "entity_fc.weight_v" in own
                else "transformer_only_pointer")
        out.update(model=name, variables=variables, unused=unused)
    else:
        ctx = _context_names(own)
        # weigh_bert checkpoints carry the 25-layer weighted-sum
        # vector at the model level (transformer_flattened.py:205-221)
        extras = {k: own.pop(k) for k in ("bert_weight",) if k in own}
        dead = ([_BERT_WEIGHT_2_NOTE]
                if own.pop("bert_weight_2", None) is not None else [])
        variables, unused = port_tell_decoder(
            own, num_layers=num_layers, embed_dim=embed_dim,
            n_bands=n_bands, context_names=ctx, strict=strict)
        out.update(model="transformer_flattened",
                   variables={"captioner": variables},
                   unused=list(unused) + dead)
        if extras:
            out["extras"] = extras

    # Normalize: consumable extras (bert_weight) always live at
    # out["extras"], never inside the variables tree (where the merge
    # step would mistake them for dead reference params).
    if isinstance(out.get("variables"), dict):
        hoisted = out["variables"].pop("extras", None)
        if hoisted:
            out.setdefault("extras", {}).update(hoisted)

    roberta_keys = {k: v for k, v in enc.items()
                    if k.startswith(("roberta.", "textmodel."))}
    if roberta_keys:
        out["roberta"] = port_fairseq_roberta(roberta_keys)
    resnet_keys = {k[len("resnet."):]: v for k, v in enc.items()
                   if k.startswith("resnet.")}
    if resnet_keys:
        out["resnet"] = port_torch_resnet(resnet_keys)
    return out


def _context_names(own: Dict[str, Any]) -> Tuple[str, ...]:
    """Attended context names, in the reference's fusion order
    (decoder_faces_objects.py:252-276: image, article, faces, obj)."""
    found = set()
    for k in own:
        if k.startswith("decoder.layers.0.context_attns."):
            found.add(k.split(".")[4])
    order = [c for c in ("image", "article", "faces", "obj",
                         "entity", "sections") if c in found]
    order += sorted(found - set(order))
    return tuple(order) or ("image", "article")


# ----------------------------------------------------------------------
# Shaping ported variables onto a model's init tree (used by the
# `port` command; lives here so porter tests can cover it and new
# families extend one module).

def merge_into_init(init_params: Dict[str, Any],
                    cand: Dict[str, Any]) -> Tuple[Dict[str, Any], list]:
    """Fill the model's param structure from the ported tree.

    Ported leaves the model does not own (dead reference params, e.g.
    the copy head's unused out_proj) are dropped and reported in the
    returned list; leaves the model NEEDS must exist and match shape
    (KeyError otherwise). Each kept leaf is cast to the init leaf's
    dtype (fp32 master convention; the porter emits torch-native
    dtypes)."""
    dropped: list = []

    def rec(init, c, path=""):
        if isinstance(init, dict):
            if not isinstance(c, dict):
                raise KeyError(f"ported tree has a leaf at {path!r} "
                               f"where the model has a subtree")
            dropped.extend(f"{path}/{k}" for k in c if k not in init)
            missing = [k for k in init if k not in c]
            if missing:
                raise KeyError(f"ported tree is missing {path}/"
                               f"{missing[0]} (wrong config for this "
                               f"checkpoint?)")
            return {k: rec(v, c[k], f"{path}/{k}")
                    for k, v in init.items()}
        if tuple(init.shape) != tuple(c.shape):
            raise KeyError(f"shape mismatch at {path}: model "
                           f"{tuple(init.shape)} vs ported "
                           f"{tuple(c.shape)}")
        return np.asarray(c, dtype=init.dtype)

    return rec(init_params, cand), dropped


def assemble_for_init(ported: Dict[str, Any],
                      init_params: Any) -> Tuple[Any, list]:
    """Shape `port_checkpoint`'s output to the target model's param
    tree and return (candidate_tree, warnings).

    - gen3_pipeline configs ({resnet, roberta, captioner[, weighted_
      sum]} at the top level): graft the family variables under
      `captioner`, attach bundled frozen encoders (or keep the init
      encoders, with a warning), and route extras["bert_weight"] into
      the weighted_sum submodule (transformer_flattened.py:205-221).
    - flattened-family ports wrap the decoder tree in {"captioner":
      ...}; unwrap when the model's params ARE the decoder tree.

    Extras that no branch consumed produce a warning naming them —
    porting must never silently change reference semantics."""
    warnings: list = []
    consumed: set = set()
    cand = ported["variables"]
    if (isinstance(init_params, dict)
            and {"resnet", "roberta"} <= set(init_params)):
        cap = (cand["captioner"]
               if isinstance(cand, dict) and set(cand) == {"captioner"}
               else cand)
        asm: Dict[str, Any] = {"captioner": cap}
        for enc in ("resnet", "roberta"):
            if enc in ported:
                asm[enc] = ported[enc]
            else:
                asm[enc] = init_params[enc]
                warnings.append(f"warning: checkpoint bundles no {enc} "
                                f"weights; keeping random init for it")
        if "weighted_sum" in init_params:
            w = ported.get("extras", {}).get("bert_weight")
            if w is not None:
                asm["weighted_sum"] = {"params": {"bert_weight": w}}
                consumed.add("bert_weight")
            else:
                asm["weighted_sum"] = init_params["weighted_sum"]
                warnings.append("warning: no bert_weight in checkpoint; "
                                "weighted_sum stays random init")
        cand = asm
    elif (isinstance(cand, dict) and set(cand) == {"captioner"}
            and isinstance(init_params, dict)
            and set(init_params) != {"captioner"}):
        cand = cand["captioner"]
    leftover = sorted(set(ported.get("extras", {})) - consumed)
    if leftover:
        warnings.append(
            f"warning: ported extras not consumed by this config "
            f"(model has no weighted_sum): {leftover} — the "
            f"reference applied these; check the config's weigh_bert/"
            f"model type")
    return cand, warnings
