"""Configurations of the port: the flagship as plain dicts, and the
YAML configs of `configs/` with their builders.

`FLAGSHIP` is the decoder of `configs/goodnews_transformer_roberta.yaml`
(the Transform-and-Tell captioner the reference serves), written out for
the serving and training builders. `FLAGSHIP_TRAIN` and
`FLAGSHIP_OPTIMIZER` are the same file's training settings: the
decoder's dropouts and flash switch, `iterator.batch_size`,
`dataset.caption_len` and `trainer.optimizer` (BertAdam); its
`trainer.mixed_precision` is bf16_o2.

Counterpart of `news_image_caption_tpu/config.py` (`load_config`,
`merge_overrides`, `build_model`, `build_dataset`). The YAML files are
read by `yaml_subset.safe_load`, the port's own reader of the subset
they use. `build_model` builds `transformer_flattened` with the
`dynamic_conv_decoder_flattened` decoder; the decoder options the port
implements at one value only, and every other model type, raise
`NotImplementedError` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import copy
import json
from typing import Any, Dict, Optional

import torch

from news_image_caption_tpu_torch.data.dataset import SyntheticNewsDataset
from news_image_caption_tpu_torch.models.captioner import \
    TransformerFlattened
from news_image_caption_tpu_torch.yaml_subset import safe_load

FLAGSHIP = dict(
    vocab_size=50265,
    cutoff=(5000, 20000, 50265),
    embed_dim=1024,
    ffn_dim=4096,
    num_heads=16,
    num_layers=4,
    kernel_sizes=(3, 7, 15, 31),
    image_dim=2048,
    article_dim=1024,
    padding_idx=0,
    target_padding_idx=1,
    max_positions=512,
)

# Serving shapes of the flagship: image patches and article tokens.
FLAGSHIP_IMAGE_LEN = 49
FLAGSHIP_ARTICLE_LEN = 512

# Training settings of the same file.
FLAGSHIP_TRAIN = dict(
    dropout=0.1,
    weight_dropout=0.1,
    relu_dropout=0.0,
    input_dropout=0.1,
    attention_dropout=0.1,
    use_flash_train=True,
)
FLAGSHIP_OPTIMIZER = dict(
    lr=1e-4,
    warmup=0.05,
    t_total=437600,
    b1=0.9,
    b2=0.98,
    eps=1e-6,
    weight_decay=1e-5,
    max_grad_norm=0.1,
)
FLAGSHIP_BATCH_SIZE = 16
FLAGSHIP_CAPTION_LEN = 64


# Decoder options (reference `DynamicConvDecoder` fields) that the port
# implements at one value: any other raises.
_FIXED = dict(conv_type="dynamic", decoder_glu=True, weight_softmax=True,
              normalize_before=False, final_norm=False, conv_dim=None,
              extra_contexts=(), include_image=True,
              adaptive_softmax_dropout=0.0, tie_adaptive_proj=False,
              remat=False, param_dtype=torch.float32)
_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float32": torch.float32, "fp32": torch.float32}
# Model types of the reference and the ROADMAP Queue 1 item that ports
# each.
_NOT_PORTED = {
    **dict.fromkeys(("transformer_faces", "transformer_faces_objects",
                     "transformer_glove", "transformer_no_image"), 8),
    "gen3_pipeline": 9,
    **dict.fromkeys(("transformer_pointer", "transformer_only_pointer",
                     "transformer_pointer_2", "transformer_context_pointer",
                     "transformer_faces_pointer",
                     "transformer_objects_pointer", "transformer_entity",
                     "transformer_entity_pointer", "tgnc", "gen1",
                     "gen2_transformer", "lstm_flattened", "baseline_glove",
                     "lstm_decoder_flattened", "decoder_tgnc"), 10),
}


def load_config(path: str, overrides: Optional[str] = None) -> Dict:
    """The YAML at `path`, with the JSON dict `overrides` merged over it."""
    with open(path) as f:
        cfg = safe_load(f.read())
    if overrides:
        cfg = merge_overrides(cfg, json.loads(overrides))
    return cfg


def merge_overrides(cfg: Dict, overrides: Dict) -> Dict:
    """Deep-merge `overrides` into `cfg` (dicts merge, scalars replace)."""
    out = copy.deepcopy(cfg)

    def merge(dst, src):
        for k, v in src.items():
            if isinstance(v, dict) and isinstance(dst.get(k), dict):
                merge(dst[k], v)
            else:
                dst[k] = v

    merge(out, overrides)
    return out


def _not_ported(kind: str, name: str) -> NotImplementedError:
    item = _NOT_PORTED.get(name)
    if item is None:
        raise KeyError(f"unknown {kind} type {name!r}")
    return NotImplementedError(
        f"{kind} type {name!r} is not ported yet (ROADMAP Queue 1 item "
        f"{item})")


def config_dtype(value: Any) -> torch.dtype:
    if value not in _DTYPES:
        raise ValueError(f"unsupported dtype {value!r}; accepted "
                         f"spellings: {sorted(_DTYPES)}")
    return _DTYPES[value]


def decoder_kwargs(cfg: Dict) -> Dict:
    """The port's `DynamicConvDecoder` arguments of the `model:` block
    (its `decoder:` block, or the model block itself), `dtype` among
    them (the config's, float32 by default)."""
    mcfg = copy.deepcopy(cfg["model"])
    mtype = mcfg.pop("type")
    if mtype != "transformer_flattened":
        raise _not_ported("model", mtype)
    dcfg = mcfg.pop("decoder", None)
    if dcfg is None:
        dcfg, mcfg = mcfg, {}
    if mcfg:
        raise TypeError(f"transformer_flattened: unknown keys {sorted(mcfg)}")
    dtype_ = dcfg.pop("type", "dynamic_conv_decoder_flattened")
    if dtype_ != "dynamic_conv_decoder_flattened":
        raise _not_ported("decoder", dtype_)
    for key, want in _FIXED.items():
        if key in dcfg:
            got = dcfg.pop(key)
            norm = (config_dtype(got) if key == "param_dtype"
                    else tuple(got) if isinstance(got, list) else got)
            if norm != want:
                raise NotImplementedError(
                    f"decoder {key}={got!r}: the port implements {want!r} "
                    "only (ROADMAP Queue 1 item 8)")
    dcfg["dtype"] = config_dtype(dcfg.pop("dtype", "float32"))
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in dcfg.items()}


def build_model(cfg: Dict, device, dtype: Optional[torch.dtype] = None,
                generator: Optional[torch.Generator] = None
                ) -> TransformerFlattened:
    """The `model:` block's captioner on `device`, its parameters and
    compute in `dtype` (default: the config's `dtype`, float32 unless
    set), drawn from `generator`. An unknown decoder key raises
    TypeError, as the reference's dataclass does."""
    kw = decoder_kwargs(cfg)
    if dtype is not None:
        kw["dtype"] = dtype
    return TransformerFlattened(device=torch.device(device),
                                generator=generator, **kw)


def build_dataset(cfg: Dict, split: str = "train") -> SyntheticNewsDataset:
    """The `dataset:` block's `split`: its keys, with the split's own
    block merged over them."""
    dcfg = copy.deepcopy(cfg.get("dataset", {"type": "synthetic_news"}))
    dtype_ = dcfg.pop("type")
    split_cfg = dcfg.pop(split, {})
    for other in ("train", "val", "test"):
        dcfg.pop(other, None)
    dcfg.update(split_cfg)
    if dtype_ == "nics_shards":
        raise NotImplementedError(
            "dataset type 'nics_shards' is not ported yet (ROADMAP Queue 1 "
            "item 5)")
    if dtype_ != "synthetic_news":
        raise KeyError(f"unknown dataset type {dtype_!r}")
    return SyntheticNewsDataset(**dcfg)
