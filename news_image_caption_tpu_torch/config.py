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
`merge_overrides`, `build_model`, `build_dataset`, `build_optimizer`).
The YAML files are read by `yaml_subset.safe_load`, the port's own
reader of the subset they use. `build_model` builds
`transformer_flattened` with the `dynamic_conv_decoder_flattened`
decoder, the faces, faces-and-objects, GloVe, no-image and entity
captioners over it (`models/variants.py`, `models/tgnc.py`), and the
pointer family (`models/pointer.py` and its variants): for those the
model block's keys go to the builder as the reference passes them, a
`decoder:` block builds the decoder it is handed, `loss_weights` is a
tuple and `max_entities` is accepted and dropped. It builds the LSTM
captioner (`lstm_flattened` and `baseline_glove`, `models/
decoder_lstm.py`; the model block's keys, or its `decoder:` block of
type `lstm_decoder_flattened`), the Gen-2 captioner
(`gen2_transformer`, `models/gen2.py`) and the Gen-1 captioners (`gen1`,
`models/gen1.py`), their keys checked as the reference's dataclasses
check them, the online pipeline (`gen3_pipeline`, `models/pipeline.py`:
`weigh_bert`, the `resnet` and `roberta` blocks, the `decoder:` block or
the model block's own decoder keys) and TGNC (`tgnc`, `models/tgnc.py`:
its own keys, then its template-guided or flattened decoder's). Every
option of the reference's decoder dataclasses builds (`param_dtype` a
dtype spelling as `dtype`); `use_fused_decode` and `flash_interpret`,
which pick the reference's TPU kernels or their interpreter, are
accepted and dropped, since the port's kernels run wherever the model's
tensors are on the card. An unknown key raises TypeError, an unknown
model type KeyError. `build_optimizer` builds
`bert_adam`, `noam` and `gen1_adam`, and leaves a model's
`frozen_collections` out of them (`mask_frozen`).

`model.type`, `decoder.type` and `dataset.type` resolve through the
registries of `utils/registry.py` (`MODELS`, `DECODERS`, `DATASETS`),
where the port's builders are registered under the reference's names.
How a built-in type's model block becomes its builder's keywords stays
here as data keyed by registered name (`CAPTIONERS`, `POINTERS`,
`FAMILIES`, the pipeline and TGNC). A type a user registers takes the
port's keywords `device`, `dtype` and `generator`, and its model block's
keys; with a `decoder:` block, the decoder registered under that block's
`type` (default `dynamic_conv_decoder_flattened`) is built from its keys
with the same `device`, `dtype` and `generator` and handed over as
`decoder=`, as the reference's `build_model` hands it. A dataset type a
user registers takes the block's keys.
"""

from __future__ import annotations

import copy
import json
from typing import Any, Dict, Optional, Union

import torch

# Imported for their registrations too.
import news_image_caption_tpu_torch.data.dataset  # noqa: F401
import news_image_caption_tpu_torch.data.readers  # noqa: F401
from news_image_caption_tpu_torch.models.captioner import \
    TransformerFlattened
from news_image_caption_tpu_torch.models.decoder_flattened import \
    DynamicConvDecoder
from news_image_caption_tpu_torch.models.decoder_lstm import \
    LSTMFlattenedModel
from news_image_caption_tpu_torch.models.gen1 import Gen1Model
from news_image_caption_tpu_torch.models.gen2 import Gen2Captioner
from news_image_caption_tpu_torch.models.pipeline import Gen3Pipeline
from news_image_caption_tpu_torch.models.pointer import TransformerPointer
from news_image_caption_tpu_torch.models.tgnc import (TGNC,
                                                      TemplateGuidedDecoder)
from news_image_caption_tpu_torch.models.variants import (POINTER_VARIANTS,
                                                          VARIANTS)
from news_image_caption_tpu_torch.training.optim import (NoamAdam, gen1_adam,
                                                        make_bert_adam,
                                                        mask_frozen)
from news_image_caption_tpu_torch.utils.registry import (DATASETS, DECODERS,
                                                         MODELS)
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


# Reference `DynamicConvDecoder` fields that choose among its TPU
# kernels and their interpreter: the port has one route per device.
_TPU_ONLY = ("use_fused_decode", "flash_interpret")
_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float32": torch.float32, "fp32": torch.float32}
# How the built-in model types' blocks become their builders' keywords,
# by registered name: the captioners take the decoder's arguments, the
# pointer family the model block's.
CAPTIONERS = ("transformer_flattened", *VARIANTS, "transformer_entity")
POINTERS = (*POINTER_VARIANTS, "transformer_entity_pointer")
# The pointer family's own keys of the model block.
_POINTER_OWN_KEYS = ("loss_weights", "use_entity_head", "max_entities",
                 "face_dim", "obj_dim", "entity_dim")
# The LSTM, Gen-2 and Gen-1 families: the keys of their model blocks
# (the reference's dataclass fields).
_LSTM_KEYS = ("vocab_size", "embed_dim", "hidden_size", "num_layers",
              "cutoff", "tie_adaptive_proj", "image_dim", "article_dim",
              "dropout_rate", "padding_idx", "target_padding_idx",
              "max_positions")
FAMILIES = {
    "lstm_flattened": _LSTM_KEYS,
    "baseline_glove": _LSTM_KEYS,
    "gen2_transformer": ("smoothing", "vocab_size", "d_model", "d_ff",
                         "num_heads", "num_layers", "img_dim", "sent_dim",
                         "dropout_rate", "max_len", "pad_id", "remat"),
    "gen1": ("model_type", "vocab_size", "input_encoding_size", "rnn_size",
             "num_layers", "att_hid_size", "fc_feat_size", "att_feat_size",
             "drop_prob", "seq_length", "sentence_embed_method",
             "sentence_embed_size", "sentence_length"),
}
# TGNC's own keys of the model block, and its template-guided decoder's
# (the reference's `TemplateGuidedDecoder` fields).
_TGNC_KEYS = ("n_templates", "image_dim", "article_dim",
              "template_loss_weight", "use_template_decoder")
_TGNC_DECODER_KEYS = ("vocab_size", "embed_dim", "ffn_dim", "num_heads",
                      "num_layers", "kernel_sizes", "cutoff",
                      "tie_adaptive_proj", "head_kernel", "dropout",
                      "padding_idx", "target_padding_idx", "max_positions",
                      "remat")
# The online pipeline's own keys of the model block, and of its encoder
# blocks (the reference's `ResNetTrunk` and `RobertaEncoder` fields, but
# the RoBERTa's compute `dtype`; `ring` and `pipe`, its multi-device
# encoders, raise).
_PIPELINE_KEYS = ("weigh_bert", "resnet", "roberta")
_RESNET_KEYS = ("depth", "num_stages")
_ROBERTA_KEYS = ("vocab_size", "hidden", "num_layers", "heads",
                 "intermediate", "max_positions", "padding_idx", "eps",
                 "ring", "pipe")


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


def config_dtype(value: Any) -> torch.dtype:
    if value not in _DTYPES:
        raise ValueError(f"unsupported dtype {value!r}; accepted "
                         f"spellings: {sorted(_DTYPES)}")
    return _DTYPES[value]


def decoder_kwargs(cfg: Dict) -> Dict:
    """The arguments of the `model:` block's builder: for a captioner,
    the port's `DynamicConvDecoder` arguments (its `decoder:` block, or
    the model block itself) with the variant's own keys (`face_dim`,
    `obj_dim`, `entity_dim`); for the pointer family, the model block's
    keys, its `decoder:` or `decoder_kwargs:` block as decoder arguments;
    for the LSTM and Gen-2 families, their model block's keys (no
    `dtype`); for a type a user registered, the model block's keys, its
    `decoder:` block as a dict. `dtype` is the config's (float32 by
    default)."""
    mcfg = copy.deepcopy(cfg["model"])
    mtype = mcfg.pop("type")
    if mtype in POINTERS:
        return _pointer_args(mcfg)
    if mtype in FAMILIES:
        kw = _family_args(mtype, mcfg)
        if mtype == "gen1":
            # Flax reads the sentence embeddings' width and length from
            # the batch; the port's layers are declared at build time.
            data = cfg.get("dataset", {})
            for key, dkey in (("sentence_embed_size", "article_dim"),
                              ("sentence_length", "article_len")):
                if kw.get(key) is None and dkey in data:
                    kw[key] = data[dkey]
        return kw
    if mtype == "gen3_pipeline":
        return _pipeline_args(mcfg)
    if mtype == "tgnc":
        return _tgnc_args(mcfg)
    if mtype not in CAPTIONERS:
        MODELS.get(mtype)       # KeyError naming the registered types
        return _registered_args(mcfg)
    dcfg = mcfg.pop("decoder", None)
    if dcfg is None:
        dcfg, mcfg = mcfg, {}
    if mcfg:
        raise TypeError(f"{mtype}: unknown keys {sorted(mcfg)}")
    return _decoder_args(dcfg)


def _decoder_args(dcfg: Dict) -> Dict:
    """A decoder block as `DynamicConvDecoder` arguments: the dtypes and
    lists converted, the TPU kernel switches dropped."""
    dcfg = dict(dcfg)
    dtype_ = dcfg.pop("type", "dynamic_conv_decoder_flattened")
    if DECODERS.get(dtype_) is not DynamicConvDecoder:
        raise KeyError(f"decoder type {dtype_!r} is not a "
                       "dynamic_conv_decoder_flattened")
    for key in _TPU_ONLY:
        dcfg.pop(key, None)
    if "param_dtype" in dcfg:
        dcfg["param_dtype"] = config_dtype(dcfg["param_dtype"])
    dcfg["dtype"] = config_dtype(dcfg.pop("dtype", "float32"))
    if "extra_contexts" in dcfg:        # [[name, dim], ...] in YAML
        dcfg["extra_contexts"] = tuple(
            (name, dim) for name, dim in dcfg["extra_contexts"])
    return _tuples(dcfg)


def _family_args(mtype: str, mcfg: Dict) -> Dict:
    """An LSTM or Gen-2 model block as its builder's keywords: an unknown
    key raises TypeError. An LSTM's `decoder:` block (type
    `lstm_decoder_flattened`) is the decoder's keys, and the model
    block's other keys are dropped, as the reference drops them."""
    dcfg = mcfg.pop("decoder", None)
    if dcfg is not None and FAMILIES[mtype] is _LSTM_KEYS:
        dtype_ = dcfg.pop("type", "lstm_decoder_flattened")
        if DECODERS.get(dtype_) is not LSTMFlattenedModel:
            raise TypeError(f"{mtype}: decoder type {dtype_!r} is not "
                            "lstm_decoder_flattened")
        mcfg = dcfg
    elif dcfg is not None:
        raise TypeError(f"{mtype}: unknown keys ['decoder']")
    unknown = sorted(set(mcfg) - set(FAMILIES[mtype]))
    if unknown:
        raise TypeError(f"{mtype}: unknown keys {unknown}")
    return _tuples(mcfg)


def _pipeline_args(mcfg: Dict) -> Dict:
    """The pipeline's model block as `Gen3Pipeline`'s keywords: its own
    keys, its `decoder:` block (or, without one, the block's other keys)
    as decoder arguments, the decoder's `dtype` the model's. An unknown
    key raises TypeError."""
    kw = {k: mcfg.pop(k) for k in _PIPELINE_KEYS if k in mcfg}
    for name, known in (("resnet", _RESNET_KEYS), ("roberta", _ROBERTA_KEYS)):
        unknown = sorted(set(kw.get(name) or {}) - set(known))
        if unknown:
            raise TypeError(f"gen3_pipeline: unknown {name} keys {unknown}")
    dcfg = mcfg.pop("decoder", None)
    if dcfg is None:
        dcfg, mcfg = mcfg, {}
    if mcfg:
        raise TypeError(f"gen3_pipeline: unknown keys {sorted(mcfg)}")
    return {**kw, **_decoder_args(dcfg)}


def _tgnc_args(mcfg: Dict) -> Dict:
    """TGNC's model block as `TGNC`'s keywords: its own keys, then its
    decoder's, from its `decoder:` block or the block's other keys:
    `TemplateGuidedDecoder`'s (type `decoder_tgnc`) with
    use_template_decoder, else a flattened decoder's. An unknown key
    raises TypeError; `dtype` is the model's (float32 by default)."""
    kw = {k: mcfg.pop(k) for k in _TGNC_KEYS if k in mcfg}
    dcfg = mcfg.pop("decoder", None)
    if dcfg is not None:
        if mcfg:
            raise TypeError(f"tgnc: unknown keys {sorted(mcfg)}")
        mcfg = dict(dcfg)
    dtype = config_dtype(mcfg.pop("dtype", "float32"))
    if kw.get("use_template_decoder", False):
        dtype_ = mcfg.pop("type", "decoder_tgnc")
        if DECODERS.get(dtype_) is not TemplateGuidedDecoder:
            raise TypeError(f"tgnc: decoder type {dtype_!r} with "
                            "use_template_decoder is not decoder_tgnc")
        unknown = sorted(set(mcfg) - set(_TGNC_DECODER_KEYS))
        if unknown:
            raise TypeError(f"decoder_tgnc: unknown keys {unknown}")
        dec = _tuples(mcfg)
    else:
        dec = _decoder_args(mcfg)
        dec.pop("dtype")
    return {**kw, **dec, "dtype": dtype}


def _tuples(block: Dict) -> Dict:
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in block.items()}


def _registered_args(mcfg: Dict) -> Dict:
    """A user-registered model type's block: its keys (lists as
    tuples), a `decoder:` block kept as a dict for `build_model`. The
    model's one dtype is the block's, else its decoder block's (float32
    by default), as a pointer's is."""
    dcfg = mcfg.pop("decoder", None)
    kw = _tuples(mcfg)
    dtype = kw.pop("dtype", None)
    if dcfg is not None:
        kw["decoder"] = dict(dcfg)
        nested = kw["decoder"].pop("dtype", None)
        dtype = nested if dtype is None else dtype
    kw["dtype"] = config_dtype(dtype or "float32")
    return kw


def _registered_decoder(dcfg: Dict, device, dtype: torch.dtype,
                        generator: Optional[torch.Generator]):
    """The decoder a user-registered model type's `decoder:` block
    names (`dynamic_conv_decoder_flattened` by default), from its keys,
    in the model's dtype."""
    dtype_ = dcfg.pop("type", "dynamic_conv_decoder_flattened")
    builder = DECODERS.get(dtype_)
    kw = (_decoder_args(dcfg) if builder is DynamicConvDecoder
          else _tuples(dcfg))
    kw["dtype"] = dtype
    return builder(device=device, generator=generator, **kw)


def _pointer_args(mcfg: Dict) -> Dict:
    """A pointer's model block as its builder's keywords. The model's
    one dtype is the block's, else its decoder block's."""
    dtype = mcfg.pop("dtype", None)
    kw = {k: mcfg.pop(k) for k in _POINTER_OWN_KEYS if k in mcfg}
    if "loss_weights" in kw:
        kw["loss_weights"] = tuple(float(w) for w in kw["loss_weights"])
    for key in ("decoder", "decoder_kwargs"):
        if key in mcfg:
            kw[key] = _decoder_args(mcfg.pop(key))
            nested = kw[key].pop("dtype")
            dtype = nested if dtype is None else dtype
    kw.update(_decoder_args(mcfg))
    kw["dtype"] = config_dtype(dtype) if isinstance(dtype, str) else \
        (dtype or torch.float32)
    return kw


def build_model(cfg: Dict, device, dtype: Optional[torch.dtype] = None,
                generator: Optional[torch.Generator] = None
                ) -> Union[TransformerFlattened, TransformerPointer,
                           LSTMFlattenedModel, Gen2Captioner, Gen3Pipeline,
                           TGNC, Gen1Model]:
    """The `model:` block's model on `device`, its parameters and
    compute in `dtype` (default: the config's `dtype`, float32 unless
    set; the LSTM and Gen-2 blocks have no dtype key), drawn from
    `generator`. `model.type` resolves through `MODELS`; a registered
    builder is called with `device`, `dtype` and `generator` beside its
    keys. An unknown decoder key raises TypeError, as the reference's
    dataclass does."""
    mtype = cfg["model"]["type"]
    kw = decoder_kwargs(cfg)
    device = torch.device(device)
    builder = MODELS.get(mtype)
    if mtype in FAMILIES:
        return builder(device=device, generator=generator,
                       dtype=dtype or torch.float32, **kw)
    if dtype is not None:
        kw["dtype"] = dtype
    if "decoder" in kw:                 # a pointer handed its decoder
        if mtype in POINTERS:
            kw["decoder"] = DynamicConvDecoder(
                device=device, dtype=kw["dtype"], generator=generator,
                **kw["decoder"])
        else:
            kw["decoder"] = _registered_decoder(kw["decoder"], device,
                                                kw["dtype"], generator)
    return builder(device=device, generator=generator, **kw)


def build_dataset(cfg: Dict, split: str = "train"):
    """The `dataset:` block's `split`: its keys, with the split's own
    block merged over them, for its type, resolved through `DATASETS`:
    `synthetic_news` (`SyntheticNewsDataset`), `nics_shards`
    (`NicsShardDataset`, shards that `preprocess` writes) or `jsonl_news`
    (`data/readers.py::jsonl_news_dataset`: the list of the jsonl's
    model-ready instances, as the reference returns it)."""
    dcfg = copy.deepcopy(cfg.get("dataset", {"type": "synthetic_news"}))
    dtype_ = dcfg.pop("type")
    split_cfg = dcfg.pop(split, {})
    for other in ("train", "val", "test"):
        dcfg.pop(other, None)
    dcfg.update(split_cfg)
    return DATASETS.build(dtype_, **dcfg)


def build_optimizer(cfg: Dict, model=None):
    """The `trainer.optimizer` block's optimizer: `bert_adam`, `noam` or
    `gen1_adam` with the reference's defaults and key names (`e` is
    bert_adam's eps, `grad_clip` gen1_adam's clamp). An unknown key
    raises ValueError, so a misspelled hyperparameter never trains at
    its default. A `model` that declares
    `frozen_collections` (the pipeline's encoders) gets them left out of
    the optimizer (`mask_frozen`): no decay, no moments."""
    ocfg = copy.deepcopy(cfg.get("trainer", {}).get(
        "optimizer", {"type": "bert_adam"}))
    otype = ocfg.pop("type")
    if otype == "bert_adam":
        tx = make_bert_adam(
            lr=ocfg.pop("lr", 1e-4), t_total=ocfg.pop("t_total", 437600),
            warmup=ocfg.pop("warmup", 0.05), b1=ocfg.pop("b1", 0.9),
            b2=ocfg.pop("b2", 0.98), eps=ocfg.pop("e", 1e-6),
            weight_decay=ocfg.pop("weight_decay", 1e-5),
            max_grad_norm=ocfg.pop("max_grad_norm", 0.1))
    elif otype == "noam":
        tx = NoamAdam(model_size=ocfg.pop("model_size", 512),
                      factor=ocfg.pop("factor", 1.0),
                      warmup=ocfg.pop("warmup", 30000))
    elif otype == "gen1_adam":
        tx = gen1_adam(lr=ocfg.pop("lr", 5e-4),
                       decay_start=ocfg.pop("decay_start", 0),
                       decay_every=ocfg.pop("decay_every", 10000),
                       decay_rate=ocfg.pop("decay_rate", 0.8),
                       grad_clip_value=ocfg.pop("grad_clip", 5.0))
    else:
        raise KeyError(f"unknown optimizer type {otype!r}")
    if ocfg:
        raise ValueError(f"unknown {otype} optimizer config keys: "
                         f"{sorted(ocfg)}")
    frozen = getattr(model, "frozen_collections", ())
    return mask_frozen(tx, frozen) if frozen else tx
