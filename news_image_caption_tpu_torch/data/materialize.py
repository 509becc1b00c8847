"""Offline materialization: raw news records -> fixed-shape shards.

Counterpart of `news_image_caption_tpu/data/materialize.py`
(`FeatureEncoders`, `materialize`, `main`): the same records, shards and
command line, with the frozen encoders the port's own
(`models/resnet.py::ResNetTrunk`, `models/roberta.py::RobertaEncoder`);
`tests/test_torch_shards.py` holds the two equal.

The reference's biggest training bottleneck is per-batch HDF5 reads and
per-article RoBERTa feature caching at training time
(dataloader.py:279-296, final_roberta/encoder.py:48-116). Here the frozen
encoders run once, offline, and write fixed-record NICS shards (see
data/native_loader.py); training then never blocks on Python
preprocessing.

Pipeline per record:
  image (path or array) -> preprocess -> ResNet patches [P, C]
  article text -> BPE ids (+ proper masks) -> RoBERTa features [S, D]
  caption text -> BPE ids (+ entity copy masks)
Fixed shapes via pad/truncate; masks stored alongside. The features are
stored in float32, whatever dtype the encoders computed in.

The encoders run on the card (bfloat16, the dtype `models/pipeline.py::
Gen3Pipeline.encode` runs them in there) unless `--platform cpu` is given
(float32). PIL opens and resizes images; it is imported only for a record
whose image needs it.

    python -m news_image_caption_tpu_torch.data.materialize \\
        INPUT.jsonl OUT_PREFIX [--records-per-shard N] [--platform cpu] [...]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from news_image_caption_tpu_torch.data.bpe import ByteBPE
from news_image_caption_tpu_torch.data.indexer import RobertaCopyIndexer
from news_image_caption_tpu_torch.data.native_loader import write_shard
from news_image_caption_tpu_torch.data.readers import (InstanceBuilder,
                                                       JsonlNewsReader)
from news_image_caption_tpu_torch.models.resnet import (ResNetTrunk,
                                                        preprocess_image)
from news_image_caption_tpu_torch.models.roberta import RobertaEncoder
from news_image_caption_tpu_torch.utils.logging import setup_logger

logger = setup_logger("materialize")


class FeatureEncoders:
    """Frozen ResNet + RoBERTa encoders (batched).

    resnet / roberta: a `ResNetTrunk` and a `RobertaEncoder`, used where
    and in the dtype they are; by default ResNet-152 (4 stages) and
    RoBERTa-large built on `device` (default the card) in `dtype`
    (default bfloat16 on the card, float32 on the CPU).
    resnet_state / roberta_state: state dicts loaded into them
    (`state_from_torchvision`, `state_from_hf`, or a JAX tree carried by
    `models/from_jax.py::params_from_jax`); without one the encoder keeps
    its random weights, drawn from a generator seeded with 0, with a
    warning."""

    def __init__(self, resnet: Optional[ResNetTrunk] = None,
                 resnet_state: Optional[Mapping] = None,
                 roberta: Optional[RobertaEncoder] = None,
                 roberta_state: Optional[Mapping] = None, crop: int = 224,
                 device=None, dtype: Optional[torch.dtype] = None):
        if resnet is None or roberta is None:
            device = torch.device(device or "cuda")
            if dtype is None:
                dtype = (torch.bfloat16 if device.type == "cuda"
                         else torch.float32)
            kw = dict(device=device, dtype=dtype, generator=torch.Generator(
                device=device).manual_seed(0))
            resnet = resnet or ResNetTrunk(depth=152, num_stages=4, **kw)
            roberta = roberta or RobertaEncoder(**kw)
        self.resnet, self.roberta = resnet, roberta
        self.crop = crop
        if resnet_state is None:
            logger.warning("materializing with RANDOM ResNet weights "
                           "(pass ported torchvision weights for real "
                           "features)")
        else:
            self.resnet.load_state_dict(resnet_state)
        if roberta_state is None:
            logger.warning("materializing with RANDOM RoBERTa weights")
        else:
            self.roberta.load_state_dict(roberta_state)
        for module in (self.resnet, self.roberta):
            module.requires_grad_(False).eval()

    @torch.no_grad()
    def image_patches(self, images_uint8: np.ndarray) -> np.ndarray:
        """uint8 [B, H, W, 3] -> float32 patches [B, P, C]."""
        w = self.resnet.conv1.weight
        x = preprocess_image(torch.from_numpy(images_uint8).to(w.device),
                             crop=self.crop)
        return self.resnet.patches(x.to(w.dtype)).float().cpu().numpy()

    @torch.no_grad()
    def article_features(self, ids: np.ndarray) -> np.ndarray:
        """int ids [B, S] -> float32 last hidden states [B, S, H]."""
        device = self.roberta.word_embeddings.weight.device
        last, _ = self.roberta(torch.from_numpy(ids).to(device))
        return last.float().cpu().numpy()


def _pad_ids(ids: List[int], length: int, pad: int = 1) -> np.ndarray:
    out = np.full((length,), pad, np.int32)
    out[:min(len(ids), length)] = ids[:length]
    return out


def materialize(input_jsonl: Optional[str], out_prefix: str,
                records_per_shard: int = 1024,
                caption_len: int = 64, article_len: int = 512,
                encoders: Optional[FeatureEncoders] = None,
                indexer: Optional[RobertaCopyIndexer] = None,
                with_copy_masks: bool = True,
                image_size: int = 256,
                batch_size: int = 16,
                reader=None) -> List[str]:
    """Returns the list of shard paths written.

    reader: any re-iterable NewsRecord source (JsonlNewsReader,
    MongoNewsReader, ...) — replaces input_jsonl, so the reference's
    live Mongo data path (nytimes_faces_ner_matched.py:88-190) feeds
    the same offline pass as materialized jsonl. Re-iterable because
    the BPE corpus build is a first pass (pass an indexer to skip it).
    encoders: default `FeatureEncoders()`, on the card.
    """
    if reader is None:
        reader = JsonlNewsReader(input_jsonl)
    if indexer is None:
        corpus = [r.caption for r in reader]
        indexer = RobertaCopyIndexer(ByteBPE.train(corpus, 200),
                                     max_len=article_len)
    builder = InstanceBuilder(indexer,
                              with_copy_masks=with_copy_masks)
    encoders = encoders or FeatureEncoders()

    shard_paths: List[str] = []
    buf: Dict[str, List[np.ndarray]] = {}
    shard_idx = 0

    def flush():
        nonlocal shard_idx, buf
        if not buf:
            return
        path = f"{out_prefix}-{shard_idx:05d}.nics"
        write_shard(path, {k: np.stack(v) for k, v in buf.items()})
        shard_paths.append(path)
        logger.info("wrote %s (%d records)", path,
                    len(next(iter(buf.values()))))
        shard_idx += 1
        buf = {}

    pending: List[Dict] = []

    def process_pending():
        nonlocal pending
        if not pending:
            return
        imgs = np.stack([p["_image"] for p in pending])
        patches = encoders.image_patches(imgs)
        art_ids = np.stack([p["article_ids"] for p in pending])
        art_feats = encoders.article_features(art_ids)
        for p, patch, feat in zip(pending, patches, art_feats):
            rec = {
                "caption_ids": p["caption_ids"],
                "article_ids": p["article_ids"],
                "image": patch.astype(np.float32),
                "article": feat.astype(np.float32),
                # Masks baked alongside (True = pad): RoBERTa outputs
                # at pad positions are nonzero, and a consumer without
                # the mask would cross-attend to them.
                "article_mask": (p["article_ids"] == 1),
                "image_mask": np.zeros((patch.shape[0],), bool),
            }
            if with_copy_masks:
                rec["caption_copy_masks"] = p["caption_copy_masks"]
                rec["context_proper_masks"] = p["context_proper_masks"]
            for k, v in rec.items():
                buf.setdefault(k, []).append(v)
            if len(buf["caption_ids"]) >= records_per_shard:
                flush()
        pending = []

    for rec in reader:
        inst = builder.build(rec)
        item = {
            "caption_ids": _pad_ids(list(inst["caption_ids"]),
                                    caption_len),
            "article_ids": _pad_ids(list(inst["article_ids"]),
                                    article_len),
        }
        if with_copy_masks:
            item["caption_copy_masks"] = _pad_ids(
                list(inst["caption_copy_masks"]), caption_len, pad=-1)
            item["context_proper_masks"] = _pad_ids(
                list(inst["context_proper_masks"]), article_len, pad=0)
        if rec.image is not None:
            img = rec.image
            if img.shape[:2] != (image_size, image_size):
                from PIL import Image
                img = np.asarray(Image.fromarray(img).resize(
                    (image_size, image_size)))
        elif inst.get("image_path"):
            if not os.path.exists(inst["image_path"]):
                # Reference behavior: skip missing-image samples
                # (goodnews_flattened.py:90-93) — baking a black
                # image's features into the shard would silently
                # train on garbage.
                logger.warning("skipping record: missing image %s",
                               inst["image_path"])
                continue
            from PIL import Image
            img = np.asarray(Image.open(
                inst["image_path"]).convert("RGB").resize(
                    (image_size, image_size)))
        else:
            img = np.zeros((image_size, image_size, 3), np.uint8)
        item["_image"] = img
        pending.append(item)
        if len(pending) >= batch_size:
            process_pending()
    process_pending()
    flush()
    return shard_paths


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("input_jsonl",
                   help="source .jsonl ('-' with --mongo-db)")
    p.add_argument("out_prefix")
    p.add_argument("--records-per-shard", type=int, default=1024)
    p.add_argument("--caption-len", type=int, default=64)
    p.add_argument("--article-len", type=int, default=512)
    p.add_argument("--no-copy-masks", action="store_true")
    p.add_argument("--mongo-db", default=None,
                   help="read records live from this MongoDB database "
                        "(goodnews/nytimes schema) instead of jsonl; "
                        "requires pymongo")
    p.add_argument("--mongo-host", default="localhost")
    p.add_argument("--mongo-port", type=int, default=27017)
    p.add_argument("--mongo-split", default="train")
    p.add_argument("--image-dir", default=".",
                   help="JPEG directory for --mongo-db records")
    p.add_argument("--platform", default=None, choices=("cpu", "cuda"),
                   help="cpu: the encoders on the CPU in float32; "
                        "default: the card")
    args = p.parse_args(argv)
    if args.platform != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --platform cpu to run the "
                           "encoders on the CPU")
    reader = None
    if args.mongo_db is not None:
        from news_image_caption_tpu_torch.data.readers import \
            MongoNewsReader
        reader = MongoNewsReader(
            host=args.mongo_host, port=args.mongo_port,
            database=args.mongo_db, split=args.mongo_split,
            image_dir=args.image_dir)
    paths = materialize(
        None if args.input_jsonl == "-" else args.input_jsonl,
        args.out_prefix,
        records_per_shard=args.records_per_shard,
        caption_len=args.caption_len,
        article_len=args.article_len,
        with_copy_masks=not args.no_copy_masks,
        encoders=FeatureEncoders(device=args.platform or "cuda"),
        reader=reader)
    print(json.dumps({"shards": paths}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
