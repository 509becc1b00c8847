"""`python -m news_image_caption_tpu_torch.compat.train --flags`: the
Gen-1 training command with the `train.py` command line.

Counterpart of `news_image_caption_tpu/compat/train.py`: an iteration
loop over training batches with the Gen-1 schedules converted from
epochs to steps (`gen1_adam`'s step decay from
`learning_rate_decay_start`, every `learning_rate_decay_every` epochs;
scheduled sampling from `scheduled_sampling_start`, its probability
raised by `scheduled_sampling_increase_prob` every
`scheduled_sampling_increase_every` epochs up to
`scheduled_sampling_max_prob`), a CIDEr evaluation and a checkpoint
every `save_checkpoint_every` iterations (`CheckpointStore`, best by
CIDEr) with an `infos_{id}.json`, and `--start_from DIR` resuming from
that directory's infos and newest readable checkpoint.

Data: the HDF5 inputs when `--input_image_h5` and `--input_json` are
given (`data/readers.py::H5DataLoader`, the reference's `get_batch`
contract: labels and masks as they come, the images' pixels mean-pooled
into 49 feature stand-ins of `--att_feat_size`, as the reference does);
otherwise the synthetic news set (`--tpu_synthetic_size N`, vocab
`--tpu_vocab_size`). The model trains in fp32 on the card, or on the CPU
with `--platform cpu`.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from news_image_caption_tpu_torch.data.dataset import SyntheticNewsDataset
from news_image_caption_tpu_torch.data.readers import H5DataLoader
from news_image_caption_tpu_torch.data.synthetic import to_device
from news_image_caption_tpu_torch.evaluation.metrics import CiderScorer
from news_image_caption_tpu_torch.models.gen1 import gen1_factory
from news_image_caption_tpu_torch.training.checkpoint import CheckpointStore
from news_image_caption_tpu_torch.training.optim import gen1_adam
from news_image_caption_tpu_torch.training.train_step import (
    create_train_state, make_train_step)

log = logging.getLogger("compat.train")


def _build_loader(opt):
    if opt.input_image_h5 and opt.input_json:
        return H5DataLoader(opt.input_image_h5, opt.input_json,
                            seq_per_img=opt.seq_per_img)
    if not opt.tpu_synthetic_size:
        raise SystemExit("no --input_image_h5/--input_json given; pass "
                         "--tpu_synthetic_size N to run on synthetic data")
    return SyntheticNewsDataset(
        size=opt.tpu_synthetic_size, vocab_size=opt.tpu_vocab_size,
        caption_len=16, article_len=opt.sentence_length, n_patches=8,
        image_dim=opt.att_feat_size, article_dim=opt.sentence_embed_size)


def _gen1_batch(loader, opt, split: str, rng: np.random.Generator
                ) -> Dict[str, np.ndarray]:
    """The next batch of `split` on the Gen-1 contract: an HDF5 batch as
    (seq, mask, fc_feats, att_feats), a synthetic one as it is."""
    if not hasattr(loader, "get_batch"):
        return next(loader.batches(opt.batch_size,
                                   seed=int(rng.integers(1 << 31))))
    data = loader.get_batch(split, opt.batch_size)
    images = data["images"].astype(np.float32) / 255.0
    # The reference runs the CNN here (train.py:151-152); feature
    # extraction is the offline pipeline's job, so the pixels are
    # mean-pooled into 49 (fc, att) feature stand-ins, widened (ceil
    # division) to exactly att_feat_size.
    B, H, W, C = images.shape
    P = 49
    att = images.reshape(B, -1, C)
    att = att[:, :P * (att.shape[1] // P), :].reshape(B, P, -1, C)
    rep = -(-opt.att_feat_size // C)
    att = att.mean(axis=2).repeat(rep, axis=-1)[..., :opt.att_feat_size]
    # One image feeds seq_per_img captions (dataloader.py:300-320).
    spi = max(1, data["labels"].shape[0] // max(B, 1))
    if spi > 1:
        att = att.repeat(spi, axis=0)
    # The loader's masks keep the slot after the last word (<end>)
    # supervised. The HDF5's labels (uint32 as the reference's prepro
    # writes them) become int64, which torch indexes with.
    return {"seq": data["labels"].astype(np.int64),
            "mask": data["masks"].astype(np.float32),
            "fc_feats": att.mean(axis=1), "att_feats": att}


def _ss_prob(opt, epoch: int) -> float:
    if opt.scheduled_sampling_start < 0:
        return 0.0
    frac = (max(epoch - opt.scheduled_sampling_start, 0)
            // opt.scheduled_sampling_increase_every)
    return min(opt.scheduled_sampling_increase_prob * frac,
               opt.scheduled_sampling_max_prob)


def train(opt) -> Dict[str, float]:
    from news_image_caption_tpu_torch.cli import _device

    device = _device(opt.platform)
    loader = _build_loader(opt)
    rng = np.random.default_rng(0)
    vocab_size = getattr(loader, "vocab_size", None) or opt.tpu_vocab_size
    if opt.cnn_weight:
        log.warning("--cnn_weight %s is not used by this command: it trains "
                    "on the batches' features", opt.cnn_weight)
    model = gen1_factory(
        device=device, dtype=torch.float32,
        generator=torch.Generator(device=device).manual_seed(0),
        model_type=opt.caption_model, vocab_size=vocab_size,
        input_encoding_size=opt.input_encoding_size,
        rnn_size=opt.rnn_size, num_layers=opt.num_layers,
        att_hid_size=opt.att_hid_size, fc_feat_size=opt.fc_feat_size,
        att_feat_size=opt.att_feat_size, drop_prob=opt.drop_prob_lm,
        sentence_embed_method=(opt.sentence_embed_method
                               if opt.sentence_embed else ""),
        sentence_embed_size=opt.sentence_embed_size,
        sentence_length=opt.sentence_length)
    # The reference initializes its model from a first training batch:
    # the batches it trains on are drawn after that one.
    _gen1_batch(loader, opt, "train", rng)
    iters_per_epoch = max(1, (getattr(loader, "size", None)
                              or len(getattr(loader, "splits", {})
                                     .get("train", []))
                              or opt.tpu_synthetic_size) // opt.batch_size)
    # The epoch schedules in steps; a negative decay start never decays.
    decay_start = (10 ** 12 if opt.learning_rate_decay_start < 0
                   else opt.learning_rate_decay_start * iters_per_epoch)
    tx = gen1_adam(lr=opt.learning_rate, decay_start=decay_start,
                   decay_every=opt.learning_rate_decay_every
                   * iters_per_epoch,
                   decay_rate=opt.learning_rate_decay_rate,
                   grad_clip_value=opt.grad_clip, b1=opt.optim_alpha,
                   b2=opt.optim_beta, eps=opt.optim_epsilon)
    state = create_train_state(model.param_module, tx)

    def store_at(root: str) -> CheckpointStore:
        return CheckpointStore(os.path.join(root, "checkpoints"), keep=5,
                               best_metric="cider", maximize=True)

    store = store_at(opt.checkpoint_path)
    infos_path = os.path.join(opt.checkpoint_path, f"infos_{opt.id}.json")
    best_cider: Optional[float] = None
    it = 0
    if opt.start_from:
        src_infos = os.path.join(opt.start_from, f"infos_{opt.id}.json")
        if not os.path.exists(src_infos):
            src_infos = infos_path
        if os.path.exists(src_infos):
            with open(src_infos) as f:
                infos = json.load(f)
            it = infos.get("iter", 0)
            if opt.load_best_score:
                best_cider = infos.get("best_val_score")
            src = store_at(opt.start_from)
            state, _ = (src if src.latest_step() is not None
                        else store).load_with_fallback(state)
        else:
            log.warning("--start_from %s: no infos_%s.json found; starting "
                        "from scratch", opt.start_from, opt.id)

    steps = {}
    max_iters = opt.tpu_max_iters or opt.max_epochs * iters_per_epoch
    t0 = time.time()
    result: Dict[str, float] = {}
    while it < max_iters:
        epoch = it // iters_per_epoch
        ss = round(_ss_prob(opt, epoch), 4)
        if ss not in steps:
            steps[ss] = make_train_step(
                lambda b, g, ss=ss: model.loss_fn(b, g, ss), tx,
                compute_dtype=torch.float32)
        batch = to_device(_gen1_batch(loader, opt, "train", rng), device)
        state, metrics = steps[ss](state, batch, seed=it)
        it += 1
        loss = float(metrics["loss"])
        if it % opt.losses_log_every == 0:
            print(f"iter {it} (epoch {epoch}), loss = {loss:.3f}, "
                  f"{time.time() - t0:.2f}s")
            t0 = time.time()
        if it % opt.save_checkpoint_every == 0 or it >= max_iters:
            cider = _eval_cider(model, loader, opt, rng, device)
            result = {"iter": it, "cider": cider, "loss": loss}
            store.save(state, it, {"cider": cider})
            if best_cider is None or cider > best_cider:
                best_cider = cider
            with open(infos_path, "w") as f:
                json.dump({"iter": it, "epoch": epoch,
                           "best_val_score": best_cider,
                           "vocab_size": vocab_size,
                           "caption_model": opt.caption_model}, f)
    return result


def _eval_cider(model, loader, opt, rng, device) -> float:
    """Greedy captions of about two batches of the val split (the train
    split where there is none) and their CIDEr."""
    scorer = CiderScorer()
    n = 0
    specials = (0, 1, 2)
    split = "val" if "val" in getattr(loader, "splits", {}) else "train"
    while n < min(opt.val_images_use, 2 * opt.batch_size):
        batch = to_device(_gen1_batch(loader, opt, split, rng), device)
        toks, _ = model.sample(batch, max_len=12)
        refs = batch.get("seq", batch.get("caption_ids"))
        for hyp_ids, ref_ids in zip(toks.cpu().numpy(), refs.cpu().numpy()):
            hyp = " ".join(f"w{t}" for t in hyp_ids if t not in specials)
            ref = " ".join(f"w{t}" for t in ref_ids if t not in specials)
            scorer += (hyp or "w0", [ref or "w0"])
            n += 1
    score, _ = scorer.compute_score()
    return float(score)


def main(argv=None) -> int:
    from news_image_caption_tpu_torch.compat.opts import parse_opt
    opt = parse_opt(argv)
    os.makedirs(opt.checkpoint_path, exist_ok=True)
    print(json.dumps(train(opt)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
