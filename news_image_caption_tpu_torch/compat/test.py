"""`python -m news_image_caption_tpu_torch.compat.test`: the Gen-2
`final*/test.py`-shaped evaluation command.

Counterpart of `news_image_caption_tpu/compat/test.py`: load a YAML
config's model from its checkpoints (`--checkpoint`: latest, best or a
step; random weights seeded with 0, with a warning, where there is
none), greedy-caption the test split in batches (at most
`--max_batches`, `--max_length` tokens), print interim BLEU-4 and CIDEr
every `--log_every` batches and the final scores as one JSON line. On
the card the model decodes in bf16 through the kernels, as `evaluate`
does; `--platform cpu` decodes on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional


def parse_opt(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Gen-2 test command")
    p.add_argument("--config", type=str, required=True,
                   help="YAML config (in place of the final* scripts' "
                        "hard-coded hyperparameters)")
    p.add_argument("--checkpoint", type=str, default="latest",
                   help="'latest' | 'best' | a step")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--max_batches", type=int, default=1400,
                   help="the reference's 1400-batch test loop")
    p.add_argument("--max_length", type=int, default=50,
                   help="greedy decode cap")
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--platform", default=None, choices=("cpu", "cuda"),
                   help="cpu: decode on the CPU; default: the card")
    return p.parse_args(argv)


def test(opt) -> dict:
    import numpy as np
    import torch

    from news_image_caption_tpu_torch import cli
    from news_image_caption_tpu_torch.compat.eval_utils import (
        decode_sequence, language_eval)
    from news_image_caption_tpu_torch.config import (build_dataset,
                                                     load_config)
    from news_image_caption_tpu_torch.data.synthetic import CONTEXT_KEYS
    from news_image_caption_tpu_torch.generation.generator import \
        GenerationConfig

    cfg = load_config(opt.config)
    device = cli._device(opt.platform)
    ds = build_dataset(cfg, "test")
    ckpt_dir = os.path.join(cli._serialization_dir(cfg, opt.config),
                            "checkpoints")
    model = None
    if os.path.isdir(ckpt_dir):
        try:
            model = cli.checkpoint_model(cfg, ckpt_dir, opt.checkpoint,
                                         device)
        except FileNotFoundError:
            pass
    if model is None:
        print(f"warning: checkpoint {opt.checkpoint!r} not found; random "
              "init", file=sys.stderr)
        model = cli.evaluation_model(cfg, device)
    gcfg = GenerationConfig(max_len=opt.max_length)
    weights = model.decode_weights()

    preds = []
    for bi, batch in enumerate(ds.batches(opt.batch_size, shuffle=False)):
        if bi >= opt.max_batches:
            break
        staged = {k: torch.from_numpy(batch[k]).to(device)
                  for k in CONTEXT_KEYS if k in batch}
        toks, _ = model.generate(staged, gcfg, weights)
        # The tokens begin with the bos seed, a special id that would end
        # every caption at once.
        caps = decode_sequence(None, toks.cpu().numpy()[:, 1:])
        refs = decode_sequence(None, np.asarray(batch["caption_ids"])[:, 1:])
        preds.extend({"image_id": len(preds) + i, "caption": c, "gt": [r]}
                     for i, (c, r) in enumerate(zip(caps, refs)))
        if (bi + 1) % opt.log_every == 0:
            interim = language_eval(preds)
            print(f"batch {bi + 1}: BLEU-4 {interim['Bleu_4'] * 100:.2f} "
                  f"CIDEr {interim['CIDEr']:.3f}", flush=True)
    stats = language_eval(preds)
    out = {f"bleu-{i}": stats[f"Bleu_{i}"] * 100 for i in range(1, 5)}
    out["cider"] = stats["CIDEr"]
    out["n_samples"] = len(preds)
    return out


def main(argv=None) -> int:
    opt = parse_opt(argv)
    print(json.dumps(test(opt)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
