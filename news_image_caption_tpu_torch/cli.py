"""Command line of the port: `evaluate` a YAML config on a split.

Counterpart of `news_image_caption_tpu/cli.py` (`main`,
`evaluate_command`): build the config's model and dataset split, caption
every batch greedily, write `generations{suffix}.jsonl` (each record
enriched with names, entities, readability and TTR unless `--no-enrich`)
and `evaluate-metrics{suffix}.json` (BLEU-1..4, CIDEr, ROUGE-L) into the
serialization directory, print the metrics as one JSON line and, with
`--dump-attention DIR`, write each batch's attention maps over its
captions to `DIR/attn_{batch:05d}.npz`.

    python -m news_image_caption_tpu_torch.cli evaluate \\
        configs/tiny_test.yaml --platform cpu

The command runs on the card unless `--platform cpu` is given, and
raises where there is no card. On the card the decoder runs in bf16
(the kernels' type) and each step through the four decode kernels; on
the CPU it runs in the config's dtype (float32 unless set) through their
plain versions. The reference's train, serve, port and preprocess
commands are not ported, and neither are checkpoints, speculative
decoding, sampling or quantized K/V: each raises NotImplementedError
naming its ROADMAP Queue 1 item. With no checkpoint, the weights are
random, drawn from a `torch.Generator` seeded with 0.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from news_image_caption_tpu_torch.config import (build_dataset, build_model,
                                                 load_config)
from news_image_caption_tpu_torch.evaluation.enrich import enrich_record
from news_image_caption_tpu_torch.evaluation.metrics import (BleuScorer,
                                                             CiderScorer,
                                                             RougeScorer)
from news_image_caption_tpu_torch.generation.generator import \
    GenerationConfig

INIT_SEED = 0   # the random init's seed when there is no checkpoint


def main(argv: Optional[list] = None, *,
         timings: Optional[Dict[str, float]] = None) -> int:
    """timings, if given, gets `evaluate`'s host-clock spans."""
    p = argparse.ArgumentParser(
        prog="python -m news_image_caption_tpu_torch.cli")
    sub = p.add_subparsers(dest="command", required=True)
    pe = sub.add_parser("evaluate", help="generate + score on a split")
    pe.add_argument("param_path")
    pe.add_argument("-o", "--overrides", default=None,
                    help="JSON dict merged over the YAML config")
    pe.add_argument("-m", "--model-path", default=None,
                    help="checkpoint to load (not ported yet)")
    pe.add_argument("-s", "--suffix", default="")
    pe.add_argument("--split", default="test")
    pe.add_argument("--no-enrich", action="store_true",
                    help="write bare generation/caption records")
    pe.add_argument("--platform", default=None, choices=("cpu", "cuda"),
                    help="cpu: the plain versions on the CPU; default: the "
                         "card")
    pe.add_argument("--dump-attention", default=None, metavar="DIR",
                    help="write per-batch attention maps (.npz) over the "
                         "generated captions to DIR")
    args = p.parse_args(argv)
    return evaluate_command(args, timings)


def generation_config(cfg: Dict) -> GenerationConfig:
    """The `generation:` block with the reference's evaluate defaults
    (beam_size 5, unused by greedy decode; early exit on). Options the
    port does not have yet raise."""
    raw = cfg.get("generation", {})
    ngram_n = raw.get("ngram_n", 2)
    if ngram_n is not None and int(ngram_n) < 1:
        raise ValueError(f"generation.ngram_n must be >= 1, got {ngram_n}")
    if int(raw.get("speculative_k", 0) or 0) >= 2:
        raise NotImplementedError("generation.speculative_k >= 2: "
                                  "speculative decoding is not ported yet "
                                  "(ROADMAP Queue 1 item 6)")
    if raw.get("sampling_topk", 1) > 1:
        raise NotImplementedError("generation.sampling_topk > 1: top-k "
                                  "sampling is not ported yet (ROADMAP "
                                  "Queue 1 item 4)")
    if raw.get("quantize_kv", False):
        raise NotImplementedError("generation.quantize_kv: quantized K/V is "
                                  "not ported yet (ROADMAP Queue 1 item 7)")
    return GenerationConfig(
        max_len=raw.get("max_len", 100),
        sampling_topk=raw.get("sampling_topk", 1),
        sampling_temp=raw.get("sampling_temp", 1.0),
        beam_size=raw.get("beam_size", 5),
        early_exit=raw.get("early_exit", True))


def evaluation_model(cfg: Dict, device: torch.device):
    """The config's model with the command's random init: bf16 on the
    card, the config's dtype on the CPU."""
    generator = torch.Generator(device=device).manual_seed(INIT_SEED)
    dtype = torch.bfloat16 if device.type == "cuda" else None
    model = build_model(cfg, device, dtype, generator)
    model.decoder.eval()
    return model


def _device(platform: Optional[str]) -> torch.device:
    if platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("evaluate: no CUDA device; pass --platform cpu to "
                           "run the plain versions on the CPU")
    return torch.device("cuda")


def evaluate_command(args,
                     timings: Optional[Dict[str, float]] = None) -> int:
    cfg = load_config(args.param_path, args.overrides)
    device = _device(args.platform)
    gcfg = generation_config(cfg)
    out_dir = (cfg.get("trainer", {}).get("serialization_dir")
               or os.path.join(os.path.dirname(args.param_path) or ".",
                               "serialization"))
    ckpt_dir = os.path.join(out_dir, "checkpoints")
    if os.path.isdir(ckpt_dir) or args.model_path:
        raise NotImplementedError(
            f"loading a checkpoint ({args.model_path or ckpt_dir}) is not "
            "ported yet (ROADMAP Queue 1 item 5)")
    ds = build_dataset(cfg, args.split)
    print(f"warning: no checkpoint in {ckpt_dir}; using random init "
          f"(torch.Generator seeded with {INIT_SEED})", file=sys.stderr)
    model = evaluation_model(cfg, device)
    metrics = evaluate(
        model, ds, gcfg, out_dir,
        batch_size=cfg.get("iterator", {}).get("batch_size", 16),
        suffix=args.suffix, enrich=not args.no_enrich,
        dump_attention=args.dump_attention, timings=timings)
    print(json.dumps(metrics))
    return 0


def _texts(tokens: np.ndarray, caption: np.ndarray):
    """(generation, caption) as `w{id}` words: generated ids without bos,
    pad and eos; caption ids without bos, pad and eos."""
    gen_ids = [int(t) for t in tokens if int(t) not in (0, 1)]
    gen_text = " ".join(f"w{t}" for t in gen_ids if t != 2)
    ref_text = " ".join(f"w{int(t)}" for t in caption
                        if int(t) not in (0, 1, 2))
    return gen_text, ref_text


def evaluate(model, ds, gcfg: GenerationConfig, out_dir: str, *,
             batch_size: int, suffix: str = "", enrich: bool = True,
             dump_attention: Optional[str] = None,
             timings: Optional[Dict[str, float]] = None) -> Dict:
    """Caption `ds` in batches of `batch_size` (unshuffled, the last
    partial batch dropped) with `model.generate`, on the model's device;
    write the generations and the metrics to `out_dir` and return the
    metrics. timings, if given, gets the host-clock seconds of each
    span: data (numpy batches), decode (staging, generate, tokens back),
    attention (maps and their files), records (texts, enrichment,
    scorers' inputs, lines), score (corpus scores, metrics file)."""
    spans = dict.fromkeys(("data", "decode", "attention", "records",
                           "score"), 0.0)
    device = next(model.decoder.parameters()).device
    weights = model.decoder.decode_weights()
    if dump_attention:
        os.makedirs(dump_attention, exist_ok=True)
    os.makedirs(out_dir, exist_ok=True)
    bleu_s, cider_s, rouge_s = BleuScorer(4), CiderScorer(), RougeScorer()
    n = batch_idx = 0
    batches = ds.batches(batch_size, shuffle=False)
    with open(os.path.join(out_dir, f"generations{suffix}.jsonl"), "w") as f:
        while True:
            t = time.perf_counter()
            batch = next(batches, None)
            t = _lap(spans, "data", t)
            if batch is None:
                break
            staged = {k: torch.from_numpy(batch[k]).to(device)
                      for k in ("image", "image_mask", "article",
                                "article_mask")}
            tokens, _ = model.generate(staged, gcfg, weights)
            tokens = tokens.to(torch.int32).cpu().numpy()
            t = _lap(spans, "decode", t)
            if dump_attention:
                ids = torch.from_numpy(tokens).to(device)
                maps = model.attention_maps(staged, ids)
                arrays = {"tokens": tokens}
                for li, layer_maps in enumerate(maps):
                    for ctx, arr in layer_maps.items():
                        arrays[f"layer{li}_{ctx}"] = arr.float().cpu().numpy()
                np.savez(os.path.join(dump_attention,
                                      f"attn_{batch_idx:05d}.npz"), **arrays)
                t = _lap(spans, "attention", t)
            for b in range(tokens.shape[0]):
                gen_text, ref_text = _texts(tokens[b], batch["caption_ids"][b])
                bleu_s += (gen_text, [ref_text])
                cider_s += (gen_text, [ref_text])
                rouge_s += (gen_text, [ref_text])
                if enrich:
                    rec = enrich_record(caption=ref_text, generation=gen_text,
                                        copied_text="")
                else:
                    rec = {"generation": gen_text, "caption": ref_text,
                           "copied_texts": ""}
                f.write(json.dumps(rec) + "\n")
                n += 1
            _lap(spans, "records", t)
            batch_idx += 1
    t = time.perf_counter()
    bleu_corpus, _ = bleu_s.compute_score()
    cider_mean, _ = cider_s.compute_score()
    rouge_mean, _ = rouge_s.compute_score()
    metrics = {
        "n_samples": n,
        "bleu-1": bleu_corpus[0] * 100, "bleu-2": bleu_corpus[1] * 100,
        "bleu-3": bleu_corpus[2] * 100, "bleu-4": bleu_corpus[3] * 100,
        "cider": cider_mean, "rouge-l": rouge_mean * 100,
    }
    with open(os.path.join(out_dir, f"evaluate-metrics{suffix}.json"),
              "w") as f:
        json.dump(metrics, f, indent=1)
    _lap(spans, "score", t)
    if timings is not None:
        timings.update(spans)
    return metrics


def _lap(spans: Dict[str, float], name: str, t: float) -> float:
    now = time.perf_counter()
    spans[name] += now - t
    return now


if __name__ == "__main__":
    sys.exit(main())
