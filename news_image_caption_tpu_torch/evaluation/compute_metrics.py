"""Offline metrics over a generations.jsonl file.

A copy of `news_image_caption_tpu/evaluation/compute_metrics.py`: the port
imports nothing of the JAX package.
`tests/test_torch_evaluation_copies.py` holds the two equal.

Capability parity target: ttl/scripts/compute_metrics.py:61-412
— BLEU-1..4 / ROUGE-L / CIDEr over (generation, caption) pairs, name
recall/precision (per-sample mean AND corpus counts), rare-name
recall/precision against word counters (caption-only and
caption+context), entity precision/recall per label (all / PERSON /
ORG / GPE / DATE), caption length / unique words, TTR and Flesch
aggregates. METEOR (a Java subprocess in pycocoevalcap) is replaced
by a documented pure-Python exact+stem alignment variant.

Usage: python -m news_image_caption_tpu_torch.evaluation.compute_metrics \
           FILE [--counters PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import re
from collections import defaultdict
from typing import Dict, List, Optional

from news_image_caption_tpu_torch.evaluation.meteor import meteor
from news_image_caption_tpu_torch.evaluation.metrics import (BleuScorer,
                                                       CiderScorer,
                                                       RougeScorer)

ENTITY_LABELS = [("", "ent"), ("PERSON", "person"), ("ORG", "orgs"),
                 ("GPE", "gpes"), ("DATE", "date")]


def meteor_lite(hyp: str, ref: str) -> float:
    """DEPRECATED single-pass variant kept for comparison; scoring
    now uses evaluation.meteor.meteor (staged exact->stem alignment,
    meteor-1.5 parameters, nltk-validated core)."""
    try:
        from nltk.stem import PorterStemmer
        stem = PorterStemmer().stem
    except Exception:  # pragma: no cover
        stem = lambda w: w
    h = hyp.lower().split()
    r = ref.lower().split()
    if not h or not r:
        return 0.0
    hs = [stem(w) for w in h]
    rs = [stem(w) for w in r]
    used = [False] * len(r)
    matches = []
    for i, w in enumerate(hs):
        for j, v in enumerate(rs):
            if not used[j] and w == v:
                used[j] = True
                matches.append((i, j))
                break
    m = len(matches)
    if m == 0:
        return 0.0
    p, rec = m / len(h), m / len(r)
    fmean = 10 * p * rec / (rec + 9 * p)
    # fragmentation: count contiguous chunks in the alignment
    chunks = 1
    for (i1, j1), (i2, j2) in zip(matches, matches[1:]):
        if not (i2 == i1 + 1 and j2 == j1 + 1):
            chunks += 1
    penalty = 0.5 * (chunks / m) ** 3
    return fmean * (1 - penalty)


def contain_entity(entities: List[Dict], target: Dict) -> bool:
    return any(e["text"] == target["text"]
               and e["label"] == target["label"] for e in entities)


def _ratio(count, total):
    return {"count": count, "total": total,
            "percentage": (count / total) if total else None}


def compute_metrics(jsonl_path: str,
                    counters: Optional[Dict] = None,
                    use_processed: bool = False) -> Dict:
    bleu = BleuScorer(4)
    rouge = RougeScorer()
    ciderer = CiderScorer()
    meteor_scores: List[float] = []
    recalls, precisions = [], []
    agg = defaultdict(int)
    lengths, gt_lengths, n_uniques, gt_n_uniques = [], [], [], []
    gen_ttrs, cap_ttrs, gen_flesch, cap_flesch = [], [], [], []
    ent_counter: Dict[str, int] = defaultdict(int)

    cap_counter = (counters or {}).get("caption", {})
    full_counter_keys = set(cap_counter) | set(
        (counters or {}).get("context", {}))

    ner_backend = "unknown"
    with open(jsonl_path) as f:
        for line in f:
            obj = json.loads(line)
            ner_backend = obj.get("ner_backend", ner_backend)
            caption = (obj["caption"] if use_processed
                       else obj.get("raw_caption", obj["caption"]))
            generation = obj["generation"]
            cap_names = obj.get("caption_names", [])
            gen_names = obj.get("generated_names", [])

            if cap_names:
                recalls.append(
                    sum(1 for n in cap_names if n in gen_names)
                    / len(cap_names))
            if gen_names:
                precisions.append(
                    sum(1 for n in gen_names if n in cap_names)
                    / len(gen_names))
            agg["full_recall"] += sum(
                1 for n in cap_names if n in gen_names)
            agg["full_recall_total"] += len(cap_names)
            agg["full_precision"] += sum(
                1 for n in gen_names if n in cap_names)
            agg["full_precision_total"] += len(gen_names)

            if counters is not None:
                rare_c = [n for n in cap_names if n not in cap_counter]
                agg["rare_recall"] += sum(
                    1 for n in rare_c if n in gen_names)
                agg["rare_recall_total"] += len(rare_c)
                rare_g = [n for n in gen_names if n not in cap_counter]
                agg["rare_precision"] += sum(
                    1 for n in rare_g if n in cap_names)
                agg["rare_precision_total"] += len(rare_g)
                frare_c = [n for n in cap_names
                           if n not in full_counter_keys]
                agg["full_rare_recall"] += sum(
                    1 for n in frare_c if n in gen_names)
                agg["full_rare_recall_total"] += len(frare_c)
                frare_g = [n for n in gen_names
                           if n not in full_counter_keys]
                agg["full_rare_precision"] += sum(
                    1 for n in frare_g if n in cap_names)
                agg["full_rare_precision_total"] += len(frare_g)

            cap_clean = re.sub(r"[^\w\s]", "", caption)
            gen_clean = re.sub(r"[^\w\s]", "", generation)
            lengths.append(len(gen_clean.split()))
            gt_lengths.append(len(cap_clean.split()))
            n_uniques.append(len(set(gen_clean.split())))
            gt_n_uniques.append(len(set(cap_clean.split())))

            bleu += (gen_clean, [cap_clean])
            rouge += (gen_clean, [cap_clean])
            ciderer += (gen_clean, [cap_clean])
            meteor_scores.append(meteor(gen_clean, cap_clean))

            # Guard BOTH sides: partially enriched records (integrity
            # counts each field independently) must skip, not crash.
            if "gen_np" in obj and "caption_np" in obj:
                gen_ttrs.append(obj["gen_np"]["basic_ttr"])
                cap_ttrs.append(obj["caption_np"]["basic_ttr"])
            if ("gen_readability" in obj
                    and "caption_readability" in obj):
                gen_flesch.append(
                    obj["gen_readability"]["flesch_reading_ease"])
                cap_flesch.append(
                    obj["caption_readability"]["flesch_reading_ease"])

            cap_ents = obj.get("caption_entities", [])
            gen_ents = obj.get("generated_entities", [])
            for label, key in ENTITY_LABELS:
                ce = [e for e in cap_ents
                      if not label or e["label"] == label]
                ge = [e for e in gen_ents
                      if not label or e["label"] == label]
                ent_counter[f"n_caption_{key}s"] += len(ce)
                ent_counter[f"n_gen_{key}s"] += len(ge)
                ent_counter[f"n_gen_{key}_matches"] += sum(
                    1 for e in ge if contain_entity(ce, e))
                ent_counter[f"n_caption_{key}_matches"] += sum(
                    1 for e in ce if contain_entity(ge, e))

    bleu_corpus, _ = bleu.compute_score(option="closest")
    rouge_mean, _ = rouge.compute_score()
    cider_mean, _ = ciderer.compute_score()

    def mean(xs):
        return sum(xs) / len(xs) if xs else None

    out = {
        "BLEU-1": bleu_corpus[0], "BLEU-2": bleu_corpus[1],
        "BLEU-3": bleu_corpus[2], "BLEU-4": bleu_corpus[3],
        "ROUGE": rouge_mean,
        "METEOR (1.5 params, exact+stem modules)": mean(meteor_scores),
        "CIDEr": cider_mean,
        "All names - recall": _ratio(agg["full_recall"],
                                     agg["full_recall_total"]),
        "All names - precision": _ratio(agg["full_precision"],
                                        agg["full_precision_total"]),
        "Caption rare names - recall": _ratio(
            agg["rare_recall"], agg["rare_recall_total"]),
        "Caption rare names - precision": _ratio(
            agg["rare_precision"], agg["rare_precision_total"]),
        "Article rare names - recall": _ratio(
            agg["full_rare_recall"], agg["full_rare_recall_total"]),
        "Article rare names - precision": _ratio(
            agg["full_rare_precision"],
            agg["full_rare_precision_total"]),
        "Length - generation": mean(lengths),
        "Length - reference": mean(gt_lengths),
        "Unique words - generation": mean(n_uniques),
        "Unique words - reference": mean(gt_n_uniques),
        "Caption TTR": mean(cap_ttrs),
        "Generation TTR": mean(gen_ttrs),
        "Caption Flesch Reading Ease": mean(cap_flesch),
        "Generation Flesch Reading Ease": mean(gen_flesch),
        # Caveat (recorded so downstream readers can't miss it): the
        # entity metrics depend on the NER backend used at enrichment
        # time; "heuristic" diverges from the reference's spaCy-based
        # entity precision/recall and rare-name recall.
        "NER backend": ner_backend,
    }
    for label, key in ENTITY_LABELS:
        name = "all" if not label else label
        out[f"Entity {name} - recall"] = _ratio(
            ent_counter[f"n_caption_{key}_matches"],
            ent_counter[f"n_caption_{key}s"])
        out[f"Entity {name} - precision"] = _ratio(
            ent_counter[f"n_gen_{key}_matches"],
            ent_counter[f"n_gen_{key}s"])
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("file")
    p.add_argument("-c", "--counters", default=None)
    p.add_argument("--use_processed", action="store_true")
    args = p.parse_args(argv)
    counters = None
    if args.counters:
        with open(args.counters, "rb") as f:
            counters = pickle.load(f)
    metrics = compute_metrics(args.file, counters, args.use_processed)
    base = os.path.basename(args.file).split(".")[0]
    if args.use_processed:
        base += "_processed"
    out_path = os.path.join(os.path.dirname(args.file) or ".",
                            f"{base}_reported_metrics.json")
    with open(out_path, "w") as f:
        json.dump(metrics, f, indent=4)
    for k, v in metrics.items():
        print(f"{k}: {v}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
