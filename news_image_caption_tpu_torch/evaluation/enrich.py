"""generations.jsonl enrichment (names, entities, readability, TTR).

A copy of `news_image_caption_tpu/evaluation/enrich.py`: the port
imports nothing of the JAX package.
`tests/test_torch_evaluation_copies.py` holds the two equal.

Capability parity target: write_to_json + helpers
(ttl/tell/commands/evaluate.py:180-356), including
the per-text analysis cache (the reference pickles spaCy docs keyed
by sha256; here the cache stores the extracted features directly).
"""

from __future__ import annotations

import hashlib
import json
from typing import Dict, List, Optional

from news_image_caption_tpu_torch.evaluation.text_analysis import (
    get_analyzer, narrative_productivity, readability_scores)


class EnrichmentCache:
    def __init__(self):
        self._cache: Dict[str, Dict] = {}

    def analyze(self, analyzer, text: str) -> Dict:
        key = hashlib.sha256(text.encode("utf-8")).hexdigest()
        if key not in self._cache:
            self._cache[key] = {
                "names": analyzer.proper_nouns(text),
                "entities": analyzer.entities(text),
            }
        return self._cache[key]


_DEFAULT_CACHE = EnrichmentCache()


def enrich_record(caption: str, generation: str,
                  context: str = "",
                  metadata: Optional[Dict] = None,
                  copied_text: str = "",
                  analyzer=None,
                  cache: Optional[EnrichmentCache] = None) -> Dict:
    analyzer = analyzer or get_analyzer()
    # Default to a module-wide cache: contexts repeat across records
    # (the reference pickles spaCy docs for the same reason); a fresh
    # cache per call would re-analyze every shared context.
    cache = cache if cache is not None else _DEFAULT_CACHE
    m = metadata or {}
    cap = cache.analyze(analyzer, caption)
    gen = cache.analyze(analyzer, generation)
    ctx = cache.analyze(analyzer, context)
    return {
        "caption": caption,
        # Which NER produced the entity fields: "spacy" matches the
        # reference's numbers; "heuristic" (capitalization-based,
        # used when spaCy is absent) will diverge on entity
        # precision/recall and rare-name recall.
        "ner_backend": type(analyzer).__name__.replace(
            "Analyzer", "").lower(),
        "raw_caption": m.get("caption", caption),
        "generation": generation,
        "copied_texts": copied_text,
        "web_url": m.get("web_url", ""),
        "image_path": m.get("image_path", ""),
        "context": context,
        "caption_names": cap["names"],
        "generated_names": gen["names"],
        "context_names": ctx["names"],
        "caption_entities": cap["entities"],
        "generated_entities": gen["entities"],
        "context_entities": ctx["entities"],
        "caption_readability": readability_scores(caption),
        "gen_readability": readability_scores(generation),
        "caption_np": narrative_productivity(caption),
        "gen_np": narrative_productivity(generation),
    }


def write_generations(path: str, records: List[Dict], append: bool = True):
    mode = "a" if append else "w"
    with open(path, mode) as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
