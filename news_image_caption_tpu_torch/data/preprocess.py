"""Text preprocessing: cleanup + entity-type templating.

A copy of `news_image_caption_tpu/data/preprocess.py` over the port's
`evaluation/text_analysis.py`: the port imports nothing of the JAX
package. `tests/test_torch_data_prep.py` holds the two equal.

Capability parity target: final/preprocess.py:13-149
(`SentenceEmbed` GloVe vectors, `preprocess_sentence` HTML/ASCII/
punctuation cleanup, `NER` entity-type templating: entity spans
replaced by PERSON_/ORG_/GPE_... placeholders) — spaCy replaced by
the pluggable analyzer (evaluation/text_analysis.py).
"""

from __future__ import annotations

import re
import unicodedata
from typing import List, Tuple

from news_image_caption_tpu_torch.evaluation.text_analysis import get_analyzer

TAG_RE = re.compile(r"<[^>]+>")
MULTISPACE_RE = re.compile(r"\s+")
PUNCT_RE = re.compile(r"[^\w\s.,!?'\-]")


def clean_sentence(text: str, strip_punct: bool = True) -> str:
    """HTML strip -> ASCII fold -> punctuation cleanup -> whitespace."""
    text = TAG_RE.sub(" ", text)
    text = unicodedata.normalize("NFKD", text)
    text = text.encode("ascii", "ignore").decode("ascii")
    if strip_punct:
        text = PUNCT_RE.sub(" ", text)
    return MULTISPACE_RE.sub(" ", text).strip()


def entity_spans(text: str, analyzer=None) -> List[Tuple[int, int, str]]:
    """(char_start, char_end, label) for each detected entity."""
    analyzer = analyzer or get_analyzer()
    spans = []
    pos = 0
    for ent in analyzer.entities(text):
        start = text.find(ent["text"], pos)
        if start < 0:
            start = text.find(ent["text"])
            if start < 0:
                continue
        spans.append((start, start + len(ent["text"]), ent["label"]))
        pos = start + len(ent["text"])
    return spans


def template_entities(text: str, analyzer=None) -> str:
    """Replace entity spans with '<LABEL>_' placeholders.

    Parity: final/preprocess.py NER templating ('PERSON_' etc.).
    """
    spans = entity_spans(text, analyzer)
    out = []
    last = 0
    for start, end, label in sorted(spans):
        if start < last:
            continue
        out.append(text[last:start])
        out.append(f"{label}_")
        last = end
    out.append(text[last:])
    return "".join(out)


def truncate_words(text: str, max_words: int = 500) -> str:
    """Context truncation (goodnews_flattened.py:98)."""
    words = text.split()
    return " ".join(words[:max_words])
