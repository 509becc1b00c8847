"""Text analysis: proper nouns, entities, readability, TTR.

A copy of `news_image_caption_tpu/evaluation/text_analysis.py`: the port
imports nothing of the JAX package.
`tests/test_torch_evaluation_copies.py` holds the two equal.

Capability parity target: the spaCy/textstat enrichment in
ttl/tell/commands/evaluate.py:180-356 (proper nouns,
entities with labels, flesch/fog/smog/ARI readability, narrative
productivity / type-token ratio).

spaCy is optional (no model downloads), so the
default analyzer is a deterministic heuristic: capitalized token
spans -> entities labeled by regex/lexicon rules (PERSON / ORG / GPE /
DATE), which covers the metric contract (entity precision/recall per
label). If spaCy IS importable with a model, `SpacyAnalyzer` uses it —
the interface is identical, so swapping analyzers changes accuracy,
not code.
"""

from __future__ import annotations

import re
from typing import Dict, List

SENT_SPLIT = re.compile(r"[.!?]+")
WORD = re.compile(r"[A-Za-z']+")
MONTHS = {"january", "february", "march", "april", "may", "june",
          "july", "august", "september", "october", "november",
          "december", "monday", "tuesday", "wednesday", "thursday",
          "friday", "saturday", "sunday"}
ORG_SUFFIX = {"inc", "corp", "co", "ltd", "llc", "university",
              "college", "institute", "department", "committee",
              "association", "company", "group", "bank", "times",
              "post", "news", "agency", "ministry", "party"}
GPE_WORDS = {"america", "states", "york", "angeles", "francisco",
             "london", "paris", "china", "russia", "washington",
             "england", "france", "germany", "japan", "india",
             "texas", "california", "europe", "africa", "asia",
             "city", "county"}
PERSON_TITLES = {"mr", "mrs", "ms", "dr", "president", "senator",
                 "gov", "rep", "prof", "sir", "judge", "mayor"}
STOP_CAPS = {"The", "A", "An", "In", "On", "At", "But", "And", "Or",
             "He", "She", "It", "They", "We", "I", "You", "This",
             "That", "His", "Her", "Its", "Their", "After", "Before",
             "When", "While", "As", "If", "Of", "For", "With", "By",
             "From", "To", "Is", "Was", "Are", "Were", "Be", "Been"}
DATE_RE = re.compile(
    r"\b(\d{4}|\d{1,2}(st|nd|rd|th)?)\b", re.IGNORECASE)


def _tokens(text: str) -> List[str]:
    return text.split()


def _cap_spans(tokens: List[str]):
    """Maximal runs of capitalized tokens (skipping leading stops)."""
    spans = []
    i = 0
    while i < len(tokens):
        w = tokens[i].strip(".,;:!?\"'()")
        if w and w[0].isupper() and w not in STOP_CAPS:
            j = i
            span = []
            while j < len(tokens):
                wj = tokens[j].strip(".,;:!?\"'()")
                if wj and wj[0].isupper() and wj not in STOP_CAPS:
                    span.append(wj)
                    j += 1
                else:
                    break
            spans.append((i, span))
            i = j
        else:
            i += 1
    return spans


class HeuristicAnalyzer:
    """Dependency-free proper-noun/entity extractor."""

    def proper_nouns(self, text: str) -> List[str]:
        out = []
        for _, span in _cap_spans(_tokens(text)):
            out.extend(span)
        return out

    def entities(self, text: str) -> List[Dict]:
        ents = []
        tokens = _tokens(text)
        for start, span in _cap_spans(tokens):
            surface = " ".join(span)
            label = self._label(span, tokens, start)
            ents.append({"text": surface, "label": label})
        # standalone dates (years, month names already in spans)
        for m in DATE_RE.finditer(text):
            token = m.group(0)
            if len(token) == 4 and token.isdigit() \
                    and 1800 <= int(token) <= 2100:
                ents.append({"text": token, "label": "DATE"})
        return ents

    def _label(self, span: List[str], tokens: List[str],
               start: int) -> str:
        low = [w.lower() for w in span]
        if any(w in MONTHS for w in low):
            return "DATE"
        if any(w.rstrip(".").lower() in ORG_SUFFIX for w in low):
            return "ORG"
        if any(w in GPE_WORDS for w in low):
            return "GPE"
        prev = tokens[start - 1].strip(".,").lower() if start > 0 else ""
        if prev in PERSON_TITLES or low[0].rstrip(".") in PERSON_TITLES:
            return "PERSON"
        if len(span) == 2 and all(w[0].isupper() for w in span):
            return "PERSON"   # First Last heuristic
        return "ORG" if len(span) > 2 else "PERSON"


class SpacyAnalyzer:
    """spaCy-backed analyzer (same interface), if available."""

    def __init__(self, model: str = "en_core_web_sm"):
        import spacy
        self.nlp = spacy.load(model)

    def proper_nouns(self, text: str) -> List[str]:
        return [t.text for t in self.nlp(text) if t.pos_ == "PROPN"]

    def entities(self, text: str) -> List[Dict]:
        return [{"text": e.text, "label": e.label_}
                for e in self.nlp(text).ents]


_ANALYZER = None


def get_analyzer():
    """Process-wide analyzer singleton: SpacyAnalyzer() costs a
    spacy.load() (~seconds); per-record construction turned
    materialization runs into hours."""
    global _ANALYZER
    if _ANALYZER is None:
        try:
            _ANALYZER = SpacyAnalyzer()
        except Exception:
            _ANALYZER = HeuristicAnalyzer()
    return _ANALYZER


# ---------------------------------------------------------------------
# Readability (textstat-equivalent formulas)
# ---------------------------------------------------------------------

def count_syllables(word: str) -> int:
    word = word.lower().strip(".,;:!?\"'()")
    if not word:
        return 0
    groups = re.findall(r"[aeiouy]+", word)
    n = len(groups)
    if word.endswith("e") and n > 1 and not word.endswith("le"):
        n -= 1
    return max(n, 1)


def _stats(text: str):
    sentences = [s for s in SENT_SPLIT.split(text) if s.strip()]
    words = WORD.findall(text)
    syllables = sum(count_syllables(w) for w in words)
    return max(len(sentences), 1), max(len(words), 1), syllables, words


def flesch_reading_ease(text: str) -> float:
    ns, nw, nsy, _ = _stats(text)
    return 206.835 - 1.015 * (nw / ns) - 84.6 * (nsy / nw)


def flesch_kincaid_grade(text: str) -> float:
    ns, nw, nsy, _ = _stats(text)
    return 0.39 * (nw / ns) + 11.8 * (nsy / nw) - 15.59


def gunning_fog(text: str) -> float:
    ns, nw, _, words = _stats(text)
    complex_words = sum(1 for w in words if count_syllables(w) >= 3)
    return 0.4 * ((nw / ns) + 100.0 * complex_words / nw)


def smog_index(text: str) -> float:
    ns, _, _, words = _stats(text)
    poly = sum(1 for w in words if count_syllables(w) >= 3)
    return 1.0430 * (poly * 30.0 / ns) ** 0.5 + 3.1291


def automated_readability_index(text: str) -> float:
    ns, nw, _, words = _stats(text)
    chars = sum(len(w) for w in words)
    return 4.71 * (chars / nw) + 0.5 * (nw / ns) - 21.43


def readability_scores(text: str) -> Dict[str, float]:
    return {
        "flesch_reading_ease": flesch_reading_ease(text),
        "flesch_kincaid_grade": flesch_kincaid_grade(text),
        "gunning_fog": gunning_fog(text),
        "smog_index": smog_index(text),
        "automated_readability_index": automated_readability_index(text),
    }


def narrative_productivity(text: str) -> Dict[str, float]:
    """Type-token ratios (parity: get_narrative_productivity)."""
    words = [w.lower() for w in WORD.findall(text)]
    n = max(len(words), 1)
    types = len(set(words))
    return {
        "basic_ttr": types / n,
        "root_ttr": types / (n ** 0.5),
        "corrected_ttr": types / ((2.0 * n) ** 0.5),
        "n_words": len(words),
        "n_types": types,
    }
