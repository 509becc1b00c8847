"""Caption metrics in pure Python/NumPy: BLEU, CIDEr, ROUGE-L.

A copy of `news_image_caption_tpu/evaluation/metrics.py`: the port
imports nothing of the JAX package.
`tests/test_torch_evaluation_copies.py` holds the two equal.

Capability parity target: pycocoevalcap as used by the reference
(eval_utils.py:25-93 `language_eval`;
ttl/tell/models/transformer_flattened.py:111-118
per-sample BleuScorer; final/custom_v3.py:248,332-361
corpus CiderScorer). pycocoevalcap wraps native/Java scorers; these
are deterministic pure-Python ports of the same algorithms:

- BLEU: corpus-level clipped n-gram precision with the 'closest'
  reference-length brevity penalty and pycocoevalcap's tiny/small
  fudge factors.
- CIDEr: TF-IDF weighted n-gram cosine similarity (n=1..4), gaussian
  length penalty sigma=6, x10 scale.
- ROUGE-L: LCS F-measure with beta=1.2.

METEOR/SPICE are Java subprocesses in pycocoevalcap and are commented
out in the reference's language_eval — intentionally out of scope.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, Iterable, List, Sequence, Tuple


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def precook(s: str, n: int = 4) -> Tuple[int, Dict]:
    words = s.split()
    counts: Counter = Counter()
    for k in range(1, n + 1):
        counts.update(_ngrams(words, k))
    return len(words), counts


class BleuScorer:
    """Corpus BLEU-1..4 accumulator (pycocoevalcap-compatible).

    Usage: scorer += (hypothesis, [refs]); scorer.compute_score().
    """

    TINY = 1e-15
    SMALL = 1e-9

    def __init__(self, n: int = 4):
        self.n = n
        self.crefs: List[List[Tuple[int, Dict]]] = []
        self.ctest: List[Tuple[int, Dict]] = []

    def __iadd__(self, pair):
        hyp, refs = pair
        self.ctest.append(precook(hyp, self.n))
        self.crefs.append([precook(r, self.n) for r in refs])
        return self

    def compute_score(self, option: str = "closest"):
        totalcomps = {
            "testlen": 0, "reflen": 0,
            "guess": [0] * self.n, "correct": [0] * self.n}
        scores_per_sent = []
        for (testlen, hyp_counts), refs in zip(self.ctest, self.crefs):
            # closest reference length (ties -> shorter, pycocoevalcap)
            reflens = [rl for rl, _ in refs]
            if option == "closest":
                reflen = min(reflens, key=lambda rl: (abs(rl - testlen), rl))
            elif option == "shortest":
                reflen = min(reflens)
            else:  # average
                reflen = sum(reflens) / len(reflens)
            totalcomps["testlen"] += testlen
            totalcomps["reflen"] += reflen
            # max ref counts for clipping
            maxcounts: Dict = {}
            for _, rc in refs:
                for ng, c in rc.items():
                    maxcounts[ng] = max(maxcounts.get(ng, 0), c)
            for ng, c in hyp_counts.items():
                k = len(ng) - 1
                totalcomps["guess"][k] += c
                totalcomps["correct"][k] += min(c, maxcounts.get(ng, 0))
            # guesses per order for this sentence (for per-sent scores)
            guess = [max(0, testlen - k) for k in range(self.n)]
            correct = [0] * self.n
            for ng, c in hyp_counts.items():
                correct[len(ng) - 1] += min(c, maxcounts.get(ng, 0))
            scores_per_sent.append(
                self._bleu_from_comps(testlen, reflen, guess, correct))
        score = self._bleu_from_comps(
            totalcomps["testlen"], totalcomps["reflen"],
            totalcomps["guess"], totalcomps["correct"])
        return score, scores_per_sent

    def _bleu_from_comps(self, testlen, reflen, guess, correct):
        bleus = []
        logp = 0.0
        for k in range(self.n):
            p_k = ((correct[k] + self.TINY)
                   / (guess[k] + self.SMALL))
            logp += math.log(p_k)
            bleu_k = math.exp(logp / (k + 1))
            ratio = (testlen + self.TINY) / (reflen + self.SMALL)
            if ratio < 1:
                bleu_k *= math.exp(1 - 1 / ratio)
            bleus.append(bleu_k)
        return bleus


class CiderScorer:
    """Corpus CIDEr accumulator (Vedantam et al. 2015)."""

    def __init__(self, n: int = 4, sigma: float = 6.0):
        self.n = n
        self.sigma = sigma
        self.crefs: List[List[Counter]] = []
        self.ctest: List[Counter] = []

    @staticmethod
    def _counts(s: str, n: int) -> List[Counter]:
        words = s.split()
        return [_ngrams(words, k) for k in range(1, n + 1)]

    def __iadd__(self, pair):
        hyp, refs = pair
        self.ctest.append(self._counts(hyp, self.n))
        self.crefs.append([self._counts(r, self.n) for r in refs])
        return self

    def compute_score(self):
        # Document frequencies over reference sets.
        doc_freq: Counter = Counter()
        for refs in self.crefs:
            seen = set()
            for ref in refs:
                for k in range(self.n):
                    seen.update(ref[k].keys())
            doc_freq.update(seen)
        n_docs = max(len(self.crefs), 1)
        log_ndocs = math.log(max(n_docs, 1))

        def tfidf_vec(counts_per_n):
            vecs, norms, length = [], [], 0
            for k in range(self.n):
                vec = {}
                norm = 0.0
                for ng, c in counts_per_n[k].items():
                    df = math.log(max(doc_freq.get(ng, 0), 1.0))
                    w = c * max(log_ndocs - df, 0.0)
                    vec[ng] = w
                    norm += w * w
                vecs.append(vec)
                norms.append(math.sqrt(norm))
            length = sum(counts_per_n[0].values())
            return vecs, norms, length

        scores = []
        for hyp, refs in zip(self.ctest, self.crefs):
            hvec, hnorm, hlen = tfidf_vec(hyp)
            score_n = [0.0] * self.n
            for ref in refs:
                rvec, rnorm, rlen = tfidf_vec(ref)
                delta = hlen - rlen
                for k in range(self.n):
                    # min-clipped dot product (CIDEr uses min(h, r))
                    dot = sum(min(w, rvec[k].get(ng, 0.0)) * rvec[k].get(ng, 0.0)
                              for ng, w in hvec[k].items())
                    if hnorm[k] > 0 and rnorm[k] > 0:
                        val = dot / (hnorm[k] * rnorm[k])
                    else:
                        val = 0.0
                    val *= math.exp(-delta ** 2 / (2 * self.sigma ** 2))
                    score_n[k] += val
            avg = sum(score_n) / self.n / max(len(refs), 1)
            scores.append(avg * 10.0)
        mean = sum(scores) / max(len(scores), 1)
        return mean, scores


class RougeScorer:
    """ROUGE-L (LCS F-measure, beta=1.2)."""

    def __init__(self, beta: float = 1.2):
        self.beta = beta
        self.scores: List[float] = []

    @staticmethod
    def _lcs(a: Sequence[str], b: Sequence[str]) -> int:
        if not a or not b:
            return 0
        prev = [0] * (len(b) + 1)
        for i in range(1, len(a) + 1):
            cur = [0] * (len(b) + 1)
            for j in range(1, len(b) + 1):
                if a[i - 1] == b[j - 1]:
                    cur[j] = prev[j - 1] + 1
                else:
                    cur[j] = max(prev[j], cur[j - 1])
            prev = cur
        return prev[-1]

    def calc_score(self, hyps: List[str], refs: List[str]) -> float:
        hyp = hyps[0].split()
        if not refs:
            return 0.0     # malformed record: score 0, don't crash
        prec, rec = [], []
        for r in refs:
            ref = r.split()
            l = self._lcs(hyp, ref)
            prec.append(l / len(hyp) if hyp else 0.0)
            rec.append(l / len(ref) if ref else 0.0)
        p, r = max(prec), max(rec)
        if p and r:
            return ((1 + self.beta ** 2) * p * r) / (r + self.beta ** 2 * p)
        return 0.0

    def __iadd__(self, pair):
        hyp, refs = pair
        self.scores.append(self.calc_score([hyp], refs))
        return self

    def compute_score(self):
        mean = sum(self.scores) / max(len(self.scores), 1)
        return mean, list(self.scores)


# -- one-shot helpers ---------------------------------------------------

def bleu(hyps: Iterable[str], refs: Iterable[List[str]], n: int = 4):
    scorer = BleuScorer(n)
    for h, r in zip(hyps, refs):
        scorer += (h, r)
    return scorer.compute_score()[0]


def cider(hyps: Iterable[str], refs: Iterable[List[str]]):
    scorer = CiderScorer()
    for h, r in zip(hyps, refs):
        scorer += (h, r)
    return scorer.compute_score()[0]


def rouge_l(hyps: Iterable[str], refs: Iterable[List[str]]):
    scorer = RougeScorer()
    for h, r in zip(hyps, refs):
        scorer += (h, r)
    return scorer.compute_score()[0]
