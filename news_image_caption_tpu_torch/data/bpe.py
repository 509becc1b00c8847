"""GPT-2 byte-level BPE encoder/decoder, pure Python.

Counterpart of `news_image_caption_tpu/data/bpe.py` (`PAT`, here
`pattern()`, `bytes_to_unicode`, `get_pairs`, `ByteBPE`, `RobertaBPE`),
with the same ids, merges and tie order; `tests/test_torch_data_prep.py`
holds the two equal.

Capability parity target: the RoBERTa byte-BPE used by the reference
indexers (ttl/tell/data/token_indexers/roberta_indexer.py:117-147
via fairseq's GPT2BPE; also HF RobertaTokenizer in
final_roberta2/dataloader.py:19-31).

Loads the standard `encoder.json` + `merges.txt` (or `vocab.bpe`)
artifacts. For environments without the pretrained artifacts, a tiny
BPE can be trained with `ByteBPE.train` (tests use this) — the merge
algorithm is the same, so round-trips exercise the production path.

RoBERTa id convention on top of raw BPE ids:
  <s>=0, <pad>=1, </s>=2, <unk>=3, then BPE id + 4.

The pre-tokenizer is GPT-2's pattern
`'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+`
written for Python's `re`, which has no `\\p{..}`: `pattern()` builds the
three character classes once a process from `unicodedata.category`
(letters L*, numbers N*) and Unicode's White_Space list, which is what the
`regex` module's `\\s` admits (not `str.isspace()`'s U+001C-U+001F), and
compiles the same alternation over them. `re` tries the alternatives in
the same order and backtracks as `regex` does, so the tokens are the
same. Python's Unicode database (15.0 in Python 3.12) decides what a
letter or a number is; a code point assigned in a later Unicode version,
which a newer `regex` may know, is "other" here.
"""

from __future__ import annotations

import json
import re
import sys
import unicodedata
from collections import Counter
from functools import lru_cache
from typing import Dict, Iterable, List, Tuple

# Unicode's White_Space property (PropList.txt), the `regex` module's \s.
WHITE_SPACE = ("\t\n\x0b\x0c\r \x85\xa0\u1680"
               + "".join(chr(c) for c in range(0x2000, 0x200B))
               + "\u2028\u2029\u202f\u205f\u3000")


def _class(chars: Iterable[int]) -> str:
    """A `re` character-class body of the code points `chars` (sorted),
    as ranges."""
    out, start, prev = [], None, None
    for c in chars:
        if start is None:
            start = prev = c
        elif c == prev + 1:
            prev = c
        else:
            out.append((start, prev))
            start = prev = c
    if start is not None:
        out.append((start, prev))
    return "".join(re.escape(chr(a)) if a == b
                   else f"{re.escape(chr(a))}-{re.escape(chr(b))}"
                   for a, b in out)


@lru_cache()
def pattern() -> "re.Pattern":
    """GPT-2's pre-tokenizer pattern for `re` (built on first use)."""
    letters, numbers = [], []
    for c in range(sys.maxunicode + 1):
        cat = unicodedata.category(chr(c))
        if cat[0] == "L":
            letters.append(c)
        elif cat[0] == "N":
            numbers.append(c)
    L, N = _class(letters), _class(numbers)
    S = _class(sorted(map(ord, WHITE_SPACE)))
    return re.compile(
        rf"'s|'t|'re|'ve|'m|'ll|'d| ?[{L}]+| ?[{N}]+| ?[^{S}{L}{N}]+"
        rf"|[{S}]+(?![^{S}])|[{S}]+")


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Invertible byte -> printable unicode char mapping (GPT-2)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: Tuple[str, ...]):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


class ByteBPE:
    def __init__(self, encoder: Dict[str, int],
                 merges: List[Tuple[str, str]]):
        self.encoder = dict(encoder)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = {pair: i for i, pair in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self._cache: Dict[str, str] = {}

    # -- construction ---------------------------------------------------
    @classmethod
    def from_files(cls, encoder_path: str, merges_path: str) -> "ByteBPE":
        with open(encoder_path) as f:
            encoder = json.load(f)
        merges = []
        with open(merges_path, encoding="utf-8") as f:
            for n, line in enumerate(f):
                # Skip ONLY the "#version: ..." header — '#' can open
                # real merges ('# #', '## #'); dropping them breaks id
                # parity with fairseq/HF on text containing '#'.
                if (n == 0 and line.startswith("#version")) \
                        or not line.strip():
                    continue
                a, b = line.split()[:2]
                merges.append((a, b))
        return cls(encoder, merges)

    @classmethod
    def train(cls, texts: Iterable[str], num_merges: int = 100) -> "ByteBPE":
        """Train a small byte-BPE (for tests / custom corpora)."""
        byte_enc = bytes_to_unicode()
        words: Counter = Counter()
        for t in texts:
            for tok in pattern().findall(t):
                u = "".join(byte_enc[b] for b in tok.encode("utf-8"))
                words[tuple(u)] += 1
        merges: List[Tuple[str, str]] = []
        # Seed with all 256 byte symbols (like GPT-2) so any string
        # is encodable even if its bytes never appeared in training.
        vocab = {ch: None for ch in byte_enc.values()}
        for _ in range(num_merges):
            pairs: Counter = Counter()
            for w, c in words.items():
                for p in zip(w, w[1:]):
                    pairs[p] += c
            if not pairs:
                break
            best = max(pairs, key=lambda p: (pairs[p], p))
            merges.append(best)
            merged = best[0] + best[1]
            vocab[merged] = None
            new_words: Counter = Counter()
            for w, c in words.items():
                out, i = [], 0
                while i < len(w):
                    if i < len(w) - 1 and (w[i], w[i + 1]) == best:
                        out.append(merged)
                        i += 2
                    else:
                        out.append(w[i])
                        i += 1
                new_words[tuple(out)] += c
            words = new_words
        encoder = {tok: i for i, tok in enumerate(sorted(vocab))}
        return cls(encoder, merges)

    # -- bpe ------------------------------------------------------------
    def bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token)
        if len(word) <= 1:
            return token
        pairs = get_pairs(word)
        while True:
            bigram = min(
                pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        # Bounded like readers._bpe_cost: news text has effectively
        # unbounded distinct tokens (names, numbers), so an uncapped
        # per-token cache leaks memory over long runs.
        if len(self._cache) >= 65536:
            self._cache.clear()
        self._cache[token] = out
        return out

    # -- public encode/decode -------------------------------------------
    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in pattern().findall(text):
            u = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            for piece in self.bpe(u).split(" "):
                ids.append(self.encoder[piece])
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        data = bytearray(self.byte_decoder[ch] for ch in text)
        return data.decode("utf-8", errors="replace")

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)


class RobertaBPE:
    """RoBERTa wrapper: specials 0..3, BPE ids offset by 4.

    encode_caption adds <s>...</s> like the reference indexer
    (roberta_indexer.py:99-107, max_len truncation included).
    """

    def __init__(self, bpe: ByteBPE, max_len: int = 512):
        self.bpe = bpe
        self.max_len = max_len
        self.bos, self.pad, self.eos, self.unk = 0, 1, 2, 3
        self.offset = 4

    def encode(self, text: str, add_specials: bool = True) -> List[int]:
        ids = [i + self.offset for i in self.bpe.encode(text)]
        if add_specials:
            ids = ids[: self.max_len - 2]
            ids = [self.bos] + ids + [self.eos]
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        core = [int(i) - self.offset for i in ids
                if int(i) >= self.offset]
        return self.bpe.decode(core)

    @property
    def vocab_size(self) -> int:
        return self.bpe.vocab_size + self.offset
