"""Vocabularies: word-level (Gen-1/2) and RoBERTa specials (Gen-3).

A copy of `news_image_caption_tpu/data/vocabulary.py`: the port
imports nothing of the JAX package.
`tests/test_torch_data_prep.py` holds the two equal.

Capability parity targets:
- GoodNewsVocab word-level vocab with frequency threshold:
  final/dataloader.py:23-57
- RobertaVocabulary special indices (pad=1, bos=0, eos=2, unk=3):
  ttl/tell/data/vocabulary.py:11-94
"""

from __future__ import annotations

import json
from collections import Counter
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional


@dataclass(frozen=True)
class RobertaSpecialTokens:
    bos: int = 0
    pad: int = 1
    eos: int = 2
    unk: int = 3


class WordVocab:
    """Word-level vocabulary with <pad>/<start>/<end>/<unk> specials.

    Layout matches the Gen-2 convention: pad=0, then specials, then
    words ordered by frequency.
    """

    PAD, START, END, UNK = "<pad>", "<start>", "<end>", "<unk>"

    def __init__(self, word2idx: Optional[Dict[str, int]] = None):
        if word2idx is None:
            word2idx = {self.PAD: 0, self.START: 1, self.END: 2,
                        self.UNK: 3}
        self.word2idx = dict(word2idx)
        self.idx2word = {i: w for w, i in self.word2idx.items()}

    @classmethod
    def build(cls, texts: Iterable[str], min_count: int = 1,
              max_size: Optional[int] = None) -> "WordVocab":
        counts = Counter()
        for t in texts:
            counts.update(t.split())
        vocab = cls()
        items = [(w, c) for w, c in counts.most_common()
                 if c >= min_count and w not in vocab.word2idx]
        if max_size is not None:
            # max(0, ..): max_size below the specials count must keep
            # NOTHING, not wrap into a negative slice keeping all.
            items = items[: max(0, max_size - len(vocab.word2idx))]
        for w, _ in items:
            vocab.add(w)
        return vocab

    def add(self, word: str) -> int:
        if word not in self.word2idx:
            idx = len(self.word2idx)
            self.word2idx[word] = idx
            self.idx2word[idx] = word
        return self.word2idx[word]

    def __len__(self) -> int:
        return len(self.word2idx)

    @property
    def pad_id(self) -> int:
        return self.word2idx[self.PAD]

    @property
    def start_id(self) -> int:
        return self.word2idx[self.START]

    @property
    def end_id(self) -> int:
        return self.word2idx[self.END]

    @property
    def unk_id(self) -> int:
        return self.word2idx[self.UNK]

    def encode(self, text: str, add_specials: bool = True) -> List[int]:
        ids = [self.word2idx.get(w, self.unk_id) for w in text.split()]
        if add_specials:
            ids = [self.start_id] + ids + [self.end_id]
        return ids

    def decode(self, ids: Iterable[int], stop_at_end: bool = True) -> str:
        words = []
        for i in ids:
            i = int(i)
            if i == self.pad_id or i == self.start_id:
                continue
            if i == self.end_id and stop_at_end:
                break
            words.append(self.idx2word.get(i, self.UNK))
        return " ".join(words)

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(self.word2idx, f)

    @classmethod
    def load(cls, path: str) -> "WordVocab":
        with open(path) as f:
            return cls(json.load(f))
