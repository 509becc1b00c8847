"""RoBERTa token indexing with entity copy masks.

Counterpart of `news_image_caption_tpu/data/indexer.py`
(`RobertaCopyIndexer`), over the port's pre-tokenizer
(`data/bpe.py::pattern`) in place of the `regex` module's;
`tests/test_torch_data_prep.py` holds the two equal.

Capability parity targets:
- RobertaTokenIndexer (ttl/tell/data/token_indexers/roberta_indexer.py:33-208):
  byte-BPE encode with <s>/</s>, max_len truncation, per-BPE-token
  copy masks derived from entity character spans;
- roberta_names_matched indexer (roberta_indexer_names_matched.py:32-232):
  multi-valued masks identifying WHICH entity each token belongs to,
  plus proper-noun masks for the context side.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from news_image_caption_tpu_torch.data.bpe import (ByteBPE, RobertaBPE,
                                                   pattern)


class RobertaCopyIndexer:
    """Byte-BPE ids + per-token entity masks aligned by char spans."""

    def __init__(self, bpe: ByteBPE, max_len: int = 512):
        self.tok = RobertaBPE(bpe, max_len=max_len)
        self.max_len = max_len

    def encode_with_offsets(self, text: str
                            ) -> Tuple[List[int], List[Tuple[int, int]]]:
        """BPE ids + per-id (char_start, char_end) spans (no specials)."""
        ids: List[int] = []
        offsets: List[Tuple[int, int]] = []
        bpe = self.tok.bpe
        for m in pattern().finditer(text):
            token = m.group(0)
            start = m.start()
            u = "".join(bpe.byte_encoder[b]
                        for b in token.encode("utf-8"))
            pieces = bpe.bpe(u).split(" ")
            # EXACT byte->char mapping: every piece is a run of byte
            # symbols; map its byte range back to the chars those
            # bytes encode. Proportional rounding assigned zero-width
            # spans to trailing pieces of multi-byte tokens (café,
            # José), dropping their entity masks.
            char_of_byte: List[int] = []
            for ci, ch in enumerate(token):
                char_of_byte.extend([ci] * len(ch.encode("utf-8")))
            bpos = 0
            for p in pieces:
                blen = len(p)
                cs = char_of_byte[bpos]
                ce = char_of_byte[bpos + blen - 1] + 1
                ids.append(bpe.encoder[p] + self.tok.offset)
                offsets.append((start + cs, start + ce))
                bpos += blen
        return ids, offsets

    def encode(self, text: str,
               entity_spans: Optional[Sequence[Tuple[int, int, int]]]
               = None) -> Dict[str, List[int]]:
        """-> {ids, copy_masks} with <s>/</s> and truncation.

        entity_spans: (char_start, char_end, entity_index>=1). Tokens
        overlapping an entity span get that entity's index in
        copy_masks (0 elsewhere; specials get 0). Mirrors the
        reference's length-aligned ids/copy-mask contract
        (roberta_indexer.py:96).
        """
        ids, offsets = self.encode_with_offsets(text)
        masks = [0] * len(ids)
        if entity_spans:
            for (es, ee, idx) in entity_spans:
                for i, (ts, te) in enumerate(offsets):
                    if ts < ee and es < te:      # overlap
                        masks[i] = idx
        limit = self.max_len - 2
        ids = ids[:limit]
        masks = masks[:limit]
        ids = [self.tok.bos] + ids + [self.tok.eos]
        masks = [0] + masks + [0]
        assert len(ids) == len(masks)
        return {"ids": ids, "copy_masks": masks}

    def proper_masks(self, text: str, analyzer=None) -> Dict[str, List[int]]:
        """Context-side: >=1 marks tokens inside proper-noun spans,
        numbered per entity (roberta_indexer_names_matched.py)."""
        from news_image_caption_tpu_torch.data.preprocess import entity_spans
        spans = entity_spans(text, analyzer)
        numbered = [(s, e, i + 1) for i, (s, e, _) in enumerate(spans)]
        enc = self.encode(text, numbered)
        return {"ids": enc["ids"], "proper_masks": enc["copy_masks"]}

    def decode(self, ids: Sequence[int]) -> str:
        return self.tok.decode(ids)
