"""The Gen-1 `eval_utils` surface: `eval_split` and `language_eval`.

Counterpart of `news_image_caption_tpu/compat/eval_utils.py`: a batched
loop over a split that sums the loss and greedy-captions every batch,
then scores the captions (BLEU-1..4, ROUGE-L, CIDEr) with the port's
scorers. The port's models hold their weights, so the loops take the
model alone; numpy batches go to the model's device.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from news_image_caption_tpu_torch.evaluation.metrics import (BleuScorer,
                                                             CiderScorer,
                                                             RougeScorer)

SPECIALS = (0, 1, 2)


def decode_sequence(ix_to_word: Optional[Dict[int, str]],
                    tokens: np.ndarray) -> List[str]:
    """ids [B, T] -> caption strings: each row up to its first special
    id, a word for an id (`w{id}` where the vocabulary has none)."""
    out = []
    for row in np.asarray(tokens):
        words = []
        for t in row:
            t = int(t)
            if t in SPECIALS:
                break
            words.append(ix_to_word.get(t, f"w{t}") if ix_to_word
                         else f"w{t}")
        out.append(" ".join(words))
    return out


def language_eval(preds: List[Dict[str, str]]) -> Dict[str, float]:
    """BLEU-1..4, ROUGE-L and CIDEr over [{image_id, caption, gt}]."""
    bleu, cider, rouge = BleuScorer(4), CiderScorer(), RougeScorer()
    for p in preds:
        refs = p["gt"] if isinstance(p["gt"], list) else [p["gt"]]
        hyp = p["caption"] or "<empty>"
        refs = [r or "<empty>" for r in refs]
        bleu += (hyp, refs)
        cider += (hyp, refs)
        rouge += (hyp, refs)
    b, _ = bleu.compute_score()
    c, _ = cider.compute_score()
    r, _ = rouge.compute_score()
    return {"Bleu_1": b[0], "Bleu_2": b[1], "Bleu_3": b[2],
            "Bleu_4": b[3], "ROUGE_L": r, "CIDEr": c}


def _on_device(model, batch: Dict) -> Dict[str, torch.Tensor]:
    device = next(model.param_module.parameters()).device
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items() if k != "infos"}


def _loss_and_tokens(model, batch: Dict, max_len: int,
                     attention: bool = False):
    """(loss, its token count, greedy tokens [B, T] without the seed,
    the attention maps or None) of one batch."""
    staged = _on_device(model, batch)
    with torch.no_grad():
        loss, aux = model.loss_fn(staged)
    atts = None
    if attention and hasattr(model, "sample_with_attention"):
        toks, _, atts = model.sample_with_attention(staged, max_len=max_len)
    elif hasattr(model, "sample"):
        toks, _ = model.sample(staged, max_len=max_len)
    else:
        # generate() returns the bos seed first, a special id that would
        # end every caption at once.
        toks = model.generate(staged)[0][:, 1:]
    n = int(aux.get("sample_size", 1))
    return float(loss), n, toks.cpu().numpy(), atts


def _references(ix_to_word, batch: Dict) -> List[str]:
    seq = batch.get("seq", batch.get("caption_ids"))
    return decode_sequence(ix_to_word, np.asarray(seq)[:, 1:])


def eval_split(model, batches: Iterable, *,
               ix_to_word: Optional[Dict[int, str]] = None,
               max_samples: Optional[int] = None,
               language_eval_flag: bool = True, max_len: int = 16
               ) -> Tuple[float, List[Dict], Dict[str, float]]:
    """Greedy-caption a split: (mean loss, predictions, scores). `model`
    has `loss_fn(batch)` and `sample(batch, max_len)` (Gen-1) or
    `generate(batch)` (the other families)."""
    total_loss, total_n = 0.0, 0
    preds: List[Dict] = []
    for batch in batches:
        loss, n, toks, _ = _loss_and_tokens(model, batch, max_len)
        total_loss += loss * n
        total_n += n
        caps = decode_sequence(ix_to_word, toks)
        for cap, ref in zip(caps, _references(ix_to_word, batch)):
            preds.append({"image_id": len(preds), "caption": cap,
                          "gt": [ref]})
        if max_samples is not None and len(preds) >= max_samples:
            break
    stats = language_eval(preds) if language_eval_flag else {}
    return total_loss / max(total_n, 1), preds, stats


def eval_split_visual_news(model, batches: Iterable, *,
                           ix_to_word: Optional[Dict[int, str]] = None,
                           max_samples: Optional[int] = None,
                           language_eval_flag: bool = True,
                           max_len: int = 16, return_attention: bool = False
                           ) -> Tuple[float, List[Dict], Dict[str, float]]:
    """`eval_split` with the visual-news loop's extras: each entry's
    image id and path from the batch's `infos`, and with
    return_attention each token's visual and sentence attention
    (`vis_att`, `sen_att`) where the model returns them."""
    total_loss, total_n = 0.0, 0
    preds: List[Dict] = []
    for batch in batches:
        loss, n, toks, atts = _loss_and_tokens(model, batch, max_len,
                                               return_attention)
        total_loss += loss * n
        total_n += n
        caps = decode_sequence(ix_to_word, toks)
        infos = batch.get("infos", [{}] * len(caps))
        for i, (cap, ref) in enumerate(zip(caps,
                                           _references(ix_to_word, batch))):
            entry = {"image_id": infos[i].get("id", len(preds)),
                     "caption": cap, "gt": [ref]}
            if "file_path" in infos[i]:
                entry["image_path"] = infos[i]["file_path"]
            if atts is not None:
                words = max(len(cap.split()), 1)
                vis, sen = (a.float().cpu().numpy() for a in atts)
                entry["vis_att"] = vis[:words, i].tolist()
                entry["sen_att"] = sen[:words, i].tolist()
            preds.append(entry)
        if max_samples is not None and len(preds) >= max_samples:
            break
    stats = language_eval(preds) if language_eval_flag else {}
    return total_loss / max(total_n, 1), preds, stats
