from news_image_caption_tpu_torch.evaluation.metrics import (
    BleuScorer, CiderScorer, RougeScorer, bleu, cider, rouge_l)

__all__ = [
    "BleuScorer",
    "CiderScorer",
    "RougeScorer",
    "bleu",
    "cider",
    "rouge_l",
]
