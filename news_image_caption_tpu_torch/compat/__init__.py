"""Signature-compatible entry points of the reference's command lines.

Counterpart of `news_image_caption_tpu/compat/`:

- `compat.opts.parse_opt`: the Gen-1 `train.py` flag surface;
- `compat.train`: the `python train.py --flags` command over the port's
  Gen-1 model, `gen1_adam` and `CheckpointStore`;
- `compat.test`: the Gen-2 `final*/test.py`-shaped evaluate command over
  a YAML config's model and checkpoints;
- `compat.eval_utils.eval_split` (and `eval_split_visual_news`): the
  batched loss and greedy-caption loop with BLEU-1..4, ROUGE-L and
  CIDEr.

The flags are the interface kept; the machinery behind them is the
port's. `--platform cpu` runs one on the CPU, as the port's other commands
do; without it they need the card.
"""
