"""Training builder for the flagship captioner on one device.

The training counterpart of `serving/worker.py::flagship_model_builder`:
the flagship decoder (`config.py::FLAGSHIP`) with its training dropouts
and flash attention (`FLAGSHIP_TRAIN`), stored in bf16, an fp32 master
copy and BertAdam with the warmup-linear schedule
(`FLAGSHIP_OPTIMIZER`), as the reference trains
`configs/goodnews_transformer_roberta.yaml` (bf16_o2).
"""

from __future__ import annotations

from typing import Optional

import torch

from news_image_caption_tpu_torch.config import (FLAGSHIP,
                                                 FLAGSHIP_OPTIMIZER,
                                                 FLAGSHIP_TRAIN)
from news_image_caption_tpu_torch.models.captioner import \
    TransformerFlattened
from news_image_caption_tpu_torch.training.optim import make_bert_adam
from news_image_caption_tpu_torch.training.train_step import (
    create_o2_train_state, make_eval_step, make_train_step)


def flagship_trainer_builder(device, seed: int = 0,
                             t_total: Optional[int] = None,
                             moment_dtype: Optional[torch.dtype] = None):
    """Returns (model, state, train_step, eval_step).

    Random weights drawn from a generator seeded with `seed`; t_total
    (the schedule's length in updates) defaults to the YAML's;
    moment_dtype (e.g. torch.bfloat16) stores BertAdam's first moments
    in that dtype (fp32 by default).
    train_step(state, batch, seed) and eval_step(batch) take batches of
    tensors on `device` (`data/synthetic.py::to_device`).
    """
    device = torch.device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    dtype = torch.bfloat16
    model = TransformerFlattened(device=device, dtype=dtype,
                                 generator=generator, **FLAGSHIP,
                                 **FLAGSHIP_TRAIN)
    opt = dict(FLAGSHIP_OPTIMIZER)
    if t_total is not None:
        opt["t_total"] = t_total
    tx = make_bert_adam(**opt, moment_dtype=moment_dtype)
    state = create_o2_train_state(model.decoder, tx)
    return (model, state,
            make_train_step(model.loss_fn, tx, compute_dtype=dtype),
            make_eval_step(model.loss_fn, compute_dtype=dtype))
