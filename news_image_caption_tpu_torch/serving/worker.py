"""Serving builder for the flagship captioner on one CUDA device.

Counterpart of `news_image_caption_tpu/serving/worker.py::
flagship_model_builder` for plain greedy serving: the flagship decoder
in bf16 end to end, greedy decode with early exit, over precomputed
image (49 x 2048) and article (512 x 1024) features. The ZMQ worker and
the HTTP proxy are not part of the port yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from news_image_caption_tpu_torch.config import (FLAGSHIP,
                                                 FLAGSHIP_ARTICLE_LEN,
                                                 FLAGSHIP_IMAGE_LEN)
from news_image_caption_tpu_torch.generation.generator import \
    GenerationConfig
from news_image_caption_tpu_torch.models.captioner import \
    TransformerFlattened
from news_image_caption_tpu_torch.models.from_jax import (load_npz,
                                                          params_from_jax)


def flagship_model_builder(device, batch_size: int = 1, max_len: int = 32,
                           early_exit: bool = True,
                           params_path: Optional[str] = None,
                           seed: int = 0):
    """Returns predict(job) -> {"tokens": int32 [B, max_len + 1]}.

    job: numpy `image` [B, 49, 2048], `image_mask` [B, 49],
    `article` [B, 512, 1024], `article_mask` [B, 512] (masks True at
    padding). params_path: a '/'-joined .npz of the reference's params
    (`models/from_jax.py::load_npz`); otherwise random weights drawn
    from a generator seeded with `seed`. `predict.warmup()` serves one
    zero request of `batch_size` rows; `predict.model`,
    `predict.weights` and `predict.config` expose what it runs.
    """
    device = torch.device(device)
    dtype = torch.bfloat16
    generator = torch.Generator(device=device).manual_seed(seed)
    model = TransformerFlattened(device=device, dtype=dtype,
                                 generator=generator, **FLAGSHIP)
    if params_path is not None:
        model.decoder.load_state_dict(
            params_from_jax(load_npz(params_path), model.decoder))
    model.decoder.eval()
    weights = model.decoder.decode_weights()
    cfg = GenerationConfig(max_len=max_len, early_exit=early_exit)

    def stage(job: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        for key in ("max_len", "rng_seed"):
            if key in job:
                raise ValueError(f"per-request {key} is not supported by "
                                 "the greedy worker")
        return {
            "image": torch.as_tensor(np.asarray(job["image"])).to(device, dtype),
            "image_mask": torch.as_tensor(
                np.asarray(job["image_mask"], bool)).to(device),
            "article": torch.as_tensor(np.asarray(job["article"])).to(device, dtype),
            "article_mask": torch.as_tensor(
                np.asarray(job["article_mask"], bool)).to(device),
        }

    def predict(job: Dict[str, np.ndarray]) -> Dict[str, Any]:
        tokens, _ = model.generate(stage(job), cfg, weights)
        return {"tokens": tokens.to(torch.int32).cpu().numpy()}

    def warmup():
        B, P, S = batch_size, FLAGSHIP_IMAGE_LEN, FLAGSHIP_ARTICLE_LEN
        predict({
            "image": np.zeros((B, P, FLAGSHIP["image_dim"]), np.float32),
            "image_mask": np.zeros((B, P), bool),
            "article": np.zeros((B, S, FLAGSHIP["article_dim"]), np.float32),
            "article_mask": np.zeros((B, S), bool),
        })

    predict.warmup = warmup
    predict.model = model
    predict.weights = weights
    predict.config = cfg
    return predict
