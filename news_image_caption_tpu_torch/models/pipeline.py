"""The online pipeline: raw image and article ids -> caption.

Counterpart of `news_image_caption_tpu/models/pipeline.py::Gen3Pipeline`
(Transform-and-Tell's `TransformerFlattenedModel._forward`): the frozen
ResNet trunk's 49 x 2048 patches and the frozen RoBERTa's article hiddens
(with `weigh_bert`, the softmax-weighted sum of all 25) are the contexts
of the flagship's captioner (`models/captioner.py::TransformerFlattened`).

`Gen3Pipeline` is one `nn.Module` whose children are the captioner's
decoder (`decoder`, so its parameter names are the flagship's under
`decoder.`), `resnet`, `roberta` and, with `weigh_bert`, `weighted_sum`;
`models/from_jax.py` maps the reference's {captioner, resnet, roberta,
weighted_sum} tree onto it. It is its own `param_module`, so a checkpoint
holds the frozen encoders too, as the reference's does. The encoders'
parameters do not require gradients and run under `torch.no_grad`; the
optimizer leaves them out (`frozen_collections`, `training/optim.py::
mask_frozen`). With `weigh_bert` the hiddens carry no gradient, but
`bert_weight` gets one through the weighted sum.

`roberta: {ring: {data: D, context: C}}` runs the encoder with ring
attention over a `context` axis and `roberta: {pipe: {data: D, pipe: P,
n_micro: M}}` through the GPipe schedule over a `pipe` axis
(`models/roberta.py`), each over a mesh of the run's ranks
(`parallel/mesh.py::make_mesh`, a `model` axis there only replicating,
as in the reference); `encode` then takes the rank's rows of the batch.
The ranks of a `context` or `pipe` line must hold the same rows: under
a data-parallel step (`trainer.mesh`) `encode` raises unless they share
their coordinate on its `data` axis, that is unless `trainer.mesh` has
the same axis. The pipelined encoder makes only the last hidden, so
`pipe` with `weigh_bert` raises.

The decoder decodes with the flagship's four kernels, over the patches
and the article hiddens the encoders computed on the card. There is no
`generate_speculative`, as in the reference, so evaluate decodes greedily
whatever `speculative_k` says.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from news_image_caption_tpu_torch.generation.generator import (
    GenerationConfig, Generators)
from news_image_caption_tpu_torch.models.captioner import \
    TransformerFlattened
from news_image_caption_tpu_torch.models.decoder_flattened import \
    DecodeWeights
from news_image_caption_tpu_torch.models.resnet import (ResNetTrunk,
                                                        preprocess_image)
from news_image_caption_tpu_torch.models.roberta import (RobertaEncoder,
                                                         WeightedSumFeatures)
from news_image_caption_tpu_torch.parallel.collectives import batch_rows
from news_image_caption_tpu_torch.parallel.mesh import (CONTEXT_AXIS,
                                                        PIPE_AXIS,
                                                        MeshConfig,
                                                        check_rows_shared,
                                                        make_mesh)
from news_image_caption_tpu_torch.utils.registry import MODELS


@MODELS.register("gen3_pipeline")
class Gen3Pipeline(nn.Module):
    """ResNet + RoBERTa encoders feeding the flagship captioner.

    resnet / roberta: their arguments as the YAML gives them (default
    ResNet-152 with 4 stages, RoBERTa-large); the decoder is built from
    `decoder_kwargs`. All on `device` in `dtype`, drawn from
    `generator`."""

    frozen_collections = ("resnet", "roberta")
    # What the encoders read of a batch, besides the caption: the raw
    # image (uint8 HWC, normalized on the device, or float NHWC) and the
    # article's ids.
    context_keys = ("image", "article_ids")

    def __init__(self, resnet: Optional[Dict] = None,
                 roberta: Optional[Dict] = None, weigh_bert: bool = False, *,
                 device, dtype, generator=None, **decoder_kwargs):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        roberta = dict(roberta or {})
        ring, pipe = roberta.pop("ring", None), roberta.pop("pipe", None)
        # A model built for its layout alone (the meta device) runs
        # nothing and joins no mesh.
        meshes = torch.device(device).type != "meta"
        self.roberta_pipe = None
        self._rows_checked = None   # the data-parallel mesh checked last
        if ring and meshes:
            roberta["ring_mesh"] = make_mesh(MeshConfig(**ring),
                                             torch.device(device).type)
        if pipe:
            pipe = dict(pipe)
            n_micro = pipe.pop("n_micro", None)
            if weigh_bert:
                raise ValueError(
                    "roberta.pipe is incompatible with weigh_bert: the "
                    "pipelined encoder produces only the last hidden "
                    "(RobertaEncoder.encode_pipelined)")
            if meshes:
                self.roberta_pipe = (make_mesh(MeshConfig(**pipe),
                                               torch.device(device).type),
                                     n_micro)
        self.captioner = TransformerFlattened(**kw, **decoder_kwargs)
        self.decoder = self.captioner.decoder
        self.resnet = ResNetTrunk(**(resnet or {}), **kw)
        self.roberta = RobertaEncoder(**roberta, **kw)
        self.weigh_bert = weigh_bert
        self.weighted_sum = (WeightedSumFeatures(self.roberta.num_layers + 1,
                                                 **kw)
                             if weigh_bert else None)
        self.article_pad = self.roberta.padding_idx
        for name in self.frozen_collections:
            getattr(self, name).requires_grad_(False)

    @property
    def param_module(self) -> nn.Module:
        """The module that holds every parameter: the pipeline itself."""
        return self

    def decode_weights(self) -> DecodeWeights:
        """The decoder's fused decode weights; compute once per load."""
        return self.captioner.decode_weights()

    def encode(self, batch: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
        """The captioner's contexts: image patches [B, P, C] with an
        all-False mask, the article features [B, S, H] and its mask
        (True at the pad id). An integer image is preprocessed here, on
        its device; the image goes to the trunk in its parameters'
        dtype."""
        image = batch["image"]
        if not image.is_floating_point():
            image = preprocess_image(image)
        image = image.to(self.resnet.conv1.weight.dtype)
        ids = batch["article_ids"]
        self._check_rows()
        with torch.no_grad():
            patches = self.resnet.patches(image)
            if self.roberta_pipe is not None:
                last = self.roberta.encode_pipelined(ids, *self.roberta_pipe)
            else:
                last, hiddens = self.roberta(ids)
        if self.weigh_bert:
            if self.weighted_sum is None:
                # Last-layer features would silently run another model.
                raise KeyError("weigh_bert=True but the model has no "
                               "'weighted_sum'")
            article = self.weighted_sum(hiddens)
        else:
            article = last
        B, P, _ = patches.shape
        return {"image": patches,
                "image_mask": torch.zeros(B, P, dtype=torch.bool,
                                          device=patches.device),
                "article": article,
                "article_mask": ids == self.article_pad}

    def _check_rows(self) -> None:
        """ValueError where the encoder's ring or pipe partners hold
        different rows of a data-parallel batch."""
        rows = batch_rows()
        if rows is None or rows.mesh is None \
                or rows.mesh is self._rows_checked:
            return
        if self.roberta.ring_mesh is not None:
            check_rows_shared(rows.mesh, self.roberta.ring_mesh,
                              CONTEXT_AXIS, "roberta.ring")
        if self.roberta_pipe is not None:
            check_rows_shared(rows.mesh, self.roberta_pipe[0], PIPE_AXIS,
                              "roberta.pipe")
        self._rows_checked = rows.mesh

    def loss_fn(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None):
        ctx = self.encode(batch)
        return self.captioner.loss_fn(
            {**ctx, "caption_ids": batch["caption_ids"]}, generator)

    @torch.inference_mode()
    def generate(self, batch: Dict[str, torch.Tensor],
                 config: GenerationConfig = GenerationConfig(),
                 weights: Optional[DecodeWeights] = None,
                 generator: Optional[Generators] = None):
        return self.captioner.generate(self.encode(batch), config, weights,
                                       generator)

    @torch.inference_mode()
    def generate_beam(self, batch: Dict[str, torch.Tensor],
                      config: GenerationConfig = GenerationConfig(),
                      weights: Optional[DecodeWeights] = None,
                      impl: str = "topk"):
        return self.captioner.generate_beam(self.encode(batch), config,
                                            weights, impl)
