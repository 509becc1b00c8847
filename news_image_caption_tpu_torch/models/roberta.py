"""The frozen RoBERTa article encoder and the weighted sum of its layers.

Counterpart of `news_image_caption_tpu/models/roberta.py`
(`position_ids_from_tokens`, `RobertaLayer`, `RobertaEncoder`,
`WeightedSumFeatures`, `port_hf_roberta`): post-norm layers with separate
q / k / v / attn_out products, scores and softmax in fp32 with padded keys
at -1e9, the probabilities in v's dtype, exact GELU, eps 1e-5 on every
LayerNorm, and the encoder's (last hidden, all L + 1 hiddens) as fairseq's
`extract_features(return_all_hiddens=True)` gives them.

Parameters are stored in PyTorch's layout, as `F.linear`, `F.embedding`
and `F.layer_norm` take them: a linear's `weight` is [out, in], an
embedding's and a LayerNorm's scale are `weight`. `models/from_jax.py`
maps the reference's flax tree (kernels [in, out], `embedding`, `scale`)
onto them, and `state_from_hf` maps a HuggingFace `RobertaModel` state
dict.

The encoder computes in its parameters' dtype (the reference's `dtype`
field, its compute dtype, is not taken: no config sets it), and every
LayerNorm returns that dtype rather than promoting to fp32. The
attention is plain PyTorch: the reference computes it in XLA, and no
Pallas kernel touches it.

Two multi-rank forms, as the reference's:

- `RobertaEncoder(ring_mesh=mesh)`: after the embeddings (over the whole
  sequence, for the positions) each rank keeps its slice of the article
  axis on the mesh's `context` axis (`parallel/sequence.py`), every
  layer's attention is ring attention over the slices
  (`parallel/ring.py`), and every hidden is gathered back whole;
- `encode_pipelined(ids, mesh, n_micro)`: the embeddings on every rank,
  the layers through the GPipe schedule over the mesh's `pipe` axis
  (`parallel/pipe.py`), each rank holding its stage's layers, and the
  last hidden alone on every rank.

Both take the rank's rows of the batch and equal the dense encoder up to
fp32 reassociation.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from news_image_caption_tpu_torch.ops.linear import initializes, new_param
from news_image_caption_tpu_torch.parallel.pipe import (pipeline_apply,
                                                        stage_layers)
from news_image_caption_tpu_torch.parallel.ring import ring_attention
from news_image_caption_tpu_torch.parallel.sequence import (
    replicate_sequence, shard_article_axis)

NEG = -1e9


def position_ids_from_tokens(ids: torch.Tensor, padding_idx: int = 1
                             ) -> torch.Tensor:
    """HF / fairseq positions: pad-aware, the first real token at
    padding_idx + 1, every pad at padding_idx."""
    mask = (ids != padding_idx).long()
    return torch.cumsum(mask, dim=1) * mask + padding_idx


class Dense(nn.Module):
    """y = x W^T + b, W [out, in]; fan-in normal init, zero bias (none
    without `bias`)."""

    def __init__(self, in_features: int, features: int, bias: bool = True,
                 *, device, dtype, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = new_param((features, in_features), device, dtype)
        self.bias = new_param((features,), device, dtype) if bias else None
        if initializes(device):
            with torch.no_grad():
                self.weight.normal_(0.0, in_features ** -0.5,
                                    generator=generator)
                if bias:
                    self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class Norm(nn.Module):
    """LayerNorm in the parameters' dtype."""

    def __init__(self, features: int, eps: float, *, device, dtype):
        super().__init__()
        self.eps = eps
        self.weight = new_param((features,), device, dtype)
        self.bias = new_param((features,), device, dtype)
        if initializes(device):
            with torch.no_grad():
                self.weight.fill_(1.0)
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias,
                            self.eps)


class Embed(nn.Module):
    """Table lookup, normal init with std features^-0.5 (flax's)."""

    def __init__(self, num: int, features: int, *, device, dtype,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = new_param((num, features), device, dtype)
        if initializes(device):
            with torch.no_grad():
                self.weight.normal_(0.0, features ** -0.5,
                                    generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids.long(), self.weight)


class RobertaLayer(nn.Module):
    def __init__(self, hidden: int, heads: int, intermediate: int,
                 eps: float = 1e-5, *, device, dtype, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.heads = heads
        self.q = Dense(hidden, hidden, **kw)
        self.k = Dense(hidden, hidden, **kw)
        self.v = Dense(hidden, hidden, **kw)
        self.attn_out = Dense(hidden, hidden, **kw)
        self.attn_ln = Norm(hidden, eps, device=device, dtype=dtype)
        self.inter = Dense(hidden, intermediate, **kw)
        self.out = Dense(intermediate, hidden, **kw)
        self.out_ln = Norm(hidden, eps, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, keep: torch.Tensor,
                ring_mesh=None) -> torch.Tensor:
        """x [B, S, H]; keep [B, S], True at real tokens; with a ring
        mesh, this rank's slices of them."""
        B, S, H = x.shape
        hd = H // self.heads

        def split(t):
            return t.view(B, S, self.heads, hd).transpose(1, 2)

        if ring_mesh is not None:
            ctx = ring_attention(*(t.view(B, S, self.heads, hd) for t in (
                self.q(x), self.k(x), self.v(x))), keep,
                ring_mesh).reshape(B, S, H)
        else:
            q, k, v = split(self.q(x)), split(self.k(x)), split(self.v(x))
            scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
            scores = (scores / math.sqrt(hd)).masked_fill(
                ~keep[:, None, None, :], NEG)
            probs = torch.softmax(scores, dim=-1).to(v.dtype)
            ctx = torch.matmul(probs, v).transpose(1, 2).reshape(B, S, H)
        x = self.attn_ln(x + self.attn_out(ctx))
        h = F.gelu(self.inter(x), approximate="none")
        return self.out_ln(x + self.out(h))


class RobertaEncoder(nn.Module):
    """ids [B, S] -> (last hidden [B, S, H], all L + 1 hiddens). With
    `ring_mesh`, sequence-parallel over its `context` axis."""

    def __init__(self, vocab_size: int = 50265, hidden: int = 1024,
                 num_layers: int = 24, heads: int = 16,
                 intermediate: int = 4096, max_positions: int = 514,
                 padding_idx: int = 1, eps: float = 1e-5, *, device, dtype,
                 generator: Optional[torch.Generator] = None,
                 ring_mesh=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.num_layers = num_layers
        self.padding_idx = padding_idx
        self.ring_mesh = ring_mesh
        self.word_embeddings = Embed(vocab_size, hidden, **kw)
        self.position_embeddings = Embed(max_positions, hidden, **kw)
        self.token_type_embedding = new_param((hidden,), device, dtype)
        if initializes(device):
            with torch.no_grad():
                self.token_type_embedding.zero_()
        self.embed_ln = Norm(hidden, eps, device=device, dtype=dtype)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", RobertaLayer(
                hidden, heads, intermediate, eps, **kw))

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        """The normalized word + position + token-type embeddings."""
        x = (self.word_embeddings(ids)
             + self.position_embeddings(
                 position_ids_from_tokens(ids, self.padding_idx))
             + self.token_type_embedding)
        return self.embed_ln(x)

    def forward(self, ids: torch.Tensor
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        keep = ids != self.padding_idx
        x = self.embed(ids)
        mesh = self.ring_mesh
        if mesh is not None:
            x, keep = shard_article_axis(x, mesh), shard_article_axis(keep,
                                                                      mesh)
        hiddens = [x]
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, keep, mesh)
            hiddens.append(x)
        if mesh is not None:
            hiddens = [replicate_sequence(h, mesh) for h in hiddens]
        return hiddens[-1], tuple(hiddens)

    def encode_pipelined(self, ids: torch.Tensor, mesh,
                         n_micro: Optional[int] = None) -> torch.Tensor:
        """The last hidden [B, S, H] of this rank's rows `ids` through the
        GPipe schedule over the mesh's `pipe` axis (`parallel/pipe.py`),
        this rank's stage running its own layers. n_micro: default the
        most microbatches the rows allow (microbatches of one row, the
        reference's max(1, B // data)). The weighted sum of all hiddens
        (weigh_bert) would have to travel the pipeline: only the last
        hidden is made."""
        if n_micro is None:
            n_micro = max(1, ids.shape[0])
        layers = stage_layers([getattr(self, f"layer_{i}")
                               for i in range(self.num_layers)], mesh)

        def stage_fn(layer, carry):
            # The pad mask rides the carry; bubble lanes see an all-False
            # mask, which the -1e9 fill makes a uniform average.
            return {"x": layer(carry["x"], carry["mask"]),
                    "mask": carry["mask"]}

        out = pipeline_apply(stage_fn, layers,
                             {"x": self.embed(ids),
                              "mask": ids != self.padding_idx},
                             mesh=mesh, n_micro=n_micro)
        return out["x"]


class WeightedSumFeatures(nn.Module):
    """Softmax-weighted sum over the encoder's hiddens (weigh_bert):
    softmax(bert_weight) . [L, B, S, H], in the promoted dtype of the
    weights and the hiddens (fp32 weights over bf16 hiddens give fp32, as
    in JAX)."""

    def __init__(self, num_layers: int = 25, *, device, dtype,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.bert_weight = new_param((num_layers,), device, dtype)
        if initializes(device):
            with torch.no_grad():
                self.bert_weight.uniform_(0.0, 1.0, generator=generator)

    def forward(self, hiddens) -> torch.Tensor:
        weights = torch.softmax(self.bert_weight, dim=0)
        stacked = torch.stack(hiddens, dim=0)
        dt = torch.promote_types(weights.dtype, stacked.dtype)
        return torch.einsum("l,lbsh->bsh", weights.to(dt), stacked.to(dt))


def state_from_hf(state_dict: Mapping[str, Any], num_layers: int = 24
                  ) -> Dict[str, torch.Tensor]:
    """A HuggingFace `RobertaModel` state dict (keys with or without the
    `roberta.` prefix) as `RobertaEncoder`'s state dict. Linear weights
    are [out, in] in both, so nothing is transposed."""
    sd = {k: torch.as_tensor(v) for k, v in state_dict.items()}
    prefix = "roberta." if any(k.startswith("roberta.") for k in sd) else ""
    emb = f"{prefix}embeddings"
    out = {"word_embeddings.weight": sd[f"{emb}.word_embeddings.weight"],
           "position_embeddings.weight":
               sd[f"{emb}.position_embeddings.weight"],
           "token_type_embedding":
               sd[f"{emb}.token_type_embeddings.weight"][0],
           "embed_ln.weight": sd[f"{emb}.LayerNorm.weight"],
           "embed_ln.bias": sd[f"{emb}.LayerNorm.bias"]}
    parts = {"q": "attention.self.query", "k": "attention.self.key",
             "v": "attention.self.value", "attn_out": "attention.output.dense",
             "attn_ln": "attention.output.LayerNorm",
             "inter": "intermediate.dense", "out": "output.dense",
             "out_ln": "output.LayerNorm"}
    for i in range(num_layers):
        for name, hf in parts.items():
            for leaf in ("weight", "bias"):
                out[f"layer_{i}.{name}.{leaf}"] = \
                    sd[f"{prefix}encoder.layer.{i}.{hf}.{leaf}"]
    return out
