"""Gen-2 captioner: an Annotated-Transformer decoder over image and
article memory.

Counterpart of `news_image_caption_tpu/models/gen2.py` (`Gen2LayerNorm`,
`Gen2MHA`, `Gen2FeedForward`, `Gen2DecoderLayer`, `Gen2Transformer`,
`label_smoothing_loss`, `label_smoothing_loss_from_logits`,
`gen2_transformer`, `Gen2Captioner`). Token embeddings times sqrt(d)
plus the interleaved sinusoidal table; each layer is four pre-norm
sublayers: causal self-attention, then an image and an article
attention that both read the self-attention's output, fused by
`context_fc` (no weight norm), then the FFN; a final norm and the
`generator` projection. The norm is the reference's: Bessel-corrected
std with eps outside the sqrt. Cross-attention projects its memory from
the memory's width to d_model (`k_lin`, `v_lin`).

Parameter names are the flax tree's (`layers.0.self_attn.q_lin.kernel`
for `layers_0/self_attn/q_lin/kernel`, `layers.0.norm_0.a_2`,
`embed.embedding`, `generator.kernel`), so `models/from_jax.py::
params_from_jax` maps the reference's weights onto `Gen2Transformer`,
which is `Gen2Captioner.param_module`.

Training is the teacher-forced pass in plain PyTorch with the reference's
dropouts, loss from the logits by reductions only, normalised by the
token count. Decoding keeps a self-attention K/V cache [B, L, H, hd] a
layer: `step` (greedy or top-k sampled `generate`) and `step_chunk`
(speculative verification and the slot pool of `generation/
continuous.py::ContinuousBatcher.for_gen2`) write a row's K/V at its own
positions, and a row attends only slots at or before its position, so
an uncommitted tail is never read and the next chunk overwrites it. On
the card two kernels run a step or a chunk: `decode_cross_attention`
for the image and the article attention of every layer (the memory's
K/V projected once a request, flat [B, S, E] in the compute dtype, the
query scaled by hd**-0.5 first, the article's padding an fp32 -1e9 key
bias), and `band_topk_lse` for the generator head, over one band whose
table folds the bias in, [Wᵀ | b | 0 ...] [V, d + 64] built once a
load (`decode_weights`), read with [x | 1 | 0 ...]: the token is the
band's top-k and its log-prob logit - lse, with no [B, V] matrix. The
self-attention over the cache stays plain PyTorch (its mask differs for
each query of a chunk; the kernel's bias is one a key). A chunk runs
its per-token products, norms and the self-attention position by
position, as k steps would, and only the two kernels on all its k
positions at once, so speculative and pooled captions take their
tokens from the same sums as `generate`'s.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from news_image_caption_tpu_torch.data.synthetic import LOSS_KEYS
from news_image_caption_tpu_torch.generation.generator import (
    GenerationConfig, Generators, generate_candidates)
from news_image_caption_tpu_torch.generation.speculative import (
    ngram_drafts, speculative_greedy)
from news_image_caption_tpu_torch.ops import attention
from news_image_caption_tpu_torch.ops.attention import AttentionKV
from news_image_caption_tpu_torch.ops.band_topk import band_topk_lse
from news_image_caption_tpu_torch.ops.dropout import dropout, remat
from news_image_caption_tpu_torch.ops.linear import (GehringLinear,
                                                     XavierLinear,
                                                     initializes, new_param,
                                                     positionwise)
from news_image_caption_tpu_torch.ops.positional import \
    interleaved_sinusoidal_table
from news_image_caption_tpu_torch.parallel.collectives import global_sums
from news_image_caption_tpu_torch.utils.registry import MODELS

NEG = -1e9
HEAD_PAD = 64       # the bias column and zeros: D % 64 == 0 for the kernel

SelfCache = Tuple[torch.Tensor, torch.Tensor]     # K, V [B, L, H, hd]
LayerKV = Dict[str, AttentionKV]                   # image, article


class Gen2Weights(NamedTuple):
    """What a decode reads besides the module: the generator's folded
    table [V, d + 64], [Wᵀ | b | 0 ...] in the compute dtype."""

    head_table: torch.Tensor


class Gen2LayerNorm(nn.Module):
    """a_2 * (x - mean) / (std + eps) + b_2, std Bessel-corrected, in
    fp32; the result in x's dtype."""

    def __init__(self, features: int, *, device, dtype, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.a_2 = new_param((features,), device, dtype)
        self.b_2 = new_param((features,), device, dtype)
        if initializes(device):
            with torch.no_grad():
                self.a_2.fill_(1.0)
                self.b_2.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        d = xf.shape[-1]
        mean = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mean) ** 2).sum(dim=-1, keepdim=True) / (d - 1)
        y = (self.a_2.float() * (xf - mean) / (torch.sqrt(var) + self.eps)
             + self.b_2.float())
        return y.to(x.dtype)


class Gen2MHA(nn.Module):
    """Multi-head attention whose keys and values are projected from
    `d_key` wide inputs to d_model, then split into heads."""

    def __init__(self, d_model: int, num_heads: int,
                 d_key: Optional[int] = None, dropout_rate: float = 0.1, *,
                 device, dtype, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        d_key = d_key or d_model
        self.num_heads = num_heads
        self.head_dim = d_model // num_heads
        self.dropout_rate = dropout_rate
        self.q_lin = XavierLinear(d_model, d_model, **kw)
        self.out_lin = XavierLinear(d_model, d_model, **kw)
        self.k_lin = XavierLinear(d_key, d_model, **kw)
        self.v_lin = XavierLinear(d_key, d_model, **kw)

    def project_kv(self, key: torch.Tensor, value: torch.Tensor):
        """[B, S, d_key] -> (k, v) [B, S, H, hd]."""
        B, S, _ = key.shape
        H, hd = self.num_heads, self.head_dim
        return (self.k_lin(key).view(B, S, H, hd),
                self.v_lin(value).view(B, S, H, hd))

    def attend(self, query: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """query [B, T, d_model] over k, v [B, S, H, hd]; mask
        broadcastable to [B, T, S], True where a key may be attended.
        Scores and softmax in fp32, the probabilities in v's dtype."""
        B, T, _ = query.shape
        H, hd = self.num_heads, self.head_dim
        q = self.q_lin(query).view(B, T, H, hd)
        scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
        scores = scores / math.sqrt(hd)
        if mask is not None:
            scores = torch.where(mask[:, None], scores, NEG)
        p = torch.softmax(scores, dim=-1).to(v.dtype)
        p = dropout(p, self.dropout_rate, generator)
        out = torch.einsum("bhts,bshd->bthd", p, v).reshape(B, T, H * hd)
        return self.out_lin(out)

    def decode_kv(self, memory: torch.Tensor,
                  key_padding_mask: Optional[torch.Tensor] = None
                  ) -> AttentionKV:
        """The memory's K/V flat [B, S, E] with the key bias [B, S] fp32
        (-1e9 where key_padding_mask is True): the layout of
        `decode_cross_attention`."""
        B, S, _ = memory.shape
        bias = torch.zeros(B, S, device=memory.device, dtype=torch.float32)
        if key_padding_mask is not None:
            bias.masked_fill_(key_padding_mask.to(torch.bool), NEG)
        return AttentionKV(self.k_lin(memory).contiguous(),
                           self.v_lin(memory).contiguous(), bias)

    def attend_decode(self, query: torch.Tensor,
                      kv: AttentionKV) -> torch.Tensor:
        """query [B, k, d_model] (k <= 16 positions a row) over the
        memory's `decode_kv`: `attend_positions` through q_lin and
        out_lin."""
        return attention.attend_positions(self.q_lin, self.out_lin,
                                          self.num_heads, query, kv)

    def attend_cache(self, query: torch.Tensor, cache: SelfCache,
                     valid: torch.Tensor) -> torch.Tensor:
        """One position a row: query [B, d_model] over the cache's slots
        that valid [B, L] allows."""
        k_c, v_c = cache
        B, L, H, hd = k_c.shape
        q = self.q_lin(query).view(B, H, hd)
        scores = torch.einsum("bhd,blhd->bhl", q.float(), k_c.float())
        scores = scores / math.sqrt(hd)
        scores = torch.where(valid[:, None, :], scores, NEG)
        p = torch.softmax(scores, dim=-1).to(v_c.dtype)
        return self.out_lin(torch.einsum("bhl,blhd->bhd", p,
                                         v_c).reshape(B, H * hd))


class Gen2FeedForward(nn.Module):
    def __init__(self, d_model: int, d_ff: int, dropout_rate: float = 0.1, *,
                 device, dtype, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.dropout_rate = dropout_rate
        self.w_1 = XavierLinear(d_model, d_ff, **kw)
        self.w_2 = XavierLinear(d_ff, d_model, **kw)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = dropout(torch.relu(self.w_1(x)), self.dropout_rate, generator)
        return self.w_2(h)


class Gen2DecoderLayer(nn.Module):
    """Pre-norm self-attention, image and article attention over its
    output, `context_fc` over both, then the FFN."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int, img_dim: int,
                 sent_dim: int, dropout_rate: float = 0.1, *, device, dtype,
                 generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.dropout_rate = dropout_rate
        self.self_attn = Gen2MHA(d_model, num_heads,
                                 dropout_rate=dropout_rate, **kw)
        self.img_attn = Gen2MHA(d_model, num_heads, d_key=img_dim,
                                dropout_rate=dropout_rate, **kw)
        self.article_attn = Gen2MHA(d_model, num_heads, d_key=sent_dim,
                                    dropout_rate=dropout_rate, **kw)
        self.ff = Gen2FeedForward(d_model, d_ff, dropout_rate, **kw)
        for i in range(4):
            setattr(self, f"norm_{i}",
                    Gen2LayerNorm(d_model, device=device, dtype=dtype))
        self.context_fc = GehringLinear(2 * d_model, d_model,
                                        weight_norm=False, **kw)

    def _norm(self, i: int) -> Gen2LayerNorm:
        return getattr(self, f"norm_{i}")

    def forward(self, x: torch.Tensor, memory: Dict[str, torch.Tensor],
                tgt_mask: Optional[torch.Tensor],
                src_masks: Dict[str, Optional[torch.Tensor]],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Teacher-forced x [B, T, d]; masks True where attended."""
        def sub(i, x, fn):
            return x + dropout(fn(self._norm(i)(x)), self.dropout_rate,
                               generator)

        def cross(attn, name):
            def fn(q):
                k, v = attn.project_kv(memory[name], memory[name])
                return attn.attend(q, k, v, src_masks.get(name), generator)
            return fn

        x = sub(0, x, lambda q: self.self_attn.attend(
            q, *self.self_attn.project_kv(q, q), tgt_mask, generator))
        x_img = sub(1, x, cross(self.img_attn, "image"))
        x_art = sub(2, x, cross(self.article_attn, "article"))
        x = self.context_fc(torch.cat([x_img, x_art], dim=-1))
        return sub(3, x, lambda h: self.ff(h, generator))

    def precompute_kv(self, memory: Dict[str, torch.Tensor],
                      article_mask: Optional[torch.Tensor]) -> LayerKV:
        return {"image": self.img_attn.decode_kv(memory["image"]),
                "article": self.article_attn.decode_kv(memory["article"],
                                                       article_mask)}

    def chunk(self, x: torch.Tensor, pos: torch.Tensor, cache: SelfCache,
              kv: LayerKV) -> torch.Tensor:
        """k decode positions of each row, x [B, k, d], the math of k
        sequential steps. pos [B] int64: each row's position of x[:, 0].
        Position j's K/V go to cache slot pos + j in place (a window past
        the cache's end moved back inside it, as `dynamic_update_slice`
        moves it) and it attends slots <= pos + j."""
        k_c, v_c = cache
        B, k, _ = x.shape
        L = k_c.shape[1]
        rows = torch.arange(B, device=x.device)
        start = pos.clamp(0, L - k)
        slots = torch.arange(L, device=x.device)
        attended = []
        for j in range(k):
            xj = x[:, j].contiguous()
            xn = self._norm(0)(xj)
            kn, vn = self.self_attn.project_kv(xn[:, None], xn[:, None])
            k_c[rows, start + j] = kn[:, 0].to(k_c.dtype)
            v_c[rows, start + j] = vn[:, 0].to(v_c.dtype)
            valid = slots[None, :] <= (pos + j)[:, None]
            attended.append(xj + self.self_attn.attend_cache(xn, cache,
                                                             valid))
        x = torch.stack(attended, dim=1)
        x_img = x + self.img_attn.attend_decode(
            positionwise(self._norm(1), x), kv["image"])
        x_art = x + self.article_attn.attend_decode(
            positionwise(self._norm(2), x), kv["article"])
        x = positionwise(self.context_fc, torch.cat([x_img, x_art], dim=-1))
        return x + positionwise(lambda r: self.ff(self._norm(3)(r)), x)


class Embed(nn.Module):
    """flax `nn.Embed`: `embedding` [V, d], xavier-uniform init."""

    def __init__(self, num: int, features: int, *, device, dtype,
                 generator=None):
        super().__init__()
        self.embedding = new_param((num, features), device, dtype)
        if initializes(device):
            bound = math.sqrt(6.0 / (num + features))
            with torch.no_grad():
                self.embedding.uniform_(-bound, bound, generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[ids]


class Gen2Transformer(nn.Module):
    """The decoder: embedding, layers, final norm and the `generator`
    projection (the attribute keeps the flax name; it is a linear
    layer, not a random generator). `remat` checkpoints each layer of
    the teacher-forced path (`ops/dropout.py::remat`)."""

    def __init__(self, *, device, dtype=torch.float32, generator=None,
                 vocab_size: int, d_model: int = 512, d_ff: int = 2048,
                 num_heads: int = 8, num_layers: int = 3, img_dim: int = 1024,
                 sent_dim: int = 300, dropout_rate: float = 0.1,
                 max_len: int = 512, pad_id: int = 0, remat: bool = False):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.remat = remat
        self.dtype = dtype
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.num_heads = num_heads
        self.num_layers = num_layers
        self.dropout_rate = dropout_rate
        self.max_len = max_len
        self.pad_id = pad_id
        self.embed = Embed(vocab_size, d_model, **kw)
        pe = torch.from_numpy(interleaved_sinusoidal_table(max_len + 8,
                                                           d_model))
        self.register_buffer("pe", pe.to(device), persistent=False)
        self.layers = nn.ModuleList(
            Gen2DecoderLayer(d_model, num_heads, d_ff, img_dim, sent_dim,
                             dropout_rate, **kw)
            for _ in range(num_layers))
        self.final_norm = Gen2LayerNorm(d_model, device=device, dtype=dtype)
        self.generator = XavierLinear(d_model, vocab_size, **kw)

    def _embed(self, tokens: torch.Tensor, start,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """tokens [B, T] from position `start` (an int, or each row's
        [B] tensor) -> [B, T, d] in the compute dtype; positions past the
        table take its last row (a chunk's uncommitted tail)."""
        T = tokens.shape[1]
        idx = torch.arange(T, device=tokens.device)
        idx = (idx[None, :] + start[:, None] if isinstance(start, torch.Tensor)
               else idx[None, :] + start)
        pe = self.pe[idx.clamp(max=self.pe.shape[0] - 1)]
        x = self.embed(tokens).float() * math.sqrt(self.d_model) + pe
        return dropout(x.to(self.dtype), self.dropout_rate, generator)

    def decode(self, memory: Dict[str, torch.Tensor], tgt: torch.Tensor,
               tgt_mask: Optional[torch.Tensor] = None,
               src_masks: Optional[Dict] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Teacher-forced hidden states [B, T, d]; the default target mask
        is causal and drops pad inputs."""
        if tgt_mask is None:
            T = tgt.shape[1]
            causal = torch.tril(torch.ones(T, T, dtype=torch.bool,
                                           device=tgt.device))
            tgt_mask = (tgt != self.pad_id)[:, None, :] & causal[None]
        memory = {k: v.to(self.dtype) for k, v in memory.items()}
        x = self._embed(tgt, 0, generator)
        for layer in self.layers:
            if self.remat:
                x = remat(lambda h, layer=layer: layer(
                    h, memory, tgt_mask, src_masks or {}, generator),
                    generator, x)
            else:
                x = layer(x, memory, tgt_mask, src_masks or {}, generator)
        return self.final_norm(x)

    def logits(self, memory, tgt, tgt_mask=None, src_masks=None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The generator's output before log-softmax [B, T, V]."""
        return self.generator(self.decode(memory, tgt, tgt_mask, src_masks,
                                          generator))

    def log_probs(self, memory, tgt, tgt_mask=None, src_masks=None
                  ) -> torch.Tensor:
        """Log-softmax over the vocab [B, T, V], fp32."""
        return torch.log_softmax(self.logits(memory, tgt, tgt_mask,
                                             src_masks).float(), dim=-1)

    # -- incremental ------------------------------------------------------

    def precompute_kv(self, memory: Dict[str, torch.Tensor],
                      article_mask: Optional[torch.Tensor] = None
                      ) -> List[LayerKV]:
        """Each layer's image and article K/V for `decode_cross_attention`
        (article_mask [B, S], True at padding)."""
        memory = {k: v.to(self.dtype) for k, v in memory.items()}
        return [layer.precompute_kv(memory, article_mask)
                for layer in self.layers]

    def init_cache(self, batch_size: int, max_len: int,
                   device=None) -> List[SelfCache]:
        """Zero self-attention K/V [B, max_len, H, hd] a layer."""
        device = device or self.embed.embedding.device
        shape = (batch_size, max_len, self.num_heads,
                 self.d_model // self.num_heads)
        return [(torch.zeros(shape, device=device, dtype=self.dtype),
                 torch.zeros(shape, device=device, dtype=self.dtype))
                for _ in range(self.num_layers)]

    def decode_weights(self) -> Gen2Weights:
        """The folded head table; compute once per load."""
        with torch.no_grad():
            w, b = self.generator.kernel, self.generator.bias
            pad = torch.zeros(w.shape[1], HEAD_PAD - 1, device=w.device,
                              dtype=w.dtype)
            table = torch.cat([w.T, b[:, None], pad], dim=1)
            return Gen2Weights(table.to(self.dtype).contiguous())

    def _layers(self, tokens: torch.Tensor, pos: torch.Tensor,
                kvs: List[LayerKV], caches: List[SelfCache]) -> torch.Tensor:
        x = self._embed(tokens, pos)
        for layer, kv, cache in zip(self.layers, kvs, caches):
            x = layer.chunk(x, pos, cache, kv)
        return positionwise(self.final_norm, x)

    def head(self, x: torch.Tensor, k: int, weights: Gen2Weights):
        """The exact top-k of log_softmax(generator(x)) for x [N, d]:
        (log_probs [N, k] fp32, ids [N, k] int64), best first, through
        `band_topk_lse` over the folded table."""
        N = x.shape[0]
        x_aug = torch.cat([x, x.new_ones(N, 1), x.new_zeros(N, HEAD_PAD - 1)],
                          dim=1)
        vals, ids, lse = band_topk_lse(x_aug, weights.head_table, k)
        return vals - lse, ids.long()

    def step(self, token_t: torch.Tensor, pos, kvs: List[LayerKV],
             caches: List[SelfCache], k: int, weights: Gen2Weights):
        """One decode step: token_t [B] at position pos (an int, or each
        row's [B] tensor) -> the exact top-k candidates (log_probs [B, k]
        fp32, ids [B, k]); the caches are written in place."""
        if not isinstance(pos, torch.Tensor):
            pos = torch.full(token_t.shape, pos, dtype=torch.long,
                             device=token_t.device)
        x = self._layers(token_t[:, None], pos.long(), kvs, caches)
        return self.head(x[:, 0], k, weights)

    def step_chunk(self, tokens: torch.Tensor, pos: torch.Tensor,
                   kvs: List[LayerKV], caches: List[SelfCache],
                   weights: Gen2Weights):
        """A greedy chunk (speculative verification). tokens [B, k]: the
        last committed token, then drafts; pos [B] each row's count of
        tokens consumed. Returns (log_probs [B, k] fp32, argmax_ids
        [B, k]): output t the greedy next token given inputs 0..t. The
        caches are written at pos..pos+k-1 and so committed: a row
        attends no slot past its position, and the next chunk overwrites
        what it did not commit."""
        B, k = tokens.shape
        x = self._layers(tokens, pos.long(), kvs, caches)
        lp, ids = self.head(x.reshape(B * k, -1), 1, weights)
        return lp.view(B, k), ids.view(B, k)


def label_smoothing_loss(log_probs: torch.Tensor, targets: torch.Tensor,
                         pad_id: int = 0, smoothing: float = 0.0):
    """Summed label-smoothed NLL over the targets that are not pad, and
    their count: the reference's KL against a true distribution with
    smoothing / (V - 2) on every class but the target (1 - smoothing)
    and the pad column (0); exact cross-entropy at smoothing 0."""
    V = log_probs.shape[-1]
    lp = log_probs.reshape(-1, V)
    tgt = targets.reshape(-1).long()
    nll = -lp.gather(1, tgt[:, None])[:, 0]
    if smoothing > 0.0:
        smooth_sum = lp.sum(dim=-1) - (-nll) - lp[:, pad_id]
        loss_tok = (1.0 - smoothing) * nll - smooth_sum * (smoothing
                                                           / (V - 2))
    else:
        loss_tok = nll
    mask = tgt != pad_id
    return torch.where(mask, loss_tok, 0.0).sum(), mask.sum()


def label_smoothing_loss_from_logits(logits: torch.Tensor,
                                     targets: torch.Tensor, pad_id: int = 0,
                                     smoothing: float = 0.0):
    """`label_smoothing_loss` from the logits with reductions only, in
    fp32: log_softmax(x) = x - logsumexp(x), and the smoothing sum is
    sum(x) - V * lse less the target's and the pad's log-probs."""
    V = logits.shape[-1]
    lg = logits.reshape(-1, V).float()
    tgt = targets.reshape(-1).long()
    lse = torch.logsumexp(lg, dim=-1)
    picked = lg.gather(1, tgt[:, None])[:, 0]
    nll = lse - picked
    if smoothing > 0.0:
        lp_sum = lg.sum(dim=-1) - V * lse
        smooth_sum = lp_sum - (picked - lse) - (lg[:, pad_id] - lse)
        loss_tok = (1.0 - smoothing) * nll - smooth_sum * (smoothing
                                                           / (V - 2))
    else:
        loss_tok = nll
    mask = tgt != pad_id
    return torch.where(mask, loss_tok, 0.0).sum(), mask.sum()


@MODELS.register("gen2_transformer")
def gen2_transformer(smoothing: float = 0.0, **kw) -> "Gen2Captioner":
    """The config's model block -> a trainable Gen-2 captioner."""
    return Gen2Captioner(Gen2Transformer(**kw), smoothing=smoothing)


class Gen2Captioner:
    """Loss, greedy / top-k sampled and speculative captions around a
    `Gen2Transformer` (`module`, the `param_module`)."""

    batch_keys = LOSS_KEYS

    def __init__(self, module: Gen2Transformer, smoothing: float = 0.0):
        self.module = module
        self.smoothing = smoothing

    @property
    def param_module(self) -> Gen2Transformer:
        return self.module

    @staticmethod
    def _memory(batch: Dict[str, torch.Tensor]):
        return {"image": batch["image"], "article": batch["article"]}

    @staticmethod
    def _src_masks(batch: Dict[str, torch.Tensor]):
        """{"article": [B, 1, S] True where attended}, from the batch's
        article_mask (True at padding) where it has one."""
        if batch.get("article_mask") is None:
            return {}
        return {"article": ~batch["article_mask"].to(torch.bool)[:, None, :]}

    def loss_fn(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None):
        """(loss over the token count, {"loss_sum", "sample_size"});
        training dropout with a generator."""
        caption = batch["caption_ids"].long()
        lg = self.module.logits(self._memory(batch), caption[:, :-1],
                                src_masks=self._src_masks(batch),
                                generator=generator)
        loss, ntokens = global_sums(*label_smoothing_loss_from_logits(
            lg, caption[:, 1:], self.module.pad_id, self.smoothing))
        return (loss / torch.clamp(ntokens, min=1),
                {"loss_sum": loss, "sample_size": ntokens})

    def decode_weights(self) -> Gen2Weights:
        return self.module.decode_weights()

    def _check_max_len(self, config: GenerationConfig) -> None:
        if config.max_len > self.module.max_len:
            raise ValueError(f"max_len {config.max_len} exceeds the "
                             f"model's max_len {self.module.max_len}")

    def prep(self, batch: Dict[str, torch.Tensor]) -> List[LayerKV]:
        """The batch's memory K/V of every layer, projected once."""
        return self.module.precompute_kv(self._memory(batch),
                                         batch.get("article_mask"))

    def _setup(self, batch, config: GenerationConfig,
               weights: Optional[Gen2Weights], cache_len: int):
        self._check_max_len(config)
        kvs = self.prep(batch)
        B = batch["article"].shape[0]
        device = batch["article"].device
        caches = self.module.init_cache(B, cache_len, device)
        seed = torch.full((B,), config.bos_id, dtype=torch.long,
                          device=device)
        return kvs, caches, seed, weights or self.decode_weights()

    @torch.inference_mode()
    def generate(self, batch: Dict[str, torch.Tensor],
                 config: GenerationConfig = GenerationConfig(),
                 weights: Optional[Gen2Weights] = None,
                 generator: Optional[Generators] = None):
        """Greedy or top-k sampled captions with the bounded K/V cache:
        (tokens [B, max_len + 1] int64, log_probs [B, max_len] fp32)."""
        kvs, caches, seed, weights = self._setup(batch, config, weights,
                                                 config.max_len + 1)

        def step(tok, i):
            return self.module.step(tok, i, kvs, caches,
                                    config.sampling_topk, weights)

        return generate_candidates(step, seed, config, generator)

    @torch.inference_mode()
    def generate_speculative(self, batch: Dict[str, torch.Tensor],
                             config: GenerationConfig = GenerationConfig(),
                             weights: Optional[Gen2Weights] = None,
                             spec_k: int = 8,
                             draft_source: Optional[torch.Tensor] = None,
                             ngram_n: int = 2):
        """Greedy captions by prompt-lookup speculative decoding, the
        tokens of `generate` with sampling_topk = 1; drafts from
        draft_source (default batch["article_ids"]). Returns (tokens,
        log_probs, n_chunks)."""
        if config.sampling_topk != 1:
            raise ValueError("speculative decoding is greedy-only "
                             "(sampling_topk must be 1)")
        # + spec_k slots: a chunk at pos = max_len - 1 writes through
        # pos + spec_k - 1.
        kvs, caches, seed, weights = self._setup(batch, config, weights,
                                                 config.max_len + spec_k)
        source = (draft_source if draft_source is not None
                  else batch["article_ids"]).to(seed.device).long()

        def chunk_fn(toks, pos):
            lp, ids = self.module.step_chunk(toks, pos, kvs, caches, weights)
            return lp, ids, None

        def commit_fn(aux, m, pos):
            """The chunk's cache writes are the commit."""

        def draft_fn(tokens, pos, finished):
            return ngram_drafts(source, tokens, pos, spec_k - 1, n=ngram_n,
                                pad_id=config.pad_id)

        return speculative_greedy(chunk_fn, commit_fn, seed, config, spec_k,
                                  draft_fn)
