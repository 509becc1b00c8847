"""Gen-1 LSTM and attention captioners.

Counterpart of `news_image_caption_tpu/models/gen1.py`: the helpers
(`TorchLSTM`, `MaxoutLSTMCore`, `AdditiveAttention`, `Gen1State`), the
cores (`ShowTellCore`, `FCCore`, `Att2inCore` for att2in and att2in2,
`TopDownCore`, `AdaAttCore` for adaatt and adaatt_mo, `AllImgCore`, and
`ShowAttendTellCore` with every `sentence_embed_method`: '', concat,
fc, fc_max, conv, conv_deep, bnews), the module `Gen1Captioner`,
`masked_nll_loss` and the model `Gen1Model` (`adapt_batch`, `forward`
with scheduled sampling, `loss_fn`, `forward_with_attention` with its
coverage loss, `generate`, `sample`, `sample_with_attention`,
`sample_beam`).

Parameter names are the flax tree's (`core.rnn.ih_0.kernel` for
`core/rnn/ih_0/kernel`, `embed.embedding`, `logit.kernel`), kernels
(in, out) and convolutions' kernels in flax's layout (taps, in, out), so
`models/from_jax.py::params_from_jax` maps the reference's weights by
renaming. Flax declares a layer's input width on its first call; the
port declares it at build time, from the model's widths: the attended
features are `att_feat_size` wide and the pooled ones `fc_feat_size`,
and the sentence embeddings `sentence_embed_size` wide and
`sentence_length` long where a `sentence_embed_method` reads them
(`config.py` fills both from the dataset when the model block leaves
them out).

Vocabulary convention (the reference's): token 0 is both the input
<bos> and the output <eos> of `sample` and `sample_beam`; the head has
vocab_size + 1 outputs. `generate` takes the caller's bos, eos and pad
ids and never marks the seed finished.

Everything but the head is plain PyTorch on both devices, as the
reference computes it in XLA: the cores, the additive attentions and
the sentence convolutions. Training reads the full log-softmax of the
`logit` layer. Decoding (greedy and top-k `generate`, `sample`,
`sample_with_attention`, `sample_beam`) takes its candidates from
`band_topk_lse` over the folded head table [Wᵀ | b | 0 ...]
[vocab_size + 1, rnn_size + 64], built once a load by
`decode_weights()` and read with [h | 1 | 0 ...], as Gen-2's head
(`models/gen2.py`): the token is the band's top-k and its log-prob
logit - lse. `sample(sample_max=False)` draws from the whole vocabulary
(its top-k is vocab_size + 1 wide, past the kernel's 16), so it forms
the full log-softmax on both devices.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from news_image_caption_tpu_torch.generation.generator import (
    GenerationConfig, Generators, beam_search_candidates,
    generate_candidates, sample_index)
from news_image_caption_tpu_torch.models.gen2 import HEAD_PAD
from news_image_caption_tpu_torch.ops.band_topk import (band_topk_lse,
                                                        stable_topk)
from news_image_caption_tpu_torch.ops.dropout import dropout
from news_image_caption_tpu_torch.ops.linear import (Dense, initializes,
                                                     new_param)
from news_image_caption_tpu_torch.parallel.collectives import (batch_rows,
                                                               global_sums)
from news_image_caption_tpu_torch.utils.registry import MODELS

Feats = Dict[str, torch.Tensor]
# Model types whose features are embedded to rnn_size first.
_EMBEDDED = ("att2in2", "adaatt", "adaatt_mo", "topdown")
# Model types whose output is dropped out before the logit layer.
_DROP_OUT = ("show_tell", "show_attend_tell", "all_img")


class Gen1State(NamedTuple):
    h: torch.Tensor           # [layers, B, rnn_size]
    c: torch.Tensor


class Gen1Weights(NamedTuple):
    """The folded head table [V + 1, rnn_size + 64] in the compute
    dtype."""

    head_table: torch.Tensor


class Embed(nn.Module):
    """flax `nn.Embed`: `embedding` [num, features], uniform in ±0.1 or
    normal with variance 1 / num."""

    def __init__(self, num: int, features: int, *, device, dtype,
                 generator=None, uniform: bool = True):
        super().__init__()
        self.embedding = new_param((num, features), device, dtype)
        if initializes(device):
            with torch.no_grad():
                if uniform:
                    self.embedding.uniform_(-0.1, 0.1, generator=generator)
                else:
                    self.embedding.normal_(0.0, math.sqrt(1.0 / num),
                                           generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[ids]


class Conv(nn.Module):
    """flax `nn.Conv` over a sequence [B, L, C]: `kernel` [taps, C, F]
    (a (1, taps) kernel keeps its leading 1, [1, taps, C, F]), `bias`
    [F]; cross-correlation with `padding` zeros at each end."""

    def __init__(self, in_features: int, features: int, taps: int,
                 padding: int, *, device, dtype, generator=None,
                 two_d: bool = False):
        super().__init__()
        self.padding = padding
        shape = ((1,) if two_d else ()) + (taps, in_features, features)
        self.kernel = new_param(shape, device, dtype)
        self.bias = new_param((features,), device, dtype)
        if initializes(device):
            std = math.sqrt(1.0 / (taps * in_features))
            with torch.no_grad():
                self.kernel.normal_(0.0, std, generator=generator)
                self.kernel.clamp_(-2.0 * std, 2.0 * std)
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel.reshape(self.kernel.shape[-3:]).to(x.dtype)
        y = F.conv1d(x.transpose(1, 2), k.permute(2, 1, 0),
                     self.bias.to(x.dtype), padding=self.padding)
        return y.transpose(1, 2)


def instance_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """flax `GroupNorm` of one channel a group, no scale or bias, over
    x [B, L, C]: each channel normalized over L, the variance
    E[x²] - E[x]² (at least 0), in fp32."""
    xf = x.float()
    mu = xf.mean(dim=1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=1, keepdim=True) - mu * mu, min=0.0)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


class TorchLSTM(nn.Module):
    """A torch.nn.LSTM-like stack of cells (gates i, f, g, o), `ih_{L}`
    and `hh_{L}` a layer, dropout between layers."""

    def __init__(self, input_size: int, hidden_size: int,
                 num_layers: int = 1, use_bias: bool = False,
                 dropout_rate: float = 0.5, *, device, dtype, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.num_layers = num_layers
        self.dropout_rate = dropout_rate
        for L in range(num_layers):
            setattr(self, f"ih_{L}", Dense(input_size if L == 0
                                           else hidden_size,
                                           4 * hidden_size,
                                           use_bias=use_bias, **kw))
            setattr(self, f"hh_{L}", Dense(hidden_size, 4 * hidden_size,
                                           use_bias=use_bias, **kw))

    def forward(self, x: torch.Tensor, state: Tuple[torch.Tensor,
                                                    torch.Tensor],
                generator: Optional[torch.Generator] = None):
        """x [B, in]; state (h, c) [L, B, H] -> (out [B, H], (h, c))."""
        h_prev, c_prev = state
        hs, cs = [], []
        inp = x
        for L in range(self.num_layers):
            gates = (getattr(self, f"ih_{L}")(inp)
                     + getattr(self, f"hh_{L}")(h_prev[L]))
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c_prev[L] + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            hs.append(h)
            cs.append(c)
            inp = h
            if L < self.num_layers - 1:
                inp = dropout(inp, self.dropout_rate, generator)
        return inp, (torch.stack(hs), torch.stack(cs))


class MaxoutLSTMCore(nn.Module):
    """FCModel's LSTM core: five gate chunks, a maxout input transform,
    optionally plus an attention term."""

    def __init__(self, input_size: int, rnn_size: int,
                 drop_prob: float = 0.5, *, device, dtype, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.rnn_size = rnn_size
        self.drop_prob = drop_prob
        self.i2h = Dense(input_size, 5 * rnn_size, **kw)
        self.h2h = Dense(rnn_size, 5 * rnn_size, **kw)

    def forward(self, xt, state, att_term=None, generator=None):
        h_prev, c_prev = state
        R = self.rnn_size
        s = self.i2h(xt) + self.h2h(h_prev[-1])
        i = torch.sigmoid(s[:, :R])
        f = torch.sigmoid(s[:, R:2 * R])
        o = torch.sigmoid(s[:, 2 * R:3 * R])
        in_tr = s[:, 3 * R:5 * R]
        if att_term is not None:
            in_tr = in_tr + att_term
        in_tr = torch.maximum(in_tr[:, :R], in_tr[:, R:])
        c = f * c_prev[-1] + i * in_tr
        h = o * torch.tanh(c)
        out = dropout(h, self.drop_prob, generator)
        return out, (h[None], c[None])


class AdditiveAttention(nn.Module):
    """tanh(p_att + h2att(h)) -> alpha -> the weighted sum of values."""

    def __init__(self, rnn_size: int, att_hid_size: int, *, device, dtype,
                 generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.h2att = Dense(rnn_size, att_hid_size, **kw)
        self.alpha_net = Dense(att_hid_size, 1, **kw)

    def forward(self, h, values, p_att):
        """h [B, R]; values [B, P, D]; p_att [B, P, att_hid]."""
        dot = torch.tanh(p_att + self.h2att(h)[:, None, :])
        w = torch.softmax(self.alpha_net(dot)[:, :, 0], dim=-1)
        return torch.einsum("bp,bpd->bd", w, values), w


# -- cores: step(xt, feats, state, generator) -> (output [B, R], state) --


class ShowTellCore(nn.Module):
    def __init__(self, input_size: int, rnn_size: int, num_layers: int = 1,
                 drop_prob: float = 0.5, **kw):
        super().__init__()
        self.rnn = TorchLSTM(input_size, rnn_size, num_layers,
                             dropout_rate=drop_prob, **kw)

    def prepare(self, fc, att, sen=None) -> Feats:
        return {}

    def step(self, xt, feats, state, generator=None):
        out, (h, c) = self.rnn(xt, (state.h, state.c), generator)
        return out, Gen1State(h, c)


class FCCore(nn.Module):
    def __init__(self, input_size: int, rnn_size: int,
                 drop_prob: float = 0.5, **kw):
        super().__init__()
        self.core = MaxoutLSTMCore(input_size, rnn_size, drop_prob, **kw)

    def prepare(self, fc, att, sen=None) -> Feats:
        return {}

    def step(self, xt, feats, state, generator=None):
        out, (h, c) = self.core(xt, (state.h, state.c), generator=generator)
        return out, Gen1State(h, c)


class Att2inCore(nn.Module):
    """The attention result, through `a2c`, added to the cell's input
    transform."""

    def __init__(self, input_size: int, att_size: int, rnn_size: int,
                 att_hid_size: int, drop_prob: float = 0.5, **kw):
        super().__init__()
        self.attention = AdditiveAttention(rnn_size, att_hid_size, **kw)
        self.a2c = Dense(att_size, 2 * rnn_size, **kw)
        self.core = MaxoutLSTMCore(input_size, rnn_size, drop_prob, **kw)

    def prepare(self, fc, att, sen=None) -> Feats:
        return {"att": att}

    def step(self, xt, feats, state, generator=None):
        att_res, _ = self.attention(state.h[-1], feats["att"], feats["p_att"])
        out, (h, c) = self.core(xt, (state.h, state.c),
                                att_term=self.a2c(att_res),
                                generator=generator)
        return out, Gen1State(h, c)


class TopDownCore(nn.Module):
    """Two-layer top-down attention LSTM (Anderson et al.)."""

    def __init__(self, input_size: int, rnn_size: int, att_hid_size: int,
                 drop_prob: float = 0.5, **kw):
        super().__init__()
        self.drop_prob = drop_prob
        self.att_lstm = TorchLSTM(2 * rnn_size + input_size, rnn_size, 1,
                                  use_bias=True, **kw)
        self.lang_lstm = TorchLSTM(2 * rnn_size, rnn_size, 1, use_bias=True,
                                   **kw)
        self.attention = AdditiveAttention(rnn_size, att_hid_size, **kw)

    def prepare(self, fc, att, sen=None) -> Feats:
        return {"fc": fc, "att": att}

    def step(self, xt, feats, state, generator=None):
        att_in = torch.cat([state.h[1], feats["fc"], xt], dim=-1)
        h_att, (h0, c0) = self.att_lstm(att_in, (state.h[0:1], state.c[0:1]),
                                        generator)
        att_res, _ = self.attention(h_att, feats["att"], feats["p_att"])
        h_lang, (h1, c1) = self.lang_lstm(
            torch.cat([att_res, h_att], dim=-1),
            (state.h[1:2], state.c[1:2]), generator)
        out = dropout(h_lang, self.drop_prob, generator)
        return out, Gen1State(torch.cat([h0, h1]), torch.cat([c0, c1]))


class AdaAttCore(nn.Module):
    """Adaptive attention with a visual sentinel (the 'fake region')."""

    def __init__(self, input_encoding_size: int, rnn_size: int,
                 att_hid_size: int, use_maxout: bool = False,
                 drop_prob: float = 0.5, **kw):
        super().__init__()
        # The reference's attention concatenates the sentinel with the
        # region features and their projections: all three sizes agree.
        assert rnn_size == input_encoding_size == att_hid_size, \
            "AdaAtt requires rnn_size == input_encoding_size == att_hid_size"
        n = 5 if use_maxout else 4
        E, R, A = input_encoding_size, rnn_size, att_hid_size
        self.rnn_size = R
        self.use_maxout = use_maxout
        self.drop_prob = drop_prob
        self.w2h = Dense(E, n * R, **kw)
        self.v2h = Dense(R, n * R, **kw)
        self.h2h = Dense(R, n * R, **kw)
        self.r_w2h = Dense(E, R, **kw)
        self.r_v2h = Dense(R, R, **kw)
        self.r_h2h = Dense(R, R, **kw)
        self.fr_linear = Dense(R, E, **kw)
        self.fr_embed = Dense(E, A, **kw)
        self.ho_linear = Dense(R, E, **kw)
        self.ho_embed = Dense(E, A, **kw)
        self.alpha_net = Dense(A, 1, **kw)
        self.att2h = Dense(E, R, **kw)

    def prepare(self, fc, att, sen=None) -> Feats:
        return {"fc": fc, "att": att}

    def step(self, xt, feats, state, generator=None):
        R = self.rnn_size

        def drop(x):
            return dropout(x, self.drop_prob, generator)

        prev_h, prev_c = state.h[-1], state.c[-1]
        s = self.w2h(xt) + self.v2h(feats["fc"]) + self.h2h(prev_h)
        i = torch.sigmoid(s[:, :R])
        f = torch.sigmoid(s[:, R:2 * R])
        o = torch.sigmoid(s[:, 2 * R:3 * R])
        if self.use_maxout:
            in_tr = torch.maximum(s[:, 3 * R:4 * R], s[:, 4 * R:5 * R])
        else:
            in_tr = torch.tanh(s[:, 3 * R:4 * R])
        c = f * prev_c + i * in_tr
        tanh_c = torch.tanh(c)
        h = o * tanh_c
        n5 = self.r_w2h(xt) + self.r_v2h(feats["fc"]) + self.r_h2h(prev_h)
        fake_region = drop(torch.sigmoid(n5) * tanh_c)
        top_h = drop(h)
        fr = drop(torch.relu(self.fr_linear(fake_region)))
        fr_embed = self.fr_embed(fr)
        ho = drop(torch.tanh(self.ho_linear(top_h)))
        ho_embed = self.ho_embed(ho)
        img_all = torch.cat([fr[:, None, :], feats["att"]], dim=1)
        embed_all = torch.cat([fr_embed[:, None, :], feats["p_att"]], dim=1)
        hA = drop(torch.tanh(embed_all + ho_embed[:, None, :]))
        alpha = torch.softmax(self.alpha_net(hA)[:, :, 0], dim=-1)
        vis = torch.einsum("bp,bpd->bd", alpha, img_all)
        out = drop(torch.tanh(self.att2h(vis + ho)))
        return out, Gen1State(h[None], c[None])


class _INSResBlock(nn.Module):
    """Conv(5) + instance norm + ReLU + Conv(5) + instance norm, with
    the residual, over [B, L, C]."""

    def __init__(self, channels: int, **kw):
        super().__init__()
        self.conv1 = Conv(channels, channels, 5, 2, **kw)
        self.conv2 = Conv(channels, channels, 5, 2, **kw)

    def forward(self, x):
        y = torch.relu(instance_norm(self.conv1(x)))
        return x + instance_norm(self.conv2(y))


class ShowAttendTellCore(nn.Module):
    """OldModel's core: an LSTM over [xt, att_res (, the sentence
    part)]; sentence_embed_method '' | concat | fc | fc_max | conv |
    conv_deep | bnews."""

    def __init__(self, input_size: int, att_size: int, rnn_size: int,
                 att_hid_size: int, num_layers: int = 1,
                 drop_prob: float = 0.5, sentence_embed_method: str = "",
                 sentence_embed_size: Optional[int] = None,
                 sentence_length: Optional[int] = None, **kw):
        super().__init__()
        m = self.method = sentence_embed_method
        self.drop_prob = drop_prob
        Es, Ls = sentence_embed_size, sentence_length
        needs = {"fc": ("Es",), "fc_max": ("Es",), "conv": ("Es",),
                 "conv_deep": ("Es", "Ls"), "bnews": ("Es",),
                 "concat": ("Es", "Ls")}.get(m, ())
        if m not in ("", "concat", "fc", "fc_max", "conv", "conv_deep",
                     "bnews"):
            raise ValueError(f"unknown sentence_embed_method {m!r}")
        for name, value in (("Es", Es), ("Ls", Ls)):
            if name in needs and value is None:
                raise ValueError(
                    f"sentence_embed_method={m!r} needs "
                    + ("sentence_embed_size" if name == "Es"
                       else "sentence_length"))
        self.ctx2att = Dense(att_size, att_hid_size, **kw)
        self.h2att = Dense(rnn_size, att_hid_size, **kw)
        self.alpha_net = Dense(att_hid_size, 1, **kw)
        extra = 0
        if m in ("fc", "fc_max"):
            self.sentence_att = Dense(Es, att_hid_size, **kw)
            self.h2att_sen = Dense(rnn_size, att_hid_size, **kw)
            extra = Es
        elif m == "conv":
            self.sen_conv = Conv(32, 32, 5, 2, two_d=True, **kw)
            self.sen_embed_proj = Dense(Es, 32, use_bias=False, **kw)
            self.h2att_sen = Dense(rnn_size, Es, **kw)
            self.ch_embed = Dense(32, 1, **kw)
            extra = Es
        elif m == "conv_deep":
            self.sen_conv = Conv(128, 128, 5, 2, two_d=True, **kw)
            self.sen_embed_proj = Dense(Es, 128, use_bias=False, **kw)
            self.res1 = _INSResBlock(128, **kw)
            self.res2 = _INSResBlock(128, **kw)
            self.h2att_sen = Dense(rnn_size, Ls, **kw)
            self.ch_embed = Dense(128, 1, **kw)
            extra = 128
        elif m == "bnews":
            self.sen_conv = Conv(256, 256, 5, 0, two_d=True, **kw)
            self.sen_embed_proj = Dense(Es, 256, use_bias=False, **kw)
            self.sen_lin = Dense(256, 64, **kw)
            extra = 64
        elif m == "concat":
            extra = Es * Ls
        self.rnn = TorchLSTM(input_size + att_size + extra, rnn_size,
                             num_layers, dropout_rate=drop_prob, **kw)

    def prepare(self, fc, att, sen=None) -> Feats:
        feats = {"att": att, "p_att": self.ctx2att(att)}
        if sen is not None:
            feats["sen"] = sen
            if self.method in ("fc", "fc_max"):
                feats["p_sen"] = self.sentence_att(sen)
        return feats

    def step(self, xt, feats, state, generator=None,
             need_attention: bool = False):
        """One LSTM step; need_attention also returns (visual alpha
        [B, P], sentence alpha [B, L]: zeros [B, L] for bnews, zeros
        [B, 1] where there is no sentence attention)."""
        def drop(x):
            return dropout(x, self.drop_prob, generator)

        m = self.method
        h_last = state.h[-1]
        dot = torch.tanh(feats["p_att"] + self.h2att(h_last)[:, None, :])
        alpha = torch.softmax(self.alpha_net(dot)[:, :, 0], dim=-1)
        att_res = torch.einsum("bp,bpd->bd", alpha, feats["att"])
        parts = [xt]
        w_sen = None
        if m == "conv":
            sen = feats["sen"]
            sen_in = sen + self.h2att_sen(h_last)[:, None, :]
            conv = self.sen_conv(self.sen_embed_proj(sen_in))
            conv = drop(F.leaky_relu(conv, 0.01))
            logits = drop(self.ch_embed(torch.tanh(conv))[:, :, 0])
            w_sen = torch.softmax(logits, dim=-1)
            parts += [att_res, torch.einsum("bl,ble->be", w_sen, sen)]
        elif m == "conv_deep":
            conv = self.sen_conv(self.sen_embed_proj(feats["sen"]))
            conv = self.res2(self.res1(F.leaky_relu(conv, 0.01)))
            conv = drop(conv)
            combined = conv + self.h2att_sen(h_last)[:, :, None]
            logits = drop(self.ch_embed(combined)[:, :, 0])
            w_sen = torch.softmax(torch.tanh(logits), dim=-1)
            parts += [att_res, torch.einsum("bl,blc->bc", w_sen, conv)]
        elif m == "bnews":
            sen = feats["sen"]
            conv = self.sen_conv(self.sen_embed_proj(sen))
            pooled = F.leaky_relu(conv, 0.01).max(dim=1).values
            parts += [torch.relu(self.sen_lin(pooled)), att_res]
            w_sen = alpha.new_zeros(xt.shape[0], sen.shape[1])
        elif m in ("fc", "fc_max"):
            dot_s = torch.tanh(feats["p_sen"]
                               + self.h2att_sen(h_last)[:, None, :])
            # The reference reuses alpha_net for the sentences.
            w_sen = torch.softmax(self.alpha_net(dot_s)[:, :, 0], dim=-1)
            if m == "fc":
                sen_res = torch.einsum("bs,bsd->bd", w_sen, feats["sen"])
            else:                      # fc_max: the argmax sentence
                idx = torch.argmax(w_sen, dim=-1)
                sen_res = feats["sen"][torch.arange(xt.shape[0]), idx]
            parts += [att_res, sen_res]
        elif m == "concat":
            parts += [feats["sen"].reshape(xt.shape[0], -1), att_res]
        else:
            parts += [att_res]
        out, (h, c) = self.rnn(torch.cat(parts, dim=-1), (state.h, state.c),
                               generator)
        if not need_attention:
            return out, Gen1State(h, c)
        if w_sen is None:
            w_sen = alpha.new_zeros(xt.shape[0], 1)
        return out, Gen1State(h, c), (alpha, w_sen)


class AllImgCore(nn.Module):
    def __init__(self, input_size: int, fc_size: int, rnn_size: int,
                 num_layers: int = 1, drop_prob: float = 0.5, **kw):
        super().__init__()
        self.rnn = TorchLSTM(input_size + fc_size, rnn_size, num_layers,
                             dropout_rate=drop_prob, **kw)

    def prepare(self, fc, att, sen=None) -> Feats:
        return {"fc": fc}

    def step(self, xt, feats, state, generator=None):
        out, (h, c) = self.rnn(torch.cat([xt, feats["fc"]], dim=-1),
                               (state.h, state.c), generator)
        return out, Gen1State(h, c)


class Gen1Captioner(nn.Module):
    """Embedding, feature preparation, the core and the logit head.

    model_type picks the core; the features follow the reference's
    families: show_tell and fc seed the sequence with img_embed(fc) at
    t = 0; att2in attends the raw features through ctx2att; att2in2,
    adaatt, adaatt_mo and topdown embed fc and att to rnn_size first;
    show_attend_tell and all_img attend the raw features and seed the
    hidden state with init_linear(fc)."""

    def __init__(self, *, device, dtype=torch.float32, generator=None,
                 model_type: str, vocab_size: int,
                 input_encoding_size: int = 512, rnn_size: int = 512,
                 num_layers: int = 1, att_hid_size: int = 512,
                 fc_feat_size: int = 2048, att_feat_size: int = 2048,
                 drop_prob: float = 0.5, seq_length: int = 16,
                 sentence_embed_method: str = "",
                 sentence_embed_size: Optional[int] = None,
                 sentence_length: Optional[int] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        mt = self.model_type = model_type
        if num_layers > 1 and mt not in ("show_tell", "show_attend_tell",
                                         "all_img"):
            raise ValueError(f"model_type {mt!r} supports num_layers=1 only "
                             f"(got {num_layers})")
        V = vocab_size + 1
        E, R = input_encoding_size, rnn_size
        self.dtype = dtype
        self.vocab_size = vocab_size
        self.rnn_size = R
        self.num_layers = num_layers
        self.drop_prob = drop_prob
        self.seq_length = seq_length
        self.embed = Embed(V, E, uniform=mt in ("show_tell", "fc",
                                                "show_attend_tell",
                                                "all_img", "att2in"), **kw)
        self.logit = Dense(R, V, uniform_scale=0.1, **kw)
        if mt in ("show_tell", "fc"):
            self.img_embed = Dense(fc_feat_size, E, **kw)
        if mt in _EMBEDDED:
            self.fc_embed = Dense(fc_feat_size, R, **kw)
            self.att_embed = Dense(att_feat_size, R, **kw)
            self.ctx2att = Dense(R, att_hid_size, **kw)
        if mt == "att2in":
            self.ctx2att = Dense(att_feat_size, att_hid_size, **kw)
        if mt in ("show_attend_tell", "all_img"):
            self.init_linear = Dense(fc_feat_size, num_layers * R, **kw)
        if mt == "show_tell":
            self.core = ShowTellCore(E, R, num_layers, drop_prob, **kw)
        elif mt == "fc":
            self.core = FCCore(E, R, drop_prob, **kw)
        elif mt in ("att2in", "att2in2"):
            self.core = Att2inCore(E, att_feat_size if mt == "att2in" else R,
                                   R, att_hid_size, drop_prob, **kw)
        elif mt in ("adaatt", "adaatt_mo"):
            self.core = AdaAttCore(E, R, att_hid_size,
                                   use_maxout=mt == "adaatt_mo",
                                   drop_prob=drop_prob, **kw)
        elif mt == "topdown":
            self.core = TopDownCore(E, R, att_hid_size, drop_prob, **kw)
        elif mt == "show_attend_tell":
            self.core = ShowAttendTellCore(
                E, att_feat_size, R, att_hid_size, num_layers, drop_prob,
                sentence_embed_method, sentence_embed_size=sentence_embed_size,
                sentence_length=sentence_length, **kw)
        elif mt == "all_img":
            self.core = AllImgCore(E, fc_feat_size, R, num_layers, drop_prob,
                                   **kw)
        else:
            raise ValueError(f"unknown model_type {mt!r}")

    @property
    def state_layers(self) -> int:
        return 2 if self.model_type == "topdown" else self.num_layers

    def init_state(self, batch_size: int,
                   fc_feats: Optional[torch.Tensor] = None) -> Gen1State:
        if (self.model_type in ("show_attend_tell", "all_img")
                and fc_feats is not None):
            m = self.init_linear(fc_feats).reshape(
                -1, self.num_layers, self.rnn_size).transpose(0, 1)
            return Gen1State(m, m)
        z = torch.zeros(self.state_layers, batch_size, self.rnn_size,
                        device=self.logit.kernel.device, dtype=self.dtype)
        return Gen1State(z, z)

    def prepare(self, fc_feats, att_feats, sen_embed=None,
                generator: Optional[torch.Generator] = None) -> Feats:
        """The features a sequence reads at every step."""
        mt = self.model_type
        fc, att = fc_feats, att_feats
        if mt in _EMBEDDED:
            att = dropout(torch.relu(self.att_embed(att_feats)),
                          self.drop_prob, generator)
            fc = (fc_feats if mt == "att2in2" else
                  dropout(torch.relu(self.fc_embed(fc_feats)),
                          self.drop_prob, generator))
        feats = dict(self.core.prepare(fc, att, sen_embed))
        if mt in ("att2in",) + _EMBEDDED:
            feats["p_att"] = self.ctx2att(att)
            feats.setdefault("att", att)
            feats.setdefault("fc", fc)
        return feats

    def token_embed(self, it: torch.Tensor,
                    generator: Optional[torch.Generator] = None):
        x = self.embed(it)
        if self.model_type in _EMBEDDED:
            x = dropout(torch.relu(x), self.drop_prob, generator)
        return x

    def core_step(self, token_t, feats, state, generator=None,
                  need_attention: bool = False):
        """The core's step on token_t [B]: (output [B, R], state) and,
        with need_attention (show_attend_tell only), the attentions."""
        xt = self.token_embed(token_t, generator)
        if need_attention:
            return self.core.step(xt, feats, state, generator,
                                  need_attention=True)
        return self.core.step(xt, feats, state, generator)

    def log_probs(self, output: torch.Tensor,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
        """Full log-softmax [B, V + 1] of the logit layer (training, and
        sampling from the whole vocabulary)."""
        if self.model_type in _DROP_OUT:
            output = dropout(output, self.drop_prob, generator)
        return torch.log_softmax(self.logit(output), dim=-1)

    def seed_image_step(self, fc_feats, feats, state, generator=None):
        """show_tell / fc: feed img_embed(fc) before <bos>."""
        _, state = self.core.step(self.img_embed(fc_feats), feats, state,
                                  generator)
        return state

    def decode_weights(self) -> Gen1Weights:
        """The folded head table [Wᵀ | b | 0 ...]; compute once per
        load."""
        with torch.no_grad():
            w, b = self.logit.kernel, self.logit.bias
            pad = torch.zeros(w.shape[1], HEAD_PAD - 1, device=w.device,
                              dtype=w.dtype)
            table = torch.cat([w.T, b[:, None], pad], dim=1)
            return Gen1Weights(table.to(self.dtype).contiguous())

    def head(self, output: torch.Tensor, k: int, weights: Gen1Weights):
        """The exact top-k of log_softmax(logit(output)) for output
        [N, R]: (log_probs [N, k] fp32, ids [N, k] int64), best first,
        through `band_topk_lse` over the folded table."""
        N = output.shape[0]
        x = output.to(weights.head_table.dtype)
        x_aug = torch.cat([x, x.new_ones(N, 1), x.new_zeros(N, HEAD_PAD - 1)],
                          dim=1)
        vals, ids, lse = band_topk_lse(x_aug, weights.head_table, k)
        return vals - lse, ids.long()


def masked_nll_loss(log_probs: torch.Tensor, targets: torch.Tensor,
                    mask: torch.Tensor):
    """LanguageModelCriterion: the NLL of the targets summed under the
    mask, over the mask's sum (at least 1); (mean, mask sum)."""
    T = min(log_probs.shape[1], targets.shape[1])
    lp = log_probs[:, :T]
    m = mask[:, :T].to(lp.dtype)
    nll = -torch.gather(lp, 2, targets[:, :T, None].long())[..., 0]
    total, count = global_sums(torch.sum(nll * m), m.sum())
    return total / torch.clamp(count, min=1.0), count


@MODELS.register("gen1")
def gen1_factory(*, device, dtype=torch.float32, generator=None,
                 **kw) -> "Gen1Model":
    """The config's model block -> a Gen-1 model."""
    return Gen1Model(Gen1Captioner(device=device, dtype=dtype,
                                   generator=generator, **kw))


class Gen1Model:
    """The Gen-1 train and sample API around a `Gen1Captioner`
    (`module`, the `param_module`)."""

    def __init__(self, module: Gen1Captioner):
        self.module = module

    @property
    def param_module(self) -> Gen1Captioner:
        return self.module

    @staticmethod
    def adapt_batch(batch: Dict[str, torch.Tensor]) -> Dict:
        """A news batch (caption_ids, image, article) as Gen-1's (seq,
        mask, fc_feats, att_feats, sen_embed); a batch with `seq` as it
        is. A decode's batch needs no caption."""
        if "seq" in batch:
            return dict(batch)
        image = batch["image"]
        out = {"fc_feats": image.mean(dim=1), "att_feats": image}
        if "caption_ids" in batch:
            seq = batch["caption_ids"].long()
            out.update(seq=seq, mask=(seq != 1).float())
        if "article" in batch:
            out["sen_embed"] = batch["article"]
        return out

    def _cast(self, x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        return None if x is None else x.to(self.module.dtype)

    def _prepare(self, batch: Dict, generator=None):
        mdl = self.module
        fc = self._cast(batch["fc_feats"])
        feats = mdl.prepare(fc, self._cast(batch["att_feats"]),
                            self._cast(batch.get("sen_embed")), generator)
        state = mdl.init_state(fc.shape[0], fc)
        if mdl.model_type in ("show_tell", "fc"):
            state = mdl.seed_image_step(fc, feats, state, generator)
        return feats, state

    def _scheduled(self, seq, t, prev_lp, ss_prob, generator):
        """seq[:, t], each row replaced with probability ss_prob (t >= 1)
        by a draw from the previous step's distribution."""
        it = seq[:, t]
        if ss_prob > 0.0 and t >= 1:
            if batch_rows() is not None:
                raise NotImplementedError(
                    "scheduled sampling under data parallelism: its draws "
                    "are per row of the local batch")
            use = torch.rand(seq.shape[0], generator=generator,
                             device=generator.device) < ss_prob
            sampled = sample_index(prev_lp, generator)
            it = torch.where(use.to(it.device), sampled.to(it.device), it)
        return it

    def _ss_generator(self, generator, ss_prob, device):
        if ss_prob > 0.0 and generator is None:
            return torch.Generator(device=device).manual_seed(0)
        return generator

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                ss_prob: float = 0.0) -> torch.Tensor:
        """Teacher-forced log-probs [B, T-1, V+1]; training dropout with
        a generator. ss_prob > 0 is scheduled sampling: from step 1 each
        row's input is, with that probability, a draw from the previous
        step's log-probs, drawn from `generator` (one seeded with 0 when
        there is none)."""
        batch = self.adapt_batch(batch)
        seq = batch["seq"]
        feats, state = self._prepare(batch, generator)
        ss_gen = self._ss_generator(generator, ss_prob, seq.device)
        lps, lp = [], None
        for t in range(seq.shape[1] - 1):
            it = self._scheduled(seq, t, lp, ss_prob, ss_gen)
            out, state = self.module.core_step(it, feats, state, generator)
            lp = self.module.log_probs(out, generator)
            lps.append(lp)
        return torch.stack(lps, dim=1)

    def loss_fn(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                ss_prob: float = 0.0):
        """(the masked NLL over the mask's sum, {"loss_sum",
        "sample_size"})."""
        batch = self.adapt_batch(batch)
        lps = self.forward(batch, generator, ss_prob)
        loss, ntokens = masked_nll_loss(lps, batch["seq"][:, 1:],
                                        batch["mask"][:, 1:])
        return loss, {"loss_sum": loss * ntokens, "sample_size": ntokens}

    def forward_with_attention(self, batch: Dict[str, torch.Tensor],
                               generator: Optional[torch.Generator] = None,
                               ss_prob: float = 0.0):
        """Teacher-forced log-probs and the sentence-attention coverage
        loss (show_attend_tell only): from step 1, each step adds
        sum(min(att_t, coverage)), the coverage the sum of the earlier
        steps' sentence attentions; the steps from the first all-pad
        column of seq on add nothing (the reference's break). Returns
        (log_probs [B, T-1, V+1], coverage loss / B)."""
        if self.module.model_type != "show_attend_tell":
            raise ValueError("forward_with_attention supports model_type="
                             "'show_attend_tell' (the reference's "
                             "return_attention path)")
        batch = self.adapt_batch(batch)
        seq = batch["seq"]
        B, T = seq.shape
        L = batch["sen_embed"].shape[1] if "sen_embed" in batch else 1
        feats, state = self._prepare(batch, generator)
        ss_gen = self._ss_generator(generator, ss_prob, seq.device)
        col_ended = ((seq[:, :T - 1].sum(dim=0) == 0)
                     & (torch.arange(T - 1, device=seq.device) >= 1))
        active = torch.cumprod(1.0 - col_ended.float(), dim=0)
        coverage = torch.zeros(B, L, device=seq.device)
        cov_loss = torch.zeros((), device=seq.device)
        lps, lp = [], None
        for t in range(T - 1):
            it = self._scheduled(seq, t, lp, ss_prob, ss_gen)
            out, state, (_, w_sen) = self.module.core_step(
                it, feats, state, generator, need_attention=True)
            lp = self.module.log_probs(out, generator)
            lps.append(lp)
            w_sen = w_sen.float()
            cov_loss = cov_loss + active[t] * torch.minimum(
                w_sen, coverage).sum()
            coverage = coverage + active[t] * w_sen
        return torch.stack(lps, dim=1), cov_loss / B

    # -- decoding -----------------------------------------------------------

    def decode_weights(self) -> Gen1Weights:
        return self.module.decode_weights()

    def _setup_decode(self, batch, weights: Optional[Gen1Weights],
                      beam: int = 1):
        """(state holder, feats, B, device, weights): the features of
        every row (tiled beam times) and the start state."""
        batch = self.adapt_batch(batch)
        B = batch["fc_feats"].shape[0]
        if beam > 1:
            batch = {k: batch[k].repeat_interleave(beam, dim=0)
                     for k in ("fc_feats", "att_feats", "sen_embed")
                     if batch.get(k) is not None}
        feats, state = self._prepare(batch)
        return ([state], feats, B, batch["fc_feats"].device,
                weights or self.decode_weights())

    def _cand_step(self, holder, feats, k: int, weights: Gen1Weights):
        def step(tok, i):
            out, holder[0] = self.module.core_step(tok, feats, holder[0])
            return self.module.head(out, k, weights)
        return step

    @torch.inference_mode()
    def generate(self, batch: Dict[str, torch.Tensor],
                 config: GenerationConfig = GenerationConfig(),
                 weights: Optional[Gen1Weights] = None,
                 generator: Optional[Generators] = None):
        """Captions with the caller's bos / eos / pad ids, greedy or
        top-k sampled, the seed never marked finished: (tokens
        [B, max_len + 1] with the seed, log_probs [B, max_len])."""
        config = dataclasses.replace(config, init_finished=False)
        holder, feats, B, device, weights = self._setup_decode(batch,
                                                               weights)
        seed = torch.full((B,), config.bos_id, dtype=torch.long,
                          device=device)
        return generate_candidates(
            self._cand_step(holder, feats, config.sampling_topk, weights),
            seed, config, generator)

    @torch.inference_mode()
    def sample(self, batch: Dict[str, torch.Tensor],
               max_len: Optional[int] = None, sample_max: bool = True,
               temperature: float = 1.0,
               generator: Optional[Generators] = None,
               weights: Optional[Gen1Weights] = None):
        """Gen-1's `sample`: greedy (sample_max), else a draw from the
        whole vocabulary at `temperature` each step, token 0 bos, eos
        and pad. Returns (tokens [B, max_len], log_probs [B, max_len]).
        A draw from the whole vocabulary reads the full log-softmax (its
        candidate list is vocab_size + 1 wide, past the band kernel's
        16)."""
        max_len = max_len or self.module.seq_length
        V1 = self.module.vocab_size + 1
        cfg = GenerationConfig(max_len=max_len, bos_id=0, eos_id=0, pad_id=0,
                               sampling_topk=1 if sample_max else V1,
                               sampling_temp=temperature,
                               init_finished=False)
        holder, feats, B, device, weights = self._setup_decode(batch,
                                                               weights)
        if sample_max:
            step = self._cand_step(holder, feats, 1, weights)
        else:
            def step(tok, i):
                out, holder[0] = self.module.core_step(tok, feats, holder[0])
                return stable_topk(self.module.log_probs(out).float(), V1)
        seed = torch.zeros(B, dtype=torch.long, device=device)
        tokens, lps = generate_candidates(step, seed, cfg, generator)
        return tokens[:, 1:], lps

    @torch.inference_mode()
    def sample_with_attention(self, batch: Dict[str, torch.Tensor],
                              max_len: Optional[int] = None,
                              weights: Optional[Gen1Weights] = None):
        """Greedy captions with each step's attention maps
        (show_attend_tell only): (tokens [B, T], log_probs [B, T],
        (visual [T, B, P], sentence [T, B, L])); token 0 ends a row,
        which then emits 0 at log-prob 0."""
        if self.module.model_type != "show_attend_tell":
            raise ValueError("sample_with_attention supports model_type="
                             "'show_attend_tell' (the reference's "
                             "return_attention path)")
        max_len = max_len or self.module.seq_length
        holder, feats, B, device, weights = self._setup_decode(batch,
                                                               weights)
        tok = torch.zeros(B, dtype=torch.long, device=device)
        finished = torch.zeros(B, dtype=torch.bool, device=device)
        toks, lps, vis, sen = [], [], [], []
        for _ in range(max_len):
            out, holder[0], (a_vis, a_sen) = self.module.core_step(
                tok, feats, holder[0], need_attention=True)
            lp, ids = self.module.head(out, 1, weights)
            tok = torch.where(finished, 0, ids[:, 0])
            toks.append(tok)
            lps.append(torch.where(finished, 0.0, lp[:, 0]))
            vis.append(a_vis)
            sen.append(a_sen)
            finished = finished | (tok == 0)
        return (torch.stack(toks, dim=1), torch.stack(lps, dim=1),
                (torch.stack(vis), torch.stack(sen)))

    @torch.inference_mode()
    def sample_beam(self, batch: Dict[str, torch.Tensor],
                    beam_size: int = 5, max_len: Optional[int] = None,
                    weights: Optional[Gen1Weights] = None):
        """The reference's beam search: a beam that emits eos (token 0)
        is harvested into a done list, live beams join at the last step,
        and the done beams rank by their raw summed log-prob. Returns
        the best (tokens [B, max_len], score [B])."""
        max_len = max_len or self.module.seq_length
        cfg = GenerationConfig(max_len=max_len, bos_id=0, eos_id=0, pad_id=0,
                               beam_size=beam_size, init_finished=False,
                               harvest_finished=True, length_penalty=0.0)
        holder, feats, B, device, weights = self._setup_decode(
            batch, weights, beam=beam_size)

        def reorder(flat_src):
            s = holder[0]
            holder[0] = Gen1State(s.h.index_select(1, flat_src),
                                  s.c.index_select(1, flat_src))

        seed = torch.zeros(B, dtype=torch.long, device=device)
        tokens, scores = beam_search_candidates(
            self._cand_step(holder, feats, beam_size, weights), seed, cfg,
            reorder)
        return tokens[:, 0, 1:], scores[:, 0]
