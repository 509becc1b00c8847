"""Adaptive input embeddings and the tied adaptive softmax.

Counterpart of `news_image_caption_tpu/ops/adaptive.py`: the embedder,
the head/tail logits, full-vocab `log_prob`, and the decode-time exact
top-k `topk_log_prob` in the form of the reference's band-streaming
kernel path (`_topk_log_prob_pallas`), which this port takes on every
device: the head band is [table0; class_projᵀ] with only the word rows
selectable, each tail band goes through `band_topk_lse`, and the class
priors are cls_logit - lse_head; and the training loss `loss_sum`.

The opt-in int8 head (the reference's `QuantTable`,
`quantize_embed_tables`, `_word_logits`): each word table int8 with one
scale a row, the class rows exact. `head_logits`, `tail_logits` and
`log_prob` take quantized tables as the reference's XLA route does (the
raw product rounded to x's dtype, times the scale in that dtype);
`topk_log_prob` runs `band_topk_lse_int8` over each word table, the head
band's over table0 alone, and folds the exact class logits into the
head's logsumexp. The kernel rounds a logit once, after the scale
(`ops/band_topk.py`); in fp32 the two roundings agree.

Split over a `model` axis (`parallel/partition.py`: the embedder's band
tables by rows, the untied tables by the vocabulary), a rank holds a
contiguous slice of each band's word rows. The embedding takes the
rows of its slice, zeros elsewhere, sums them over the ranks and then
projects them: exact. The loss merges each band's logsumexp over the
ranks (a max, then a sum of exponentials) and takes the target's logit
from the rank that holds it (`split_nll`). `topk_log_prob` runs each
band's kernel over the rank's rows, adds the rank's first id, gathers
every rank's (values, ids, logsumexp), merges the logsumexps and runs
`stable_topk` over the candidates in rank order, so ties still go to
the lowest id (`merge_topk`); the head band's class rows ride in rank
0's table (`head_table`), so their logits enter the merged logsumexp
once, as the kernel computes them; under the int8 head, whose kernel
runs over table0 alone, they join it outside as unsplit. The kernels
are the same; only the call layout changes. Full-vocab log-probs gather
the ranks' logits whole first. At a model axis of one every form is the
unsplit one.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Sequence, Tuple

import torch
from torch import nn

from news_image_caption_tpu_torch.ops.band_topk import (band_topk_lse,
                                                        band_topk_lse_int8,
                                                        stable_topk)
from news_image_caption_tpu_torch.ops.dropout import dropout
from news_image_caption_tpu_torch.ops.linear import (initializes, new_param,
                                                     positionwise)
from news_image_caption_tpu_torch.parallel.collectives import (axis_max,
                                                               copy_in,
                                                               gather_out,
                                                               reduce_out,
                                                               vocab_gather)
from news_image_caption_tpu_torch.parallel.partition import (is_split,
                                                             shard_of)


class QuantTable(NamedTuple):
    """An int8 word table for the decode head: q [band_v, d] int8 and
    scale [band_v] in the table's dtype, logits[n, v] = scale[v] *
    (x[n] . q[v])."""

    q: torch.Tensor
    scale: torch.Tensor


def quantize_embed_tables(embed_tables):
    """[(table, proj)] -> [(QuantTable, proj)], the reference's
    per-row symmetric rule: amax in fp32, the scale max(amax, 1e-8) /
    127 rounded to the table's dtype FIRST, then q = clip(round-half-
    even(table / scale), ±127) with that rounded scale (the scale
    dequantization multiplies by)."""
    out = []
    for table, proj in embed_tables:
        t32 = table.float()
        amax = t32.abs().amax(dim=1, keepdim=True)
        scale = (amax.clamp(min=1e-8) / 127.0).to(table.dtype).float()
        q = torch.round(t32 / scale).clamp(-127, 127).to(torch.int8)
        out.append((QuantTable(q, scale[:, 0].to(table.dtype)), proj))
    return out


def _word_logits(x: torch.Tensor, table) -> torch.Tensor:
    """x [N, d] @ tableᵀ in x's dtype; an int8 table's raw product
    rounded to x's dtype, then times its row scales in that dtype."""
    if isinstance(table, QuantTable):
        return (x @ table.q.to(x.dtype).T) * table.scale.to(x.dtype)
    return x @ table.to(x.dtype).T


def table_rows(table) -> int:
    """The rows of a word table or of an int8 `QuantTable`."""
    return (table.q if isinstance(table, QuantTable) else table).shape[0]


def split_nll(local: torch.Tensor, first: int, target: torch.Tensor, shard,
              extra: torch.Tensor | None = None,
              extra_first: int = 0) -> torch.Tensor:
    """logsumexp - picked logit [N], fp32, of a band whose logits are
    split over the model ranks: `local` [N, n] this rank's, ids [first,
    first + n); `extra` [N, e] replicated logits of ids [extra_first,
    extra_first + e) (the head band's class slots). The max and the sum
    of exponentials are merged over the ranks, the picked logit comes
    from the rank that holds the target."""
    n = local.shape[1]
    m = axis_max(local.detach().amax(dim=-1), shard)
    if extra is not None:
        m = torch.maximum(m, extra.detach().amax(dim=-1))
    sums = reduce_out(torch.exp(local - m[:, None]).sum(dim=-1), shard)
    mine = (target >= first) & (target < first + n)
    at = torch.clamp(target - first, 0, n - 1)[:, None]
    picked = reduce_out(torch.where(mine, torch.gather(local, 1, at)[:, 0],
                                    0.0), shard)
    if extra is not None:
        sums = sums + torch.exp(extra - m[:, None]).sum(dim=-1)
        e = extra.shape[1]
        held = (target >= extra_first) & (target < extra_first + e)
        at = torch.clamp(target - extra_first, 0, e - 1)[:, None]
        picked = picked + torch.where(held, torch.gather(extra, 1, at)[:, 0],
                                      0.0)
    return m + torch.log(sums) - picked


def merge_topk(vals: torch.Tensor, ids: torch.Tensor, lse: torch.Tensor,
               k: int, shard):
    """Every model rank's band top-k merged: vals [N, k'] fp32, ids
    [N, k'] global, lse [N, 1] of this rank's rows -> (vals [N, k], ids
    [N, k], lse [N, 1]) of the whole band (`merge_candidates` over the
    ranks' gathered candidates)."""
    v, j, lse = merge_candidates(vocab_gather(torch.cat(
        [vals.float(), ids.to(torch.float32), lse.float()], dim=-1), shard),
        k)
    return v, j.to(ids.dtype), lse


def merge_candidates(every: torch.Tensor, k: int):
    """every [m, N, 2k' + 1]: each rank's (top-k' values, their global
    ids as fp32, logsumexp) in rank order -> (vals [N, k], ids [N, k]
    int64, lse [N, 1]): the ranks' logsumexps merged, and `stable_topk`
    over the candidates in rank order, so ties go to the lowest id."""
    m, N, width = every.shape
    kk = (width - 1) // 2
    vals = every[..., :kk].permute(1, 0, 2).reshape(N, m * kk)
    ids = every[..., kk:2 * kk].permute(1, 0, 2).reshape(N, m * kk)
    lse = torch.logsumexp(every[..., 2 * kk].T, dim=-1, keepdim=True)
    v, j = stable_topk(vals, k)
    return v, torch.gather(ids, 1, j).long(), lse


def band_ranges(cutoff: Sequence[int]) -> List[Tuple[int, int]]:
    """[(lo, hi)] for each band; cutoff ends with the vocab size."""
    out, prev = [], 0
    for c in cutoff:
        out.append((prev, c))
        prev = c
    return out


def band_dim(dim: int, factor: float, i: int) -> int:
    """Band i's width: dim // factor**i."""
    return int(dim // (factor ** i))


def _xavier_uniform_(p: torch.Tensor, generator) -> None:
    bound = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
    p.uniform_(-bound, bound, generator=generator)


class AdaptiveEmbedding(nn.Module):
    """Per-band tables `embed_i` [band_v, d_i] and projections `proj_i`
    [d_i, output_dim], d_i = dim // factor**i, summed over the bands;
    times sqrt(output_dim) with scale_embeds. The parameters are stored
    in `dtype`, the output is in `out_dtype` (default `dtype`)."""

    def __init__(self, cutoff: Sequence[int], dim: int, output_dim: int, *,
                 device, dtype, generator=None, padding_idx: int = 0,
                 scale_embeds: bool = False, factor: float = 1.0,
                 out_dtype: torch.dtype | None = None):
        super().__init__()
        self.bands = band_ranges(cutoff)
        self.output_dim = output_dim
        self.scale_embeds = scale_embeds
        self.out_dtype = out_dtype or dtype
        for i, (lo, hi) in enumerate(self.bands):
            d = band_dim(dim, factor, i)
            table = new_param((hi - lo, d), device, dtype)
            proj = new_param((d, output_dim), device, dtype)
            if initializes(device):
                with torch.no_grad():
                    table.normal_(0.0, math.sqrt(1.0 / d),
                                  generator=generator)
                    table[padding_idx] = 0.0
                    _xavier_uniform_(proj, generator)
            setattr(self, f"embed_{i}", table)
            setattr(self, f"proj_{i}", proj)

    def weights_for_band(self, i: int):
        return getattr(self, f"embed_{i}"), getattr(self, f"proj_{i}")

    def _rows(self, table: torch.Tensor, token_ids: torch.Tensor,
              lo: int, hi: int) -> torch.Tensor:
        """The band's table rows of the tokens (a clamped row where a
        token is outside the band); split, the rank's rows, zeros where
        another rank holds the row, summed over the ranks."""
        if not is_split(self) or table.shape[0] == hi - lo:
            return table[torch.clamp(token_ids - lo, 0, hi - lo - 1)]
        shard = shard_of(self)
        n = table.shape[0]
        first = lo + shard.index * n
        mine = (token_ids >= first) & (token_ids < first + n)
        rows = table[torch.clamp(token_ids - first, 0, n - 1)]
        return reduce_out(torch.where(mine[..., None], rows,
                                      torch.zeros((), dtype=rows.dtype,
                                                  device=rows.device)),
                          shard)

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        dtype = self.out_dtype
        out = torch.zeros(token_ids.shape + (self.output_dim,),
                          device=token_ids.device, dtype=dtype)
        for i, (lo, hi) in enumerate(self.bands):
            table, proj = self.weights_for_band(i)
            in_band = (token_ids >= lo) & (token_ids < hi)
            e = self._rows(table, token_ids, lo, hi).to(dtype) @ proj.to(dtype)
            out = out + torch.where(in_band[..., None], e,
                                    torch.zeros((), dtype=dtype,
                                                device=e.device))
        if self.scale_embeds:
            out = out * math.sqrt(self.output_dim)
        return out


class AdaptiveSoftmax(nn.Module):
    """Adaptive softmax over the bands of `cutoff`. Tied (the default),
    the word logits reuse the embedder's band tables, passed as
    `embed_tables` (a list of (table, proj)); untied (tied=False) it owns
    them: `untied_head` [D, cutoff0] and `untied_tail_i` [d_i, band_v].
    It owns the class head `class_proj` [D, n_tails] and the tail
    projections `tail_proj_i` [D, d_i], d_i = D // factor**i, or with
    tie_proj (tied only) reads the embedder's band projections
    transposed instead. `dropout` drops the tail projections' output in
    training (a generator given). The parameters are stored in `dtype`;
    products run in the input's dtype."""

    def __init__(self, input_dim: int, cutoff: Sequence[int], *, device,
                 dtype, generator=None, factor: float = 1.0,
                 dropout: float = 0.0, tied: bool = True,
                 tie_proj: bool = False):
        super().__init__()
        if tie_proj and not tied:
            raise ValueError("tie_proj requires tied embeddings "
                             "(embed_tables at call time)")
        self.cutoff = tuple(cutoff)
        self.n_tails = len(cutoff) - 1
        self.dropout = dropout
        self.tied = tied
        self.tie_proj = tie_proj
        dims = [band_dim(input_dim, factor, i) for i in range(len(cutoff))]
        self.class_proj = new_param((input_dim, self.n_tails), device, dtype)
        owned = [self.class_proj]
        if not tie_proj:
            for i in range(1, len(cutoff)):
                p = new_param((input_dim, dims[i]), device, dtype)
                setattr(self, f"tail_proj_{i}", p)
                owned.append(p)
        if not tied:
            self.untied_head = new_param((input_dim, self.cutoff[0]), device,
                                         dtype)
            owned.append(self.untied_head)
            for i, (lo, hi) in enumerate(band_ranges(cutoff)[1:], start=1):
                p = new_param((dims[i], hi - lo), device, dtype)
                setattr(self, f"untied_tail_{i}", p)
                owned.append(p)
        if initializes(device):
            with torch.no_grad():
                for p in owned:
                    _xavier_uniform_(p, generator)

    def word_table(self, i: int, embed_tables):
        """Band i's word table [band_v, d_i]: the embedder's (or its int8
        `QuantTable`) when tied, the untied one transposed otherwise."""
        if self.tied:
            return embed_tables[i][0]
        owned = self.untied_head if i == 0 else \
            getattr(self, f"untied_tail_{i}")
        return owned.T

    def split_tables(self, embed_tables) -> bool:
        """Whether the word tables are split over model ranks (a rank's
        table0 holds fewer rows than the head band's words)."""
        return (is_split(self)
                and table_rows(self.word_table(0, embed_tables))
                < self.cutoff[0])

    def _whole_logits(self, x, table, i: int) -> torch.Tensor:
        """x's logits over band i's whole vocabulary: split, the ranks'
        gathered in rank order."""
        lo, hi = band_ranges(self.cutoff)[i]
        if not is_split(self) or table_rows(table) == hi - lo:
            return _word_logits(x, table)
        shard = shard_of(self)
        return gather_out(_word_logits(copy_in(x, shard), table), shard, -1)

    def head_logits(self, x, embed_tables) -> torch.Tensor:
        """x [N, D] -> [N, cutoff0 + n_tails]; the class logits exact
        with quantized tables too."""
        word = self._whole_logits(x, self.word_table(0, embed_tables), 0)
        cls = x @ self.class_proj.to(x.dtype)
        return torch.cat([word, cls], dim=-1)

    def tail_hidden(self, x, i: int, embed_tables=None,
                    generator=None) -> torch.Tensor:
        """Projection of x for tail band i (1-based), [N, d_i]: x @
        tail_proj_i, or with tie_proj x @ proj_iᵀ of the embedder's band
        i; dropped at `dropout` with a generator."""
        if self.tie_proj:
            h = x @ embed_tables[i][1].to(x.dtype).T
        else:
            h = x @ getattr(self, f"tail_proj_{i}").to(x.dtype)
        return dropout(h, self.dropout, generator)

    def tail_logits(self, x, i: int, embed_tables,
                    generator=None) -> torch.Tensor:
        return self._whole_logits(self.tail_hidden(x, i, embed_tables,
                                                   generator),
                                  self.word_table(i, embed_tables), i)

    def log_prob(self, x, embed_tables) -> torch.Tensor:
        """Full-vocab log-probs [N, V]; softmax in fp32, result in x's
        dtype."""
        c0 = self.cutoff[0]
        hlog = torch.log_softmax(self.head_logits(x, embed_tables).float(),
                                 dim=-1).to(x.dtype)
        parts = [hlog[:, :c0]]
        for i in range(1, len(self.cutoff)):
            prior = hlog[:, c0 + i - 1:c0 + i]
            tlog = torch.log_softmax(
                self.tail_logits(x, i, embed_tables).float(),
                dim=-1).to(x.dtype)
            parts.append(tlog + prior)
        return torch.cat(parts, dim=-1)

    def loss_sum(self, x, target, padding_idx: int, embed_tables,
                 generator=None):
        """Summed adaptive cross-entropy and the token count.

        x [N, D]; target [N] ids. The head CE takes tail targets
        remapped to their class slot c0 + i; each tail adds its in-band
        CE. Targets equal to padding_idx are ignored, and in a tail so
        is a target whose in-band index equals padding_idx (the
        reference's ignore_index quirk). NLL = logsumexp - picked logit,
        in fp32. A generator drops the tail projections (`dropout`).
        Returns (loss fp32 scalar, ntokens int64 scalar).
        """
        c0 = self.cutoff[0]
        bands = band_ranges(self.cutoff)
        shard = shard_of(self) if self.split_tables(embed_tables) else None

        def band_nll(h, table, tgt, extra=None):
            """NLL of the band whose word rows are `table` (this rank's
            where split, `split_nll`), `extra` its class-slot logits."""
            if shard is not None:
                local = _word_logits(copy_in(h, shard), table).float()
                return split_nll(local, shard.index * table.shape[0], tgt,
                                 shard, None if extra is None
                                 else extra.float(), c0)
            logits = _word_logits(h, table)
            if extra is not None:
                logits = torch.cat([logits, extra], dim=-1)
            logits = logits.float()
            picked = torch.gather(logits, 1, tgt[:, None])[:, 0]
            return torch.logsumexp(logits, dim=-1) - picked

        head_target = target
        for i, (lo, hi) in enumerate(bands[1:]):
            in_band = (target >= lo) & (target < hi)
            head_target = torch.where(in_band, c0 + i, head_target)
        nll = band_nll(x, self.word_table(0, embed_tables), head_target,
                       x @ self.class_proj.to(x.dtype))
        loss = torch.where(head_target != padding_idx, nll, 0.0).sum()
        for i, (lo, hi) in enumerate(bands[1:], start=1):
            in_band = (target >= lo) & (target < hi)
            tgt_in = torch.clamp(target - lo, 0, hi - lo - 1)
            nll = band_nll(self.tail_hidden(x, i, embed_tables, generator),
                           self.word_table(i, embed_tables), tgt_in)
            valid = in_band & (tgt_in != padding_idx)
            loss = loss + torch.where(valid, nll, 0.0).sum()
        return loss, (target != padding_idx).sum()

    def head_table(self, embed_tables, dtype) -> torch.Tensor:
        """[table0; class_projᵀ]: the head band of `topk_log_prob`
        (word rows, then one class row per tail). Split, this rank's
        rows of table0, with the class rows in rank 0's alone."""
        parts = [self.word_table(0, embed_tables).to(dtype)]
        if not self.split_tables(embed_tables) or shard_of(self).index == 0:
            parts.append(self.class_proj.to(dtype).T)
        return torch.cat(parts, dim=0).contiguous()

    def topk_log_prob(self, x, k: int, embed_tables, head_table=None):
        """Exact top-k full-vocab log-probs without the [N, V] matrix:
        per band the kernel's top-k and logsumexp, tails shifted by
        their class prior, then a (bands * k)-wide merge. x [N, D];
        or [B, n, D], a decode chunk's n positions a row, whose products
        (class slots, tail projections) run position by position at a
        step's shapes (`positionwise`) and whose bands' kernels take all
        B*n rows at once. Returns (log_probs [..., k] fp32, token_ids
        [..., k] int64), best first.

        With quantized tables (`quantize_embed_tables`) every band goes
        through `band_topk_lse_int8`, the head's over table0 alone (ids
        < c0 all selectable), and the head's logsumexp takes the exact
        class logits in beside the kernel's; head_table is not read."""
        c0 = self.cutoff[0]
        lead = x.shape[:-1]
        quantized = self.tied and isinstance(embed_tables[0][0], QuantTable)
        if head_table is None and not quantized:
            head_table = self.head_table(embed_tables, x.dtype)
        shard = shard_of(self) if self.split_tables(embed_tables) else None

        def rows(fn):
            y = positionwise(fn, x) if x.dim() == 3 else fn(x)
            return y.reshape(-1, y.shape[-1])

        def band(h, table, sel_limit=None):
            """The band's top-k and logsumexp over this rank's rows,
            merged over the model ranks (ids from the band's start)."""
            n = table_rows(table) if sel_limit is None else sel_limit
            kk = min(k, n)
            if quantized:
                v, ids, lse = band_topk_lse_int8(h, table.q, table.scale, kk,
                                                 sel_limit)
            else:
                v, ids, lse = band_topk_lse(h, table.to(h.dtype).contiguous(),
                                            kk, sel_limit)
            if shard is None:
                return v, ids, lse
            return merge_topk(v, ids + shard.index * n, lse, k, shard)

        flat = x.reshape(-1, x.shape[-1])
        # Class-slot logits at the kernel's rounding point (x's dtype).
        cls = rows(lambda r: r @ self.class_proj.to(r.dtype)).float()
        if quantized:
            hv, hi, lse_w = band(flat, embed_tables[0][0])
            lse_h = torch.logaddexp(lse_w, torch.logsumexp(cls, dim=-1,
                                                           keepdim=True))
        else:
            words = self.word_table(0, embed_tables).shape[0]
            hv, hi, lse_h = band(flat, head_table, words)
        vals, ids = [hv - lse_h], [hi]
        for i in range(1, len(self.cutoff)):
            h = rows(lambda r: self.tail_hidden(r, i, embed_tables))
            tv, ti, lse_t = band(h, self.word_table(i, embed_tables))
            prior = cls[:, i - 1:i] - lse_h
            vals.append(tv - lse_t + prior)
            ids.append(ti + self.cutoff[i - 1])
        v, j = stable_topk(torch.cat(vals, dim=-1), k)
        ids = torch.gather(torch.cat(ids, dim=-1).long(), -1, j)
        return v.view(*lead, k), ids.view(*lead, k)
