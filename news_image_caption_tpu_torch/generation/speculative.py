"""Exact speculative greedy decoding (draft and verify).

Counterpart of `news_image_caption_tpu/generation/speculative.py`
(`write_rows`, `greedy_verify`, `commit_conv_caches`, `ngram_drafts`,
`speculative_greedy`). A drafter proposes the next `spec_k - 1` tokens
of every row; one chunked decoder step (`DynamicConvDecoder.step_chunk`)
scores the last committed token and the drafts at once; each row
commits its longest verified prefix and one corrected token. The output
is the greedy caption token for token: every committed token is the
argmax given its true prefix, and at least one commits a chunk. The
default drafter copies from the article's token ids (prompt lookup):
news captions copy entity spans from their articles.

The reference's `lax.while_loop` becomes a Python loop that reads the
rows' finished flags on the host once a chunk, as `generate_candidates`
does a step. The conv caches are ring-major [K-1, B, C], as the conv
block's kernel reads them; `commit_conv_caches` writes each row's
verified prefix into its own ring slots. The buffers are written in
place. Under the int8 routes (`quantize_kv`, `quantize_head`) the chunk
runs over int8 K/V and tables (`TransformerFlattened.
generate_speculative` binds them into `chunk_fn`), and its tokens are
the quantized greedy's.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from news_image_caption_tpu_torch.generation.generator import \
    GenerationConfig


def write_rows(b: torch.Tensor, vals: torch.Tensor,
               starts: torch.Tensor) -> torch.Tensor:
    """b[r, starts[r]:starts[r] + k] = vals[r] in place, for vals [B, k];
    a window that would run past b's end is moved back inside it, as
    `lax.dynamic_update_slice` moves it. Returns b."""
    k = vals.shape[1]
    starts = starts.long().clamp(0, b.shape[1] - k)
    idx = starts[:, None] + torch.arange(k, device=b.device)[None, :]
    return b.scatter_(1, idx, vals.to(b.dtype))


def greedy_verify(ids: torch.Tensor, drafts: Optional[torch.Tensor],
                  finished: torch.Tensor, pos: torch.Tensor, limit,
                  eos_id: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Commit counts of one verified greedy chunk, the rule shared by
    `speculative_greedy` and the continuous pool
    (`generation/continuous.py`).

    ids [B, k]: the chunk's argmax outputs (output t the greedy next
    token given inputs 0..t); drafts [B, k-1] or None (k = 1); limit:
    the most outputs a row takes (an int or [B]). Output t is valid iff
    drafts 0..t-1 all matched, and the first mismatching output is the
    corrected token, so a row commits its matches + 1, cut at its first
    committed eos and its limit; finished rows commit 0. Returns
    (m [B] int32, committed_eos [B] bool).
    """
    if drafts is not None and drafts.shape[1] > 0:
        same = (ids[:, :-1] == drafts).to(torch.int32)
        m = torch.cumprod(same, dim=1).sum(dim=1) + 1       # 1..k
    else:
        m = torch.ones(ids.shape[0], dtype=torch.int64, device=ids.device)
    is_eos = ids == eos_id
    first_eos = is_eos.to(torch.int32).argmax(dim=1)        # the first
    has_eos = is_eos.any(dim=1)
    m = torch.where(has_eos, torch.minimum(m, first_eos + 1), m)
    m = torch.minimum(m, limit - pos.long())
    m = torch.where(finished, 0, m)
    committed_eos = has_eos & (first_eos < m)
    return m.to(torch.int32), committed_eos


def commit_conv_caches(caches: List[torch.Tensor], hs: List[torch.Tensor],
                       m: torch.Tensor, pos: torch.Tensor) -> None:
    """Advance the ring-major conv histories by each row's verified
    prefix, in place. caches[l] [K-1, B, C]; hs[l] [B, k, C] the chunk's
    conv inputs (`DynamicConvDecoder.step_chunk`); m [B] the inputs each
    row commits; pos [B] its inputs consumed before the chunk. Input i
    of row r goes to slot (pos_r + i) mod (K-1) for i < m_r, in order,
    so a row that commits more than K-1 keeps its last K-1: the ring
    that m_r sequential steps would have left. A pointwise layer (K = 1)
    has no ring."""
    for cache, h in zip(caches, hs):
        Km1 = cache.shape[0]
        if Km1 == 0:
            continue
        rows = torch.arange(cache.shape[1], device=cache.device)
        for i in range(h.shape[1]):
            slot = (pos.long() + i) % Km1
            keep = (i < m)[:, None]
            cache[slot, rows] = torch.where(keep, h[:, i].to(cache.dtype),
                                            cache[slot, rows])


def ngram_drafts(source: torch.Tensor, tokens: torch.Tensor,
                 pos: torch.Tensor, k_draft: int, n: int = 2,
                 pad_id: int = 1) -> torch.Tensor:
    """Prompt-lookup drafts: continue the generated suffix from its
    first occurrence in `source`.

    source [B, S] ids to draft from (the article's); tokens [B, L] the
    committed tokens (tokens[b, pos[b]] the last); pos [B]. Returns
    drafts [B, k_draft] int64: the k_draft source ids after the first
    place where source matches the last min(n, pos + 1) committed
    tokens; pad_id where none matches or the match runs off the end.
    """
    B, S = source.shape
    dev = source.device
    pos = pos.long()
    offs = pos[:, None] - (n - 1) + torch.arange(n, device=dev)[None, :]
    valid = offs >= 0                                       # [B, n]
    last = tokens.gather(1, offs.clamp(0, tokens.shape[1] - 1))
    M = S - n + 1
    if M <= 0:
        return torch.full((B, k_draft), pad_id, dtype=torch.long, device=dev)
    # win[b, s, j] = source[b, s + j] for s in 0..M-1
    win = torch.stack([source[:, j:j + M] for j in range(n)], dim=-1)
    match = ((win == last[:, None, :]) | ~valid[:, None, :]).all(dim=-1)
    has = match.any(dim=1)
    s = match.to(torch.int32).argmax(dim=1)                 # first match
    didx = (s[:, None] + n
            + torch.arange(k_draft, device=dev)[None, :])
    drafts = source.long().gather(1, didx.clamp(0, S - 1))
    return torch.where(has[:, None] & (didx < S), drafts, pad_id)


def speculative_greedy(chunk_fn: Callable, commit_fn: Callable,
                       seed: torch.Tensor, config: GenerationConfig,
                       spec_k: int, draft_fn: Callable,
                       collect_flags: bool = False):
    """Greedy generation by draft and verify; the tokens are those of
    `generate_candidates` with sampling_topk = 1.

    chunk_fn(tokens [B, spec_k], pos [B] int32) -> (log_probs [B, spec_k],
    argmax_ids [B, spec_k], aux): output t the greedy next token given
    inputs 0..t (`DynamicConvDecoder.step_chunk`); it owns the decode
    state and does not advance it. commit_fn(aux, m [B], pos [B])
    advances each row's state by its m committed inputs.
    draft_fn(tokens, pos, finished) -> drafts [B, spec_k - 1].

    Returns (tokens [B, max_len + 1] int64, log_probs [B, max_len] fp32,
    n_chunks): the verification steps run, the unit of wall time.

    collect_flags=True: chunk_fn returns a fourth [B, spec_k] bool
    tensor, a flag an output (the pointer family's copied marks); the
    committed outputs' flags are kept beside their tokens (False
    elsewhere) and returned as (tokens, log_probs, flags [B, max_len],
    n_chunks).
    """
    B = seed.shape[0]
    L, k = config.max_len, spec_k
    if k < 2:
        raise ValueError("spec_k must be >= 2 (1 draft minimum)")
    dev = seed.device
    buf = L + k + 1
    tokens = torch.full((B, buf), config.pad_id, dtype=torch.long,
                        device=dev)
    tokens[:, 0] = seed
    lps = torch.zeros(B, buf - 1, dtype=torch.float32, device=dev)
    flags = torch.zeros(B, buf - 1, dtype=torch.bool, device=dev)
    pos = torch.zeros(B, dtype=torch.int32, device=dev)
    if config.init_finished:
        finished = seed == config.eos_id
    else:
        finished = torch.zeros(B, dtype=torch.bool, device=dev)
    arange_k = torch.arange(k, device=dev)[None, :]
    n_chunks = 0
    while bool((~finished & (pos < L)).any()):   # one host read a chunk
        cur = tokens.gather(1, pos.long()[:, None])
        drafts = draft_fn(tokens, pos, finished)
        out = chunk_fn(torch.cat([cur, drafts], dim=1), pos)
        lp_c, ids, aux = out[:3]
        m, committed_eos = greedy_verify(ids, drafts, finished, pos, L,
                                         config.eos_id)
        live = arange_k < m[:, None]
        # Positions past a row's frontier hold pad, so the masked tail
        # writes change nothing; buf = L + k + 1 keeps the window inside.
        write_rows(tokens, torch.where(live, ids, config.pad_id), pos + 1)
        write_rows(lps, torch.where(live, lp_c.float(), 0.0), pos)
        if collect_flags:
            write_rows(flags, out[3] & live, pos)
        commit_fn(aux, m, pos)
        pos = pos + m
        finished = finished | committed_eos | (pos >= L)
        n_chunks += 1
    if collect_flags:
        return tokens[:, :L + 1], lps[:, :L], flags[:, :L], n_chunks
    return tokens[:, :L + 1], lps[:, :L], n_chunks
