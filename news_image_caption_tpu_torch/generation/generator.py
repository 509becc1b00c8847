"""Greedy, top-k sampling and beam-search decode loops over a
candidate-producing step.

Counterpart of `news_image_caption_tpu/generation/generator.py`
(`GenerationConfig`, `generate`, `generate_candidates`, `beam_combine`,
`rank_beams`, `beam_search_candidates`, `beam_search`). The reference's
`lax.scan` / `lax.while_loop` becomes a Python loop: with `early_exit`
it stops as soon as every row has emitted eos (one host read of the
finished mask per step); the outputs are the same either way, since
finished rows emit pad with log-prob 0.

Top-k sampling (`sampling_topk > 1`) picks argmax(log_prob / temp +
Gumbel noise) over the step's exact top-k candidates, which is how
`jax.random.categorical` samples. The noise comes from `gumbel_noise`,
drawn from a `torch.Generator` for the batch or from one generator a
row; torch's streams are not JAX's, so the tests feed JAX's draws
through that one function.

A step function owns its decode state (the conv caches): the loops pass
it tokens and a step index only. Beam search reorders that state through
a `reorder(flat_src)` callback; `index_reorder` builds the usual one.
Every selection goes through `stable_topk`, so ties break toward the
lowest position as `lax.top_k` breaks them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch

from news_image_caption_tpu_torch.ops.band_topk import stable_topk

NEG_INF = -1e9   # the score of a dead beam slot; fp32, as the reference's


@dataclass(frozen=True)
class GenerationConfig:
    max_len: int = 100
    eos_id: int = 2
    pad_id: int = 1
    bos_id: int = 0
    sampling_topk: int = 1
    sampling_temp: float = 1.0
    beam_size: int = 5
    length_penalty: float = 1.0
    # Mark sequences whose seed equals eos as already finished. Gen-1
    # models use token 0 as both <bos> input and <eos> output, so they
    # set this False.
    init_finished: bool = True
    # Stop once every row has finished (same outputs, fewer steps).
    early_exit: bool = False
    # Gen-1 beam semantics: a beam that emits eos is harvested into a
    # done list (its tokens and raw score) and its live slot's score
    # drops to -1e9, so the slot keeps decoding but never wins; live
    # beams are harvested at the end. Ranking applies length_penalty
    # over the done list (the Gen-1 reference ranks by raw sum: pass
    # 0.0). False: finished beams freeze in their slot emitting pad.
    harvest_finished: bool = False
    # int8 context K/V (`ops/attention.py::quantize_kv`) and int8 head
    # word tables (`ops/adaptive.py::QuantTable`), opt-in: each halves
    # its stream of decode bytes, and captions may differ from the exact
    # route's near ties. The flattened captioner's decode reads them.
    quantize_kv: bool = False
    quantize_head: bool = False


Generators = Union[torch.Generator, Sequence]


def gumbel_noise(generator: Generators, shape: Tuple[int, int]
                 ) -> torch.Tensor:
    """Gumbel(0, 1) noise [B, k] fp32, -log(-log(u)) with u uniform in
    [tiny, 1) as `jax.random.gumbel` draws it: from one generator for
    the batch, or from a sequence of B generators, a [1, k] draw each,
    so a row's noise does not depend on the batch it is decoded in. On
    each generator's device."""
    if isinstance(generator, torch.Generator):
        return _gumbel(generator, shape)
    return torch.cat([_gumbel(g, (1,) + tuple(shape[1:])) for g in generator])


def _gumbel(generator: torch.Generator, shape) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def select_candidates(cand_lp: torch.Tensor, cand_ids: torch.Tensor,
                      config: GenerationConfig,
                      generator: Optional[Generators] = None):
    """One step's choice among the exact top-k candidates: (log_prob / temp
    of the chosen [B], its id [B]). Greedy takes the best; sampling takes
    argmax(log_prob / temp + `gumbel_noise`), drawing from `generator`."""
    lp = cand_lp / config.sampling_temp
    if config.sampling_topk == 1:
        return lp[:, 0], cand_ids[:, 0]
    choice = sample_index(lp, generator)[:, None]
    return lp.gather(1, choice)[:, 0], cand_ids.gather(1, choice)[:, 0]


def sample_index(logits: torch.Tensor, generator: Generators) -> torch.Tensor:
    """A draw a row from softmax(logits [B, k]), as `jax.random.
    categorical` draws: argmax(logits + `gumbel_noise`) [B] int64."""
    noise = gumbel_noise(generator, tuple(logits.shape)).to(logits.device)
    return torch.argmax(logits.float() + noise, dim=1)


def generate(step_fn: Callable, seed: torch.Tensor, config: GenerationConfig,
             generator: Optional[Generators] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy or top-k sampled generation over a full-vocab step.

    step_fn(token_t [B], step_idx) -> log_probs [B, V]; the per-row
    top-k of those log-probs is the candidate set of
    `generate_candidates`, which this adapts onto.
    """
    def cand_step(tok, i):
        return stable_topk(step_fn(tok, i), config.sampling_topk)

    return generate_candidates(cand_step, seed, config, generator)


def generate_candidates(step_fn: Callable, seed: torch.Tensor,
                        config: GenerationConfig,
                        generator: Optional[Generators] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy or top-k sampled generation.

    step_fn(token_t [B], step_idx) -> (cand_lp [B, k], cand_ids [B, k])
    with the candidates the exact top-k, best first; step_fn owns its
    decode state. seed [B] is the first input token. Sampling draws
    from `generator` (see `gumbel_noise`); without one, from a generator
    on seed's device seeded with 0, as the reference samples with
    PRNGKey(0) where it is given no key. Returns (tokens
    [B, max_len + 1] int64 with the seed first, log_probs [B, max_len]
    fp32, each the chosen candidate's log-prob / temp).
    """
    if config.sampling_topk > 1 and generator is None:
        generator = torch.Generator(device=seed.device).manual_seed(0)
    B = seed.shape[0]
    L = config.max_len
    tokens = torch.full((B, L + 1), config.pad_id, dtype=torch.long,
                        device=seed.device)
    tokens[:, 0] = seed
    lps = torch.zeros(B, L, dtype=torch.float32, device=seed.device)
    if config.init_finished:
        finished = seed == config.eos_id
    else:
        finished = torch.zeros(B, dtype=torch.bool, device=seed.device)
    cur = seed
    for i in range(L):
        if config.early_exit and bool(finished.all()):
            break
        cand_lp, cand_ids = step_fn(cur, i)
        sel_lp, sel_ids = select_candidates(cand_lp, cand_ids, config,
                                            generator)
        next_tok = torch.where(finished, config.pad_id, sel_ids)
        lps[:, i] = torch.where(finished, 0.0, sel_lp.float())
        tokens[:, i + 1] = next_tok
        finished = finished | (next_tok == config.eos_id)
        cur = next_tok
    return tokens, lps


def beam_combine(scores: torch.Tensor, rv: torch.Tensor, ri: torch.Tensor,
                 finished: torch.Tensor, B: int, K: int, pad_id: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One beam-search combine.

    scores / finished [B*K]; rv / ri [B*K, K] each row's candidate
    log-probs and ids (its exact top-K). A finished row contributes
    exactly one candidate: itself extended by pad at +0.0 (its other
    slots are dead at -1e9). Returns (new_scores [B*K] fp32, tok_flat
    [B*K], flat_src [B*K]): the continuation token of each beam slot and
    the row it descends from, for reordering tokens and caches. Scores
    stay fp32: -1e9 + lp rounds to -1e9, so dead slots tie, and the
    lowest position wins the tie.
    """
    pad_vals = torch.full((K,), NEG_INF, dtype=torch.float32,
                          device=scores.device)
    pad_vals[0] = 0.0
    rv = torch.where(finished[:, None], pad_vals, rv.float())
    ri = torch.where(finished[:, None], pad_id, ri.long())
    cand = (scores[:, None] + rv).view(B, K * K)
    top_scores, top_flat = stable_topk(cand, K)                 # [B, K]
    tok = torch.gather(ri.view(B, K * K), 1, top_flat)
    rows = torch.arange(B, device=scores.device)[:, None] * K
    flat_src = (rows + top_flat // K).view(-1)
    return top_scores.reshape(-1), tok.view(-1), flat_src


def rank_beams(tokens: torch.Tensor, scores: torch.Tensor, pad_id: int,
               length_penalty: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best-first order by score / length**alpha (alpha = 0 ranks by the
    raw summed log-prob, the Gen-1 rule); the length counts the tokens
    that are not pad, the seed included. tokens [B, K, L+1], scores
    [B, K]; returns the tokens reordered and the normalised scores, by a
    stable sort as `jnp.argsort` sorts."""
    lengths = (tokens != pad_id).sum(-1).float()
    norm = scores / torch.clamp(lengths, min=1.0) ** length_penalty
    order = torch.argsort(-norm, dim=1, stable=True)
    tokens = torch.gather(tokens, 1, order[:, :, None].expand_as(tokens))
    return tokens, torch.gather(norm, 1, order)


def merge_done(done_s: torch.Tensor, done_t: torch.Tensor,
               tokens: torch.Tensor, scores: torch.Tensor,
               mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Insert the masked beams into each item's top-K done list.

    done_s [B, K], done_t [B, K, L+1]; tokens [B*K, L+1], scores and
    mask [B*K]. The top K of the 2K entries, done entries first, so
    they win ties. Returns the new (done_s, done_t)."""
    B, K = done_s.shape
    cand_s = torch.where(mask, scores, NEG_INF).view(B, K)
    all_s = torch.cat([done_s, cand_s], dim=1)                 # [B, 2K]
    all_t = torch.cat([done_t, tokens.view(B, K, -1)], dim=1)
    s, j = stable_topk(all_s, K)
    return s, torch.gather(all_t, 1, j[:, :, None].expand(B, K,
                                                          all_t.shape[2]))


def index_reorder(caches: List[torch.Tensor]) -> Callable:
    """The ancestry reorder of `beam_search_candidates` for a list of
    ring-major caches [K-1, B*K, C] that a step reads: reorder(flat_src)
    gathers each cache along dim 1 (the flat beam axis) into a second
    buffer with `index_select` and swaps that buffer into the list, so
    no buffer is allocated a step. Every ring slot moves, the one the
    step just wrote included."""
    spare = [torch.empty_like(c) for c in caches]

    def reorder(flat_src: torch.Tensor) -> None:
        for j, cache in enumerate(caches):
            torch.index_select(cache, 1, flat_src, out=spare[j])
            caches[j], spare[j] = spare[j], cache

    return reorder


def beam_search_candidates(step_fn: Callable, seed: torch.Tensor,
                           config: GenerationConfig, reorder: Callable
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam search over a candidate-producing step.

    step_fn(token_t [B*K], step_idx) -> (cand_lp [B*K, K], cand_ids
    [B*K, K]) with the candidates each row's exact top-K; step_fn owns
    its decode state, and reorder(flat_src [B*K]) moves that state to
    the beams' new order after each combine (`index_reorder`). The
    global top-K of an item lies in the union of its rows' top-K, so
    the combine is a K*K-wide top-k.

    config.harvest_finished switches to the done-list semantics (see
    `GenerationConfig`). The state carried from step to step (tokens,
    scores, finished flags, the done list) lives in buffers allocated
    once and written in place; the tokens are gathered into a second
    buffer and swapped, as `index_reorder` does for the caches.

    Returns (tokens [B, K, max_len+1] int64, scores [B, K] fp32),
    best first by score / length**length_penalty.
    """
    B, K, L = seed.shape[0], config.beam_size, config.max_len
    dev = seed.device
    flat_seed = seed.repeat_interleave(K)
    tokens = torch.full((B * K, L + 1), config.pad_id, dtype=torch.long,
                        device=dev)
    tokens[:, 0] = flat_seed
    spare_tokens = torch.empty_like(tokens)
    # Only beam 0 is live at the start (all beams are identical).
    scores = torch.full((B, K), NEG_INF, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0
    scores = scores.view(-1)
    if config.init_finished:
        finished = flat_seed == config.eos_id
    else:
        finished = torch.zeros(B * K, dtype=torch.bool, device=dev)
    spare_finished = torch.empty_like(finished)
    harvest = config.harvest_finished
    if harvest:
        done_s = torch.full((B, K), NEG_INF, dtype=torch.float32, device=dev)
        done_t = torch.full((B, K, L + 1), config.pad_id, dtype=torch.long,
                            device=dev)
    cur = flat_seed
    for i in range(L):
        if config.early_exit and bool(finished.all()):
            break
        rv, ri = step_fn(cur, i)
        new_scores, tok, flat_src = beam_combine(
            scores, rv, ri, finished, B, K, config.pad_id)
        scores.copy_(new_scores)
        torch.index_select(tokens, 0, flat_src, out=spare_tokens)
        tokens, spare_tokens = spare_tokens, tokens
        reorder(flat_src)
        torch.index_select(finished, 0, flat_src, out=spare_finished)
        finished, spare_finished = spare_finished, finished
        tokens[:, i + 1] = tok
        just_eos = (tok == config.eos_id) & ~finished
        if harvest:
            s, t = merge_done(done_s, done_t, tokens, scores, just_eos)
            done_s.copy_(s)
            done_t.copy_(t)
            scores.masked_fill_(just_eos, NEG_INF)
        finished |= just_eos
        cur = tok

    if harvest:
        # Live beams are harvested when the loop ends.
        scores, tokens = merge_done(done_s, done_t, tokens, scores, ~finished)
    else:
        tokens = tokens.view(B, K, L + 1)
        scores = scores.view(B, K)
    return rank_beams(tokens, scores, config.pad_id, config.length_penalty)


def beam_search(step_fn: Callable, seed: torch.Tensor,
                config: GenerationConfig, reorder: Callable
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam search over a full-vocab step.

    step_fn(token_t [B*K], step_idx) -> log_probs [B*K, V] over the flat
    beam batch; its per-row top-K is an exact candidate set, so this
    adapts onto `beam_search_candidates` (same reorder, same returns).
    """
    def cand_step(tok, i):
        return stable_topk(step_fn(tok, i), config.beam_size)

    return beam_search_candidates(cand_step, seed, config, reorder)
