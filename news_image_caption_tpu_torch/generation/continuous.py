"""Continuous batching: a pool of decode slots refilled mid-flight.

Counterpart of `news_image_caption_tpu/generation/continuous.py`
(`_SlotPool`, `ContinuousBatcher` with `for_flattened`, `for_pointer`,
`for_tgnc` and `for_gen2`, `ContinuousBeamBatcher`). The decoder steps a
fixed pool of W slots; requests queue, each slot decodes its own caption
at its own position, and a slot whose caption is done is harvested and
refilled without stopping the others.

The pool's state lives on the model's device in tensors allocated once
(`reset`) and written in place: tokens, log-probs, positions, finished
flags and limits a slot, the context K/V of every slot ([W, S', E] a
layer and context, sized by the first request inserted) and the
ring-major conv caches [K-1, W, C]. A dispatch (`_dispatch_chunk`)
runs `inner_steps` decode steps of every slot as a Python loop (the
reference's `lax.scan`), then starts a non-blocking copy of its small
host view (finished flags and result rows) into pinned memory with an
event; `harvest_lag` dispatches stay in flight, and a harvest waits on
the oldest view's event: one host read a dispatch. On the CPU the view
is a copy made at once.

Per-slot positions ride the conv block's per-row ring positions
(`DynamicConvDecoder.step_chunk`, `step_topk`), so a greedy slot
with `spec_k >= 2` also decodes speculatively from its own draft source
(`commit_conv_caches` advances each slot's ring by its commit). Two
engines:
- `ContinuousBatcher`: greedy (optionally speculative) slots, or top-k
  sampling slots with a generator each (`sampling_topk > 1`); a
  harvested caption equals `TransformerFlattened.generate` on the
  request alone (sampling: with that request's generator). Over the
  pointer family (`for_pointer`) each slot also carries the copy head's
  keys, the article's ids and relevance, entity K/V and a copied-token
  table, and results carry the copied flags; over the Gen-2 family
  (`for_gen2`) the caches are the self-attention K/V that the chunk
  writes at each slot's positions; over TGNC (`for_tgnc`) each slot
  also carries its request's template logits, and the caches are the
  trunk's and the template heads' rings;
- `ContinuousBeamBatcher`: exact beam search, K rows a slot; a harvested
  result equals `generate_beam` on the request alone.

Over the flattened captioner both engines take the config's int8 routes
as `generate` does: with `quantize_kv` a request's K/V are quantized in
its prep, so the slots hold int8 K/V and their scales
(`QuantAttentionKV` leaves, sized by the first insert like any); with
`quantize_head` the head's tables are quantized once at engine build
(unless the weights carry them) and every step reads them.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from news_image_caption_tpu_torch.generation.generator import (
    NEG_INF, GenerationConfig, beam_combine, rank_beams, select_candidates)
from news_image_caption_tpu_torch.generation.speculative import (
    commit_conv_caches, greedy_verify, ngram_drafts, write_rows)

__all__ = ["ContinuousBatcher", "ContinuousBeamBatcher"]


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    return [leaf for sub in tree for leaf in _leaves(sub)]


def _tree_map(fn: Callable, tree, *rest):
    """fn over the tensors of nested lists, dicts and named tuples (the
    decoder's per-layer {context: AttentionKV}), leaf by leaf."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    parts = [_tree_map(fn, *xs) for xs in zip(tree, *rest)]
    return type(tree)(*parts) if hasattr(tree, "_fields") else type(tree)(
        parts)


class _HostView:
    """A dispatch's results on the host: a copy into pinned memory on
    the card's stream, waited on by its event when harvested; on the
    CPU a copy made at once."""

    def __init__(self, arrays: Dict[str, torch.Tensor]):
        self.event = None
        if next(iter(arrays.values())).device.type == "cuda":
            self.arrays = {}
            for k, v in arrays.items():
                host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                host.copy_(v, non_blocking=True)
                self.arrays[k] = host
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.arrays = {k: v.clone() for k, v in arrays.items()}

    def numpy(self) -> Dict[str, np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return {k: v.numpy() for k, v in self.arrays.items()}


class _SlotPool:
    """What both engines share on the host: the request queue, the slot
    bookkeeping, failure isolation a request, admission control and the
    refill / dispatch / harvest loop.

    A subclass provides `reset()` (which allocates the state and calls
    `_reset_bookkeeping`), `_prep(request)` (the request's context K/V,
    batch 1), `_insert_slot(slot, kvs1, extra)`, `_dispatch_chunk()`
    (`inner_steps` steps of every slot, then one `_HostView` appended to
    `_pending`) and `_harvest(pending)` ({request id: results}).

    The harvest lags `harvest_lag` dispatches: `step()` keeps up to that
    many in flight and waits only on the oldest, so the copy of a view
    to the host overlaps the next dispatches. A finished request is
    returned `harvest_lag` steps after its slot finishes, its slot frozen
    meanwhile (`stats()` shows the cost).
    """

    def __init__(self, config: GenerationConfig, n_slots: int,
                 inner_steps: int, max_queue: Optional[int],
                 harvest_lag: int = 1):
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        if inner_steps < 1:
            raise ValueError("inner_steps must be >= 1")
        if harvest_lag < 1:
            raise ValueError("harvest_lag must be >= 1")
        self.harvest_lag = harvest_lag
        self.config = config
        self.W = n_slots
        self.inner_steps = inner_steps
        # Admission bound for callers that poll `backlog` (the serving
        # loop): past about two refills of queued work there is no gain,
        # only held device memory.
        self.max_queue = 2 * n_slots if max_queue is None else max_queue
        self._queue: deque = deque()
        self._slot_req: List[Optional[int]] = [None] * n_slots
        self._next_id = 0
        self._failed: Dict[int, Exception] = {}
        self._pending: deque = deque()
        self.kvs = None
        self.n_chunks = 0          # dispatches

    def _reset_bookkeeping(self) -> None:
        self._queue.clear()
        self._slot_req = [None] * self.W
        self._failed.clear()
        self._pending = deque()    # views in flight, oldest first

    def _enqueue(self, request: Dict[str, Any], extra: tuple) -> int:
        rid = self._next_id
        self._next_id += 1
        self._queue.append((rid, request, extra))
        return rid

    def _check_limit(self, max_len: Optional[int]) -> int:
        limit = self.config.max_len if max_len is None else int(max_len)
        if not 0 < limit <= self.config.max_len:
            raise ValueError(f"max_len {limit} outside (0, "
                             f"{self.config.max_len}]")
        return limit

    @property
    def backlog(self) -> int:
        """Queued requests not yet in a slot: callers stop submitting
        while backlog >= max_queue (staged features hold device
        memory)."""
        return len(self._queue)

    @property
    def idle(self) -> bool:
        """Nothing queued and no slot decoding."""
        return not self._queue and all(r is None for r in self._slot_req)

    def drain_failed(self) -> Dict[int, Exception]:
        """Requests whose prep or insertion failed (a malformed shape)
        since the last drain; callers answer them as errors."""
        out, self._failed = self._failed, {}
        return out

    def stats(self) -> Dict[str, Any]:
        """Host-side counters, no device read (the worker's `_stats`
        RPC)."""
        return {
            "engine": type(self).__name__,
            "slots": self.W,
            "inner_steps": self.inner_steps,
            "harvest_lag": self.harvest_lag,
            "views_in_flight": len(self._pending),
            "busy_slots": sum(r is not None for r in self._slot_req),
            "backlog": self.backlog,
            "max_queue": self.max_queue,
            "n_chunks": self.n_chunks,
        }

    def _fill(self) -> None:
        for slot in [s for s, r in enumerate(self._slot_req) if r is None]:
            if not self._queue:
                break
            rid, request, extra = self._queue.popleft()
            try:
                kvs1 = self._prep(request)
                lead = {leaf.shape[0] for leaf in _leaves(kvs1)}
                if lead != {1}:
                    raise ValueError(
                        f"continuous batching takes B=1 requests; this "
                        f"request's context K/V have leading dims {lead} "
                        f"(split batched jobs into single requests)")
                sized_now = self.kvs is None
                if sized_now:
                    # The first request inserted sizes the pool's K/V and
                    # so fixes its context shapes; a later request of
                    # other shapes fails alone (serving fixes them with
                    # its warmup request).
                    self.kvs = _tree_map(
                        lambda one: torch.zeros((self.W,) + one.shape[1:],
                                                dtype=one.dtype,
                                                device=one.device), kvs1)
                try:
                    mismatch = [(tuple(big.shape[1:]), tuple(one.shape[1:]))
                                for big, one in zip(_leaves(self.kvs),
                                                    _leaves(kvs1))
                                if big.shape[1:] != one.shape[1:]]
                    if mismatch:
                        raise ValueError(
                            f"request context shapes differ from the "
                            f"pool's (pool, request): {mismatch[0]}")
                    self._insert_slot(slot, kvs1, extra)
                except Exception:
                    if sized_now:
                        # A malformed request never sizes the pool.
                        self.kvs = None
                    raise
            except Exception as e:   # fail the request, not the engine
                self._failed[rid] = e
                continue
            self._slot_req[slot] = rid

    @torch.inference_mode()
    def step(self) -> Dict[int, Tuple[np.ndarray, ...]]:
        """Refill free slots, dispatch `inner_steps` steps of every slot,
        then harvest the views `harvest_lag` dispatches old. Returns
        {request id: results} of the captions this call completed.

        A failed prep or insertion does not raise here: it goes to
        `drain_failed()`. A failed dispatch raises after `reset()`: the
        work in flight is lost, and the caller fails its requests and
        goes on serving."""
        self._fill()
        dispatched = False
        if any(r is not None for r in self._slot_req):
            try:
                self._dispatch_chunk()
            except Exception:
                self.reset()
                raise
            self.n_chunks += 1
            dispatched = True
        # Wait on the oldest views only once harvest_lag are in flight;
        # with nothing dispatched, flush them all.
        keep = self.harvest_lag - 1 if dispatched else 0
        out: Dict[int, Tuple[np.ndarray, ...]] = {}
        while len(self._pending) > keep:
            out.update(self._harvest(self._pending.popleft()))
        return out

    def run(self) -> Dict[int, Tuple[np.ndarray, ...]]:
        """`step()` until the queue and every slot drain; returns what
        this call decoded (a server calls `step()` and routes results
        itself)."""
        results: Dict[int, Tuple[np.ndarray, ...]] = {}
        while not self.idle:
            results.update(self.step())
        # The step that freed the last slot dispatched too; the views
        # still in flight belong to harvested requests.
        self._pending.clear()
        return results

    def _owned_done(self, owners, flags: np.ndarray):
        """(slot, request) of the view's finished slots that still hold
        the request they held when its dispatch ran (request ids are
        unique, so an older view of a refilled slot is skipped)."""
        for s, r in enumerate(owners):
            if r is not None and flags[s] and self._slot_req[s] == r:
                self._slot_req[s] = None
                yield s, r


class ContinuousBatcher(_SlotPool):
    """Greedy (optionally speculative) or top-k sampling slots.

    prep_fn(request) -> the request's context K/V (batch 1)
    chunk_fn(tokens [W, k], pos [W] int32, kvs, caches) -> (log_probs,
        ids, hs): output t the greedy next token given inputs 0..t
        (`DynamicConvDecoder.step_chunk`); the caches do not advance
    commit_fn(caches, hs, m [W], pos [W]) advances them in place
    init_caches_fn(W) -> the W slots' caches
    sample_step_fn(tokens [W], pos, kvs, caches) -> (log_probs [W, k],
        ids [W, k]), the exact top-k of one step at each slot's position,
        the caches advancing in place (sampling_topk > 1)
    clear_slot_fn(caches, slot) zeroes a slot's caches in place (default:
        the ring-major conv caches' rows)
    collect_flags: chunk_fn returns a fourth [W, k] bool tensor, a flag
        an output; results are then (tokens, log_probs, flags [max_len])
    `for_flattened` builds one over the flagship captioner, `for_pointer`
    over the pointer family.
    """

    def __init__(self, prep_fn: Callable, chunk_fn: Callable,
                 commit_fn: Callable, init_caches_fn: Callable,
                 config: GenerationConfig, n_slots: int, device,
                 inner_steps: int = 8, spec_k: int = 1,
                 source_len: int = 1, ngram_n: int = 2,
                 max_queue: Optional[int] = None,
                 sample_step_fn: Optional[Callable] = None,
                 harvest_lag: int = 1, collect_flags: bool = False,
                 clear_slot_fn: Optional[Callable] = None):
        super().__init__(config, n_slots, inner_steps, max_queue,
                         harvest_lag=harvest_lag)
        if spec_k < 1:
            raise ValueError("spec_k must be >= 1")
        self._sampling = config.sampling_topk > 1
        if self._sampling and spec_k > 1:
            raise ValueError("speculative decoding is greedy-only; "
                             "sampling_topk > 1 requires spec_k == 1")
        if self._sampling and sample_step_fn is None:
            raise ValueError("sampling_topk > 1 needs a sample_step_fn (a "
                             "top-k candidate step at each row's position)")
        if self._sampling and collect_flags:
            raise ValueError("collect_flags is greedy-only")
        self.collect_flags = collect_flags
        self._clear_slot = clear_slot_fn or _clear_conv_slot
        self.k = spec_k
        self.source_len = source_len
        self.ngram_n = ngram_n
        self.device = torch.device(device)
        self._prep = prep_fn
        self._chunk_fn = chunk_fn
        self._commit_fn = commit_fn
        self._sample_step_fn = sample_step_fn
        self._init_caches_fn = init_caches_fn
        self.n_committed = 0       # tokens committed over the slots
        self.n_slot_steps = 0      # W * inner_steps a dispatch
        self._buf = config.max_len + spec_k + 1
        self.reset()

    @torch.inference_mode()
    def reset(self) -> None:
        """A fresh pool. Drops everything in flight: queued requests and
        occupied slots are abandoned without results, and the caller
        fails them (`serving/worker.py` answers each with an error)."""
        cfg, W, dev = self.config, self.W, self.device
        self.tokens = torch.full((W, self._buf), cfg.pad_id,
                                 dtype=torch.long, device=dev)
        self.lps = torch.zeros(W, self._buf - 1, dtype=torch.float32,
                               device=dev)
        self.flags = torch.zeros(W, self._buf - 1, dtype=torch.bool,
                                 device=dev)
        self.pos = torch.zeros(W, dtype=torch.int32, device=dev)
        # An empty slot is finished: it commits nothing.
        self.finished = torch.ones(W, dtype=torch.bool, device=dev)
        self.limit = torch.full((W,), cfg.max_len, dtype=torch.int32,
                                device=dev)
        self.kvs = None                       # sized by the first insert
        self.caches = self._init_caches_fn(W)
        self.source = torch.full((W, self.source_len), cfg.pad_id,
                                 dtype=torch.long, device=dev)
        # Each sampling slot draws from its request's generator; an empty
        # slot from a spare one, whose draws are never read.
        spare = torch.Generator(device=dev).manual_seed(0)
        self.generators: List[Any] = [spare] * W
        self._arange_k = torch.arange(self.k, device=dev)[None, :]
        self._reset_bookkeeping()

    def submit(self, request: Dict[str, Any],
               source_row: Optional[np.ndarray] = None,
               max_len: Optional[int] = None,
               generator: Optional[Any] = None) -> int:
        """Queue one request (a batch-1 dict of contexts); returns its id,
        under which `step()` returns (tokens [max_len + 1], log_probs
        [max_len]) once it is decoded. source_row [S]: the request's
        draft source ids (speculative slots; pads, so no draft is ever
        accepted, when absent). max_len: the request's length cap (at
        most config.max_len). generator: what a sampling slot draws from
        (see `generation/generator.py::gumbel_noise`); by default a
        `torch.Generator` on the pool's device seeded with the request
        id. Raises for a cap outside (0, max_len] and queues nothing."""
        limit = self._check_limit(max_len)
        rid = self._enqueue(request, ())
        if generator is None and self._sampling:
            generator = torch.Generator(device=self.device).manual_seed(rid)
        self._queue[-1] = (rid, request, (source_row, limit, generator))
        return rid

    def _insert_slot(self, slot: int, kvs1, extra: tuple) -> None:
        source_row, limit, generator = extra
        cfg = self.config
        src = np.full((self.source_len,), cfg.pad_id, np.int64)
        if source_row is not None:
            row = np.asarray(source_row, np.int64).ravel()
            n = min(self.source_len, row.shape[0])
            src[:n] = row[:n]
        _tree_map(lambda big, one: big[slot].copy_(one[0]), self.kvs, kvs1)
        self._clear_slot(self.caches, slot)
        self.tokens[slot] = cfg.pad_id
        self.tokens[slot, 0] = cfg.bos_id
        self.lps[slot] = 0.0
        self.flags[slot] = False
        self.pos[slot] = 0
        self.finished[slot] = cfg.init_finished and cfg.bos_id == cfg.eos_id
        self.limit[slot] = limit
        self.source[slot] = torch.from_numpy(src).to(self.device)
        if generator is not None:
            self.generators[slot] = generator

    def _greedy_step(self) -> torch.Tensor:
        cfg = self.config
        cur = self.tokens.gather(1, self.pos.long()[:, None])      # [W, 1]
        drafts = None
        inp = cur
        if self.k > 1:
            drafts = ngram_drafts(self.source, self.tokens, self.pos,
                                  self.k - 1, n=self.ngram_n,
                                  pad_id=cfg.pad_id)
            inp = torch.cat([cur, drafts], dim=1)
        out = self._chunk_fn(inp, self.pos, self.kvs, self.caches)
        lp_c, ids, hs = out[:3]
        # The commit rule of speculative decoding, with each request's
        # cap in place of the global max_len.
        m, committed_eos = greedy_verify(ids, drafts, self.finished,
                                         self.pos, self.limit, cfg.eos_id)
        live = self._arange_k < m[:, None]
        write_rows(self.tokens, torch.where(live, ids, cfg.pad_id),
                   self.pos + 1)
        write_rows(self.lps, torch.where(live, lp_c.float(), 0.0), self.pos)
        if self.collect_flags:
            write_rows(self.flags, out[3] & live, self.pos)
        self._commit_fn(self.caches, hs, m, self.pos)
        self.pos += m
        self.finished |= committed_eos | (self.pos >= self.limit)
        return m.sum()

    def _sample_step(self) -> torch.Tensor:
        cfg = self.config
        cur = self.tokens.gather(1, self.pos.long()[:, None])[:, 0]
        lp_c, ids = self._sample_step_fn(cur, self.pos, self.kvs, self.caches)
        sel_lp, sel_ids = select_candidates(lp_c, ids, cfg, self.generators)
        live = ~self.finished
        next_tok = torch.where(live, sel_ids, cfg.pad_id)
        write_rows(self.tokens, next_tok[:, None], self.pos + 1)
        write_rows(self.lps, torch.where(live, sel_lp.float(), 0.0)[:, None],
                   self.pos)
        m = live.to(torch.int32)
        self.pos += m
        self.finished |= (next_tok == cfg.eos_id) | (self.pos >= self.limit)
        return m.sum()

    def _dispatch_chunk(self) -> None:
        step = self._sample_step if self._sampling else self._greedy_step
        committed = sum(step() for _ in range(self.inner_steps))
        L = self.config.max_len
        self.n_slot_steps += self.W * self.inner_steps
        # Take the slot owners as of this dispatch: by harvest time a
        # slot may have been freed and refilled.
        arrays = {"finished": self.finished, "tokens": self.tokens[:, :L + 1],
                  "lps": self.lps[:, :L], "committed": committed.reshape(1)}
        if self.collect_flags:
            arrays["flags"] = self.flags[:, :L]
        self._pending.append((list(self._slot_req), _HostView(arrays)))

    def _harvest(self, pending) -> Dict[int, Tuple[np.ndarray, ...]]:
        owners, view = pending
        view = view.numpy()        # the step's one wait on the device
        self.n_committed += int(view["committed"][0])
        extra = ("flags",) if self.collect_flags else ()
        return {r: tuple(view[k][s] for k in ("tokens", "lps") + extra)
                for s, r in self._owned_done(owners, view["finished"])}

    @property
    def occupancy(self) -> float:
        """Committed tokens a slot-step dispatched (1.0: every slot
        committed a token every step; speculative slots can pass 1)."""
        return (self.n_committed / self.n_slot_steps
                if self.n_slot_steps else 0.0)

    def stats(self) -> Dict[str, Any]:
        return {**super().stats(),
                "n_committed": self.n_committed,
                "occupancy": round(self.occupancy, 4),
                "spec_k": self.k,
                "sampling_topk": self.config.sampling_topk}

    @classmethod
    def for_flattened(cls, model, config: GenerationConfig, n_slots: int,
                      weights=None, inner_steps: int = 8, spec_k: int = 1,
                      source_len: int = 512, ngram_n: int = 2,
                      max_queue: Optional[int] = None,
                      harvest_lag: int = 1) -> "ContinuousBatcher":
        """An engine over a `TransformerFlattened` (the flagship and its
        variants): a request's K/V projected by `precompute_kv`, chunks
        through `DynamicConvDecoder.step_chunk` at each slot's position,
        commits by `commit_conv_caches`, sampling steps through
        `step_topk` at each slot's position. weights: the decoder's `decode_weights()`,
        computed here when not given. The config's int8 routes as
        `generate` takes them (see the module)."""
        dec = model.decoder
        model._check_max_len(config)
        if weights is None:
            weights = dec.decode_weights(config.quantize_head)
        device = next(dec.parameters()).device
        tables = model.head_tables(config, weights)

        def prep_fn(request):
            return dec.precompute_kv(model._contexts(request),
                                     config.quantize_kv)

        def chunk_fn(tokens, pos, kvs, caches):
            return dec.step_chunk(tokens, pos, kvs, caches, weights, tables)

        def sample_step_fn(tok, pos, kvs, caches):
            return dec.step_topk(tok, pos, kvs, caches,
                                 config.sampling_topk, weights,
                                 tables=tables)

        return cls(prep_fn, chunk_fn, commit_conv_caches,
                   lambda W: dec.init_cache(W, device), config, n_slots,
                   device, inner_steps=inner_steps, spec_k=spec_k,
                   source_len=source_len, ngram_n=ngram_n,
                   max_queue=max_queue, sample_step_fn=sample_step_fn,
                   harvest_lag=harvest_lag)

    @classmethod
    def for_pointer(cls, model, config: GenerationConfig, n_slots: int,
                    weights=None, inner_steps: int = 8, spec_k: int = 1,
                    source_len: int = 512, ngram_n: int = 2,
                    max_queue: Optional[int] = None,
                    harvest_lag: int = 1) -> "ContinuousBatcher":
        """An engine over a `TransformerPointer` (entity gate and copy
        head), greedy or speculative: a request's K/V, the copy head's
        keys, the article's ids and proper-noun relevance ride its slot
        (`pointer_tree`); the caches are the conv rings, entity K/V of
        max_len + max(spec_k, 1) rows and the [W, V] copied-token table
        (`pointer_caches`); chunks and commits are the pointer's own
        `pointer_chunk` / `pointer_commit`, shared with
        `generate_speculative`. Results are (tokens, log_probs,
        copied_flags). transformer_only_pointer has no copy gate: serve
        its captioner through `for_flattened`."""
        if config.sampling_topk != 1:
            raise ValueError("the pointer engine is greedy-only "
                             "(sampling_topk must be 1)")
        if not model.use_entity_head:
            raise ValueError("transformer_only_pointer has no copy gate; "
                             "use for_flattened on model.captioner")
        dec = model.decoder
        model._check_max_len(config)
        if weights is None:
            weights = dec.decode_weights()
        device = next(dec.parameters()).device

        def prep_fn(request):
            return model.pointer_tree(
                request, dec.precompute_kv(model._contexts(request)))

        def chunk_fn(tokens, pos, tree, caches):
            return model.pointer_chunk(tokens, pos, tree, caches,
                                       config.eos_id, weights)

        return cls(prep_fn, chunk_fn, model.pointer_commit,
                   lambda W: model.pointer_caches(
                       W, config.max_len + max(spec_k, 1), device),
                   config, n_slots, device, inner_steps=inner_steps,
                   spec_k=spec_k, source_len=source_len, ngram_n=ngram_n,
                   max_queue=max_queue, harvest_lag=harvest_lag,
                   collect_flags=True,
                   clear_slot_fn=model.clear_pointer_slot)

    @classmethod
    def for_tgnc(cls, model, config: GenerationConfig, n_slots: int,
                 weights=None, inner_steps: int = 8, spec_k: int = 1,
                 source_len: int = 512, ngram_n: int = 2,
                 max_queue: Optional[int] = None,
                 harvest_lag: int = 1) -> "ContinuousBatcher":
        """An engine over TGNC's template-guided decoder, greedy or
        speculative: a request's template logits (the classifier over
        its article and image) are computed once in prep and ride its
        slot beside its K/V (`TGNC.prep`); the trunk's and the heads'
        rings advance by `commit_conv_caches`; chunks go through
        `TemplateGuidedDecoder.step_chunk` at each slot's position.
        weights: the decoder's `decode_weights()`, computed here when
        not given. A TGNC without its template decoder is a flattened
        captioner: serve `model.captioner` through `for_flattened`."""
        if config.sampling_topk != 1:
            raise ValueError("the tgnc engine is greedy-only "
                             "(sampling_topk must be 1)")
        if not model.use_template_decoder:
            raise ValueError("this TGNC has no template decoder; use "
                             "for_flattened on model.captioner")
        dec = model.tg_decoder
        model._check_max_len(config)
        if weights is None:
            weights = dec.decode_weights()
        device = next(dec.parameters()).device

        def chunk_fn(tokens, pos, tree, caches):
            return dec.step_chunk(tokens, pos, tree["kvs"], caches,
                                  tree["template_logits"], weights)

        return cls(model.prep, chunk_fn, commit_conv_caches,
                   lambda W: dec.init_cache(W, device), config, n_slots,
                   device, inner_steps=inner_steps, spec_k=spec_k,
                   source_len=source_len, ngram_n=ngram_n,
                   max_queue=max_queue, harvest_lag=harvest_lag)

    @classmethod
    def for_gen2(cls, model, config: GenerationConfig, n_slots: int,
                 weights=None, inner_steps: int = 8, spec_k: int = 1,
                 source_len: int = 512, ngram_n: int = 2,
                 max_queue: Optional[int] = None,
                 harvest_lag: int = 1) -> "ContinuousBatcher":
        """An engine over a `Gen2Captioner`, greedy or speculative: a
        request's memory K/V of every layer ride its slot, the article's
        padding in their key bias; the caches are the self-attention K/V
        of max_len + spec_k slots, which `Gen2Transformer.step_chunk`
        writes at each slot's positions, so the chunk's writes are the
        commit (a slot attends no slot past its position); a refilled
        slot's rows are zeroed. weights: the model's `decode_weights()`,
        computed here when not given."""
        if config.sampling_topk != 1:
            raise ValueError("continuous batching is greedy-only "
                             "(sampling_topk must be 1)")
        module = model.module
        model._check_max_len(config)
        if weights is None:
            weights = model.decode_weights()
        device = module.embed.embedding.device

        def chunk_fn(tokens, pos, kvs, caches):
            lp, ids = module.step_chunk(tokens, pos, kvs, caches, weights)
            return lp, ids, None

        def commit_fn(caches, hs, m, pos):
            """The chunk's cache writes are the commit."""

        def clear_slot(caches, slot):
            for k_c, v_c in caches:
                k_c[slot].zero_()
                v_c[slot].zero_()

        return cls(model.prep, chunk_fn, commit_fn,
                   lambda W: module.init_cache(
                       W, config.max_len + max(spec_k, 1), device),
                   config, n_slots, device, inner_steps=inner_steps,
                   spec_k=spec_k, source_len=source_len, ngram_n=ngram_n,
                   max_queue=max_queue, harvest_lag=harvest_lag,
                   clear_slot_fn=clear_slot)


def _clear_conv_slot(caches: List[torch.Tensor], slot: int) -> None:
    for cache in caches:
        cache[:, slot].zero_()


class ContinuousBeamBatcher(_SlotPool):
    """Exact beam search from the slot pool: W slots of K = beam_size
    rows each, flat row r in slot r // K. Each slot's rows step at the
    slot's depth (`DynamicConvDecoder.step_topk`, the slot's context
    K/V shared by its beams); the combine, the reorder of the four ring
    caches (`index_select` on the flat rows, so no row leaves its slot)
    and the final ranking are `generate_beam`'s own. A done slot (every
    beam finished, or its cap reached) is frozen until harvested.
    Freeze-in-slot semantics only, as in the reference."""

    def __init__(self, model, config: GenerationConfig, n_slots: int,
                 weights=None, inner_steps: int = 8,
                 max_queue: Optional[int] = None, harvest_lag: int = 1):
        super().__init__(config, n_slots, inner_steps, max_queue,
                         harvest_lag=harvest_lag)
        model._check_max_len(config)
        if config.harvest_finished:
            raise ValueError("continuous beam implements the default "
                             "freeze-in-slot semantics (the Gen-1 done-list "
                             "mode is generate_beam-only)")
        self.model = model
        self.K = config.beam_size
        dec = model.decoder
        self.weights = weights if weights is not None else \
            dec.decode_weights(config.quantize_head)
        # The int8 head tables, once at engine build (quantize_head).
        self.tables = model.head_tables(config, self.weights)
        self.device = next(dec.parameters()).device
        self.reset()

    def _prep(self, request):
        return self.model.decoder.precompute_kv(
            self.model._contexts(request), self.config.quantize_kv)

    @torch.inference_mode()
    def reset(self) -> None:
        """A fresh pool; abandons all work in flight (see
        `ContinuousBatcher.reset`)."""
        W, K, L, dev = self.W, self.K, self.config.max_len, self.device
        pad = self.config.pad_id
        self.tokens = torch.full((W * K, L + 1), pad, dtype=torch.long,
                                 device=dev)
        self.scores = torch.full((W * K,), NEG_INF, dtype=torch.float32,
                                 device=dev)
        self.pos = torch.zeros(W, dtype=torch.int32, device=dev)
        self.finished = torch.zeros(W * K, dtype=torch.bool, device=dev)
        self.done = torch.ones(W, dtype=torch.bool, device=dev)   # frozen
        self.limit = torch.full((W,), L, dtype=torch.int32, device=dev)
        self.kvs = None
        self.caches = self.model.decoder.init_cache(W * K, dev)
        self._spare = [torch.empty_like(c) for c in self.caches]
        self._reset_bookkeeping()

    def submit(self, request: Dict[str, Any],
               max_len: Optional[int] = None) -> int:
        """Queue one batch-1 request; `step()` returns (tokens
        [beam, max_len + 1], scores [beam]), best first, under the
        returned id."""
        return self._enqueue(request, (self._check_limit(max_len),))

    def stats(self) -> Dict[str, Any]:
        return {**super().stats(), "beam_size": self.K}

    def _insert_slot(self, slot: int, kvs1, extra: tuple) -> None:
        (limit,) = extra
        cfg, K = self.config, self.K
        rows = slice(slot * K, (slot + 1) * K)
        _tree_map(lambda big, one: big[slot].copy_(one[0]), self.kvs, kvs1)
        for cache in self.caches:
            cache[:, rows].zero_()
        self.tokens[rows] = cfg.pad_id
        self.tokens[rows, 0] = cfg.bos_id
        # Only beam 0 is live at the start (the beams are all the same).
        self.scores[rows] = NEG_INF
        self.scores[slot * K] = 0.0
        self.finished[rows] = cfg.init_finished and cfg.bos_id == cfg.eos_id
        self.pos[slot] = 0
        self.done[slot] = False
        self.limit[slot] = limit

    def _beam_step(self) -> None:
        cfg, W, K = self.config, self.W, self.K
        pos_rows = self.pos.repeat_interleave(K)                  # [W*K]
        freeze = self.done.repeat_interleave(K)
        cur = self.tokens.gather(1, pos_rows.long()[:, None])[:, 0]
        rv, ri = self.model.decoder.step_topk(
            cur, pos_rows, self.kvs, self.caches, K, self.weights, beam=K,
            tables=self.tables)
        scores, tok, flat_src = beam_combine(self.scores, rv, ri,
                                             self.finished, W, K, cfg.pad_id)
        tokens = self.tokens.index_select(0, flat_src)
        for j, cache in enumerate(self.caches):
            torch.index_select(cache, 1, flat_src, out=self._spare[j])
            self.caches[j], self._spare[j] = self._spare[j], cache
        finished = self.finished[flat_src]
        write_rows(tokens, tok[:, None], pos_rows + 1)
        finished |= (tok == cfg.eos_id) & ~finished
        # A frozen slot (done, awaiting harvest, or empty) keeps its
        # tokens, scores and flags through the combine's reorders.
        self.tokens = torch.where(freeze[:, None], self.tokens, tokens)
        self.scores = torch.where(freeze, self.scores, scores)
        self.finished = torch.where(freeze, self.finished, finished)
        self.pos += (~self.done).to(torch.int32)
        self.done |= (self.finished.view(W, K).all(dim=1)
                      | (self.pos >= self.limit))

    def _dispatch_chunk(self) -> None:
        for _ in range(self.inner_steps):
            self._beam_step()
        W, K, L = self.W, self.K, self.config.max_len
        # Every slot ranked each dispatch: small beside the steps.
        tokens, scores = rank_beams(self.tokens.view(W, K, L + 1),
                                    self.scores.view(W, K),
                                    self.config.pad_id,
                                    self.config.length_penalty)
        self._pending.append((list(self._slot_req), _HostView({
            "done": self.done, "tokens": tokens, "scores": scores})))

    def _harvest(self, pending) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
        owners, view = pending
        view = view.numpy()        # the step's one wait on the device
        return {r: (view["tokens"][s], view["scores"][s])
                for s, r in self._owned_done(owners, view["done"])}
