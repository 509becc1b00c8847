#!/usr/bin/env python3
"""Smoke run of the PyTorch port (news_image_caption_tpu_torch) on one
NVIDIA GPU.

Phases, each fatal on failure (exit code 1, no result line):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from news_image_caption_tpu_torch/csrc/;
  3. hold every kernel against its plain PyTorch version on the card at
     the flagship's shapes (bf16; decode shapes for the decode kernels,
     1 to 640 rows (a beam-5 step at B=128) and up to 128 items of five
     queries, every tap count and tied logits for the head and the conv
     block; train-step shapes for flash attention, then its ragged
     tiles, T = 128 over S' = 514 and an item with every key padded), and
     time both, the library's call and an empty launch with CUDA events;
     the four decode kernels twice over: a greedy step's shapes and a
     beam-5 step's at B=16 (80 rows, five queries an item), the latter
     printed as the `beam5_step_b16` JSON line;
  4. serve requests through `flagship_model_builder` at full flagship
     width in bf16 with seeded random weights: three single requests,
     then one of 16 rows. Check the tokens, that every kernel's launch
     count rose by its count per decode step, and the kernel path
     against the plain path (the same weights on the CPU);
  4b. beam-5 search through `TransformerFlattened.generate_beam` with
     the same model and weights, max_len 32 and early exit, at B=16
     (80 rows) and B=128 (640 rows). Check the tokens ([B, 5, 33], bos
     first, ids in the vocab, pad after eos) and the scores (finite,
     best first), that every decode kernel's launches equal its plan's
     count a step times the steps run, each beam's score times
     len^alpha against its tokens re-scored by teacher forcing on the
     card, step 0's candidates against the plain path on the CPU and,
     at B=16, the beams' first tokens of 8-step searches too. Then two
     B=16 searches, early exit and harvest, on a copy of the model
     whose eos row is raised so that its beams finish: the early-exit
     loop stops before max_len, every returned beam ends in eos and the
     beams end at different steps, launches and teacher forcing as
     above. Print request ms, captions/s and device ms a step
     (the `beam5_requests` JSON line, a smoke reading);
  5. train through `flagship_trainer_builder` at full flagship width,
     bf16_o2 with the YAML's dropouts and random weights: 20 steps on
     one synthetic batch of 16. Check that every loss is finite and the
     last is below the first, that no step was skipped, that the flash
     forward and backward ran 8 times a step (4 layers x 2 contexts),
     and the kernel path's deterministic loss against the plain path's
     (the same weights on the CPU); print ms/step, samples/s, peak
     device memory and the flash kernels' share of device time;
  6. the dynamic conv kernel at B=16, T=512, C=1024, H=16 and each of
     the flagship's layer widths K = 3/7/15/31 against its plain
     version within `dynamic_conv_tolerance` (its fused sums' bound plus
     one bf16 unit) and bit for bit (a product of two bf16 values is
     exact in fp32), a second call bit-equal to the first, timed beside
     the plain version, the module's shift and band routes (the faster
     is `library_ms`) and the byte floor; then
     `DynamicConv(method="pallas")` at full flagship width with seeded
     weights: one launch per forward at T=512 (the output against the
     same module on the CPU), none at T=63 (the output equal to the
     shift route's), and a backward that raises;
  7. the evaluate command, `news_image_caption_tpu_torch.cli.main(
     ["evaluate", "configs/goodnews_transformer_roberta.yaml", "--split",
     "test", "--dump-attention", DIR])` with its serialization directory
     in a temporary directory: the flagship in bf16 with random weights
     (the command's own init), the split's 256 records in batches of 16,
     max_len 100, articles padded to 512. Check the files
     (generations.jsonl: 256 enriched records, `checkdiff.
     integrity_check` passes; evaluate-metrics.json: finite BLEU-1..4,
     CIDEr, ROUGE-L; `compute_metrics` over the generations returns its
     keys; every dumped attention row sums to 1 within 1e-2), that every
     decode kernel's launches rose by its count a step (3 / 8 / 4 / 4)
     times the decode steps of all batches, and the first batch against
     the plain path on the CPU (the same weights, rebuilt; its tokens
     first equal to the command's): step-0 log-probs within 0.1, step-0
     tokens agreeing >= 0.75. Print the command's wall seconds, its
     host-clock spans, captions/s and the device ms a step of one
     profiled batch (the `evaluate` JSON line).
The line before the last is a JSON summary of the kernels (`launches`
over the main paths, `launches_by_path` split by path); the last is
{"ok": true, "device": {...}}.

Run from the repository root: python3 chip_smoke.py

`python3 chip_smoke.py --serving-latency N` instead measures the
flagship's request latency over N requests, greedy at B=1 and B=16 and
beam-5 at B=16 and B=128, and profiles one request of each (see
`latency_mode`); it prints no result line.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(res.returncode == 0 and res.stdout.strip() != "",
          f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of fn() on the card, L2-cold: CUDA
    events around each call, with a 128 MB buffer overwritten before
    it. A flagship decode step reads 260 MB (B=1) to 400 MB (B=16) of
    weights and context K/V, five to eight times the 50 MB L2, so the
    main path finds each kernel's operands in device memory. A spin of
    about 1 ms on the card after the overwrite lets the host enqueue
    all of fn() before the start event fires, so the host's time in
    the wrapper stays out of the reading."""
    import torch
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)       # clock cycles
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def within(got, want, atol: float, rtol: float):
    """(max |got - want|, whether |got - want| <= atol + rtol |want|)."""
    d = (got.float() - want.float()).abs()
    return d.max().item(), bool((d <= atol + rtol * want.float().abs()).all())


HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)
PEAK_OPS_PER_S = {"bf16": 989e12,  # dense tensor-core rate, bf16 inputs
                  "fp32": 67e12}   # fp32 outside the tensor cores


class Tally:
    """One kernel's entry of the `kernels` line, summed over the calls
    of one step: the largest error, the kernel's, the plain version's
    and the library call's device times, and the bound (the larger of
    the bytes every input and output holds over the card's memory rate
    and the operations over the card's peak rate for their type)."""

    def __init__(self, rate: str = "bf16"):
        self.rate = rate
        self.errs = []
        self.ms = self.plain_ms = self.bytes_ms = self.ops_ms = 0.0
        self.library_ms = None

    def add(self, tensors, ops: float, ms: float, plain_ms: float,
            library_ms=None, calls: int = 1) -> str:
        """Count `calls` calls that move `tensors` once each and do
        `ops` operations; returns a line for the log."""
        nbytes = sum(t.numel() * t.element_size() for t in tensors)
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        o_ms = ops / PEAK_OPS_PER_S[self.rate] * 1e3
        self.ms += calls * ms
        self.plain_ms += calls * plain_ms
        self.bytes_ms += calls * b_ms
        self.ops_ms += calls * o_ms
        line = (f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound"
                f" {max(b_ms, o_ms):.4f} ms ({nbytes / 1e6:.2f} MB,"
                f" {ops / 1e6:.0f} MFLOP)")
        if library_ms is not None:
            self.library_ms = (self.library_ms or 0.0) + calls * library_ms
            line += f", library {library_ms:.4f} ms"
        return line

    def result(self) -> dict:
        return dict(max_abs_err=max(self.errs), ms=self.ms,
                    plain_ms=self.plain_ms,
                    bound_ms=max(self.bytes_ms, self.ops_ms),
                    bound_by=("bytes" if self.bytes_ms >= self.ops_ms
                              else "operations"),
                    library_ms=self.library_ms)


def sdpa(torch, q, k, v, bias, H: int, dropout_p: float = 0.0):
    """The library yardstick of the attention kernels: PyTorch's
    scaled_dot_product_attention on [B, H, Q, dh] views, the key bias
    as an additive mask, scale 1 (q is pre-scaled), the heads gathered
    into [B, Q, E] as the kernels write them. Timed here only; the port
    never calls it."""
    B, Q, E = q.shape
    S = k.shape[1]
    heads = lambda t, n: t.view(B, n, H, E // H).transpose(1, 2)
    return torch.nn.functional.scaled_dot_product_attention(
        heads(q, Q), heads(k, S), heads(v, S),
        attn_mask=bias.to(q.dtype)[:, None, None, :], dropout_p=dropout_p,
        scale=1.0).transpose(1, 2).reshape(B, Q, E)


def kernel_phase(torch, ops):
    """Phase 3. Returns two {kernel: dict(max_abs_err, ms, plain_ms,
    bound_ms, bound_by, library_ms)}, the times summed over one decode
    step at batch 16 (all layers): a greedy step (16 rows, one query an
    item) and a beam-5 step (80 rows, five queries an item)."""
    band, xattn, blocks, _build = ops
    F_ = torch.nn.functional
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(bf16)

    N, D, H, F = 16, 1024, 16, 4096
    NB = 5 * N                   # the rows of a beam-5 step at B=16
    NB128 = 5 * 128              # and at B=128, held but not timed
    results = {}
    beam = {name: Tally() for name in ("band_topk_lse",
                                       "decode_cross_attention",
                                       "decode_conv_block",
                                       "decode_ffn_block")}

    # An empty kernel's launch under the same method: the fixed cost in
    # every time below.
    empty = _build.function("nic_empty_launch", [_build.P])
    stream = torch.cuda.current_stream().cuda_stream
    print(f"  empty kernel launch: {time_ms(lambda: empty(stream)):.4f} ms"
          " (CUDA events, after the L2 flush and the spin)", flush=True)

    # band_topk_lse: the head band [table0; class_projᵀ] (5002 rows,
    # selectable below 5000), the two tails and two ragged single tiles,
    # at 1, 16, 80 and 640 (beam-5 steps at B=16 and B=128) rows. Tolerance: one bf16
    # rounding of a logit of magnitude < 8 (2^-5 = 0.03125), for the
    # values and for the plain logit at each id the kernel chose.
    # Library yardstick, a chain of three calls: the bf16 product,
    # logsumexp, topk. The greedy tally's times are N = 16, k = 1; the
    # beam tally's N = 80, k = 5.
    tally = results["band_topk_lse"] = Tally()
    for V, sel in ((5002, 5000), (15000, 15000), (30265, 30265), (63, 63),
                   (65, 60)):
        table = rn(V, D, scale=D ** -0.5)
        for n in (1, N, NB, NB128):
            x = rn(n, D)
            logits = (x.float() @ table.float().T).to(bf16).float()
            worst = [0.0, 0.0, 0.0, 1.0]
            for k in (1, 5, 16):
                kv, ki, kl = band.band_topk_lse(x, table, k, sel)
                again = band.band_topk_lse(x, table, k, sel)
                pv, pi, pl = band.band_topk_lse_plain(x, table, k, sel)
                torch.cuda.synchronize()
                e_v, ok_v = within(kv, pv, 0.03125, 0.0)
                e_l, ok_l = within(kl, pl, 1e-3, 1e-4)
                at_ids = torch.gather(logits, 1, ki.long())
                e_i, ok_i = within(at_ids, pv, 0.03125, 0.0)
                agree = (ki == pi).float().mean().item()
                ok_sel = bool((ki < sel).all()) and bool((ki >= 0).all())
                same = all(torch.equal(a, b)
                           for a, b in zip((kv, ki, kl), again))
                check(ok_v and ok_l and ok_i and ok_sel,
                      f"band_topk_lse V={V} N={n} k={k} disagrees with its"
                      " plain twin")
                check(same, f"band_topk_lse V={V} N={n} k={k}: two calls on"
                      " the same inputs differ")
                worst = [max(worst[0], e_v), max(worst[1], e_l),
                         max(worst[2], e_i), min(worst[3], agree)]
                if n == N:
                    tally.errs += [e_v, e_l]
                if n == NB and k == 5:
                    beam["band_topk_lse"].errs += [e_v, e_l]
                    out5 = (kv, ki, kl)
            print(f"  band_topk_lse V={V} sel={sel} N={n} k=1/5/16: values"
                  f" {worst[0]:.3g}, lse {worst[1]:.3g}, plain logit at chosen"
                  f" ids {worst[2]:.3g} (tol 0.03125 / 1e-3+1e-4|lse| /"
                  f" 0.03125), ids equal {worst[3]:.3f}, repeated calls"
                  " bit-equal", flush=True)

            def library(k=1, x=x):
                lg = x @ table.T
                return (torch.logsumexp(lg.float(), -1),
                        torch.topk(lg[:, :sel], k))
            if n == N and V > 1000:
                line = tally.add(
                    (x, table, kv[:, :1], ki[:, :1], kl), 2.0 * N * V * D,
                    time_ms(lambda: band.band_topk_lse(x, table, 1, sel)),
                    time_ms(lambda: band.band_topk_lse_plain(x, table, 1,
                                                             sel)),
                    time_ms(library))
                print(f"    time N={N} k=1: {line}")
                t5 = time_ms(lambda: band.band_topk_lse(x, table, 5, sel))
                print(f"    time N={N} k=5: kernel {t5:.4f} ms, library"
                      f" {time_ms(lambda: library(5)):.4f} ms")
            if n == NB and V > 1000:
                line = beam["band_topk_lse"].add(
                    (x, table, *out5), 2.0 * NB * V * D,
                    time_ms(lambda: band.band_topk_lse(x, table, 5, sel)),
                    time_ms(lambda: band.band_topk_lse_plain(x, table, 5,
                                                             sel)),
                    time_ms(lambda: library(5)))
                print(f"    time N={NB} k=5 (a beam-5 step at B=16): {line}")
    # Ties: copies of one row in one tile, in two tiles of one block and
    # in other blocks; x is that row, so the copies are the largest
    # logits. The ids must be the plain version's exactly, lowest first.
    V, src, copies = 30265, 20000, [7, 70, 64 * 132 + 5, 64 * 133 + 9, 19999,
                                    30264]
    table = rn(V, D, scale=D ** -0.5)
    table[copies] = table[src].clone()
    x = (table[src] * 8).expand(N, D).contiguous()
    kv, ki, _ = band.band_topk_lse(x, table, 7)
    pv, pi, _ = band.band_topk_lse_plain(x, table, 7)
    torch.cuda.synchronize()
    check(ki.tolist() == [sorted(copies + [src])] * N
          and bool(torch.equal(ki, pi)),
          f"band_topk_lse: tied logits did not go to the lowest ids:"
          f" {ki[0].tolist()} against {pi[0].tolist()}")
    print(f"  band_topk_lse ties (7 equal rows over tiles and blocks): ids"
          f" {ki[0].tolist()} equal to the plain version's", flush=True)

    # decode_cross_attention: article (S' = 514) and image (S' = 51)
    # contexts, padded keys masked with -1e9. Tolerance 0.02 abs + 0.02
    # rel: one bf16 rounding of a probability or the output. The timed
    # calls are a greedy step's (Q = 1, B = 16) and a beam-5 step's
    # (Q = 5, B = 16), one per layer and context, and B = 1 for the log;
    # a beam-5 step at B = 128 (Q = 5) is held, not timed. Library
    # yardstick: scaled_dot_product_attention.
    tally = results["decode_cross_attention"] = Tally()

    def attention_case(B, Q, S, timed=None, one_key=False):
        k_, v_ = rn(B, S, D), rn(B, S, D)
        bias = torch.zeros(B, S, device=dev)
        bias[B // 2:, S // 2:S - 2] = -1e9      # padded context slots
        if one_key:                             # item 0 sees one key only
            bias[0] = -1e9
            bias[0, S // 3] = 0.0
        q = rn(B, Q, D, scale=0.125)
        got = xattn.decode_cross_attention(q, k_, v_, bias, H)
        again = xattn.decode_cross_attention(q, k_, v_, bias, H)
        want = xattn.decode_cross_attention_plain(q, k_, v_, bias, H)
        torch.cuda.synchronize()
        e, ok = within(got, want, 0.02, 0.02)
        same = bool(torch.equal(got, again))
        print(f"  decode_cross_attention B={B} Q={Q} S'={S}"
              f"{' (item 0: one key unmasked)' if one_key else ''}: {e:.3g}"
              f" (tol 0.02 + 0.02|ref|), repeated call bit-equal {same}",
              flush=True)
        check(ok, f"decode_cross_attention B={B} Q={Q} S'={S} disagrees")
        check(same, f"decode_cross_attention B={B} Q={Q} S'={S}: two calls"
              " on the same inputs differ")
        tally.errs.append(e)
        if timed is not None:
            timed.errs.append(e)
            line = timed.add(
                (q, k_, v_, bias, got), 4.0 * B * Q * S * D,
                time_ms(lambda: xattn.decode_cross_attention(q, k_, v_, bias,
                                                             H)),
                time_ms(lambda: xattn.decode_cross_attention_plain(
                    q, k_, v_, bias, H)),
                time_ms(lambda: sdpa(torch, q, k_, v_, bias, H)),
                calls=4 if B == N else 0)
            print(f"    time B={B} Q={Q}: {line}")

    for S in (514, 51):
        attention_case(N, 1, S, timed=tally)
        attention_case(N, 5, S, timed=beam["decode_cross_attention"])
        attention_case(128, 5, S)
        attention_case(N, 16, S)
        attention_case(1, 1, S, timed=tally)
        attention_case(1, 5, S)
        attention_case(1, 16, S)
    for S in (1, 63, 65):
        attention_case(N, 1, S)
        attention_case(1, 16, S)
    attention_case(N, 5, 514, one_key=True)
    attention_case(1, 1, 51, one_key=True)

    # decode_conv_block: K = 2/3/7/15/31 at 1, 5, 16, 80 and 640 rows, at t
    # before, at and past the ring filling. Tolerance 0.02 (h) and 0.05
    # (y) abs + rel, the reference tests' bf16 tolerances. The tallies'
    # times are N = 16 (greedy) and N = 80 (beam) at the flagship's K =
    # 3/7/15/31, the taps packed once as the model does. Library
    # yardstick, a chain in bf16: linear, glu, linear, softmax, gather +
    # einsum, linear, add.
    tally = results["decode_conv_block"] = Tally()
    w1, b1 = rn(D, 2 * D, scale=D ** -0.5), rn(2 * D, scale=0.05)
    w2, b2 = rn(D, D, scale=D ** -0.5), rn(D, scale=0.05)
    for K in (2, 3, 7, 15, 31):
        wl = rn(D, H * K, scale=0.05)
        taps = blocks.pack_taps(wl, H)
        for n in (1, 5, N, NB, NB128):
            x = rn(n, D)
            cache = rn(K - 1, n, D, scale=0.5)
            worst = [0.0, 0.0]
            for t in (0, K - 2, 2 * K + 3):
                args = (x, cache, t, w1, b1, wl, w2, b2, H)
                y, h = blocks.decode_conv_block(*args, taps=taps)
                y2, h2 = blocks.decode_conv_block(*args, taps=taps)
                py, ph = blocks.decode_conv_block_plain(*args)
                torch.cuda.synchronize()
                e_h, ok_h = within(h, ph, 0.02, 0.02)
                e_y, ok_y = within(y, py, 0.05, 0.05)
                check(ok_h and ok_y,
                      f"decode_conv_block N={n} K={K} t={t} disagrees")
                check(bool(torch.equal(y, y2)) and bool(torch.equal(h, h2)),
                      f"decode_conv_block N={n} K={K} t={t}: two calls on"
                      " the same inputs differ")
                worst = [max(worst[0], e_h), max(worst[1], e_y)]
                if n in (N, NB):
                    (tally if n == N else beam["decode_conv_block"]).errs += [
                        e_h, e_y]
            print(f"  decode_conv_block N={n} K={K} t=0/{K - 2}/{2 * K + 3}:"
                  f" h {worst[0]:.3g}, y {worst[1]:.3g} (tol 0.02 / 0.05, abs"
                  " + rel), repeated calls bit-equal", flush=True)
            if n not in (N, NB) or K == 2:
                continue
            slots = (t + torch.arange(K - 1, device=dev)) % (K - 1)

            def library():
                hh = F_.glu(F_.linear(x, w1.T, b1), dim=-1)
                p = torch.softmax(F_.linear(hh, wl.T).view(n, H, K), dim=-1)
                hist = torch.cat([cache[slots], hh[None]]).view(K, n, H, D // H)
                conv = torch.einsum("nhk,knhr->nhr", p, hist).reshape(n, D)
                return F_.linear(conv, w2.T, b2) + x, hh
            line = (tally if n == N else beam["decode_conv_block"]).add(
                (x, cache, w1, b1, wl, w2, b2, y, h),
                2.0 * n * D * (2 * D + H * K + D) + 2.0 * n * D * K,
                time_ms(lambda: blocks.decode_conv_block(*args, taps=taps)),
                time_ms(lambda: blocks.decode_conv_block_plain(*args)),
                time_ms(library))
            print(f"    time N={n} K={K}: {line}")

    # decode_ffn_block at N = 640, 80, 16, 5 and 1 rows. Tolerance 0.02
    # abs + rel. The timed calls are N = 16 (greedy) and N = 80 (beam,
    # five launches of 16 rows in the call), one per layer; N = 640 (40
    # launches) is held, not timed. Library yardstick,
    # a chain of four calls in bf16: linear, relu, linear, add.
    tally = results["decode_ffn_block"] = Tally()
    f1, fb1 = rn(D, F, scale=D ** -0.5), rn(F, scale=0.05)
    f2, fb2 = rn(F, D, scale=F ** -0.5), rn(D, scale=0.05)
    x = rn(NB128, D)
    for n in (NB128, NB, N, 5, 1):
        args = (x[:n].contiguous(), f1, fb1, f2, fb2)
        y = blocks.decode_ffn_block(*args)
        again = blocks.decode_ffn_block(*args)
        py = blocks.decode_ffn_block_plain(*args)
        torch.cuda.synchronize()
        e, ok = within(y, py, 0.02, 0.02)
        same = bool(torch.equal(y, again))
        print(f"  decode_ffn_block N={n} C={D} F={F}: {e:.3g} (tol 0.02 +"
              f" 0.02|ref|), repeated call bit-equal {same}", flush=True)
        check(ok, f"decode_ffn_block N={n} disagrees with its plain twin")
        check(same, f"decode_ffn_block N={n}: two calls on the same inputs"
              " differ")
        if n == NB128:
            continue
        into = beam["decode_ffn_block"] if n == NB else tally
        into.errs.append(e)
        if n in (NB, N, 1):
            xs = args[0]
            line = into.add(
                (*args, y), 4.0 * n * D * F,
                time_ms(lambda: blocks.decode_ffn_block(*args)),
                time_ms(lambda: blocks.decode_ffn_block_plain(*args)),
                time_ms(lambda: F_.linear(torch.relu(
                    F_.linear(xs, f1.T, fb1)), f2.T, fb2) + xs),
                calls=0 if n == 1 else 4)
            print(f"    time N={n}: {line}")
    return ({name: t.result() for name, t in results.items()},
            {name: t.result() for name, t in beam.items()})


def flash_phase(torch, flash):
    """Phase 3, flash attention. The dropout mask against the plain
    generator; then the flagship train step's shapes, timed: q
    [16, 63, 1024] (pre-scaled), k/v [16, S', 1024] with S' = 514
    (article) and 51 (image), half the items padded, p = 0.1 and one
    seed, so kernel and plain version draw the same mask; then ragged
    query and key tiles, T = 128 over S' = 514 included, with an item
    whose keys are all padded. Every case is held against the plain
    versions and repeated bit for bit. Returns {kernel: dict(max_abs_err,
    ms, plain_ms, bound_ms, bound_by, library_ms)}: the largest error at
    the train step's shapes and the times summed over one train step's
    calls (4 layers x 2 contexts). Library yardstick:
    scaled_dot_product_attention with dropout_p = 0.1, and its backward
    through autograd."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    bf16 = torch.bfloat16

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(bf16)

    # The mask itself: v = I in every head makes the output the dropped
    # probability matrix, so its zeros are the dropped slots. One tile,
    # then three T tiles and two key tiles in two heads.
    seed = torch.tensor([5], dtype=torch.int32, device=dev)
    for B, T, S, H in ((2, 8, 64, 1), (2, 130, 128, 2)):
        eye = torch.eye(S, device=dev, dtype=bf16).repeat(B, 1, H)
        out, _ = flash.flash_attention_fwd(
            rn(B, T, H * S, scale=0.3), rn(B, S, H * S), eye,
            torch.zeros(B, S, device=dev), seed, H, 0.25)
        keep = flash.dropout_keep(seed, B, H, T, S, 0.25)
        kept = (out.float() > 0).view(B, T, H, S).transpose(1, 2)
        same = bool(torch.equal(kept, keep))
        print(f"  flash dropout mask T={T} S'={S} H={H}, kernel vs plain"
              f" generator: identical {same}, kept"
              f" {keep.float().mean().item():.4f} (p = 0.25)", flush=True)
        check(same, "the flash kernel's dropout mask differs from the plain"
              " one")

    E, H, p = 1024, 16, 0.1
    seed = torch.tensor([1234], dtype=torch.int32, device=dev)
    res = {"flash_attention_fwd": Tally(), "flash_attention_bwd": Tally()}

    def flash_case(B, T, S, timed=False):
        # q as the layer gives it: unit-scale projections times 64^-0.5.
        q, k, v = rn(B, T, E, scale=0.125), rn(B, S, E), rn(B, S, E)
        g = rn(B, T, E, scale=0.1)
        bias = torch.zeros(B, S, device=dev)
        bias[B // 2:, S // 2:max(S - 2, S // 2)] = -1e9
        if not timed:
            bias[0] = -1e9                  # an item with every key padded
        fargs = (q, k, v, bias, seed, H, p)
        out, lse = flash.flash_attention_fwd(*fargs)
        grads = flash.flash_attention_bwd(q, k, v, bias, seed, lse, g, H, p)
        out2, lse2 = flash.flash_attention_fwd(*fargs)
        grads2 = flash.flash_attention_bwd(q, k, v, bias, seed, lse, g, H, p)
        torch.cuda.synchronize()
        pout, plse = flash.flash_attention_fwd_plain(*fargs)
        pgrads = flash.flash_attention_bwd_plain(q, k, v, bias, seed, plse,
                                                 g, H, p)
        # out: one bf16 rounding of a probability or of the output (0.02
        # abs + rel); lse fp32 (1e-3 + 1e-5 rel); gradients: a bf16
        # rounding of ds summed over up to 514 terms, 2% of the item's
        # largest entry plus 2% relative. (Of an item whose keys are all
        # padded the saved lse is -1e9, which swallows log S: its probs
        # are 1 in the backward, here as in the reference, and its
        # gradients S times larger than its neighbours'.)
        e_o, ok_o = within(out, pout, 0.02, 0.02)
        e_l, ok_l = within(lse, plse, 1e-3, 1e-5)
        errs = [e_o, e_l]
        oks = [ok_o, ok_l]
        for got, want in zip(grads, pgrads):
            e, ok = within(got, want,
                           0.02 * want.float().abs().amax((1, 2), True), 0.02)
            errs.append(e)
            oks.append(ok)
        same = (torch.equal(out, out2) and torch.equal(lse, lse2)
                and all(torch.equal(a, b) for a, b in zip(grads, grads2)))
        print(f"  flash attention B={B} T={T} S'={S} p={p}: out {e_o:.3g},"
              f" lse {e_l:.3g}, dq {errs[2]:.3g}, dk {errs[3]:.3g},"
              f" dv {errs[4]:.3g} (tol 0.02+0.02|ref| / 1e-3+1e-5|ref| /"
              f" 0.02 max|ref|+0.02|ref|), repeated call bit-equal {same}",
              flush=True)
        check(all(oks), f"flash attention T={T} S'={S} disagrees with its"
              " plain twin")
        check(same, f"flash attention T={T} S'={S}: two calls on the same"
              " inputs differ")
        if not timed:
            return
        res["flash_attention_fwd"].errs += errs[:2]
        res["flash_attention_bwd"].errs += errs[2:]
        # The library's forward and, over one retained graph, its backward.
        lq, lk, lv = (t.detach().requires_grad_() for t in (q, k, v))
        lout = sdpa(torch, lq, lk, lv, bias, H, p)
        flops = 4.0 * B * T * S * E
        line = res["flash_attention_fwd"].add(
            (q, k, v, bias, seed, out, lse), flops,
            time_ms(lambda: flash.flash_attention_fwd(*fargs)),
            time_ms(lambda: flash.flash_attention_fwd_plain(*fargs)),
            time_ms(lambda: sdpa(torch, q, k, v, bias, H, p)), calls=4)
        print(f"    time flash_attention_fwd S'={S}: {line}")
        # Backward: the scores again, dp, dv, dq and dk: five products.
        line = res["flash_attention_bwd"].add(
            (q, k, v, bias, seed, lse, g, *grads), 2.5 * flops,
            time_ms(lambda: flash.flash_attention_bwd(q, k, v, bias, seed,
                                                      lse, g, H, p)),
            time_ms(lambda: flash.flash_attention_bwd_plain(
                q, k, v, bias, seed, plse, g, H, p)),
            time_ms(lambda: torch.autograd.grad(lout, (lq, lk, lv), g,
                                                retain_graph=True)), calls=4)
        print(f"    time flash_attention_bwd S'={S}: {line}")

    for S in (514, 51):
        flash_case(16, 63, S, timed=True)
    for T in (2, 63, 64, 65, 128):
        for S in (1, 63, 65, 514):
            flash_case(2, T, S)
    return {name: t.result() for name, t in res.items()}


def make_job(rng, B: int, article_lens):
    from news_image_caption_tpu_torch.config import (FLAGSHIP,
                                                     FLAGSHIP_ARTICLE_LEN,
                                                     FLAGSHIP_IMAGE_LEN)
    P, S = FLAGSHIP_IMAGE_LEN, FLAGSHIP_ARTICLE_LEN
    article_mask = np.arange(S)[None, :] >= np.asarray(article_lens)[:, None]
    return {
        "image": rng.randn(B, P, FLAGSHIP["image_dim"]).astype(np.float32),
        "image_mask": np.zeros((B, P), bool),
        "article": rng.randn(B, S, FLAGSHIP["article_dim"]).astype(np.float32),
        "article_mask": article_mask,
    }


def stage_batch(torch, job, device) -> dict:
    """A job's arrays as the model's batch on `device`, features bf16."""
    batch = {k: torch.as_tensor(v).to(device) for k, v in job.items()}
    batch["image"] = batch["image"].bfloat16()
    batch["article"] = batch["article"].bfloat16()
    return batch


def decode_steps(tokens: np.ndarray, eos: int, max_len: int) -> int:
    """Steps an early-exit greedy loop ran for these tokens: until every
    row had emitted eos (its column), or max_len."""
    ends = []
    for row in tokens:
        hits = np.flatnonzero(row[1:] == eos)
        if hits.size == 0:
            return max_len
        ends.append(int(hits[0]) + 1)
    return max(ends)


def check_tokens(tokens: np.ndarray, B: int, cfg, vocab: int) -> None:
    check(tokens.shape == (B, cfg.max_len + 1),
          f"tokens shape {tokens.shape}, expected {(B, cfg.max_len + 1)}")
    check(bool((tokens[:, 0] == cfg.bos_id).all()), "bos is not first")
    check(bool(((tokens >= 0) & (tokens < vocab)).all()), "id out of vocab")
    for row in tokens:
        hits = np.flatnonzero(row[1:] == cfg.eos_id)
        if hits.size:
            check(bool((row[hits[0] + 2:] == cfg.pad_id).all()),
                  "a row continues after eos")


def greedy_launches_a_step() -> dict:
    """Per greedy decode step of the flagship: one band call per
    adaptive band, one attention per layer and context (image, article),
    one conv and FFN block per layer: 3 / 8 / 4 / 4."""
    from news_image_caption_tpu_torch.config import FLAGSHIP
    n_layers = FLAGSHIP["num_layers"]
    return {"band_topk_lse": len(FLAGSHIP["cutoff"]),
            "decode_cross_attention": 2 * n_layers,
            "decode_conv_block": n_layers, "decode_ffn_block": n_layers}


def serving_phase(torch, counted):
    """Phase 4. Returns (the main-path launch count of each kernel, the
    server's predict)."""
    from news_image_caption_tpu_torch.config import FLAGSHIP
    from news_image_caption_tpu_torch.models.captioner import \
        TransformerFlattened
    from news_image_caption_tpu_torch.serving.worker import \
        flagship_model_builder

    t0 = time.perf_counter()
    predict = flagship_model_builder("cuda", batch_size=1, max_len=32,
                                     early_exit=True, seed=0)
    predict.warmup()
    cfg = predict.config
    print(f"  model built and warmed up in {time.perf_counter() - t0:.1f} s,"
          f" peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          " GiB", flush=True)
    rng = np.random.RandomState(0)
    jobs = [make_job(rng, 1, [512]), make_job(rng, 1, [300]),
            make_job(rng, 1, [40]),
            make_job(rng, 16, rng.randint(20, 513, size=16))]
    per_step = greedy_launches_a_step()

    for fn in counted.values():
        fn.launches = 0
    steps, outputs = 0, []
    for job in jobs:
        B = job["image"].shape[0]
        t = time.perf_counter()
        tokens = predict(job)["tokens"]
        lat = (time.perf_counter() - t) * 1e3
        check_tokens(tokens, B, cfg, FLAGSHIP["vocab_size"])
        n = decode_steps(tokens, cfg.eos_id, cfg.max_len)
        steps += n
        outputs.append(tokens)
        print(f"  request B={B}: {lat:.1f} ms, {n} decode steps,"
              f" tokens[0,:8] {tokens[0, :8].tolist()}", flush=True)
    launches = {name: fn.launches for name, fn in counted.items()}
    for name, n in launches.items():
        print(f"  {name}: {n} launches over {steps} steps"
              f" (expected {per_step[name]} per step)")
        check(n == per_step[name] * steps and n > 0,
              f"{name} launched {n} times, expected {per_step[name] * steps}")

    # Kernel path vs plain path: the same weights, the plain twins on
    # the CPU, on the 16-row request.
    job = jobs[-1]
    gpu_batch, cpu_batch = stage_batch(torch, job, "cuda"), stage_batch(
        torch, job, "cpu")
    tok_k, lp_k = predict.model.generate(gpu_batch, cfg, predict.weights)
    check(bool(np.array_equal(tok_k.cpu().numpy(), outputs[-1])),
          "generate and predict disagree on the same request")
    cpu_model = TransformerFlattened(
        decoder=copy.deepcopy(predict.model.decoder).to("cpu"))
    t = time.perf_counter()
    tok_p, lp_p = cpu_model.generate(cpu_batch, cfg)
    print(f"  plain path on the CPU: {time.perf_counter() - t:.1f} s")
    lp_k, tok_k = lp_k.cpu(), tok_k.cpu()
    check(bool(torch.isfinite(lp_k).all()), "non-finite log-probs")
    e0 = (lp_k[:, 0] - lp_p[:, 0]).abs().max().item()
    agree0 = (tok_k[:, 1] == tok_p[:, 1]).float().mean().item()
    agree = (tok_k[:, 1:] == tok_p[:, 1:]).float().mean().item()
    print(f"  step-0 top-1 log-prob, kernel vs plain path: max |diff| {e0:.4g}"
          f" (tol 0.1); step-0 token agreement {agree0:.3f} (min 0.75);"
          f" token agreement over the decode {agree:.3f}", flush=True)
    check(e0 <= 0.1, "step-0 log-probs of the kernel and plain paths differ")
    check(agree0 >= 0.75, "step-0 tokens of the kernel and plain paths differ")
    return launches, predict


def check_beams(tokens: np.ndarray, scores: np.ndarray, B: int, cfg,
                vocab: int) -> None:
    """Beam output: tokens [B, K, max_len + 1] as `check_tokens` holds
    each row, scores [B, K] finite and best first."""
    K = cfg.beam_size
    check(tokens.shape == (B, K, cfg.max_len + 1),
          f"beam tokens shape {tokens.shape}, expected"
          f" {(B, K, cfg.max_len + 1)}")
    check_tokens(tokens.reshape(B * K, -1), B * K, cfg, vocab)
    check(scores.shape == (B, K) and bool(np.isfinite(scores).all()),
          f"beam scores {scores.shape} not finite")
    check(bool((np.diff(scores, axis=1) <= 0).all()),
          "beam scores are not sorted best first")


def beam_launches_a_step(torch, rows: int, beam: int) -> dict:
    """Each decode kernel's launches in one flagship step of `rows`
    rows, from the kernels' plans: a band call a band, a conv and an FFN
    call a layer, an attention call a layer and context."""
    from news_image_caption_tpu_torch.config import FLAGSHIP
    from news_image_caption_tpu_torch.ops import _build
    from news_image_caption_tpu_torch.ops.band_topk import band_plan
    from news_image_caption_tpu_torch.ops.decode_blocks import (
        conv_block_plan, ffn_plan)
    sms = _build.sms_of(torch.device("cuda"))
    D, H = FLAGSHIP["embed_dim"], FLAGSHIP["num_heads"]
    cut = FLAGSHIP["cutoff"]
    bands = [cut[0] + len(cut) - 1] + [b - a for a, b in zip(cut, cut[1:])]
    layers = FLAGSHIP["kernel_sizes"]
    return {
        "band_topk_lse": sum(band_plan(rows, D, v, beam, sms).launches
                             for v in bands),
        "decode_cross_attention": 2 * len(layers),
        "decode_conv_block": sum(conv_block_plan(rows, D, H, K, sms).launches
                                 for K in layers),
        "decode_ffn_block": len(layers) * ffn_plan(
            rows, D, FLAGSHIP["ffn_dim"], sms).launches}


def rescore_beams(torch, decoder, batch, tokens, scores, cfg):
    """Each returned beam's raw score (its score times len**alpha, len
    counting the tokens that are not pad) against the sum of its tokens'
    log-probs re-scored by teacher forcing (`decoder.log_prob`, the
    full-sequence path) up to and including its eos. Returns (|diff|,
    tokens summed) a beam."""
    from news_image_caption_tpu_torch.models.captioner import \
        TransformerFlattened
    B, K, L1 = tokens.shape
    flat = tokens.reshape(B * K, L1)
    ctx = {k: v.repeat_interleave(K, 0)
           for k, v in TransformerFlattened._contexts(batch).items()}
    with torch.inference_mode():
        lp = decoder.log_prob(flat[:, :-1], ctx)
    step_lp = torch.gather(lp, 2, flat[:, 1:, None])[..., 0].float()
    eos = (flat[:, 1:] == cfg.eos_id).int()
    live = (torch.cumsum(eos, 1) - eos) == 0       # no eos before the step
    rescored = (step_lp * live).sum(1)
    lengths = (flat != cfg.pad_id).sum(1).float()
    raw = scores.reshape(-1) * lengths.clamp(min=1) ** cfg.length_penalty
    return (raw - rescored).abs(), rescored, live.sum(1)


def check_rescored(torch, decoder, batch, tokens, scores, cfg,
                   what: str) -> None:
    """`rescore_beams` on the card, held to its bound: the bf16
    teacher-forced log-probs are rounded to bf16 up to three times
    (head, tail, prior add; 0.031 each at |lp| < 16), and the two paths'
    hidden states differ by bf16 roundings: 0.05 a token plus 1% of the
    sum."""
    diff, rescored, n_tok = rescore_beams(
        torch, decoder, batch, torch.from_numpy(tokens).cuda(),
        torch.from_numpy(scores).cuda(), cfg)
    bound = 0.05 * n_tok + 0.01 * rescored.abs()
    print(f"  {what}: score x len^alpha against the teacher-forced sum of"
          f" its log-probs: max |diff| {diff.max().item():.4g} over sums of"
          f" {rescored.min().item():.1f} to {rescored.max().item():.1f}"
          f" (bound 0.05 a token + 1%); largest share of the bound"
          f" {(diff / bound).max().item():.3f}", flush=True)
    check(bool((diff <= bound).all()),
          f"{what}: beam scores disagree with teacher forcing")


def beam_phase(torch, counted, predict):
    """Phase 4b. Beam-5 requests through `TransformerFlattened.
    generate_beam` with the serving phase's flagship model and weights,
    max_len 32 and early exit: five timed requests of 16 items and four
    of 128, then one profiled request of each, and at B=16 an early-exit
    and a harvest search on a copy of the model whose beams finish
    (`finishing_requests`). Checks
    the tokens and scores, that every kernel's launches equal its plan's
    count a step times the steps run, the scores against a
    teacher-forced re-scoring on the card, and the kernel path against
    the plain path on the CPU, at both sizes. Returns the beam path's
    launch count of each kernel and the timings (a smoke reading: the
    request latency metric is `--serving-latency`'s)."""
    from news_image_caption_tpu_torch.config import FLAGSHIP
    from news_image_caption_tpu_torch.generation.generator import \
        GenerationConfig
    from torch.profiler import ProfilerActivity, profile

    model, weights = predict.model, predict.weights
    K, vocab = 5, FLAGSHIP["vocab_size"]
    cfg = GenerationConfig(max_len=32, early_exit=True, beam_size=K)
    rng = np.random.RandomState(1)

    def beam_steps(tokens):
        return decode_steps(tokens.reshape(-1, tokens.shape[-1]),
                            cfg.eos_id, cfg.max_len)

    launches = {name: 0 for name in counted}
    summary = {}
    for B, n_req in ((16, 5), (128, 4)):
        jobs = [make_job(rng, B, rng.randint(20, 513, size=B))
                for _ in range(n_req)]
        batches = [stage_batch(torch, job, "cuda") for job in jobs]
        model.generate_beam(batches[0], cfg, weights)       # warm-up
        torch.cuda.synchronize()
        per_step = beam_launches_a_step(torch, B * K, K)
        for fn in counted.values():
            fn.launches = 0
        lat, steps, outs = [], 0, []
        for batch in batches:
            t = time.perf_counter()
            tokens, scores = model.generate_beam(batch, cfg, weights)
            tokens, scores = tokens.cpu().numpy(), scores.cpu().numpy()
            lat.append((time.perf_counter() - t) * 1e3)
            check_beams(tokens, scores, B, cfg, vocab)
            steps += beam_steps(tokens)
            outs.append((tokens, scores))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            tokens, _ = model.generate_beam(batches[0], cfg, weights)
            n = beam_steps(tokens.cpu().numpy())
            wall = (time.perf_counter() - t) * 1e3
        steps += n
        for name, fn in counted.items():
            print(f"  B={B} beam {K}: {name}: {fn.launches} launches over"
                  f" {steps} steps (plan: {per_step[name]} a step at"
                  f" {B * K} rows)")
            check(fn.launches == per_step[name] * steps and fn.launches > 0,
                  f"{name} launched {fn.launches} times at B={B} beam {K},"
                  f" expected {per_step[name] * steps}")
            launches[name] += fn.launches
        dev_events = [e for e in prof.key_averages()
                      if str(e.device_type).endswith("CUDA")]
        busy = sum(e.self_device_time_total for e in dev_events) / 1e3
        check(busy > 0, "the profiler saw no device time")
        lat_sorted = sorted(lat)
        p50 = lat_sorted[len(lat) // 2]
        summary[B] = {"requests": lat, "p50_ms": p50,
                      "captions_per_s": B * 1e3 / p50,
                      "steps_per_request": (steps - n) / len(lat),
                      "profiled_wall_ms": wall, "device_busy_ms": busy,
                      "device_busy_share": busy / wall,
                      "device_ms_per_step": busy / n}
        print(f"  B={B} beam {K}: request ms {[round(x, 1) for x in lat]},"
              f" p50 {p50:.1f} ms, {B * 1e3 / p50:.1f} captions/s;"
              f" profiled request: {n} steps, wall {wall:.1f} ms, device"
              f" busy {busy:.2f} ms ({100 * busy / wall:.1f}%),"
              f" {busy / n:.4f} device ms a step; best beam of item 0"
              f" {outs[0][0][0, 0, :10].tolist()}", flush=True)
        top = sorted(dev_events, key=lambda e: -e.self_device_time_total)
        for e in top[:6]:
            print(f"    {e.self_device_time_total / 1e3 / n:8.4f} ms/step"
                  f" x{e.count / n:<5.1f} {e.key[:80]}")
        check_rescored(torch, model.decoder, batches[0], *outs[0], cfg,
                       f"B={B} beam {K}")
        beam_vs_plain(torch, model, weights, jobs[0], cfg, search=B == 16)
        if B == 16:
            summary[B]["finishing_steps"], more = finishing_requests(
                torch, counted, model, batches[0], outs[0][0], cfg, per_step)
            for name, n in more.items():
                launches[name] += n
    summary["launches"] = launches
    return launches, summary


def finishing_requests(torch, counted, model, batch, tokens, cfg,
                       per_step) -> dict:
    """Two beam-5 requests at B=16 on a copy of the model whose eos word
    row leans toward the decoder's mean state m (as the tests' weights
    do, at flagship width), so that beams finish: eos rises by `lift`
    at that state, `lift` the mean gap between a step's best log-prob
    and eos's (teacher forced over `tokens`, a search's beams on the
    same batch) plus the first of 1, 2, 4, 8, 16 at which an early-exit
    search stops before max_len with beams ending at different steps.
    At that lift: the early-exit search, then one with harvest (the
    done list; early exit on, which a harvest search reaches only if
    all its live beams emit eos in one step). Checks for each the
    steps run, that every returned beam ends in eos and pad follows it,
    that beams end at different steps, the launches against the plans a
    step times the steps, and the scores against teacher forcing.
    Returns ({config: steps run}, {kernel: launches in the two checked
    searches})."""
    from news_image_caption_tpu_torch.models.captioner import \
        TransformerFlattened
    decoder = copy.deepcopy(model.decoder)
    B, K, L1 = tokens.shape
    flat = torch.from_numpy(tokens).cuda().reshape(B * K, L1)[:, :-1]
    ctx = {k: v.repeat_interleave(K, 0)
           for k, v in TransformerFlattened._contexts(batch).items()}
    with torch.inference_mode():
        m = decoder.hidden(flat, ctx).float().mean((0, 1))
        lp = decoder.log_prob(flat, ctx).float()
        gap = (lp.max(-1).values - lp[..., cfg.eos_id]).mean().item()
    del lp
    e0 = decoder.embedder.adaptive.embed_0
    row = e0[cfg.eos_id].detach().float().clone()
    steps = []
    step_topk = decoder.step_topk

    def counted_step(tok, i, *args, **kw):
        steps.append(i)
        return step_topk(tok, i, *args, **kw)
    decoder.step_topk = counted_step
    biased = TransformerFlattened(decoder=decoder)

    def search(c):
        steps.clear()
        tok, sc = biased.generate_beam(batch, c, weights)
        tok, sc = tok.cpu().numpy(), sc.cpu().numpy()
        ends = [int(np.argmax(r[1:] == cfg.eos_id)) + 1
                if (r[1:] == cfg.eos_id).any() else 0
                for r in tok.reshape(B * K, L1)]
        return tok, sc, len(steps), ends

    for extra in (1.0, 2.0, 4.0, 8.0, 16.0):
        lift = gap + extra
        with torch.no_grad():
            e0[cfg.eos_id] = (row + lift * m / (m @ m)).to(e0.dtype)
        weights = decoder.decode_weights()
        _, _, n, ends = search(cfg)
        print(f"  B={B} beam {K}, eos raised by {lift:.2f}: {n} steps,"
              f" beams end at steps {sorted(set(ends))}", flush=True)
        if n < cfg.max_len and min(ends) > 0 and len(set(ends)) > 1:
            break
    run, launches = {}, {key: 0 for key in counted}
    for name, c in (("early_exit", cfg),
                    ("harvest", dataclasses.replace(cfg,
                                                    harvest_finished=True))):
        for fn in counted.values():
            fn.launches = 0
        tok, sc, n, ends = search(c)
        run[name] = n
        print(f"  B={B} beam {K} {name}, eos raised by {lift:.2f}: {n}"
              f" steps, the returned beams end at steps {min(ends)} to"
              f" {max(ends)}; launches"
              f" {dict((k, f.launches) for k, f in counted.items())}",
              flush=True)
        check_beams(tok, sc, B, c, model.decoder.vocab_size)
        check(name == "harvest" or n < cfg.max_len,
              "early exit did not stop the search")
        check(min(ends) > 0, f"{name}: a returned beam has no eos")
        check(len(set(ends)) > 1, f"{name}: every returned beam ended at"
              " one step")
        for key, fn in counted.items():
            check(fn.launches == per_step[key] * n,
                  f"{key} launched {fn.launches} times in the {name}"
                  f" search, expected {per_step[key] * n}")
            launches[key] += fn.launches
        check_rescored(torch, decoder, batch, tok, sc, c,
                       f"B={B} beam {K} {name}")
    return run, launches


def beam_vs_plain(torch, model, weights, job, cfg, search: bool):
    """The kernel path against the plain path on the CPU (the same
    weights) on one beam-5 request: step 0's candidates (every beam of
    an item starts from bos) within 0.1 and their ids; then, with
    `search`, the first tokens of the beams of 8-step searches, as
    multisets an item."""
    from news_image_caption_tpu_torch.models.captioner import \
        TransformerFlattened
    K = cfg.beam_size
    B = job["image"].shape[0]
    batches = {dev: stage_batch(torch, job, dev) for dev in ("cuda", "cpu")}
    cpu_model = TransformerFlattened(
        decoder=copy.deepcopy(model.decoder).to("cpu"))
    short = dataclasses.replace(cfg, max_len=8)
    t = time.perf_counter()
    out = {}
    for dev, m, w in (("cuda", model, weights), ("cpu", cpu_model, None)):
        with torch.inference_mode():
            kvs, caches, seed, w = m._decode_setup(batches[dev], cfg, w, K)
            cand = m.decoder.step_topk(seed.repeat_interleave(K), 0, kvs,
                                       caches, K, w, beam=K)
            out[dev] = [c.cpu() for c in cand]
            if search:
                out[dev].append(m.generate_beam(batches[dev], short,
                                                w)[0].cpu())
    print(f"  plain path on the CPU: {time.perf_counter() - t:.1f} s")
    (v_k, i_k, *t_k), (v_p, i_p, *t_p) = out["cuda"], out["cpu"]
    e0 = (v_k - v_p).abs().max().item()
    agree_ids = (i_k == i_p).float().mean().item()
    line = (f"  B={B} beam {K} step 0, kernel vs plain path: candidate"
            f" log-probs max |diff| {e0:.4g} (tol 0.1), candidate ids equal"
            f" {agree_ids:.3f} (min 0.75)")
    if search:
        first = []
        for a, b in zip(t_k[0][:, :, 1].tolist(), t_p[0][:, :, 1].tolist()):
            first.append(sum(min(a.count(x), b.count(x)) for x in set(a)) / K)
        agree = float(np.mean(first))
        same = (t_k[0] == t_p[0]).float().mean().item()
        line += (f"; first tokens of the beams after 8 steps agree"
                 f" {agree:.3f} (min 0.75); all tokens equal {same:.3f}")
    print(line, flush=True)
    check(e0 <= 0.1, f"B={B} beam step-0 candidates of the kernel and plain"
          " paths differ")
    check(agree_ids >= 0.75, f"B={B} beam step-0 candidate ids of the kernel"
          " and plain paths differ")
    if search:
        check(agree >= 0.75, "beam first tokens of the kernel and plain paths"
              " differ")


def train_phase(torch, flash):
    """Phase 5. Returns the main-path launch count of each flash kernel
    over the 20 train steps."""
    from news_image_caption_tpu_torch.config import (FLAGSHIP,
                                                     FLAGSHIP_ARTICLE_LEN,
                                                     FLAGSHIP_BATCH_SIZE,
                                                     FLAGSHIP_CAPTION_LEN,
                                                     FLAGSHIP_IMAGE_LEN)
    from news_image_caption_tpu_torch.data.synthetic import (
        SyntheticNewsDataset, to_device)
    from news_image_caption_tpu_torch.models.captioner import \
        TransformerFlattened
    from news_image_caption_tpu_torch.training.builder import \
        flagship_trainer_builder
    from news_image_caption_tpu_torch.training.train_step import \
        make_eval_step

    B, steps = FLAGSHIP_BATCH_SIZE, 20
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model, state, train_step, eval_step = flagship_trainer_builder(
        "cuda", seed=0, t_total=100)
    n_params = sum(p.numel() for p in state.params.values())
    ds = SyntheticNewsDataset(
        size=B, vocab_size=FLAGSHIP["vocab_size"],
        caption_len=FLAGSHIP_CAPTION_LEN, article_len=FLAGSHIP_ARTICLE_LEN,
        n_patches=FLAGSHIP_IMAGE_LEN, image_dim=FLAGSHIP["image_dim"],
        article_dim=FLAGSHIP["article_dim"], seed=0)
    batch_np = next(ds.batches(B, shuffle=False))
    batch = to_device(batch_np, "cuda")
    torch.cuda.synchronize()
    print(f"  trainer built in {time.perf_counter() - t0:.1f} s: {n_params}"
          f" parameters, bf16 stored, fp32 master; batch {B}, caption"
          f" {FLAGSHIP_CAPTION_LEN} (T = {FLAGSHIP_CAPTION_LEN - 1}),"
          f" article {FLAGSHIP_ARTICLE_LEN}, image {FLAGSHIP_IMAGE_LEN}",
          flush=True)

    counted = {"flash_attention_fwd": flash.flash_attention_fwd,
               "flash_attention_bwd": flash.flash_attention_bwd}
    for fn in counted.values():
        fn.launches = 0
    losses, skipped, wall = [], [], []
    for _ in range(steps):
        t = time.perf_counter()
        state, m = train_step(state, batch, 0)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t)
        losses.append(m["loss"].item())
        skipped.append(m["skipped"])
    launches = {name: fn.launches for name, fn in counted.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print("  losses (bits/token): " + " ".join(f"{x:.4f}" for x in losses))
    ms = sorted(wall[1:])[len(wall[1:]) // 2] * 1e3
    print(f"  step time (host clock, synchronised), median of steps 2-{steps}:"
          f" {ms:.2f} ms, {B / ms * 1e3:.1f} samples/s (first step"
          f" {wall[0] * 1e3:.1f} ms); peak device memory {peak:.2f} GiB",
          flush=True)
    check(all(np.isfinite(losses)), "a train loss is not finite")
    check(losses[-1] < losses[0],
          f"the loss did not fall: {losses[0]:.4f} -> {losses[-1]:.4f}")
    check(sum(skipped) == 0, f"{sum(skipped)} steps were skipped")
    per_step = 2 * FLAGSHIP["num_layers"]
    for name, n in launches.items():
        print(f"  {name}: {n} launches over {steps} steps (expected"
              f" {per_step} per step)")
        check(n == per_step * steps,
              f"{name} launched {n} times, expected {per_step * steps}")

    # Where the device time of a step goes (3 profiled steps).
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(3):
            state, _ = train_step(state, batch, 0)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t) * 1e3
    # Device operations only: the train step's record_function spans
    # also appear as device-side annotation rows, which would count twice.
    dev_events = [e for e in prof.key_averages()
                  if str(e.device_type).endswith("CUDA")
                  and not e.key.startswith("train_step.")]
    busy = sum(e.self_device_time_total for e in dev_events) / 1e3
    by_name = sorted(dev_events, key=lambda e: -e.self_device_time_total)
    fwd = sum(e.self_device_time_total for e in dev_events
              if "flash_fwd_kernel" in e.key) / 1e3
    bwd = sum(e.self_device_time_total for e in dev_events
              if "flash_bwd_kernel" in e.key) / 1e3
    check(busy > 0, "the profiler saw no device time")
    print(f"  profiled 3 steps: wall {prof_wall:.1f} ms, device busy"
          f" {busy:.1f} ms ({100 * busy / prof_wall:.1f}%), flash forward"
          f" {fwd:.2f} ms ({100 * fwd / busy:.1f}% of busy), flash backward"
          f" {bwd:.2f} ms ({100 * bwd / busy:.1f}%)")
    for e in by_name[:8]:
        print(f"    {e.self_device_time_total / 3e3:8.3f} ms/step"
              f" x{e.count // 3:<4d} {e.key[:90]}")

    # Kernel path vs plain path: the deterministic loss of the trained
    # weights on 4 rows, on the card and on the CPU (plain versions).
    rows = {k: v[:4] for k, v in batch_np.items()}
    got = eval_step(to_device(rows, "cuda"))["loss"].item()
    cpu_model = TransformerFlattened(
        decoder=copy.deepcopy(model.decoder).to("cpu"))
    t = time.perf_counter()
    want = make_eval_step(cpu_model.loss_fn)(to_device(rows, "cpu"))["loss"]
    want = want.item()
    print(f"  deterministic loss on 4 rows: kernel path {got:.5f}, plain path"
          f" on the CPU {want:.5f} bits/token ({time.perf_counter() - t:.1f} s);"
          f" |diff| {abs(got - want):.4g} (tol 0.01 |plain|)", flush=True)
    check(abs(got - want) <= 0.01 * abs(want),
          "the kernel and plain paths' losses differ")
    return launches, ms


def dynamic_conv_bytes(B: int, T: int, C: int, H: int, K: int) -> int:
    """Bytes the dynamic conv must move in bf16: x and w read once, the
    output written once."""
    return 2 * (2 * B * T * C + B * T * H * K)


def dynamic_conv_phase(torch, dc):
    """Phase 6. Returns ({"dynamic_conv": dict(max_abs_err, ms,
    plain_ms, bound_ms, bound_by, library_ms)}, the main-path launch
    count), the times summed over the four layer widths: one forward of
    each flagship layer's conv. The faster of the module's shift and
    band routes a width, each the port's own plain PyTorch, is the
    library yardstick: no single PyTorch call computes the function."""
    from news_image_caption_tpu_torch.ops import conv
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    bf16 = torch.bfloat16
    B, T, C, H = 16, 512, 1024, 16
    widths = (3, 7, 15, 31)
    x = torch.randn(B, T, C, generator=gen, device=dev).to(bf16)
    xh = x.view(B, T, H, C // H)
    tally = Tally("fp32")
    for K in widths:
        w = torch.softmax(torch.randn(B, T, H, K, generator=gen, device=dev),
                          -1).to(bf16)
        got = dc.dynamic_conv(x, w, H)
        again = dc.dynamic_conv(x, w, H)
        want = dc.dynamic_conv_plain(x, w, H)
        torch.cuda.synchronize()
        d = (got.float() - want.float()).abs()
        e = d.max().item()
        ok = bool((d <= dc.dynamic_conv_tolerance(x, w, H)).all())
        exact = bool(torch.equal(got, want))
        t_k = time_ms(lambda: dc.dynamic_conv(x, w, H))
        t_p = time_ms(lambda: dc.dynamic_conv_plain(x, w, H))
        t_s = time_ms(lambda: conv._shift_accumulate(xh, w, K))
        t_b = time_ms(lambda: conv._band_matmul(xh, w, K))
        floor_us = dynamic_conv_bytes(B, T, C, H, K) / HBM_BYTES_PER_S * 1e6
        print(f"  dynamic_conv B={B} T={T} C={C} H={H} K={K}: max |diff| {e:.3g}"
              f" (tol: fused sums' bound + one bf16 unit), bit-equal {exact};"
              f" kernel {t_k * 1e3:.2f} us ({floor_us:.2f} us floor at 3.35"
              f" TB/s, {100 * floor_us / (t_k * 1e3):.1f}% of it), plain"
              f" {t_p:.4f} ms, shift route {t_s:.4f} ms, band route"
              f" {t_b:.4f} ms", flush=True)
        # A product of two bf16 values is exact in fp32: the fused sums
        # are the plain version's, bit for bit.
        check(ok and exact,
              f"dynamic_conv K={K} disagrees with its plain version")
        check(bool(torch.equal(got, again)),
              f"dynamic_conv K={K}: two calls differ")
        tally.errs.append(e)
        # x and w read, the output written; one fp32 multiply and add a
        # tap and channel, outside the tensor cores.
        tally.add((x, w, got), 2.0 * B * T * C * K, t_k, t_p,
                  library_ms=min(t_s, t_b))

    # The module: one launch per forward at T % 128 == 0, none otherwise.
    dc.dynamic_conv.launches = 0
    x63 = x[:, :63].contiguous()
    for K in widths:
        mod = conv.DynamicConv(
            C, K, H, device=dev, dtype=bf16, method="pallas",
            generator=torch.Generator(device=dev).manual_seed(K))
        before = dc.dynamic_conv.launches
        out = mod(x)        # under grad mode: the backward is checked below
        check(dc.dynamic_conv.launches == before + 1,
              f"DynamicConv(K={K}) at T={T} launched"
              f" {dc.dynamic_conv.launches - before} kernels, expected 1")
        check(tuple(out.shape) == (B, T, C) and out.dtype == bf16
              and bool(torch.isfinite(out).all()),
              f"DynamicConv(K={K}) output {tuple(out.shape)} {out.dtype}")
        cpu = copy.deepcopy(mod).to("cpu")
        with torch.no_grad():
            want = cpu(x.cpu())
        # The taps come from a bf16 matmul on each device: one bf16
        # rounding of a logit (2^-7 at |logit| < 2) moves a tap by under
        # 1%, and the sum by under 1% of max |x| (about 5).
        e, ok = within(out.detach().cpu(), want, 0.05, 0.02)
        print(f"  DynamicConv(1024, {K}, 16, method='pallas') T={T}: one"
              f" launch; vs the same module on the CPU {e:.3g}"
              f" (tol 0.05 + 0.02|ref|)", flush=True)
        check(ok, f"DynamicConv(K={K}) on the card and on the CPU differ")
        raised = False
        try:
            out.float().sum().backward()
        except NotImplementedError:
            raised = True
        check(raised, f"DynamicConv(K={K}): backward through the kernel"
              " did not raise")
        before = dc.dynamic_conv.launches
        shift = copy.deepcopy(mod)
        shift.method = "shift"
        with torch.no_grad():
            same = bool(torch.equal(mod(x63), shift(x63)))
        check(dc.dynamic_conv.launches == before,
              f"DynamicConv(K={K}) at T=63 launched the kernel")
        check(same, f"DynamicConv(K={K}) at T=63 is not the shift route")
    launches = dc.dynamic_conv.launches
    print(f"  DynamicConv at T=63: no launch, equal to the shift route;"
          f" backward raises; {launches} launches over {len(widths)}"
          f" forwards at T={T} (expected {len(widths)})", flush=True)
    check(launches == len(widths), f"dynamic_conv launched {launches} times")
    return {"dynamic_conv": tally.result()}, launches


EVAL_CONFIG = "configs/goodnews_transformer_roberta.yaml"


def check_evaluate_files(out_dir: str, attn_dir: str, n_batches: int,
                         cfg) -> list:
    """Phase 7's checks of the files the command wrote. Returns each
    batch's tokens, read back from its attention dump."""
    import math

    from news_image_caption_tpu_torch.evaluation import checkdiff
    from news_image_caption_tpu_torch.evaluation.compute_metrics import \
        compute_metrics
    gen_path = f"{out_dir}/generations.jsonl"
    with open(gen_path) as f:
        recs = [json.loads(line) for line in f]
    check(len(recs) == 256, f"{len(recs)} generations, expected 256")
    check(all(k in r for r in recs for k in checkdiff.ENRICHED_FIELDS),
          "a generation record lacks its enrichment")
    integrity = checkdiff.integrity_check(gen_path)
    check(integrity["ok"] and integrity["records"] == 256
          and not integrity["problems"],
          f"integrity check failed: {integrity}")
    with open(f"{out_dir}/evaluate-metrics.json") as f:
        metrics = json.load(f)
    keys = ("bleu-1", "bleu-2", "bleu-3", "bleu-4", "cider", "rouge-l")
    check(metrics["n_samples"] == 256
          and all(math.isfinite(metrics[k]) for k in keys),
          f"evaluate metrics {metrics}")
    offline = compute_metrics(gen_path)
    for k in ("BLEU-1", "BLEU-4", "ROUGE", "CIDEr", "All names - recall",
              "Entity all - precision", "Generation TTR"):
        check(k in offline, f"compute_metrics lacks {k!r}")
    tokens, worst = [], 0.0
    for i in range(n_batches):
        with np.load(f"{attn_dir}/attn_{i:05d}.npz") as z:
            tok = z["tokens"]
            check(tok.shape == (16, cfg.max_len + 1),
                  f"dumped tokens of shape {tok.shape}")
            maps = [k for k in z.files if k != "tokens"]
            check(len(maps) == 8, f"dumped maps {sorted(z.files)}")
            for k in maps:
                arr = z[k]
                check(arr.shape[:2] == tok.shape, f"{k} of shape {arr.shape}")
                worst = max(worst, float(np.abs(arr.sum(-1) - 1.0).max()))
            tokens.append(tok)
    print(f"  files: 256 enriched records, integrity ok, metrics"
          f" { {k: round(metrics[k], 4) for k in keys} }, compute_metrics"
          f" {len(offline)} keys; {n_batches} attention dumps, rows sum to 1"
          f" within {worst:.3g} (tol 1e-2)", flush=True)
    check(worst <= 1e-2, "a dumped attention row does not sum to 1")
    return tokens


def evaluate_phase(torch, counted):
    """Phase 7. The evaluate command on the flagship config's test split,
    then its first batch again with the command's model rebuilt: against
    the dumped tokens, profiled, and against the plain path on the CPU.
    Returns the command's launch count of each decode kernel and a
    summary."""
    import tempfile

    from news_image_caption_tpu_torch import cli
    from news_image_caption_tpu_torch.config import (build_dataset,
                                                     load_config)
    from news_image_caption_tpu_torch.models.captioner import \
        TransformerFlattened
    from torch.profiler import ProfilerActivity, profile

    per_step = greedy_launches_a_step()
    with tempfile.TemporaryDirectory() as tmp:
        out_dir, attn_dir = f"{tmp}/serialization", f"{tmp}/attn"
        overrides = json.dumps({"trainer": {"serialization_dir": out_dir}})
        cfg = load_config(EVAL_CONFIG, overrides)
        gcfg = cli.generation_config(cfg)
        timings = {}
        for fn in counted.values():
            fn.launches = 0
        t = time.perf_counter()
        rc = cli.main(["evaluate", EVAL_CONFIG, "--split", "test",
                       "--dump-attention", attn_dir, "-o", overrides],
                      timings=timings)
        wall = time.perf_counter() - t
        launches = {name: fn.launches for name, fn in counted.items()}
        check(rc == 0, f"evaluate returned {rc}")
        n_batches = 256 // cfg["iterator"]["batch_size"]
        tokens = check_evaluate_files(out_dir, attn_dir, n_batches, gcfg)
    steps = sum(decode_steps(t, gcfg.eos_id, gcfg.max_len) for t in tokens)
    print(f"  command: {wall:.1f} s, {256 / wall:.2f} captions/s; spans"
          f" (host clock, s) { {k: round(v, 3) for k, v in timings.items()} }",
          flush=True)
    for name, n in launches.items():
        print(f"  {name}: {n} launches over {steps} steps"
              f" (expected {per_step[name]} per step)")
        check(n == per_step[name] * steps and n > 0,
              f"{name} launched {n} times, expected {per_step[name] * steps}")

    model = cli.evaluation_model(cfg, torch.device("cuda"))
    weights = model.decoder.decode_weights()
    batch_np = next(build_dataset(cfg, "test").batches(16, shuffle=False))
    batch = {k: torch.from_numpy(batch_np[k]).cuda()
             for k in ("image", "image_mask", "article", "article_mask")}
    tok_k, lp_k = model.generate(batch, gcfg, weights)
    check(bool(np.array_equal(tok_k.to(torch.int32).cpu().numpy(),
                              tokens[0])),
          "the rebuilt model's first batch differs from the command's")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        prof_tokens, _ = model.generate(batch, gcfg, weights)
        n = decode_steps(prof_tokens.cpu().numpy(), gcfg.eos_id, gcfg.max_len)
        batch_wall = (time.perf_counter() - t) * 1e3
    dev_events = [e for e in prof.key_averages()
                  if str(e.device_type).endswith("CUDA")]
    busy = sum(e.self_device_time_total for e in dev_events) / 1e3
    check(busy > 0, "the profiler saw no device time")
    print(f"  profiled batch: {n} steps, wall {batch_wall:.1f} ms, device"
          f" busy {busy:.2f} ms ({100 * busy / batch_wall:.1f}%),"
          f" {busy / n:.4f} device ms a step", flush=True)

    cpu_model = TransformerFlattened(
        decoder=copy.deepcopy(model.decoder).to("cpu"))
    short = dataclasses.replace(gcfg, max_len=min(16, gcfg.max_len))
    t = time.perf_counter()
    tok_p, lp_p = cpu_model.generate({k: v.cpu() for k, v in batch.items()},
                                     short)
    print(f"  plain path on the CPU, {short.max_len} steps:"
          f" {time.perf_counter() - t:.1f} s")
    lp_k, tok_k = lp_k.cpu(), tok_k.cpu()
    check(bool(torch.isfinite(lp_k).all()), "non-finite log-probs")
    e0 = (lp_k[:, 0] - lp_p[:, 0]).abs().max().item()
    agree0 = (tok_k[:, 1] == tok_p[:, 1]).float().mean().item()
    agree = (tok_k[:, 1:short.max_len + 1]
             == tok_p[:, 1:]).float().mean().item()
    print(f"  first batch, step-0 top-1 log-prob, kernel vs plain path: max"
          f" |diff| {e0:.4g} (tol 0.1); step-0 token agreement {agree0:.3f}"
          f" (min 0.75); token agreement over {short.max_len} steps"
          f" {agree:.3f}", flush=True)
    check(e0 <= 0.1, "step-0 log-probs of the kernel and plain paths differ")
    check(agree0 >= 0.75, "step-0 tokens of the kernel and plain paths differ")
    return launches, {
        "config": EVAL_CONFIG, "samples": 256, "batch_size": 16,
        "max_len": gcfg.max_len, "decode_steps": steps, "wall_s": wall,
        "captions_per_s": 256 / wall, "spans_s": timings,
        "profiled_batch": {"steps": n, "wall_ms": batch_wall,
                           "device_busy_ms": busy,
                           "device_busy_share": busy / batch_wall,
                           "device_ms_per_step": busy / n},
        "step0_lp_diff": e0, "step0_token_agreement": agree0,
        "card": card_line(), "launches": launches}


def latency_mode(torch, n_requests: int) -> None:
    """`--serving-latency N`: request latency over N requests (host
    clock, request in to tokens on the host; articles of 20-512 tokens,
    max_len 32, early exit): the flagship greedy server at B=1 and B=16,
    then beam-5 (`generate_beam`, the same model and weights, the job
    staged inside the request as the server does) at B=16 and B=128;
    and one profiled request of each: device busy share of the wall
    time, device ms a decode step and the kernels' device time by name.
    Prints one JSON object a path and batch size."""
    from torch.profiler import ProfilerActivity, profile

    from news_image_caption_tpu_torch.generation.generator import \
        GenerationConfig
    from news_image_caption_tpu_torch.serving.worker import \
        flagship_model_builder
    predict = flagship_model_builder("cuda", batch_size=1, max_len=32,
                                     early_exit=True, seed=0)
    cfg = predict.config
    beam_cfg = dataclasses.replace(cfg, beam_size=5)

    def greedy(job):
        return predict(job)["tokens"]

    def beam(job):
        tokens, _ = predict.model.generate_beam(
            stage_batch(torch, job, "cuda"), beam_cfg, predict.weights)
        return tokens.cpu().numpy()

    def steps_of(tokens):
        return decode_steps(tokens.reshape(-1, tokens.shape[-1]),
                            cfg.eos_id, cfg.max_len)

    rngs = {"greedy": np.random.RandomState(0),
            "beam5": np.random.RandomState(1)}
    for path, B, serve in (("greedy", 1, greedy), ("greedy", 16, greedy),
                           ("beam5", 16, beam), ("beam5", 128, beam)):
        rng = rngs[path]
        jobs = [make_job(rng, B, rng.randint(20, 513, size=B))
                for _ in range(n_requests)]
        for job in jobs[:3]:
            serve(job)
        lat, steps = [], 0
        for job in jobs:
            t = time.perf_counter()
            tokens = serve(job)
            lat.append((time.perf_counter() - t) * 1e3)
            steps += steps_of(tokens)
        lat.sort()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            tokens = serve(jobs[0])
            wall = (time.perf_counter() - t) * 1e3
        n = steps_of(tokens)
        dev_events = [e for e in prof.key_averages()
                      if str(e.device_type).endswith("CUDA")]
        busy = sum(e.self_device_time_total for e in dev_events) / 1e3
        check(busy > 0, "the profiler saw no device time")
        top = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:10]
        print(json.dumps({
            "path": path, "B": B, "requests": n_requests,
            "p50_ms": lat[len(lat) // 2], "p90_ms": lat[(9 * len(lat)) // 10],
            "quartiles_ms": [lat[len(lat) // 4], lat[(3 * len(lat)) // 4]],
            "captions_per_s": B * 1e3 / lat[len(lat) // 2],
            "steps_per_request": steps / n_requests,
            "profiled_wall_ms": wall, "device_busy_ms": busy,
            "device_busy_share": busy / wall,
            "device_ms_per_step": busy / n,
            "top_device_ms_per_step": {
                e.key[:60]: [e.self_device_time_total / 1e3 / n, e.count / n]
                for e in top}}), flush=True)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available: this smoke run needs an NVIDIA GPU")
    from news_image_caption_tpu_torch.ops import (_build, band_topk,
                                                  decode_attention,
                                                  decode_blocks, dynamic_conv,
                                                  flash_attention)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print(card_line(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    _build.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)

    if len(sys.argv) > 1:
        check(len(sys.argv) == 3 and sys.argv[1] == "--serving-latency",
              "usage: chip_smoke.py [--serving-latency N_REQUESTS]")
        latency_mode(torch, int(sys.argv[2]))
        return

    print("phase 3: kernels vs plain versions (bf16, flagship shapes)",
          flush=True)
    timing, beam_timing = kernel_phase(
        torch, (band_topk, decode_attention, decode_blocks, _build))
    timing.update(flash_phase(torch, flash_attention))
    print(json.dumps({"beam5_step_b16": beam_timing}), flush=True)

    print("phase 4: flagship serving (bf16, random weights)", flush=True)
    counted = {"band_topk_lse": band_topk.band_topk_lse,
               "decode_cross_attention": decode_attention.decode_cross_attention,
               "decode_conv_block": decode_blocks.decode_conv_block,
               "decode_ffn_block": decode_blocks.decode_ffn_block}
    launches, predict = serving_phase(torch, counted)
    by_path = {name: {"greedy": n} for name, n in launches.items()}

    print("phase 4b: flagship beam-5 search (bf16, random weights)",
          flush=True)
    beam_launches, beam_summary = beam_phase(torch, counted, predict)
    for name, n in beam_launches.items():
        launches[name] += n
        by_path[name]["beam5"] = n
    print(json.dumps({"beam5_requests": beam_summary}), flush=True)
    del predict

    print("phase 5: flagship train step (bf16_o2, random weights)",
          flush=True)
    train_launches, step_ms = train_phase(torch, flash_attention)
    launches.update(train_launches)
    by_path.update({name: {"train": n} for name, n in train_launches.items()})

    print("phase 6: dynamic conv at full flagship width (bf16)", flush=True)
    conv_timing, launches["dynamic_conv"] = dynamic_conv_phase(torch,
                                                               dynamic_conv)
    by_path["dynamic_conv"] = {"conv_module": launches["dynamic_conv"]}
    timing.update(conv_timing)

    print("phase 7: the evaluate command (flagship, bf16, random weights)",
          flush=True)
    eval_launches, eval_summary = evaluate_phase(torch, counted)
    for name, n in eval_launches.items():
        launches[name] += n
        by_path[name]["evaluate"] = n
    print(json.dumps({"evaluate": eval_summary}), flush=True)

    sources = {"band_topk_lse": ("band_topk.cu", "pallas_topk.py:124"),
               "decode_cross_attention": ("decode_attention.cu",
                                          "pallas_kernels.py:146"),
               "decode_conv_block": ("decode_blocks.cu",
                                     "pallas_decode.py:177"),
               "decode_ffn_block": ("decode_ffn.cu",
                                    "pallas_decode.py:133"),
               "flash_attention_fwd": ("flash_attention.cu",
                                       "pallas_flash.py:243"),
               "flash_attention_bwd": ("flash_attention.cu",
                                       "pallas_flash.py:266"),
               "dynamic_conv": ("dynamic_conv.cu", "pallas_kernels.py:72")}
    kernels = [{"name": name, "route": "cuda",
                "source": f"news_image_caption_tpu_torch/csrc/{src}",
                "replaces": f"news_image_caption_tpu/ops/{tpu}",
                "launches": launches[name],
                "launches_by_path": by_path[name],
                "max_abs_err": timing[name]["max_abs_err"],
                "ms": timing[name]["ms"],
                "plain_ms": timing[name]["plain_ms"],
                "bound_ms": timing[name]["bound_ms"],
                "bound_by": timing[name]["bound_by"],
                "library_ms": timing[name]["library_ms"]}
               for name, (src, tpu) in sources.items()]
    print("(ms / plain_ms / library_ms / bound_ms: device time, CUDA events,"
          " and the card's least time at 3.35 TB/s and 989 TFLOP/s bf16 or"
          " 67 TFLOP/s fp32, of one decode step at"
          " batch 16 for the decode kernels and of one train step at batch"
          " 16 for the flash kernels, all layers; for dynamic_conv, one"
          " forward at B=16, T=512 of each flagship layer width, K ="
          " 3/7/15/31, summed, its library_ms the faster of the shift and"
          f" band routes a width; train step {step_ms:.2f} ms)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
