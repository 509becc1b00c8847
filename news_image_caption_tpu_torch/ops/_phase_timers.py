"""Where the time of one launch of a redesigned kernel goes, phase by
phase.

It needs only the card, no profiler. It
builds the kernels with `-DNIC_PHASE_TIMERS`, which turns every
`NIC_PHASE(i)` marker of `csrc/decode_ffn.cu`, `csrc/decode_blocks.cu`,
`csrc/band_topk.cu`, `csrc/decode_attention.cu`,
`csrc/flash_attention.cu`, `csrc/dynamic_conv.cu` and the held-row
forward of `csrc/flash_generic.cu` into a stamp
of the multiprocessor's cycle counter and the card's nanosecond timer
by thread 0 of every block (`csrc/common.cuh`). It launches each kernel
once at the flagship's shapes (a decode step's for the decode kernels,
a train step's for the flash kernels, fp32 for the generic forward,
B=16, T=512 for the dynamic conv) with the L2 cache flushed, reads
the stamps back and prints, for every phase, the mean and the largest
time a block spent in it, when the blocks started and ended relative to
the first, and the launch's span. The stamps cost a few hundred cycles a block, so the
span reads a little above the kernel's time in `chip_smoke.py`.

The generic conv block and FFN (`csrc/decode_generic.cu`) run several
device kernels a call. For them it prints, at the fp32 flagship's greedy
(16 rows) and beam-5 B=16 (80 rows) shapes, K = 3 / 7 / 15 / 31, the
device time of each kernel of an L2-cold call (`torch.profiler`'s CUDA
activity, the median of five calls), the bytes that kernel must move and
the operations it must do as shares of the card's 3.35 TB/s and 67
TFLOP/s fp32, and the whole call's time by CUDA events (the mean of 20
L2-cold calls), beside the time `torch.sum` takes to read one FFN
weight (16.8 MB) under the same method. Where the sources carry them,
`NIC_PHASE_ADD` sums (`csrc/common.cuh`) split each product's blocks
between issuing and waiting for their operands, multiplying, the depth
slices' and splits' sums and the epilogue.

Run on the card, from the repository root:
    python3 -m news_image_caption_tpu_torch.ops._phase_timers
    python3 -m news_image_caption_tpu_torch.ops._phase_timers --generic
(the second: the generic conv block and FFN alone).
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from news_image_caption_tpu_torch.ops import (_build, band_topk,
                                              decode_attention,
                                              decode_blocks, dynamic_conv,
                                              flash_attention)

SLOTS, BLOCKS = 16, 2048        # PHASE_SLOTS, PHASE_BLOCKS of common.cuh
FFN_PHASES = ["issue loads", "wait x, w1", "fc1", "h, group barrier",
              "read h, wait w2", "fc2", "slice barrier",
              "add groups, write y"]
CONV_PHASES = ["issue loads", "wait x, w1", "linear1, GLU",
               "barrier: every block's h", "read h, wait taps",
               "tap logits, softmax", "ring combine",
               "barrier: every block's conv output", "read conv output",
               "linear2, write y"]
BAND_PHASES = ["issue loads", "walk the tiles", "write partials"]
ATTENTION_PHASES = ["issue loads", "wait K", "scores", "row max, sum",
                    "cluster barrier", "p", "wait V", "p V",
                    "cluster barrier", "add partials, write out"]
FLASH_FWD_PHASES = ["issue loads", "wait first tile",
                    "walk 1: row max, sum", "walk 2: p, p v", "write out"]
DYNAMIC_CONV_PHASES = ["start", "issue every copy",
                       "wait for the first tile",
                       "every tile's taps, sums, writes (warp 0)"]
FLASH_GENERIC_FWD_PHASES = ["start", "scores (q k^T, K chunks)",
                            "softmax", "p v (V chunks)", "write out"]
FLASH_BWD_PHASES = ["issue loads", "wait first tile",
                    "walk 1: probs, dp, delta, dv", "walk 2: ds, dq, dk",
                    "write dq"]


def read_stamps(reader: str) -> np.ndarray:
    """[2 (cycles, ns), BLOCKS, SLOTS] int64 of the last launch."""
    host = np.zeros((2, BLOCKS, SLOTS), np.int64)
    fn = _build.function(reader, [_build.P])
    torch.cuda.synchronize()
    _build.check(fn(host.ctypes.data_as(ctypes.c_void_p)), reader)
    return host


def report(title: str, stamps: np.ndarray, blocks: int, phases) -> None:
    blocks = min(blocks, BLOCKS)
    n = len(phases)
    cycles, ns = stamps[0, :blocks, :n], stamps[1, :blocks, :n]
    ran_last = cycles[:, n - 1] != 0     # blocks that stamped the last phase
    t0 = ns[:, 0].min()
    end = np.where(ran_last, ns[:, n - 1], ns[:, n - 2])
    life = np.where(ran_last, cycles[:, n - 1], cycles[:, n - 2]) - cycles[:, 0]
    ghz = float(np.median(life / np.maximum(end - ns[:, 0], 1)))
    print(f"{title}: {blocks} blocks, span of the launch"
          f" {(end.max() - t0) / 1e3:.2f} us (first stamp to last), a block"
          f" lives {np.mean(end - ns[:, 0]) / 1e3:.2f} us on average,"
          f" {ghz:.2f} cycles a ns")
    print(f"  blocks start {np.mean(ns[:, 0] - t0) / 1e3:.2f} us after the"
          f" first on average, the last {(ns[:, 0].max() - t0) / 1e3:.2f} us"
          f" after; they end {np.mean(end - t0) / 1e3:.2f} us after it on"
          " average")
    for i in range(1, n):
        d = (cycles[:, i] - cycles[:, i - 1]) / ghz / 1e3
        if i == n - 1:
            d = d[ran_last]
        print(f"  {phases[i]:36s} mean {d.mean():6.2f} us, max {d.max():6.2f}"
              f" us ({d.size} blocks)")


def kernel_calls(fn, flush, runs: int = 5) -> list:
    """The device kernels of `runs` L2-cold calls of fn(), in launch
    order: a list a call of (kernel name, device us)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    calls, cur = [], None
    for e in events:
        if "nic::" not in e.name:          # the flush between two calls
            cur = None
            continue
        if cur is None:
            cur = []
            calls.append(cur)
        cur.append((e.name, e.time_range.elapsed_us()))
    return calls


def call_ms(fn, flush, iters: int = 20) -> float:
    """Mean device ms of an L2-cold call (CUDA events, as chip_smoke.py's
    time_ms: the flush, then a spin so that the host enqueues the whole
    call before the start event)."""
    for _ in range(3):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


# What each product of a generic call must move and do: (bytes, flops)
# of x [N, C] through the FFN (C, F) or the conv block (C, H heads, K).
def _ffn_work(N, C, F):
    return {"fc1": (4 * (N * C + C * F + N * F), 2 * N * C * F),
            "fc2": (4 * (N * F + F * C + 2 * N * C), 2 * N * F * C)}


def _conv_work(N, C, H, K, taps_product: bool):
    mix_bytes = 4 * ((K - 1) * N * C + 2 * N * C + N * H * K)
    mix_flops = 2 * (K - 1) * N * C
    work = {"linear1": (4 * (N * C + 2 * C * C + N * C), 4 * N * C * C),
            "linear2": (4 * (N * C + C * C + 2 * N * C), 2 * N * C * C)}
    taps = (4 * (N * C + C * H * K + N * H * K), 2 * N * C * H * K)
    if taps_product:
        work["taps"] = taps
        work["mix"] = (mix_bytes, mix_flops)
    else:                        # the taps' product inside the mix kernel
        work["mix"] = (mix_bytes + taps[0], mix_flops + taps[1])
    return work


def _label_kernels(call, products):
    """(label, name, us) for the kernels of one call: a name with `mix`
    is the conv block's mix, one with `split_epilogue` (sources whose
    products add their depth splits in a second kernel) the split sum of
    the product before it, any other the next of `products`."""
    out, left, last = [], list(products), None
    for name, us in call:
        if "mix" in name:
            label = "mix"
        elif "split_epilogue" in name:
            label = f"{last} split sum"
        else:
            label = last = left.pop(0)
        out.append((label, name, us))
    return out


def report_generic(title, calls, work, products, whole_ms, sums) -> None:
    labelled = [_label_kernels(c, products) for c in calls]
    print(f"{title}: {len(calls[0])} kernels a call, the call"
          f" {whole_ms * 1e3:.2f} us (CUDA events)")
    for i, (label, name, _) in enumerate(labelled[0]):
        us = float(np.median([c[i][2] for c in labelled]))
        line = f"  {label:18s} {us:8.2f} us"
        if label in work:
            nbytes, flops = work[label]
            line += (f"  {nbytes / 1e6:7.2f} MB at"
                     f" {nbytes / (us * 1e-6) / 3.35e12 * 100:5.1f}% of"
                     f" 3.35 TB/s, {flops / 1e6:7.1f} MFLOP at"
                     f" {flops / (us * 1e-6) / 67e12 * 100:5.1f}% of 67"
                     " TFLOP/s")
        print(line + f"  [{name.split('(')[0][-60:]}]")
    for label, row in sums.items():
        print(f"  {label}: {row}")


GENERIC_SUM_KINDS = ["fc1 (relu)", "fc2 / linear2 (residual)",
                     "fc2 (sums)", "linear1 (glu)", "tap logits", "mix"]
# Slots of a kind (csrc/decode_generic.cu::PROD_PHASES): blocks, then
# cycles a phase summed over the blocks (thread 0's clock), the blocks'
# lives in ns and in cycles, the first start (as its complement), the
# last start and the last end in ns, and cycles issuing the first chunks.
GENERIC_SUM_SLOTS = ["blocks", "wait for chunks", "multiply",
                     "add slices, write partials, arrive",
                     "last block: add splits", "epilogue"]
LIFE_NS, LIFE_CYCLES, FIRST_START, LAST_START, LAST_END, FIRST_CHUNKS = (
    6, 7, 8, 9, 10, 11)


def read_generic_sums() -> dict:
    """The generic blocks' phase sums of the last call, as mean us a
    block per kind and slot, and when the kind's blocks started and
    ended; {} where the library has none."""
    try:
        fn = _build.function("nic_decode_generic_sums", [_build.P])
    except AttributeError:
        return {}
    host = np.zeros((8, 12), np.uint64)
    torch.cuda.synchronize()
    _build.check(fn(host.ctypes.data_as(ctypes.c_void_p)),
                 "nic_decode_generic_sums")
    out = {}
    for k, kind in enumerate(GENERIC_SUM_KINDS):
        blocks = int(host[k, 0])
        if blocks == 0:
            continue
        ghz = float(host[k, LIFE_CYCLES]) / max(float(host[k, LIFE_NS]), 1.0)
        first = int(~host[k, FIRST_START])
        slots = [(FIRST_CHUNKS, "issue first chunks")] + list(
            enumerate(GENERIC_SUM_SLOTS))[1:]
        phases = ", ".join(f"{name} {host[k, s] / blocks / ghz / 1e3:.2f}"
                           for s, name in slots)
        out[kind] = (f"{blocks} blocks, {ghz:.2f} cycles a ns; span"
                     f" {(int(host[k, LAST_END]) - first) / 1e3:.2f} us,"
                     f" the last start"
                     f" {(int(host[k, LAST_START]) - first) / 1e3:.2f} us"
                     f" after the first; mean us a block: life"
                     f" {host[k, LIFE_NS] / blocks / 1e3:.2f}, {phases}")
    return out


def generic_blocks(dev, flush) -> None:
    """The generic conv block and FFN at the fp32 flagship's greedy and
    beam-5 B=16 shapes: each kernel of a call, its share of the card's
    rates, and the blocks' NIC_PHASE_ADD sums; first, a plain read of w1
    (`torch.sum`) under the same method."""
    gen = torch.Generator(device=dev).manual_seed(29)
    sums_reset = None
    try:
        sums_reset = _build.function("nic_decode_generic_sums", [_build.P])
    except AttributeError:
        pass

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def sums_of(fn):
        if sums_reset is None:
            return {}
        fn()
        torch.cuda.synchronize()
        _build.check(sums_reset(None), "nic_decode_generic_sums")
        flush.zero_()
        fn()
        return read_generic_sums()

    D, H, F = 1024, 16, 4096
    w1, b1 = rn(D, F, scale=D ** -0.5), rn(F, scale=0.05)
    w2, b2 = rn(F, D, scale=F ** -0.5), rn(D, scale=0.05)
    # What a plain read of one FFN weight takes under the same L2-cold
    # method, the yardstick of a product bound by its bytes.
    print(f"torch.sum of w1 ({w1.numel() * 4 / 1e6:.2f} MB):"
          f" {call_ms(lambda: w1.sum(), flush) * 1e3:.2f} us (CUDA events)")
    for N in (16, 80):
        x = rn(N, D)
        fn = lambda: decode_blocks.decode_ffn_block_generic(x, w1, b1, w2, b2)
        report_generic(f"decode_ffn_block_generic fp32 N={N} C={D} F={F}",
                       kernel_calls(fn, flush), _ffn_work(N, D, F),
                       ["fc1", "fc2"], call_ms(fn, flush), sums_of(fn))
    cw1, cb1 = rn(D, 2 * D, scale=D ** -0.5), rn(2 * D, scale=0.05)
    cw2, cb2 = rn(D, D, scale=D ** -0.5), rn(D, scale=0.05)
    for N in (16, 80):
        for K in (3, 7, 15, 31):
            x, cache = rn(N, D), rn(K - 1, N, D, scale=0.5)
            wl = rn(D, H * K, scale=0.3)
            taps = decode_blocks.pack_taps(wl, H)
            fn = lambda: decode_blocks.decode_conv_block_generic(
                x, cache, 2 * K + 3, cw1, cb1, wl, cw2, cb2, H, taps=taps)
            calls = kernel_calls(fn, flush)
            n_products = sum("mix" not in n and "split_epilogue" not in n
                             for n, _ in calls[0])
            products = (["linear1", "taps", "linear2"] if n_products == 3
                        else ["linear1", "linear2"])
            report_generic(f"decode_conv_block_generic fp32 N={N} C={D}"
                           f" H={H} K={K}", calls,
                           _conv_work(N, D, H, K, n_products == 3), products,
                           call_ms(fn, flush), sums_of(fn))


def main() -> None:
    assert torch.cuda.is_available(), "the phase timers need the card"
    _build.lib(("-DNIC_PHASE_TIMERS",))
    if "--generic" in sys.argv[1:]:
        dev = torch.device("cuda")
        torch.backends.cuda.matmul.allow_tf32 = False
        flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
        print(f"card: {torch.cuda.get_device_name(0)}", flush=True)
        generic_blocks(dev, flush)
        return
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).bfloat16()

    def cold(fn, reader):
        """One launch with zeroed stamps and a flushed L2, after three
        to warm up."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        _build.check(_build.function(reader, [_build.P])(None), reader)
        flush.zero_()
        torch.cuda.synchronize()
        fn()

    D, H, F = 1024, 16, 4096
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    w1, b1 = rn(D, F, scale=D ** -0.5), rn(F, scale=0.05)
    w2, b2 = rn(F, D, scale=F ** -0.5), rn(D, scale=0.05)
    for N in (16, 1):
        x = rn(N, D)
        cold(lambda: decode_blocks.decode_ffn_block(x, w1, b1, w2, b2),
             "nic_decode_ffn_phases")
        plan = decode_blocks.ffn_plan(N, D, F, sms)
        report(f"decode_ffn_block N={N} C={D} F={F}",
               read_stamps("nic_decode_ffn_phases"), plan.blocks,
               FFN_PHASES)
    cw1, cb1 = rn(D, 2 * D, scale=D ** -0.5), rn(2 * D, scale=0.05)
    cw2, cb2 = rn(D, D, scale=D ** -0.5), rn(D, scale=0.05)
    # Past 16 rows a stage walks several row tiles and its stamps are the
    # last tile's: the first phase of a stage then holds the tiles before.
    for N, K in ((16, 31), (16, 3), (1, 31), (80, 31), (80, 3)):
        x, cache = rn(N, D), rn(K - 1, N, D, scale=0.5)
        wl = rn(D, H * K, scale=0.05)
        taps = decode_blocks.pack_taps(wl, H)
        cold(lambda: decode_blocks.decode_conv_block(
            x, cache, K + 2, cw1, cb1, wl, cw2, cb2, H, taps=taps),
             "nic_decode_conv_phases")
        plan = decode_blocks.conv_block_plan(N, D, H, K, sms)
        report(f"decode_conv_block N={N} C={D} K={K} ({plan.groups} groups"
               f" share {plan.row_tiles} row tiles)",
               read_stamps("nic_decode_conv_phases"),
               plan.blocks * plan.groups, CONV_PHASES)
    for N, V, k in ((16, 5002, 1), (16, 30265, 1), (16, 30265, 5),
                    (80, 30265, 5)):
        x, table = rn(N, D), rn(V, D, scale=D ** -0.5)
        cold(lambda: band_topk.band_topk_lse(x, table, k),
             "nic_band_topk_phases")
        plan = band_topk.band_plan(N, D, V, k, sms)
        report(f"band_topk_lse N={N} V={V} k={k} ({plan.tiles_per_block}"
               f" tiles a block at most, {plan.stages} slots of {plan.kc}"
               " columns)", read_stamps("nic_band_topk_phases"), plan.blocks,
               BAND_PHASES)
    for B, S in ((16, 514), (16, 51), (1, 514), (1, 51)):
        q, k, v = rn(B, 1, D, scale=0.125), rn(B, S, D), rn(B, S, D)
        bias = torch.zeros(B, S, device=dev)
        cold(lambda: decode_attention.decode_cross_attention(q, k, v, bias,
                                                             H),
             "nic_decode_attention_phases")
        plan = decode_attention.attention_plan(B, 1, S, H, D // H, sms)
        report(f"decode_cross_attention B={B} Q=1 S'={S} ({plan.splits}"
               f" splits of {plan.per} keys)",
               read_stamps("nic_decode_attention_phases"),
               H * B * plan.splits, ATTENTION_PHASES)
    B, T, p = 16, 63, 0.1
    seed = torch.tensor([1234], dtype=torch.int32, device=dev)
    for S in (514, 51):
        q, k, v = rn(B, T, D, scale=0.125), rn(B, S, D), rn(B, S, D)
        g, bias = rn(B, T, D, scale=0.1), torch.zeros(B, S, device=dev)
        lse = flash_attention.flash_attention_fwd(q, k, v, bias, seed, H,
                                                  p)[1]
        plan = flash_attention.flash_plan(B, T, S, H, D // H, sms)
        cold(lambda: flash_attention.flash_attention_fwd(q, k, v, bias, seed,
                                                         H, p),
             "nic_flash_phases")
        report(f"flash_attention_fwd B={B} T={T} S'={S} ({plan.key_tiles}"
               f" key tiles, {plan.fwd.stages} slots)",
               read_stamps("nic_flash_phases"), plan.blocks, FLASH_FWD_PHASES)
        cold(lambda: flash_attention.flash_attention_bwd(q, k, v, bias, seed,
                                                         lse, g, H, p),
             "nic_flash_phases")
        report(f"flash_attention_bwd B={B} T={T} S'={S} ({plan.key_tiles}"
               f" key tiles, {plan.bwd.stages} slots)",
               read_stamps("nic_flash_phases"), plan.blocks, FLASH_BWD_PHASES)
    for S in (514, 51):
        q, k, v = (rn(B, T, D, scale=0.125).float(), rn(B, S, D).float(),
                   rn(B, S, D).float())
        bias = torch.zeros(B, S, device=dev)
        plan = flash_attention.generic_flash_plan(B, T, S, H, D // H)
        cold(lambda: flash_attention.flash_attention_fwd_generic(
            q, k, v, bias, seed, H, p), "nic_flash_generic_phases")
        report(f"flash_attention_fwd_generic fp32 B={B} T={T} S'={S}"
               f" ({plan.fwd_rows} held rows, {plan.fwd_stages} slots)",
               read_stamps("nic_flash_generic_phases"), plan.fwd_blocks,
               FLASH_GENERIC_FWD_PHASES)
    x = rn(16, 512, D)
    for K in (3, 31):
        w = torch.softmax(rn(16, 512, H, K).float(), -1).bfloat16()
        cold(lambda: dynamic_conv.dynamic_conv(x, w, H),
             "nic_dynamic_conv_phases")
        plan = dynamic_conv.dynamic_conv_plan(16, 512, D, H, K, torch.bfloat16)
        report(f"dynamic_conv B=16 T=512 C={D} H={H} K={K} ({plan.tiles}"
               f" tiles of {plan.tile_rows} rows, {plan.channels} channels a"
               " block)",
               read_stamps("nic_dynamic_conv_phases"),
               plan.grid[0] * plan.grid[1] * plan.grid[2], DYNAMIC_CONV_PHASES)


if __name__ == "__main__":
    main()
