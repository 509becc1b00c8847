"""The dynamic conv kernel's launch plan, what it admits, and its tiling
written out block by block, on the CPU.

`dynamic_conv_plan` decides how `csrc/dynamic_conv.cu` cuts a call:
blocks of four warps over (segments of one or two time tiles, chunks of
64 channels, batch items), a lane a channel pair and `rows_per_thread`
rows of each tile, the taps staged as the words of w that hold them and
(K templated) a tile's taps in a [rows][head slots][tap slots] fp32
layout, and which instantiation runs. The kernel runs only on the card (test_torch_dispatch.py,
chip_smoke.py); here

  (a) the plan is checked as a pure function over a grid of shapes:
      every (b, t, c) covered exactly once, shared memory within the
      48 KB a block takes without opt-in, the tap rows 16-byte aligned,
      room for every row's words of w;
  (b) `admits` is what the launch accepts (the C entry point stubbed);
  (c) the kernel's staging and sums are written out in PyTorch block by
      block, with its index math, halo rows and zero rows: with the
      plain version's separate products it equals `dynamic_conv_plain`
      bit for bit, and with fused products (fp32 sums through float64,
      one rounding a tap) it lies within `dynamic_conv_tolerance`.
"""

import pytest

torch = pytest.importorskip("torch")

from news_image_caption_tpu_torch.ops import _build  # noqa: E402
from news_image_caption_tpu_torch.ops import dynamic_conv as dc  # noqa: E402

SM_SMEM = 228 * 1024
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
# (C, R) of the grid: C in 6 / 96 / 1024 with R = 3 / 32 / 64 / 2 where
# R divides C.
WIDTHS = [(C, R) for C in (6, 96, 1024) for R in (3, 32, 64, 2)
          if C % R == 0]


def _log2(n):
    return n.bit_length() - 1


@pytest.mark.parametrize("K", [1, 3, 5, 7, 15, 31])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_plan_covers_every_position_once(dtype, K):
    es = 4 if dtype == "fp32" else 2
    for B in (1, 3, 16):
        for T in (1, 63, 130, 512):
            for C, R in WIDTHS:
                H = C // R
                plan = dc.dynamic_conv_plan(B, T, C, H, K, DTYPES[dtype])
                tile, rows = plan.tile_rows, plan.rows_per_thread
                seg = plan.tiles * tile
                assert tile == dc.WARPS * rows and plan.channels == dc.CHUNK
                assert plan.tiles in (1, dc.SEGMENT)
                assert plan.tiles == 1 or (T > (plan.tiles - 1) * tile
                                           and plan.grid[0] * plan.grid[1]
                                           * B >= 132)
                assert plan.grid == (-(-T // seg), -(-C // dc.CHUNK), B)
                # Time rows: segment x, tile i, warp rg, row m of the warp.
                ts = [tx * seg + i * tile + rg * rows + m
                      for tx in range(plan.grid[0]) for i in range(plan.tiles)
                      for rg in range(dc.WARPS) for m in range(rows)]
                assert sorted(t for t in ts if t < T) == list(range(T))
                # Channels: chunk y, lane p, the pair's two channels.
                cs = [cy * dc.CHUNK + 2 * p + j for cy in range(plan.grid[1])
                      for p in range(dc.CHUNK // 2) for j in (0, 1)]
                assert sorted(c for c in cs if c < C) == list(range(C))
                # The tap layout: powers of two, rows of float4s, after
                # an x window of whole 16-byte lines.
                taps, heads = plan.tap_slots, plan.head_slots
                raw, touched = plan.raw_slots, dc.heads_touched(C, R)
                assert taps == max(4, 1 << (K - 1).bit_length()) >= K
                assert (taps * 4) % 16 == 0 and heads & (heads - 1) == 0
                assert touched <= heads <= dc.CHUNK
                assert raw & (raw - 1) == 0 and raw * 4 >= (touched * K + 1) * es
                assert ((seg + K - 1) * dc.CHUNK * es) % 16 == 0
                assert (seg * raw * 4) % 16 == 0
                templated = plan.instance != 0
                assert plan.smem_bytes == dc.dynamic_conv_smem_bytes(
                    tile, plan.tiles, K, heads, taps, raw, es,
                    templated) <= dc.SMEM_BUDGET
                assert plan.lines == ((C * es) % 16 == 0)
                fixed = (K in dc.FIXED_TAPS and R % 2 == 0
                         and dc.dynamic_conv_smem_bytes(
                             dc.WARPS * dc.FIXED_ROWS, 1, K, heads, taps, raw,
                             es, True) <= dc.SMEM_BUDGET)
                assert plan.instance == (K if fixed else 0)
                assert rows == dc.FIXED_ROWS or not fixed


@pytest.mark.parametrize("K", [3, 7, 15, 31])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_flagship_plan(dtype, K):
    """B=16, T=512, C=1024, H=16: the templated kernel, 16 rows a
    thread, one head a block (every tap load a warp broadcast),
    segments of two tiles (128 rows) where they fit 48 KB (fp32 at K=31:
    one); room for the four blocks a multiprocessor of the kernel's
    launch bounds in shared memory and threads, and a block for every
    one of 132 multiprocessors. At B=1 a segment is one tile, which
    keeps the most blocks."""
    plan = dc.dynamic_conv_plan(16, 512, 1024, 16, K, DTYPES[dtype])
    assert plan.instance == K and plan.rows_per_thread == 16
    assert plan.tile_rows == 64 and plan.head_slots == 1 and plan.lines
    want = 1 if dtype == "fp32" and K == 31 else 2
    assert plan.tiles == want
    assert plan.grid == (8 // plan.tiles, 16, 16)
    resident = min(SM_SMEM // plan.smem_bytes, 2048 // (32 * dc.WARPS))
    assert resident >= 4
    assert plan.grid[0] * plan.grid[1] * plan.grid[2] >= 132
    one = dc.dynamic_conv_plan(1, 512, 1024, 16, K, DTYPES[dtype])
    assert one.tiles == 1 and one.grid == (8, 16, 1)
    assert dc.dynamic_conv_plan(16, 512, 1024, 16, K, DTYPES[dtype],
                                sms=1) == plan


@pytest.mark.parametrize("B,T,K,dtype,want", [
    (16, 512, 3, torch.bfloat16, 2),    # 512 blocks of two tiles
    (16, 512, 31, torch.float32, 1),    # two tiles do not fit 48 KB
    (2, 512, 3, torch.bfloat16, 1),     # two tiles leave 64 of 132 blocks
    (3, 512, 7, torch.bfloat16, 2),     # 3 x 4 x 16 = 192 blocks of two
    (16, 64, 3, torch.bfloat16, 1),     # T is one tile
    (16, 65, 15, torch.bfloat16, 2),    # the second tile one row
])
def test_plan_walks_two_tiles_where_they_pay(B, T, K, dtype, want):
    """A block walks two tiles where T has a second, they fit 48 KB and
    the grid keeps a block for each of 132 multiprocessors; else one."""
    plan = dc.dynamic_conv_plan(B, T, 1024, 16, K, dtype)
    assert plan.tiles == want
    assert plan.grid == (-(-T // (want * plan.tile_rows)), 16, B)


@pytest.mark.parametrize("shape,dtype,match", [
    ((1, 8, 64, 4, 32), torch.bfloat16, "1 <= K <= 31"),
    ((1, 8, 64, 4, 0), torch.bfloat16, "1 <= K <= 31"),
    ((1, 8, 63, 3, 3), torch.bfloat16, "C even"),
    ((1, 8, 64, 6, 3), torch.float32, "C % H == 0"),
    ((1, 0, 64, 4, 3), torch.float32, "T >= 1"),
    ((0, 8, 64, 4, 3), torch.bfloat16, "B <= 65535"),
    ((65536, 8, 64, 4, 3), torch.bfloat16, "B <= 65535"),
    ((1, 8, 64, 4, 3), torch.float16, "bf16 or both fp32"),
])
def test_plan_refuses(shape, dtype, match):
    assert dc.admits(dtype, *shape)[0] is False
    with pytest.raises(ValueError, match=match):
        dc.dynamic_conv_plan(*shape, dtype)


@pytest.fixture
def stub_library(monkeypatch):
    """The C entry point as a stub that records its arguments and
    succeeds, so `_launch` runs its checks on CPU tensors."""
    calls = []

    def function(name, argtypes):
        assert len(argtypes) == 20
        return lambda *args: calls.append(args) or 0

    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(_build, "sms_of", lambda d: 132)
    return calls


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
@pytest.mark.parametrize("B,T,C,H,K", [
    (16, 512, 1024, 16, 31), (1, 1, 64, 4, 1), (2, 63, 96, 3, 31),
    (2, 130, 6, 2, 5), (1, 77, 1024, 512, 7), (2, 8, 64, 4, 32),
    (2, 8, 63, 3, 3), (2, 8, 64, 6, 3), (1, 8, 64, 64, 31)])
def test_admits_is_what_the_launch_accepts(stub_library, dtype, B, T, C, H,
                                           K):
    ok, why = dc.admits(dtype, B, T, C, H, K)
    x = torch.zeros(B, T, C, dtype=dtype)
    w = torch.zeros(B, T, H, K, dtype=dtype)
    before = dc.dynamic_conv.launches
    try:
        dc._launch(x, w, H)
        got = (True, "")
    except ValueError as e:
        got = (False, str(e))
    assert got == (ok, why)
    assert dc.dynamic_conv.launches == before + ok
    assert ok == (dtype in (torch.bfloat16, torch.float32) and K <= 31
                  and C % 2 == 0 and C % H == 0)
    if ok:      # the plan is what reaches the kernel
        plan = dc.dynamic_conv_plan(B, T, C, H, K, dtype)
        assert stub_library[-1][3:19] == (
            B, T, C, H, K, x.element_size(), plan.tile_rows,
            plan.rows_per_thread, plan.tiles, plan.channels,
            plan.head_slots, plan.tap_slots, plan.raw_slots, int(plan.lines),
            plan.smem_bytes, plan.instance)


@pytest.mark.parametrize("dtype,offset,lines", [
    (torch.bfloat16, 0, True), (torch.bfloat16, 2, False),
    (torch.bfloat16, 8, True), (torch.float32, 2, False),
    (torch.float32, 4, True)])
def test_unaligned_x_moves_as_pairs(stub_library, dtype, offset, lines):
    """x at `offset` elements into its storage, still aligned to a
    channel pair: 16-byte lines only where x is 16-byte aligned."""
    x = torch.zeros(2 * 64 * 128 + offset, dtype=dtype)[offset:].view(
        2, 64, 128)
    w = torch.zeros(2, 64, 2, 3, dtype=dtype)
    dc._launch(x, w, 2)
    plan = dc.dynamic_conv_plan(2, 64, 128, 2, 3, dtype, 132, lines)
    assert plan.lines == lines
    assert stub_library[-1][3:19] == (
        2, 64, 128, 2, 3, x.element_size(), *plan[:7], int(lines),
        plan.smem_bytes, plan.instance)


@pytest.mark.parametrize("dtype,offset", [(torch.bfloat16, 1),
                                          (torch.float32, 1)])
def test_launch_refuses_x_off_a_channel_pair(stub_library, dtype, offset):
    x = torch.zeros(2 * 64 * 128 + offset, dtype=dtype)[offset:].view(
        2, 64, 128)
    w = torch.zeros(2, 64, 2, 3, dtype=dtype)
    with pytest.raises(ValueError, match="aligned to a channel pair"):
        dc._launch(x, w, 2)
    assert stub_library == []


# -- (c) the kernel written out block by block --------------------------------

def emulate(x, w, H, fused):
    """The kernel's output, block by block and lane row by lane row as
    csrc/dynamic_conv.cu computes it, with the longest segments the plan
    takes (`sms=1`): its segment's x window with halo
    and zero rows, each row's taps read from the words of w that hold
    them (at element e0 % 2 of the first for bf16) and, K templated,
    staged as fp32 by the same shift arithmetic; sums in tap order.
    `fused`: each tap one rounding of w x + s to fp32 (through float64,
    where w x is exact), as fmaf; else the product and the sum rounded
    apart, as the plain version."""
    B, T, C = x.shape
    K = w.shape[-1]
    R = C // H
    es = x.element_size()
    plan = dc.dynamic_conv_plan(B, T, C, H, K, x.dtype, sms=1)
    tile, rows, seg = plan.tile_rows, plan.rows_per_thread, plan.tiles * plan.tile_rows
    lt, lh = _log2(plan.tap_slots), _log2(plan.head_slots)
    xf, wflat = x.float(), w.float().reshape(-1)
    out = torch.full((B, T, C), float("nan"))
    for b in range(plan.grid[2]):
        for cy in range(plan.grid[1]):
            c0 = cy * dc.CHUNK
            width = min(dc.CHUNK, C - c0)
            h0 = c0 // R
            nh = (c0 + width - 1) // R - h0 + 1
            slot = torch.arange(c0, c0 + width) // R - h0   # a channel's head
            for sx in range(plan.grid[0]):
                t0 = sx * seg
                win = torch.zeros(seg + K - 1, width)
                for r in range(seg + K - 1):
                    if 0 <= t0 - K + 1 + r < T:
                        win[r] = xf[b, t0 - K + 1 + r, c0:c0 + width]

                def tap_row(t):
                    """Row t's taps [nh, K] from its words of w."""
                    e0 = ((b * T + t) * H + h0) * K
                    first, end = e0 * es // 4, ((e0 + nh * K) * es + 3) // 4
                    assert end - first <= plan.raw_slots
                    base = first * 4 // es           # the first word's element
                    odd = e0 - base
                    assert odd == (e0 % 2 if es == 2 else 0)
                    return wflat[base + odd:base + odd + nh * K].view(nh, K)

                for i in range(plan.tiles):
                    ti = t0 + i * tile
                    if ti >= T:
                        break
                    if plan.instance:    # fp32 staging, the kernel's indices
                        j = torch.arange(tile << (lh + lt))
                        k, hh = j & ((1 << lt) - 1), (j >> lt) & ((1 << lh) - 1)
                        r = j >> (lh + lt)
                        rows_taps = torch.stack([
                            tap_row(ti + q) if ti + q < T else
                            torch.zeros(nh, K) for q in range(tile)])
                        ok = (k < K) & (hh < nh) & (ti + r < T)
                        ws = torch.zeros(j.shape[0])
                        ws[ok] = rows_taps[r[ok], hh[ok], k[ok]]
                        ws = ws.view(tile, 1 << lh, 1 << lt)
                    for r in range(tile):      # warp r // rows, row r % rows
                        t = ti + r
                        if t >= T:
                            continue
                        wt = ws[r] if plan.instance else tap_row(t)
                        s = torch.zeros(width)
                        for kk in range(K):
                            wk, xk = wt[slot, kk], win[i * tile + r + kk]
                            s = ((wk.double() * xk.double() + s.double())
                                 .float() if fused else s + wk * xk)
                        assert bool(out[b, t, c0:c0 + width].isnan().all())
                        out[b, t, c0:c0 + width] = s
    assert not bool(out.isnan().any())
    return out.to(x.dtype)


CASES = [(2, 70, 128, 2, 7),    # templated K, two chunks, a ragged tile
         (1, 300, 64, 1, 3),     # segments of two tiles, the last one tile
         (1, 40, 96, 48, 3),     # R = 2: 32 heads a chunk
         (2, 63, 96, 3, 31),     # R = 32, generic: T below the halo
         (1, 130, 6, 2, 5),      # odd R: a pair spans two heads; pairs
         (3, 1, 64, 4, 1)]       # one row, one tap


def _inputs(B, T, C, H, K, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, T, C, generator=g).to(dtype)
    w = torch.softmax(torch.randn(B, T, H, K, generator=g), -1).to(dtype)
    return x, w


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("B,T,C,H,K", CASES)
def test_emulated_kernel_with_separate_products_is_plain(B, T, C, H, K,
                                                         dtype):
    x, w = _inputs(B, T, C, H, K, DTYPES[dtype], T + K)
    assert torch.equal(emulate(x, w, H, fused=False),
                       dc.dynamic_conv_plain(x, w, H))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("B,T,C,H,K", CASES)
def test_emulated_fused_kernel_is_within_the_tolerance(B, T, C, H, K, dtype):
    """Taps of mixed sign over a large common x make sums that cancel
    to near zero, where a bf16 unit of the output is smallest."""
    x, w = _inputs(B, T, C, H, K, DTYPES[dtype], 7 * T + K)
    x = (x.float() + 3.0).to(x.dtype)
    w = (w.float() - 1.0 / K).to(w.dtype)
    got = emulate(x, w, H, fused=True)
    diff = (got.float() - dc.dynamic_conv_plain(x, w, H).float()).abs()
    assert bool((diff <= dc.dynamic_conv_tolerance(x, w, H)).all())
