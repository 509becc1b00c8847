"""The host-side plans and the algorithms of the head and conv-block
kernels designed for the H100, on the CPU.

`band_topk_lse` gives every block a share of the vocab tiles to walk in
ascending order with carried (max, sumexp, top-k), and merges the
blocks' states in block order; `decode_conv_block` gives every block 16
channels of linear1, the ring combine and linear2, and its head's taps
in a packed layout. The CUDA kernels run only on the card
(test_torch_dispatch.py, chip_smoke.py); here

  (a) the plans (`band_plan`, `conv_block_plan`) are checked as pure
      functions: every vocab id, channel and tap is covered exactly
      once, the table is walked once for up to 128 rows, a block's
      shared memory fits the card's 232,448 bytes and a cooperative
      launch's blocks fit on the card;
  (b) the two algorithms are written out in PyTorch block by block, with
      the kernels' summation orders and bf16 rounding points, and held
      against the plain versions, ties to the lowest id included.
"""

import pytest

torch = pytest.importorskip("torch")

from news_image_caption_tpu_torch.ops.band_topk import (  # noqa: E402
    MAX_BLOCKS, TILE, band_plan, band_smem_bytes,
    band_topk_lse_plain)
from news_image_caption_tpu_torch.ops.decode_blocks import (  # noqa: E402
    CONV_ROWS, CONV_STRIP, conv_block_plan, conv_block_smem_bytes,
    decode_conv_block_plain, pack_taps)

SMEM_LIMIT = 232448
SM_SMEM = 228 * 1024
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, so that the suite's parallel
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bf16_ulp(t):
    """One bf16 unit in the last place at the magnitude of t (fp32)."""
    mag = t.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


# -- (a) the plans ---------------------------------------------------------

def block_tiles(plan, b):
    """Vocab tiles of block b, in the order it walks them."""
    return list(range(b, plan.n_tiles, plan.blocks))


@pytest.mark.parametrize("sms", [132, 108])
@pytest.mark.parametrize("k", [1, 5, 16])
@pytest.mark.parametrize("V", [1, 63, 64, 65, 5002, 15000, 30265])
@pytest.mark.parametrize("N", [1, 5, 16, 80, 128])
def test_band_plan_covers_every_vocab_id_once(N, V, k, sms):
    k = min(k, V)                                     # a band of one row
    plan = band_plan(N, 1024, V, k, sms)
    assert plan.tile == TILE and plan.n_tiles == -(-V // TILE)
    ids = []
    for b in range(plan.blocks):
        tiles = block_tiles(plan, b)
        assert 1 <= len(tiles) <= plan.tiles_per_block   # no idle block
        assert tiles == sorted(tiles)                     # ids ascend
        for t in tiles:
            ids += range(t * TILE, min(V, (t + 1) * TILE))
    assert sorted(ids) == list(range(V))                  # exactly once
    assert plan.blocks <= min(sms, MAX_BLOCKS)            # one a multiprocessor
    assert plan.launches == 1         # the table once a call up to 128 rows
    assert plan.rows in (16, 32, 128) and plan.rows >= N
    assert plan.x_resident == (plan.rows <= 32)
    assert 1024 % plan.kc == 0 and 2 <= plan.stages <= 4
    assert plan.smem_bytes == band_smem_bytes(
        plan.rows, 1024, plan.kc, plan.stages, plan.x_resident) <= SMEM_LIMIT
    # A block keeps at least 32 KB of table requested.
    assert (plan.stages - 1) * TILE * plan.kc * 2 >= 32 * 1024
    assert plan.scratch_floats == 2 * plan.rows * plan.blocks * (1 + k)


def test_band_smem_is_the_layout_written_out():
    rows, D, kc, stages = 16, 1024, 256, 4
    x = rows * (D + 8) * 2
    ring = stages * TILE * (kc + 8) * 2
    logits = rows * (TILE + 8) * 2
    lists = rows * 16 * (4 + 4)
    assert band_smem_bytes(rows, D, kc, stages, True) == x + ring + logits + lists
    streamed = stages * (TILE + rows) * (kc + 8) * 2
    assert band_smem_bytes(rows, D, kc, stages, False) == (
        streamed + logits + lists)
    # The flagship's greedy step: x resident, four slots of 256 columns.
    plan = band_plan(16, 1024, 30265, 1, 132)
    assert (plan.x_resident, plan.kc, plan.stages, plan.blocks,
            plan.tiles_per_block) == (True, 256, 4, 132, 4)
    # A beam step of 80 rows streams x beside the table.
    plan = band_plan(80, 1024, 30265, 5, 132)
    assert (plan.rows, plan.x_resident, plan.kc) == (128, False, 128)
    # More than 128 rows: further launches, each walking the table.
    assert band_plan(300, 1024, 5002, 5, 132).launches == 3
    # A width whose 16 rows do not fit beside the ring streams them.
    assert not band_plan(16, 4096, 5002, 1, 132).x_resident


@pytest.mark.parametrize("N,D,V,k", [(0, 1024, 100, 1), (4, 96, 100, 1),
                                     (4, 32, 100, 1), (4, 1024, 0, 1),
                                     (4, 1024, 100, 17), (4, 1024, 100, 0),
                                     (4, 1024, 3, 5)])
def test_band_plan_refuses(N, D, V, k):
    with pytest.raises(ValueError, match="band_topk_lse"):
        band_plan(N, D, V, k, 132)


@pytest.mark.parametrize("sms", [132, 108])
@pytest.mark.parametrize("K", [2, 3, 7, 15, 31])
@pytest.mark.parametrize("N", [1, 5, 16, 80, 128])
def test_conv_block_plan_covers_every_channel_and_tap_once(N, K, sms):
    C, H = 1024, 16
    plan = conv_block_plan(N, C, H, K, sms)
    strips = [range(s * plan.strip, (s + 1) * plan.strip)
              for s in range(plan.blocks)]
    assert [c for s in strips for c in s] == list(range(C))
    R = C // H
    for s in strips:                                   # a strip, one head
        assert s[0] // R == s[-1] // R
    assert plan.blocks_per_head * H == plan.blocks
    assert plan.taps in (8, 16, 32) and K <= plan.taps < max(2 * K, 9)
    # Up to 128 rows are one launch, in tiles of 16 rows, which the
    # groups of blocks share: group g takes tiles g, g + groups, ...
    assert plan.launches == 1
    assert (plan.row_tiles - 1) * CONV_ROWS < N <= plan.row_tiles * CONV_ROWS
    assert conv_block_plan(300, C, H, K, sms).launches == 3
    assert 1 <= plan.groups <= plan.row_tiles
    assert sorted(tile for g in range(plan.groups) for tile in
                  range(g, plan.row_tiles, plan.groups)) == list(
                      range(plan.row_tiles))
    assert plan.smem_bytes == conv_block_smem_bytes(C, plan.taps) <= SMEM_LIMIT
    # Its blocks wait for one another: all must be on the card at once,
    # and a further group would not be.
    resident = sms * (SM_SMEM // (plan.smem_bytes + 1024))
    assert plan.blocks * plan.groups <= resident
    assert plan.groups == plan.row_tiles or (
        plan.blocks * (plan.groups + 1) > resident)
    # The blocks' strips of w1 (a and g columns) and w2 are the matrices
    # once; the packed taps hold every (head, tap, channel) once.
    assert plan.blocks * 3 * plan.strip * C == 3 * C * C
    wl = torch.arange(C * H * K, dtype=torch.float32).view(C, H * K)
    packed = pack_taps(wl, H)
    assert packed.shape == (H, plan.taps, C)
    assert torch.equal(packed[:, :K].permute(2, 0, 1).reshape(C, H * K), wl)
    assert not packed[:, K:].any()


def test_conv_block_smem_is_the_layout_written_out():
    C, taps = 1024, 32
    w1 = C * 2 * CONV_STRIP * 2            # a and g columns
    w2 = C * CONV_STRIP * 2
    acts = CONV_ROWS * (C + 8) * 2         # x, then h, then the conv output
    tap_rows = taps * (C + 8) * 2
    parts = 8 * CONV_ROWS * 8 * 4          # a [16, 8] fp32 tile a warp
    ring = taps * CONV_ROWS * CONV_STRIP * 2
    weights = CONV_ROWS * 32 * 4
    assert conv_block_smem_bytes(C, taps) == (
        w1 + w2 + acts + tap_rows + parts + ring + weights + 16)
    plan = conv_block_plan(16, C, 16, 31, 132)
    assert (plan.blocks, plan.blocks_per_head, plan.taps, plan.row_tiles,
            plan.groups) == (64, 4, 32, 1, 1)
    assert conv_block_plan(80, C, 16, 31, 132)[3:5] == (5, 2)
    assert conv_block_plan(80, C, 16, 31, 108)[3:5] == (5, 1)
    assert 2 * plan.smem_bytes > SMEM_LIMIT           # one block a multiprocessor


@pytest.mark.parametrize("N,C,H,K,sms", [
    (4, 1024, 16, 1, 132), (4, 1024, 16, 33, 132), (0, 1024, 16, 3, 132),
    (4, 1000, 8, 3, 132), (4, 64, 8, 3, 132), (4, 96, 4, 3, 132),
    (4, 2048, 16, 3, 132), (4, 1024, 16, 31, 48)])
def test_conv_block_plan_refuses(N, C, H, K, sms):
    """Tap counts and widths the kernel does not take, a head narrower
    than a strip, a width too large for shared memory, and more blocks
    than the card holds at once."""
    with pytest.raises(ValueError, match="decode_conv_block"):
        conv_block_plan(N, C, H, K, sms)


# -- (b) the algorithms ------------------------------------------------------

def ranked(vals, ids, k):
    """The k best (value, id) pairs a row: value descending, then id
    ascending. vals, ids [N, n]."""
    by_id = torch.argsort(ids, dim=1, stable=True)
    vals, ids = torch.gather(vals, 1, by_id), torch.gather(ids, 1, by_id)
    order = torch.sort(vals, dim=1, descending=True, stable=True).indices[:, :k]
    return torch.gather(vals, 1, order), torch.gather(ids, 1, order)


def walk_band(x, table, k, sel_limit, plan):
    """band_topk_lse as the kernel computes it: block b walks its tiles
    in ascending order, carrying a row's (max, sumexp), rescaled the
    flash way, and its sorted top-k list; the tile's logits are rounded
    to x's dtype, ids >= sel_limit join only the sum; then the blocks'
    states are merged in block order."""
    N, V = x.shape[0], table.shape[0]
    BIG = 2 ** 30
    states = []
    for b in range(plan.blocks):
        m = torch.full((N,), -torch.inf)
        s = torch.zeros(N)
        top_v = torch.full((N, k), -torch.inf)
        top_i = torch.full((N, k), BIG)
        for t in block_tiles(plan, b):
            ids = torch.arange(t * plan.tile, min(V, (t + 1) * plan.tile))
            logits = (x.float() @ table[ids].float().T).to(x.dtype).float()
            m_new = torch.maximum(m, logits.max(dim=1).values)
            s = s * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(dim=1)
            m = m_new
            cand = torch.where(ids < sel_limit, logits, -torch.inf)
            cand_i = torch.where(cand > -torch.inf, ids, BIG).expand(N, -1)
            top_v, top_i = ranked(torch.cat([top_v, cand], 1),
                                  torch.cat([top_i, cand_i], 1), k)
        states.append((m, s, top_v, top_i))
    mx = torch.stack([st[0] for st in states]).max(dim=0).values
    total = torch.zeros(N)
    for m, s, _, _ in states:                          # block order
        total = total + s * torch.exp(m - mx)
    lse = (mx + torch.log(total))[:, None]
    vals, ids = ranked(torch.cat([st[2] for st in states], 1),
                       torch.cat([st[3] for st in states], 1), k)
    return vals, ids.to(torch.int32), lse


def _band_inputs(N, V, D, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(N, D, generator=g).to(dtype)
    table = (torch.randn(V, D, generator=g) * D ** -0.5).to(dtype)
    return x, table


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("N,V,sel,k,sms", [
    (5, 300, 300, 5, 3), (16, 700, 650, 16, 4), (1, 65, 60, 1, 132),
    (3, 64, 64, 5, 2), (2, 63, 63, 16, 1), (7, 1000, 998, 5, 132)])
def test_walked_band_matches_plain(dtype, N, V, sel, k, sms):
    x, table = _band_inputs(N, V, 64, DTYPES[dtype], V + k)
    plan = band_plan(N, 64, V, k, sms)
    vals, ids, lse = walk_band(x, table, k, sel, plan)
    pv, pi, pl = band_topk_lse_plain(x, table, k, sel)
    assert bool((ids < sel).all())
    torch.testing.assert_close(lse, pl, atol=1e-5, rtol=1e-5)
    if dtype == "fp32":
        torch.testing.assert_close(vals, pv, atol=1e-5, rtol=1e-5)
        assert torch.equal(ids, pi)
    else:
        # A tile's product sums in another order than the whole band's,
        # which can turn the rounding of a logit: one bf16 ulp.
        assert bool(((vals - pv).abs() <= bf16_ulp(pv)).all())
        assert (ids == pi).float().mean().item() >= 0.9


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_walked_band_breaks_ties_toward_the_lowest_id(dtype):
    """Copies of one table row in one tile, in two tiles of one block
    and in other blocks tie exactly; x is that row, so the copies are the
    largest logits and come back lowest id first. sel_limit cuts the
    last copy off. A table of equal rows returns ids 0 .. k - 1."""
    V, D, k, sms = 900, 64, 6, 4                      # 15 tiles, 4 blocks
    x, table = _band_inputs(3, V, D, DTYPES[dtype], 5)
    src, copies = 500, [3, 40, 64 * 4 + 9, 64 * 5 + 1, 499, 890]
    table[copies] = table[src].clone()
    x[:] = table[src] * 8
    plan = band_plan(3, D, V, k, sms)
    assert {c // 64 % plan.blocks for c in copies} == {0, 1, 3}
    vals, ids, _ = walk_band(x, table, k, 880, plan)
    pv, pi, _ = band_topk_lse_plain(x, table, k, 880)
    assert ids.tolist() == [sorted(copies[:-1] + [src])] * 3 == pi.tolist()
    assert torch.equal(vals, pv)
    flat = table[:1].expand(V, -1).contiguous()
    vals, ids, lse = walk_band(x, flat, k, 700, plan)
    assert ids.tolist() == [list(range(k))] * 3
    torch.testing.assert_close(lse, band_topk_lse_plain(x, flat, k, 700)[2],
                               atol=1e-5, rtol=1e-5)


def strip_conv_block(x, cache, t, w1, b1, wl, w2, b2, H, plan):
    """decode_conv_block as the kernel computes it: block s owns 16
    channels; linear1 over its a and g columns in two halves of K added
    in order, the GLU; every block's h pooled; its head's tap logits from
    the packed taps, K split among the warps and added in order, the
    softmax over the K real taps; the ring combine of its channels,
    history in tap order in fp32, rounded once; the conv output pooled;
    linear2 over its 16 columns in four quarters of K added in order."""
    dtype = x.dtype
    r = lambda v: v.to(dtype).float()
    N, C = x.shape
    K = wl.shape[1] // H
    R, strip = C // H, plan.strip
    xf, w1f, w2f = x.float(), w1.float(), w2.float()
    packed = pack_taps(wl, H).float()                  # [H, taps, C]

    def in_parts(a, w, parts):
        """a @ w with K split as the warps split it: 16-deep steps p,
        p + parts, ..., each part summed apart, the parts added in order."""
        steps = a.shape[1] // 16
        total = torch.zeros(a.shape[0], w.shape[1])
        for p in range(parts):
            part = torch.zeros_like(total)
            for s in range(p, steps, parts):
                ks = slice(s * 16, (s + 1) * 16)
                part = part + a[:, ks] @ w[ks]
            total = total + part
        return total

    h = torch.zeros(N, C)
    for s in range(plan.blocks):
        cols = slice(s * strip, (s + 1) * strip)
        a = r(r(in_parts(xf, w1f[:, cols], 2)) + b1.float()[cols])
        gcols = slice(C + s * strip, C + (s + 1) * strip)
        g = r(r(in_parts(xf, w1f[:, gcols], 2)) + b1.float()[gcols])
        h[:, cols] = r(a * r(torch.sigmoid(g)))
    hconv = torch.zeros(N, C)
    for s in range(plan.blocks):
        cols = slice(s * strip, (s + 1) * strip)
        head = s * strip // R
        tiles = plan.taps // 8
        logits = r(in_parts(h, packed[head].T, 8 // tiles))[:, :K]
        p = r(torch.softmax(logits, dim=-1))
        hist = torch.zeros(N, strip)
        for k in range(K - 1):                         # tap order
            hist = hist + p[:, k:k + 1] * cache[(t + k) % (K - 1)][:, cols].float()
        hconv[:, cols] = r(r(hist) + r(p[:, K - 1:] * h[:, cols]))
    y = torch.zeros(N, C)
    for s in range(plan.blocks):
        cols = slice(s * strip, (s + 1) * strip)
        y[:, cols] = r(r(r(in_parts(hconv, w2f[:, cols], 4))
                         + b2.float()[cols]) + xf[:, cols])
    return y.to(dtype), h.to(dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("N,C,H,K,t", [(1, 64, 4, 2, 0), (5, 64, 2, 3, 1),
                                       (16, 128, 4, 7, 9), (3, 64, 1, 15, 40),
                                       (16, 64, 4, 31, 29)])
def test_strip_conv_block_matches_plain(dtype, N, C, H, K, t):
    g = torch.Generator().manual_seed(C + K)
    dt = DTYPES[dtype]

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dt)

    args = (rn(N, C), rn(K - 1, N, C, scale=0.5), t,
            rn(C, 2 * C, scale=C ** -0.5), rn(2 * C, scale=0.05),
            rn(C, H * K, scale=0.2), rn(C, C, scale=C ** -0.5),
            rn(C, scale=0.05), H)
    plan = conv_block_plan(N, C, H, K, 132)
    y, h = strip_conv_block(*args, plan)
    py, ph = decode_conv_block_plain(*args)
    if dtype == "fp32":
        torch.testing.assert_close(h, ph, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(y, py, atol=1e-5, rtol=1e-5)
    else:
        # Another order of the fp32 sums can turn one rounding of h; a
        # turned h (one ulp of 2^-8 relative) moves the tap weights, the
        # conv output and, through linear2's sum over C, y by a few ulp.
        x = args[0].float()
        assert bool(((h.float() - ph.float()).abs() <= bf16_ulp(ph)).all())
        assert (h == ph).float().mean().item() > 0.95
        tol = 4 * bf16_ulp(x.abs() + py.float().abs())
        assert bool(((y.float() - py.float()).abs() <= tol).all())
        assert (y == py).float().mean().item() > 0.8
