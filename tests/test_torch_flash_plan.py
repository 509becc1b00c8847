"""The host-side plan and the tiled algorithm of the two flash
cross-attention kernels designed for the H100, on the CPU.

`flash_attention_fwd` and `flash_attention_bwd` give a block 64 query
rows of one (head, item) and walk the keys twice in tiles of 64 that
pass through a ring of shared-memory slots; no score matrix exists, and
T * S is not bounded. The CUDA kernels run only on the card
(test_torch_dispatch.py, chip_smoke.py); here

  (a) the plan (`flash_plan`, and the order in which a block fills and
      reads its slots, `ring_schedule` below) is checked as a pure
      function: every query row and every key is covered exactly once,
      a block's shared memory is the layout written out and fits the
      card's 232,448 bytes, no slot is refilled before its tile was
      read, two blocks share a multiprocessor at the flagship's shapes;
  (b) the two-walk forward and the two-walk backward are written out in
      PyTorch below, tile by tile in the plan's order, with the kernels'
      rounding points, the ragged last tile (keys past S score -inf,
      their K and V rows are zeros) and rows past T (zeros, lse = +inf),
      and held against the plain versions: that walking the keys this
      way keeps the reference's numerics is proved before the card is
      asked.
"""

import pytest

torch = pytest.importorskip("torch")

from news_image_caption_tpu_torch.ops.flash_attention import (  # noqa: E402
    HEAD_DIMS, KEYS, MAX_STAGES, ROWS, FlashPlan, dropout_keep,
    flash_attention_bwd_plain, flash_attention_fwd_plain, flash_plan,
    flash_smem_bytes)

SMEM_LIMIT = 232448
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
BATCHES = (1, 16, 64)
SMS = (132, 108)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, so that the suite's parallel
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- (a) the plan ----------------------------------------------------------

def ring_schedule(key_tiles, stages, backward):
    """What a block does with its slots, in order, as the kernels do
    it (csrc/flash_attention.cu, FlashBlock::request_first and
    ::arrive): ("request", item, slot, with_v) and ("read", item, slot). Items
    0 .. key_tiles - 1 are the tiles of the first walk, the next
    key_tiles those of the second; item i is tile i % key_tiles. Where
    the tiles are resident they are requested once, up front; else
    stages - 1 items are requested ahead of the one being read, each
    into the slot whose reader has just finished, and the forward's
    first walk requests no V."""
    n, resident = key_tiles, stages >= key_tiles
    slot = (lambda i: i % n) if resident else (lambda i: i % stages)
    with_v = lambda i: backward or resident or i >= n
    ahead = range(n) if resident else range(stages - 1)
    for i in ahead:
        yield ("request", i, slot(i), with_v(i))
    for it in range(2 * n):
        nxt = it + stages - 1
        if not resident and nxt < 2 * n:
            yield ("request", nxt, slot(nxt), with_v(nxt))
        yield ("read", it, slot(it))


@pytest.mark.parametrize("head_dim", [16, 32, 64, 128])
@pytest.mark.parametrize("S", [1, 15, 51, 63, 64, 65, 514, 2000])
@pytest.mark.parametrize("T", [1, 2, 63, 64, 65, 128, 200])
def test_flash_plan_covers_every_row_and_key_once(T, S, head_dim):
    H = 16
    for B in BATCHES:
        for sms in SMS:
            plan = flash_plan(B, T, S, H, head_dim, sms)
            assert (plan.rows, plan.keys) == (ROWS, KEYS)
            rows = [range(i * plan.rows, min(T, (i + 1) * plan.rows))
                    for i in range(plan.t_tiles)]
            keys = [range(j * plan.keys, min(S, (j + 1) * plan.keys))
                    for j in range(plan.key_tiles)]
            assert all(len(r) > 0 for r in rows + keys)     # no empty tile
            assert [t for r in rows for t in r] == list(range(T))
            assert [s for r in keys for s in r] == list(range(S))
            assert plan.blocks == H * B * plan.t_tiles
            # dk and dv of several T tiles are added from fp32 parts.
            assert plan.parts_floats == (
                0 if plan.t_tiles == 1
                else 2 * plan.t_tiles * B * S * H * head_dim)
            for backward, each in ((False, plan.fwd), (True, plan.bwd)):
                assert 1 <= each.stages <= min(MAX_STAGES, plan.key_tiles)
                assert each.resident == (each.stages == plan.key_tiles)
                assert each.resident or each.stages >= 2    # a ring
                assert each.smem_bytes == flash_smem_bytes(
                    backward, each.stages, head_dim) <= SMEM_LIMIT
                assert each.blocks_per_sm >= 1


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("key_tiles,stages", [
    (1, 1), (2, 2), (3, 3), (4, 4), (3, 2), (5, 2), (5, 3), (9, 4), (9, 2),
    (32, 4), (32, 3)])
def test_ring_schedule_never_refills_a_slot_before_it_is_read(
        key_tiles, stages, backward):
    n = key_tiles
    resident = stages == n
    holds = {}                 # slot -> item requested into it, not yet read
    read, requested = [], []
    for event in ring_schedule(n, stages, backward):
        if event[0] == "request":
            _, item, slot, with_v = event
            assert 0 <= slot < stages
            assert slot not in holds, "a tile was overwritten before its read"
            holds[slot] = item
            requested.append(item)
            # Only the forward's first walk over a ring reads no V.
            assert with_v == (backward or resident or item >= n)
            # Never more than stages - 1 items ahead of the one in use.
            assert resident or item - len(read) <= stages - 1
        else:
            _, item, slot = event
            if resident:       # both walks read the tile in place
                assert slot == item % n and slot in requested
            else:
                assert holds.pop(slot) == item
            read.append(item)
    assert read == list(range(2 * n))                  # both walks, in order
    assert requested == (list(range(n)) if resident else list(range(2 * n)))


def test_flash_smem_is_the_layout_written_out():
    dh, stages = 64, 3
    tile = 64 * dh * 2                   # q, g, K, V or the dk/dv staging
    slot = 2 * tile + 64 * 4             # K, V and the key bias of 64 keys
    assert flash_smem_bytes(False, stages, dh) == tile + stages * slot
    transposed = 64 * 64 * 2             # dropped probabilities or ds, bf16
    assert flash_smem_bytes(True, stages, dh) == (
        3 * tile + transposed + stages * slot)
    # No term grows with T * S: the score matrix is gone.
    assert flash_plan(1, 4096, 1 << 20, 16, 64, 132).bwd.smem_bytes == (
        flash_smem_bytes(True, MAX_STAGES, dh))


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("S", [514, 51])
def test_flash_plan_at_the_flagship_holds_the_call_on_the_card(S, sms):
    """The train step's calls (B = 16, T = 63, 16 heads of 64): one T
    tile, two blocks or more a multiprocessor in both kernels, so all
    256 blocks of a call are on an H100 (132 multiprocessors) at once;
    the image's keys are one resident tile, the article's nine pass a
    ring of MAX_STAGES slots."""
    plan = flash_plan(16, 63, S, 16, 64, sms)
    assert plan.t_tiles == 1 and plan.blocks == 256 and plan.parts_floats == 0
    for each in (plan.fwd, plan.bwd):
        assert each.blocks_per_sm >= 2
        assert sms < 132 or plan.blocks <= sms * each.blocks_per_sm
        assert (each.stages, each.resident) == ((1, True) if S == 51
                                                else (MAX_STAGES, False))
    assert plan == FlashPlan(64, 64, 1, -(-S // 64), 256, plan.fwd, plan.bwd, 0)


@pytest.mark.parametrize("T,S", [(128, 514), (63, 4000), (1000, 1000),
                                 (100000, 100000)])
def test_flash_plan_does_not_bound_t_times_s(T, S):
    """The shapes the score matrix in shared memory refused (T * S over
    about 55,000 slots) are planned like any other."""
    plan = flash_plan(2, T, S, 16, 64, 132)
    assert plan.t_tiles == -(-T // 64) and plan.key_tiles == -(-S // 64)
    assert plan.bwd.smem_bytes <= SMEM_LIMIT


def test_flash_plan_gives_up_slots_where_blocks_must_share():
    """Where the call has more blocks than the card multiprocessors the
    plan gives up slots to fit a second block, down to the two a ring
    needs (the backward at heads of 128 still fits only one); a call
    of few blocks keeps every slot."""
    many = flash_plan(16, 63, 514, 16, 128, 132)
    few = flash_plan(1, 63, 514, 8, 128, 132)           # 8 blocks
    assert many.bwd.stages == 2 < MAX_STAGES
    assert few.bwd.stages == MAX_STAGES and few.bwd.blocks_per_sm == 1
    assert many.fwd.blocks_per_sm >= 2
    wide = flash_plan(64, 63, 514, 16, 64, 132)
    assert wide.fwd.blocks_per_sm >= 2 and wide.bwd.blocks_per_sm >= 2


@pytest.mark.parametrize("B,T,S,head_dim", [
    (2, 9, 51, 12), (2, 9, 51, 48), (2, 9, 51, 256), (2, 9, 51, 0),
    (0, 9, 51, 64), (2, 0, 51, 64), (2, 9, 0, 64), (70000, 9, 51, 64),
    (2, 64 * 70000, 51, 64)])
def test_flash_plan_refuses(B, T, S, head_dim):
    with pytest.raises(ValueError, match="flash attention"):
        flash_plan(B, T, S, 16, head_dim, 132)
    assert head_dim not in HEAD_DIMS or min(B, T, S) < 1 or max(
        B, -(-T // 64)) > 65535


# -- (b) the tiled algorithm -----------------------------------------------

def _pad_rows(x, rows):
    """x [B, n, H, dh] with zero rows up to `rows`, as a tile in shared
    memory holds them."""
    return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, rows - x.shape[1]))


def _key_tile(k, v, bias, j, H):
    """Key tile j as a block sees it: K and V [B, 64, H, dh] fp32 with
    zero rows past S, the bias [B, 1, 1, 64] and which keys exist."""
    B, S, E = k.shape
    run = slice(j * KEYS, min(S, (j + 1) * KEYS))
    n = run.stop - run.start
    kh = _pad_rows(k[:, run].float().view(B, n, H, E // H), KEYS)
    vh = _pad_rows(v[:, run].float().view(B, n, H, E // H), KEYS)
    bj = torch.nn.functional.pad(bias[:, run].float(), (0, KEYS - n))
    exists = torch.arange(KEYS) < n
    return kh, vh, bj[:, None, None, :], exists


def _scores(qh, kh, bj, exists):
    """fp32 scores of a tile plus the bias; -inf for a key past S."""
    s = torch.einsum("bthd,bshd->bhts", qh, kh) + bj
    return torch.where(exists, s, torch.full_like(s, float("-inf")))


def _mask_tile(keep, scale, rows, j, B, H):
    """The dropout multiplier of a [64 rows, 64 keys] tile: `scale`
    where kept, 0 where dropped; 1 everywhere without dropout. Slots
    past T or S get 0 (the kernel hashes them; they weigh nothing)."""
    if keep is None:
        return torch.ones(B, H, ROWS, KEYS)
    m = keep[:, :, rows, j * KEYS:(j + 1) * KEYS].float() * scale
    return torch.nn.functional.pad(
        m, (0, KEYS - m.shape[3], 0, ROWS - m.shape[2]))


def _reads(key_tiles, stages, backward):
    return [item for kind, item, *_ in ring_schedule(key_tiles, stages,
                                                     backward)
            if kind == "read"]


def tiled_forward(q, k, v, bias, seed, H, p, plan):
    """flash_attention_fwd as the kernel computes it: per T tile, walk 1
    over the key tiles keeps the row maximum and the sum of
    exp(s - max), rescaled where the maximum grows; walk 2 forms
    exp(s - max) * (scale / sum) where kept, rounds it to v's dtype and
    adds p v in fp32; the output is rounded once."""
    B, T, E = q.shape
    S, dh = k.shape[1], E // H
    scale = torch.tensor(1.0 / (1.0 - p), dtype=torch.float32)
    keep = dropout_keep(seed, B, H, T, S, p) if p > 0 else None
    out = torch.empty_like(q)
    lse = torch.empty(B, H, T)
    n = plan.key_tiles
    for i in range(plan.t_tiles):
        rows = slice(i * ROWS, min(T, (i + 1) * ROWS))
        nr = rows.stop - rows.start
        qh = _pad_rows(q[:, rows].float().view(B, nr, H, dh), ROWS)
        mx = torch.full((B, H, ROWS), float("-inf"))
        total = torch.zeros(B, H, ROWS)
        o = torch.zeros(B, H, ROWS, dh)
        for item in _reads(n, plan.fwd.stages, False):
            j = item % n
            kh, vh, bj, exists = _key_tile(k, v, bias, j, H)
            s = _scores(qh, kh, bj, exists)
            if item < n:
                new = torch.maximum(mx, s.amax(dim=-1))
                total = (total * torch.exp(mx - new)
                         + torch.exp(s - new[..., None]).sum(dim=-1))
                mx = new
                continue
            weight = (scale / total)[..., None]
            pj = (torch.exp(s - mx[..., None]) * weight
                  * (_mask_tile(keep, 1.0, rows, j, B, H) if keep is not None
                     else 1.0))
            o = o + torch.einsum("bhts,bshd->bhtd", pj.to(v.dtype).float(), vh)
        lse[:, :, rows] = (mx + torch.log(total))[:, :, :nr]
        out[:, rows] = o[:, :, :nr].transpose(1, 2).reshape(B, nr, E).to(
            q.dtype)
    return out, lse


def tiled_backward(q, k, v, bias, seed, lse, g, H, p, plan):
    """flash_attention_bwd as the kernel computes it: per T tile, walk 1
    forms probs = exp(s - lse) and dp = (g vᵀ) * mask tile by tile, adds
    delta = Σ dp * probs and the tile's dv = (probs * mask rounded)ᵀ g;
    walk 2 forms both again, ds = probs * (dp - delta) rounded, adds
    dq += ds k and the tile's dk = dsᵀ q. One T tile: dk and dv are
    rounded as they are written; several: their fp32 parts are added in
    tile order and rounded once."""
    B, T, E = q.shape
    S, dh = k.shape[1], E // H
    scale = 1.0 / (1.0 - p)
    keep = dropout_keep(seed, B, H, T, S, p) if p > 0 else None
    n = plan.key_tiles
    dq = torch.empty_like(q)
    dk_parts, dv_parts = [], []
    for i in range(plan.t_tiles):
        rows = slice(i * ROWS, min(T, (i + 1) * ROWS))
        nr = rows.stop - rows.start
        qh = _pad_rows(q[:, rows].float().view(B, nr, H, dh), ROWS)
        gh = _pad_rows(g[:, rows].float().view(B, nr, H, dh), ROWS)
        # A row past T: lse = +inf, so probs = exp(s - inf) = 0.
        lrow = torch.nn.functional.pad(lse[:, :, rows], (0, ROWS - nr),
                                       value=float("inf"))
        delta = torch.zeros(B, H, ROWS)
        dqa = torch.zeros(B, H, ROWS, dh)
        dk_i = torch.zeros(B, S, H, dh)
        dv_i = torch.zeros(B, S, H, dh)
        for item in _reads(n, plan.bwd.stages, True):
            j = item % n
            run = slice(j * KEYS, min(S, (j + 1) * KEYS))
            nk = run.stop - run.start
            kh, vh, bj, exists = _key_tile(k, v, bias, j, H)
            probs = torch.exp(_scores(qh, kh, bj, exists) - lrow[..., None])
            mask = _mask_tile(keep, scale, rows, j, B, H)
            dp = torch.einsum("bthd,bshd->bhts", gh, vh) * mask
            if item < n:
                delta = delta + (dp * probs).sum(dim=-1)
                dropped = (probs * mask).to(v.dtype).float()
                dv_i[:, run] = torch.einsum("bhts,bthd->bshd", dropped,
                                            gh)[:, :nk]
            else:
                ds = (probs * (dp - delta[..., None])).to(v.dtype).float()
                dqa = dqa + torch.einsum("bhts,bshd->bhtd", ds, kh)
                dk_i[:, run] = torch.einsum("bhts,bthd->bshd", ds, qh)[:, :nk]
        dq[:, rows] = dqa[:, :, :nr].transpose(1, 2).reshape(B, nr, E).to(
            q.dtype)
        dk_parts.append(dk_i)
        dv_parts.append(dv_i)
    dk, dv = dk_parts[0], dv_parts[0]
    for part_k, part_v in zip(dk_parts[1:], dv_parts[1:]):    # tile order
        dk, dv = dk + part_k, dv + part_v
    return (dq, dk.reshape(B, S, E).to(k.dtype), dv.reshape(B, S, E).to(
        v.dtype))


def _flash_inputs(B, T, S, E, dtype, seed):
    """Item 0 has every key padded, the last item half of them."""
    gen = torch.Generator().manual_seed(seed)
    q = (torch.randn(B, T, E, generator=gen) * 0.3).to(dtype)
    k = torch.randn(B, S, E, generator=gen).to(dtype)
    v = torch.randn(B, S, E, generator=gen).to(dtype)
    g = (torch.randn(B, T, E, generator=gen) * 0.1).to(dtype)
    bias = torch.zeros(B, S)
    bias[0] = -1e9
    bias[B - 1, S // 2:max(S - 2, S // 2)] = -1e9
    return q, k, v, bias, g, torch.tensor([S + T], dtype=torch.int32)


SHAPES = [(2, 1), (9, 51), (63, 64), (64, 65), (65, 130), (130, 514)]


def _close(got, want, dtype, fp32_tol, name):
    got, want = got.float(), want.float()
    if dtype == "fp32":
        # The tolerance of tests/test_torch_flash.py, at the scale of
        # each item (the fully padded item's gradients are S times its
        # neighbours': its saved lse of -1e9 swallows log S).
        dims = tuple(range(1, want.dim()))
        scale = want.abs().amax(dims, True).clamp_min(1.0)
        tol = fp32_tol * scale + fp32_tol * want.abs()
    else:
        # One bf16 rounding of a probability, of ds or of the output.
        dims = tuple(range(1, want.dim()))
        tol = 0.02 * want.abs().amax(dims, True).clamp_min(1.0) \
            + 0.02 * want.abs()
    assert bool(((got - want).abs() <= tol).all()), (
        name, (got - want).abs().max().item())


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("T,S", SHAPES)
def test_tiled_forward_matches_plain(T, S, p, dtype):
    B, H, E = 3, 2, 32
    q, k, v, bias, _, seed = _flash_inputs(B, T, S, E, DTYPES[dtype], 3)
    plan = flash_plan(B, T, S, H, E // H, 132)
    out, lse = tiled_forward(q, k, v, bias, seed, H, p, plan)
    want, want_lse = flash_attention_fwd_plain(q, k, v, bias, seed, H, p)
    assert bool(torch.isfinite(out.float()).all())
    _close(out, want, dtype, 1e-5, "out")
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)
    # The fully padded item attends uniformly, ragged tiles or not.
    if p == 0.0:
        mean_v = v[0].float().mean(dim=0).expand(T, E)
        torch.testing.assert_close(out[0].float(), mean_v,
                                   atol=1e-5 if dtype == "fp32" else 0.02,
                                   rtol=0.02)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("T,S", SHAPES)
def test_tiled_backward_matches_plain(T, S, p, dtype):
    B, H, E = 3, 2, 32
    q, k, v, bias, g, seed = _flash_inputs(B, T, S, E, DTYPES[dtype], 5)
    plan = flash_plan(B, T, S, H, E // H, 132)
    lse = flash_attention_fwd_plain(q, k, v, bias, seed, H, p)[1]
    got = tiled_backward(q, k, v, bias, seed, lse, g, H, p, plan)
    want = flash_attention_bwd_plain(q, k, v, bias, seed, lse, g, H, p)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert bool(torch.isfinite(a.float()).all()), name
        _close(a, b, dtype, 2e-4, name)


@pytest.mark.parametrize("stages", [2, 3, 4])
def test_tiled_walks_do_not_depend_on_the_ring(stages):
    """Fewer slots change when a tile arrives, not what is computed."""
    B, T, S, H, E = 2, 70, 300, 2, 32
    q, k, v, bias, g, seed = _flash_inputs(B, T, S, E, torch.float32, 9)
    plan = flash_plan(B, T, S, H, E // H, 132)
    fewer = plan._replace(
        fwd=plan.fwd._replace(stages=stages, resident=False),
        bwd=plan.bwd._replace(stages=stages, resident=False))
    out, lse = tiled_forward(q, k, v, bias, seed, H, 0.1, plan)
    out2, lse2 = tiled_forward(q, k, v, bias, seed, H, 0.1, fewer)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    grads = tiled_backward(q, k, v, bias, seed, lse, g, H, 0.1, plan)
    grads2 = tiled_backward(q, k, v, bias, seed, lse, g, H, 0.1, fewer)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2))
