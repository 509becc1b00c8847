"""The host-side plans and the split algorithms of the two decode
kernels designed for the H100, on the CPU.

`decode_cross_attention` shares the keys of one (head, item) among the
blocks of a cluster, and `decode_ffn_block` shares the FFN dimension
among blocks and groups of blocks. The CUDA kernels run only on the card
(test_torch_dispatch.py, chip_smoke.py); here

  (a) the plans (`attention_plan`, `ffn_plan`) are checked as pure
      functions: every key and every column is covered exactly once,
      clusters and groups hold at most 8 blocks, a block's shared memory
      fits the card's 232,448 bytes;
  (b) the split algorithms are written out in PyTorch below, with the
      kernels' summation orders and bf16 rounding points, and held
      against the plain versions: that cutting the work this way keeps
      the reference's numerics is proved before the card is asked.
"""

import pytest

torch = pytest.importorskip("torch")

from news_image_caption_tpu_torch.ops.decode_attention import (  # noqa: E402
    BLOCKS_PER_SM, MAX_Q, AttentionPlan, attention_plan,
    attention_smem_bytes, decode_cross_attention_plain)
from news_image_caption_tpu_torch.ops.decode_blocks import (  # noqa: E402
    FFN_ROWS, FFN_STRIP, decode_ffn_block_plain, ffn_plan, ffn_smem_bytes)

SMEM_LIMIT = 232448
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, so that the suite's parallel
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- (a) the plans ---------------------------------------------------------

@pytest.mark.parametrize("sms", [132, 108, 16])
@pytest.mark.parametrize("S", [1, 51, 514])
@pytest.mark.parametrize("B,Q", [(1, 1), (1, 16), (5, 5), (16, 1), (16, 16)])
def test_attention_plan_covers_every_key_once(B, Q, S, sms):
    plan = attention_plan(B, Q, S, num_heads=16, head_dim=64, sms=sms)
    assert 1 <= plan.splits <= 8
    assert plan.per % 16 == 0 and plan.per >= 16
    runs = [range(z * plan.per, min(S, (z + 1) * plan.per))
            for z in range(plan.splits)]
    assert all(len(r) > 0 for r in runs)              # no empty block
    assert [s for r in runs for s in r] == list(range(S))
    assert plan.smem_bytes == attention_smem_bytes(Q, plan.per, 64)
    assert plan.smem_bytes <= SMEM_LIMIT
    # No more splits than give every multiprocessor its blocks (these
    # contexts fit in one block's shared memory).
    assert plan.splits <= max(1, -(-BLOCKS_PER_SM * sms // (B * 16)))


@pytest.mark.parametrize("head_dim", [16, 32, 64, 128])
@pytest.mark.parametrize("B,S", [(64, 514), (16, 2000), (1, 2500),
                                 (128, 1500)])
def test_attention_plan_splits_long_contexts_to_fit(B, S, head_dim):
    plan = attention_plan(B, 16, S, num_heads=16, head_dim=head_dim, sms=132)
    assert plan.splits <= 8 and plan.smem_bytes <= SMEM_LIMIT
    assert (plan.splits - 1) * plan.per < S <= plan.splits * plan.per


def test_attention_smem_is_the_layout_written_out():
    Q, per, dh = 5, 176, 64
    k_and_v = per * dh * 2                      # V takes K's place
    scores = Q * (per + 8) * 4
    probs = Q * (per + 8) * 2
    bias = per * 4
    stats = (2 * 4 + 2 * 8 + 2) * MAX_Q * 4     # warps, blocks, context
    parts = (Q * dh // 2 + 8) * 8               # fp32 pairs this block adds
    assert attention_smem_bytes(Q, per, dh) == (
        k_and_v + scores + probs + bias + stats + parts)
    # The flagship's greedy step at batch 16 over the article.
    plan = attention_plan(16, 1, 514, 16, 64, 132)
    assert plan == AttentionPlan(plan.splits, plan.per,
                                 attention_smem_bytes(1, plan.per, 64))
    assert plan.splits == -(-BLOCKS_PER_SM * 132 // 256)
    # A short context stays in one block: the image at any batch size.
    assert attention_plan(1, 1, 51, 16, 64, 132).splits == 1
    assert attention_plan(1, 1, 514, 16, 64, 132).splits > 4


@pytest.mark.parametrize("B,Q,S", [(1, 1, 20000), (16, 1, 100000), (1, 1, 0),
                                   (0, 1, 5), (2, 17, 51), (2, 0, 51)])
def test_attention_plan_refuses(B, Q, S):
    with pytest.raises(ValueError, match="decode_cross_attention"):
        attention_plan(B, Q, S, num_heads=16, head_dim=64, sms=132)


@pytest.mark.parametrize("C,F", [(1024, 4096), (64, 128), (512, 2048),
                                 (1024, 96), (128, 32), (192, 96)])
@pytest.mark.parametrize("N", [1, 5, 16, 40])
def test_ffn_plan_covers_every_column_once(N, C, F):
    plan = ffn_plan(N, C, F, sms=132)
    strips = [range(g * plan.strip, (g + 1) * plan.strip)
              for g in range(plan.blocks)]
    assert [c for s in strips for c in s] == list(range(F))
    assert 1 <= plan.group <= 8
    assert plan.blocks == plan.group * plan.groups
    # Within a group, rank r owns one slice of the output columns ...
    slices = [range(r * plan.slice, (r + 1) * plan.slice)
              for r in range(plan.group)]
    assert [c for s in slices for c in s] == list(range(C))
    # ... in whole 16-column steps of the second product,
    assert plan.slice % 16 == 0
    # and the groups own the rows of w2 (the FFN columns) once each.
    rows = [range(i * plan.group * plan.strip, (i + 1) * plan.group * plan.strip)
            for i in range(plan.groups)]
    assert [f for r in rows for f in r] == list(range(F))
    assert (plan.launches - 1) * FFN_ROWS < N <= plan.launches * FFN_ROWS
    assert plan.smem_bytes == ffn_smem_bytes(C, plan.group) <= SMEM_LIMIT


def test_ffn_plan_at_the_flagship_fills_the_card_with_one_wave():
    plan = ffn_plan(16, 1024, 4096, sms=132)
    assert (plan.blocks, plan.group, plan.groups, plan.slice) == (128, 8, 16,
                                                                  128)
    assert plan.blocks <= 132                         # one block an SM
    assert 2 * plan.smem_bytes > SMEM_LIMIT           # and only one fits
    # The blocks' strips of w1 and pieces of w2, all requested at the
    # start, are the two matrices once.
    assert plan.blocks * 2 * FFN_STRIP * 1024 * 2 == 2 * 1024 * 4096 * 2


@pytest.mark.parametrize("N,C,F,sms", [(4, 96, 128, 132), (4, 64, 100, 132),
                                       (0, 64, 128, 132),
                                       (4, 2048, 4096, 132),
                                       (16, 1024, 8192, 132),
                                       (16, 1024, 4096, 108)])
def test_ffn_plan_refuses(N, C, F, sms):
    """Shapes the kernel does not take, a width too large for shared
    memory, and more blocks than the card holds at once (they wait for
    one another)."""
    with pytest.raises(ValueError, match="decode_ffn_block"):
        ffn_plan(N, C, F, sms)


# -- (b) the split algorithms ----------------------------------------------

def bf16_ulp(t):
    """One bf16 unit in the last place at the magnitude of t (fp32)."""
    mag = t.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def split_attention(q, k, v, bias, num_heads, per):
    """decode_cross_attention as the kernel computes it: block z of a
    cluster holds keys [z * per, (z + 1) * per); per-block fp32 scores,
    row maxima and sums; the maxima and sums exchanged; p = exp(s - max)
    / sum with the whole context's max and sum, rounded to v's dtype;
    fp32 partial outputs added in rank order and rounded once."""
    B, Q, E = q.shape
    S = k.shape[1]
    H, dh = num_heads, E // num_heads
    qh = q.float().view(B, Q, H, dh)
    runs = [slice(lo, min(S, lo + per)) for lo in range(0, S, per)]
    scores, stats = [], []
    for run in runs:
        kh = k[:, run].float().reshape(B, -1, H, dh)
        s = torch.einsum("bqhd,bshd->bhqs", qh, kh) \
            + bias[:, run].float()[:, None, None, :]
        m = s.max(dim=-1).values
        stats.append((m, torch.exp(s - m[..., None]).sum(dim=-1)))
        scores.append(s)
    mx = stats[0][0]
    for m, _ in stats[1:]:
        mx = torch.maximum(mx, m)
    total = torch.zeros_like(mx)
    for m, l in stats:                                 # rank order
        total = total + l * torch.exp(m - mx)
    out = torch.zeros(B, Q, H, dh)
    for run, s in zip(runs, scores):                   # rank order
        p = (torch.exp(s - mx[..., None]) / total[..., None]).to(v.dtype)
        vh = v[:, run].float().reshape(B, -1, H, dh)
        out = out + torch.einsum("bhqs,bshd->bqhd", p.float(), vh)
    return out.to(q.dtype).reshape(B, Q, E)


def _attention_inputs(B, Q, S, E, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    q = (torch.randn(B, Q, E, generator=g) * 0.3).to(dtype)
    k = torch.randn(B, S, E, generator=g).to(dtype)
    v = torch.randn(B, S, E, generator=g).to(dtype)
    bias = torch.zeros(B, S)
    bias[B // 2:, S // 2:max(S - 2, S // 2)] = -1e9    # padded slots
    return q, k, v, bias


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("B,Q,S,per", [(2, 1, 51, 16), (2, 5, 514, 80),
                                       (1, 16, 65, 32), (3, 1, 514, 272),
                                       (2, 5, 63, 64), (2, 3, 1, 16)])
def test_split_attention_matches_plain(dtype, B, Q, S, per):
    q, k, v, bias = _attention_inputs(B, Q, S, 64, DTYPES[dtype], S + Q)
    got = split_attention(q, k, v, bias, 4, per).float()
    want = decode_cross_attention_plain(q, k, v, bias, 4).float()
    if dtype == "fp32":
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        # The exchanged sum differs from the plain softmax's in its last
        # fp32 bits, which can turn one rounding of a probability or of
        # the output: one bf16 ulp of the output, plus the 2^-9 relative
        # weight of one turned probability where the output cancels.
        tol = bf16_ulp(want) + 2.0 ** -9 * v.float().abs().max()
        assert bool(((got - want).abs() <= tol).all())
        assert (got == want).float().mean().item() > 0.97


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_split_attention_with_one_key_unmasked(dtype):
    """An item that sees one key only returns that key's value row, and
    a block whose keys are all masked adds exactly nothing."""
    q, k, v, bias = _attention_inputs(2, 5, 514, 64, DTYPES[dtype], 7)
    bias[0] = -1e9
    bias[0, 171] = 0.0
    got = split_attention(q, k, v, bias, 4, 80)
    want = decode_cross_attention_plain(q, k, v, bias, 4)
    torch.testing.assert_close(got[0], v[0, 171].expand(5, 64))
    torch.testing.assert_close(got[0], want[0])
    assert bool(torch.isfinite(got).all())


def split_ffn(x, w1, b1, w2, b2, group):
    """decode_ffn_block as the kernel computes it: block g owns 32
    columns of w1; fc1's K is shared by 8 warps (16-deep steps w, w + 8,
    ...) whose fp32 partials are added in warp order; the block's strip
    of h = relu(r(r(.) + b1)) is rounded; `group` blocks pool their
    strips and multiply them with the matching rows of w2 in fp32; the
    groups' partials are added in group order; then r(r(r(.) + b2) + x)."""
    dtype = x.dtype
    r = lambda t: t.to(dtype).float()
    N, C = x.shape
    F = w1.shape[1]
    xf, w1f, w2f = x.float(), w1.float(), w2.float()
    warps, step = 8, 16
    strips = []
    for g in range(F // FFN_STRIP):
        cols = slice(g * FFN_STRIP, (g + 1) * FFN_STRIP)
        acc = torch.zeros(N, FFN_STRIP)
        for w in range(warps):
            part = torch.zeros(N, FFN_STRIP)
            for s in range(w, C // step, warps):
                ks = slice(s * step, (s + 1) * step)
                part = part + xf[:, ks] @ w1f[ks, cols]
            acc = acc + part
        strips.append(torch.relu(r(r(acc) + b1.float()[cols])))
    total = torch.zeros(N, C)
    for i in range(0, len(strips), group):             # group order
        rows = slice(i * FFN_STRIP, (i + group) * FFN_STRIP)
        total = total + torch.cat(strips[i:i + group], dim=1) @ w2f[rows]
    return r(r(r(total) + b2.float()) + xf).to(dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("N,C,F", [(1, 64, 128), (5, 128, 256),
                                   (16, 256, 1024), (16, 64, 96)])
def test_split_ffn_matches_plain(dtype, N, C, F):
    g = torch.Generator().manual_seed(F + N)
    dt = DTYPES[dtype]
    x = torch.randn(N, C, generator=g).to(dt)
    w1 = (torch.randn(C, F, generator=g) * C ** -0.5).to(dt)
    b1 = (torch.randn(F, generator=g) * 0.05).to(dt)
    w2 = (torch.randn(F, C, generator=g) * F ** -0.5).to(dt)
    b2 = (torch.randn(C, generator=g) * 0.05).to(dt)
    plan = ffn_plan(N, C, F, sms=132)
    got = split_ffn(x, w1, b1, w2, b2, plan.group).float()
    want = decode_ffn_block_plain(x, w1, b1, w2, b2).float()
    if dtype == "fp32":
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        # Another order of the fp32 sums can turn one of the output's
        # three nested roundings (product, + bias, + residual): one bf16
        # ulp at the magnitude of the largest of those terms, which
        # |x| + |y| bounds.
        tol = bf16_ulp(x.float().abs() + want.abs())
        assert bool(((got - want).abs() <= tol).all())
        assert (got == want).float().mean().item() > 0.9
