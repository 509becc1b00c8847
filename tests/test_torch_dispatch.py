"""Kernel dispatch of the port, and the CUDA kernels on the card.

A CPU tensor takes a kernel module's plain twin (no launch counted); a
tensor on any other non-CUDA device raises instead of falling back.
The tests marked `cuda` launch each CUDA kernel on the card and hold
it against its plain twin; they skip where torch.cuda.is_available()
is false. This file imports no jax, so the card tests run where jax is
absent: `python -m pytest --noconftest tests/test_torch_dispatch.py -m
cuda` (tests/conftest.py configures jax).
"""

import pytest

torch = pytest.importorskip("torch")

from news_image_caption_tpu_torch.ops.band_topk import (  # noqa: E402
    band_topk_lse, band_topk_lse_generic, band_topk_lse_int8,
    band_topk_lse_int8_generic, band_topk_lse_int8_plain, band_topk_lse_plain)
from news_image_caption_tpu_torch.ops.decode_attention import (  # noqa: E402
    decode_cross_attention, decode_cross_attention_generic,
    decode_cross_attention_int8, decode_cross_attention_int8_generic,
    decode_cross_attention_int8_plain, decode_cross_attention_plain)
from news_image_caption_tpu_torch.ops.decode_blocks import (  # noqa: E402
    decode_conv_block, decode_conv_block_generic, decode_conv_block_plain,
    decode_ffn_block, decode_ffn_block_generic, decode_ffn_block_partial,
    decode_ffn_block_partial_plain, decode_ffn_block_plain, pack_taps)
from news_image_caption_tpu_torch.ops.dynamic_conv import (  # noqa: E402
    dynamic_conv, dynamic_conv_plain, dynamic_conv_tolerance)
from news_image_caption_tpu_torch.ops.flash_attention import (  # noqa: E402
    dropout_keep, flash_attention_bwd, flash_attention_bwd_generic,
    flash_attention_bwd_plain, flash_attention_fwd, flash_attention_fwd_generic,
    flash_attention_fwd_plain, flash_cross_attention_plain)

KERNELS = ["band_topk_lse", "decode_cross_attention", "decode_conv_block",
           "decode_ffn_block", "flash_attention_fwd", "flash_attention_bwd",
           "dynamic_conv", "band_topk_lse_int8", "decode_cross_attention_int8",
           "decode_ffn_block_partial", "band_topk_lse_generic",
           "decode_cross_attention_generic", "decode_conv_block_generic",
           "decode_ffn_block_generic", "flash_attention_fwd_generic",
           "flash_attention_bwd_generic", "band_topk_lse_int8_generic",
           "decode_cross_attention_int8_generic"]
GENERIC = (band_topk_lse_generic, decode_cross_attention_generic,
           decode_conv_block_generic, decode_ffn_block_generic)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "false")
    return torch.device("cuda")


def _kernel_calls(device, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(0)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dtype).to(device)

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=g,
                             dtype=torch.int8).to(device)

    N, C, H, K, F, V, S = 5, 64, 4, 7, 128, 300, 51
    x = rn(N, C)
    # Flash attention: T = 9 queries over S = 51 keys (two padded), p = 0.1.
    q, kf, vf = rn(2, 9, C, scale=0.3), rn(2, S, C), rn(2, S, C)
    bias = torch.zeros(2, S, device=device)
    bias[1, -2:] = -1e9
    seed = torch.tensor([7], dtype=torch.int32, device=device)
    flash = (q, kf, vf, bias, seed, H, 0.1)
    lse = flash_attention_fwd_plain(*flash)[1]
    flash_bwd = (q, kf, vf, bias, seed, lse, rn(2, 9, C, scale=0.1), H, 0.1)
    band8 = (x, i8(V, C), rn(V, scale=0.2).abs() / 127, 5, 250)
    xattn8 = (rn(2, 3, C, scale=0.3), i8(2, S, C), rn(2, S, H).abs() / 127,
              i8(2, S, C), rn(2, S, H).abs() / 127,
              torch.zeros(2, S, device=device), H)
    taps = torch.softmax(torch.randn(2, 9, H, K, generator=g), -1)
    conv = (x, rn(K - 1, N, C), 9, rn(C, 2 * C, scale=0.05),
            rn(2 * C, scale=0.05), rn(C, H * K, scale=0.05),
            rn(C, C, scale=0.05), rn(C, scale=0.05), H)
    ffn = (x, rn(C, F, scale=0.05), rn(F, scale=0.05), rn(F, C, scale=0.05),
           rn(C, scale=0.05))
    band = (x, rn(V, C, scale=0.2), 5, 250)
    xattn = (rn(2, 3, C, scale=0.3), rn(2, S, C), rn(2, S, C),
             torch.zeros(2, S, device=device), H)
    return {
        "dynamic_conv": (dynamic_conv, dynamic_conv_plain,
                         (rn(2, 9, C), taps.to(dtype).to(device), H)),
        "flash_attention_fwd": (flash_attention_fwd,
                                flash_attention_fwd_plain, flash),
        "flash_attention_bwd": (flash_attention_bwd,
                                flash_attention_bwd_plain, flash_bwd),
        "band_topk_lse": (band_topk_lse, band_topk_lse_plain, band),
        "decode_cross_attention": (
            decode_cross_attention, decode_cross_attention_plain, xattn),
        "decode_conv_block": (decode_conv_block, decode_conv_block_plain,
                              conv),
        "decode_ffn_block": (decode_ffn_block, decode_ffn_block_plain, ffn),
        # The generic variants at the same inputs (they take any width).
        "band_topk_lse_generic": (band_topk_lse_generic, band_topk_lse_plain,
                                  band),
        "decode_cross_attention_generic": (
            decode_cross_attention_generic, decode_cross_attention_plain,
            xattn),
        "decode_conv_block_generic": (decode_conv_block_generic,
                                      decode_conv_block_plain, conv),
        "decode_ffn_block_generic": (decode_ffn_block_generic,
                                     decode_ffn_block_plain, ffn),
        "decode_ffn_block_partial": (
            decode_ffn_block_partial, decode_ffn_block_partial_plain,
            (x, rn(C, F, scale=0.05), rn(F, scale=0.05),
             rn(F, C, scale=0.05))),
        "band_topk_lse_int8": (band_topk_lse_int8, band_topk_lse_int8_plain,
                               band8),
        "decode_cross_attention_int8": (
            decode_cross_attention_int8, decode_cross_attention_int8_plain,
            xattn8),
        # The generic variants of flash and of the int8 kernels, likewise.
        "flash_attention_fwd_generic": (flash_attention_fwd_generic,
                                        flash_attention_fwd_plain, flash),
        "flash_attention_bwd_generic": (flash_attention_bwd_generic,
                                        flash_attention_bwd_plain, flash_bwd),
        "band_topk_lse_int8_generic": (band_topk_lse_int8_generic,
                                       band_topk_lse_int8_plain, band8),
        "decode_cross_attention_int8_generic": (
            decode_cross_attention_int8_generic,
            decode_cross_attention_int8_plain, xattn8),
    }


@pytest.mark.parametrize("name", KERNELS)
def test_cpu_tensors_take_the_plain_version(name):
    wrapper, plain, args = _kernel_calls("cpu")[name]
    before = wrapper.launches
    got, want = wrapper(*args), plain(*args)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, w)
    assert wrapper.launches == before   # no kernel launched


@pytest.mark.parametrize("name", KERNELS)
def test_other_devices_raise_instead_of_falling_back(name):
    wrapper, _, args = _kernel_calls("cpu")[name]
    meta = tuple(a.to("meta") if isinstance(a, torch.Tensor) else a
                 for a in args)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        wrapper(*meta)


@pytest.mark.cuda
@pytest.mark.parametrize("name", KERNELS)
def test_kernel_matches_plain_on_card(cuda_device, name):
    """The CUDA kernel against its plain twin on the same card inputs,
    in bf16: values within one bf16 rounding (0.02 / 0.05)."""
    wrapper, plain, args = _kernel_calls(cuda_device)[name]
    before = wrapper.launches
    got = wrapper(*args)
    torch.cuda.synchronize()
    want = plain(*args)
    assert wrapper.launches == before + 1
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        if g.dtype == torch.int32:
            assert (g == w).float().mean().item() >= 0.9
        else:
            torch.testing.assert_close(g.float(), w.float(), atol=0.05,
                                       rtol=0.05)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,C,H,K,dtype", [
    (1, 1, 64, 4, 1, torch.bfloat16),        # one row, one tap
    (2, 63, 96, 3, 31, torch.bfloat16),      # T below the halo, C < chunk
    (2, 130, 6, 2, 5, torch.bfloat16),       # odd R: a pair spans two heads
    (1, 77, 1024, 512, 7, torch.bfloat16),   # R = 2: 64 heads a chunk
    (2, 200, 1024, 16, 31, torch.float32),   # fp32
    (3, 512, 1024, 16, 15, torch.bfloat16),  # flagship width
    (16, 512, 1024, 16, 3, torch.bfloat16),  # the flagship, K templated
    (16, 512, 1024, 16, 7, torch.bfloat16),
    (16, 512, 1024, 16, 15, torch.bfloat16),
    (16, 512, 1024, 16, 31, torch.bfloat16),
    (4, 512, 1024, 16, 5, torch.bfloat16),   # K of the generic kernel
    (1, 512, 1024, 16, 31, torch.bfloat16),  # B = 1: the grid not full
    (2, 130, 96, 3, 7, torch.float32),       # fp32, R = 32, a ragged tile
    (16, 500, 1024, 16, 3, torch.bfloat16),  # two tiles a segment, ragged
    (8, 700, 1024, 16, 5, torch.bfloat16),   # generic, a tile past T
])
def test_dynamic_conv_matches_plain_on_card(cuda_device, B, T, C, H, K,
                                           dtype):
    """The kernel fuses each tap's product and sum (fmaf), in tap order:
    within `dynamic_conv_tolerance` of the plain version (its fp32 sums'
    bound plus one unit in the last place of x's dtype); fp32 also
    within 1e-5 + 1e-5 |plain|, and bf16 bit-equal (a product of two bf16
    values is exact in fp32, so fused and separate sums agree); a second
    call is bit-equal to the first."""
    g = torch.Generator().manual_seed(T)
    x = torch.randn(B, T, C, generator=g).to(dtype).to(cuda_device)
    w = torch.softmax(torch.randn(B, T, H, K, generator=g), -1)
    w = w.to(dtype).to(cuda_device)
    got = dynamic_conv(x, w, H)
    again = dynamic_conv(x, w, H)
    torch.cuda.synchronize()
    want = dynamic_conv_plain(x, w, H)
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= dynamic_conv_tolerance(x, w, H)).all())
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        assert torch.equal(got, want)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,offset", [(torch.bfloat16, 2),
                                          (torch.float32, 2)])
def test_dynamic_conv_takes_x_off_16_bytes_on_card(cuda_device, dtype,
                                                    offset):
    """x `offset` elements into its storage, not 16-byte aligned: its
    rows move as channel pairs, and the output is the plain version's
    (within 1e-5 + 1e-5 |plain| for fp32)."""
    B, T, C, H, K = 2, 130, 1024, 16, 7
    g = torch.Generator().manual_seed(offset)
    buf = torch.randn(B * T * C + offset, generator=g).to(dtype)
    x = buf.to(cuda_device)[offset:].view(B, T, C)
    assert x.data_ptr() % 16 != 0
    w = torch.softmax(torch.randn(B, T, H, K, generator=g), -1)
    w = w.to(dtype).to(cuda_device)
    got = dynamic_conv(x, w, H)
    torch.cuda.synchronize()
    want = dynamic_conv_plain(x, w, H)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_dynamic_conv_refuses_what_the_kernel_does_not_take(cuda_device):
    x = torch.randn(1, 8, 64, device=cuda_device)
    w = torch.randn(1, 8, 4, 3, device=cuda_device)
    for args, match in [((x.half(), w.half(), 4), "bf16 or both fp32"),
                        ((x, w.bfloat16(), 4), "bf16 or both fp32"),
                        ((x, w, 8), "expected"),
                        ((x.transpose(1, 2).contiguous().transpose(1, 2), w,
                          4), "contiguous"),
                        ((x, torch.randn(1, 8, 4, 32, device=cuda_device),
                          4), "1 <= K <= 31")]:
        with pytest.raises(ValueError, match=match):
            dynamic_conv(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Q,S", [
    (16, 1, 514), (1, 1, 514),     # a greedy step over the article
    (16, 16, 51), (1, 5, 51),      # the image context, beams as queries
    (16, 1, 1), (1, 16, 1),        # one key
    (16, 5, 63), (1, 1, 63),       # one short of a 64-key boundary
    (16, 16, 65), (1, 5, 65),      # one past it
])
def test_decode_attention_edge_shapes_on_card(cuda_device, B, Q, S):
    """The cluster-split kernel at flagship width (16 heads of 64) where
    the key runs are ragged: within one bf16 rounding of the plain
    version, and bit-equal on a second call (fixed summation order)."""
    g = torch.Generator().manual_seed(S + Q)
    q = (torch.randn(B, Q, 1024, generator=g) * 0.125).bfloat16()
    k = torch.randn(B, S, 1024, generator=g).bfloat16()
    v = torch.randn(B, S, 1024, generator=g).bfloat16()
    bias = torch.zeros(B, S)
    bias[B // 2:, S // 2:max(S - 2, S // 2)] = -1e9
    args = [t.to(cuda_device) for t in (q, k, v, bias)] + [16]
    got = decode_cross_attention(*args)
    again = decode_cross_attention(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got.float(), decode_cross_attention_plain(*args).float(), atol=0.02,
        rtol=0.02)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Q,S", [(16, 5, 514), (1, 1, 51)])
def test_decode_attention_one_key_unmasked_on_card(cuda_device, B, Q, S):
    """An item whose keys are all masked but one returns that key's
    value row; blocks of its cluster that hold only masked keys add
    exactly nothing."""
    g = torch.Generator().manual_seed(S)
    q = (torch.randn(B, Q, 1024, generator=g) * 0.125).bfloat16()
    k = torch.randn(B, S, 1024, generator=g).bfloat16()
    v = torch.randn(B, S, 1024, generator=g).bfloat16()
    bias = torch.zeros(B, S)
    bias[0] = -1e9
    bias[0, S // 3] = 0.0
    args = [t.to(cuda_device) for t in (q, k, v, bias)] + [16]
    got = decode_cross_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], args[2][0, S // 3].expand(Q, 1024))
    torch.testing.assert_close(
        got.float(), decode_cross_attention_plain(*args).float(), atol=0.02,
        rtol=0.02)


@pytest.mark.cuda
def test_decode_attention_refuses_what_the_kernel_does_not_take(cuda_device):
    def inputs(B=2, Q=3, S=51, E=256):
        return [torch.randn(B, Q, E, device=cuda_device).bfloat16(),
                torch.randn(B, S, E, device=cuda_device).bfloat16(),
                torch.randn(B, S, E, device=cuda_device).bfloat16(),
                torch.zeros(B, S, device=cuda_device), 4]

    before = decode_cross_attention.launches
    q, k, v, bias, H = inputs(Q=17)
    with pytest.raises(ValueError, match="1 <= Q <= 16"):
        decode_cross_attention(q, k, v, bias, H)
    q, k, v, bias, H = inputs(S=0)
    with pytest.raises(ValueError, match="S >= 1"):
        decode_cross_attention(q, k, v, bias, H)
    q, k, v, bias, H = inputs()
    with pytest.raises(ValueError, match="contiguous"):
        decode_cross_attention(
            q, k.transpose(0, 1).contiguous().transpose(0, 1), v, bias, H)
    generic = decode_cross_attention_generic.launches
    with pytest.raises(ValueError, match="bf16.*bf16 or fp32"):
        decode_cross_attention(q.half(), k.half(), v.half(), bias, H)
    q, k, v, bias, H = inputs(E=520)
    with pytest.raises(ValueError, match="head size.*head size"):
        decode_cross_attention(q, k, v, bias, 2)        # heads of 260
    assert decode_cross_attention.launches == before
    assert decode_cross_attention_generic.launches == generic


@pytest.mark.cuda
@pytest.mark.parametrize("N,C,F", [(16, 1024, 4096), (5, 1024, 4096),
                                   (1, 1024, 4096), (40, 1024, 4096),
                                   (3, 192, 96), (16, 64, 32)])
def test_decode_ffn_shapes_on_card(cuda_device, N, C, F):
    """The FFN kernel at the flagship's width for 16, 5, 1 and (three
    launches of 16 rows) 40 rows, and at small widths whose groups are
    smaller than 8: within one bf16 rounding of the plain version, and
    bit-equal on a second call."""
    g = torch.Generator().manual_seed(N + F)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).bfloat16().to(
            cuda_device)

    args = (rn(N, C), rn(C, F, scale=C ** -0.5), rn(F, scale=0.05),
            rn(F, C, scale=F ** -0.5), rn(C, scale=0.05))
    before = decode_ffn_block.launches
    got = decode_ffn_block(*args)
    assert decode_ffn_block.launches == before + -(-N // 16)
    again = decode_ffn_block(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(),
                               decode_ffn_block_plain(*args).float(),
                               atol=0.02, rtol=0.02)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("N,m", [(16, 2), (40, 4)])
def test_decode_ffn_partial_mode_on_card(cuda_device, N, m):
    """The partial mode over each of m ranks' F/m columns (tensor
    parallelism): the fp32 sums added, then b2 and x, within one bf16
    rounding of the whole kernel; at one rank, the whole kernel bit for
    bit; its launches counted on `decode_ffn_block_partial`."""
    from news_image_caption_tpu_torch.ops.decode_blocks import ffn_epilogue
    g = torch.Generator().manual_seed(N)
    C, F = 1024, 4096

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).bfloat16().to(
            cuda_device)

    x, w1, b1 = rn(N, C), rn(C, F, scale=C ** -0.5), rn(F, scale=0.05)
    w2, b2 = rn(F, C, scale=F ** -0.5), rn(C, scale=0.05)
    whole = decode_ffn_block(x, w1, b1, w2, b2)
    before = decode_ffn_block_partial.launches
    one = ffn_epilogue(decode_ffn_block_partial(x, w1, b1, w2), b2, x)
    assert decode_ffn_block_partial.launches == before + -(-N // 16)
    n = F // m
    total = sum(decode_ffn_block_partial(
        x, w1[:, r * n:(r + 1) * n].contiguous(),
        b1[r * n:(r + 1) * n].contiguous(),
        w2[r * n:(r + 1) * n].contiguous()) for r in range(m))
    got = ffn_epilogue(total, b2, x)
    torch.cuda.synchronize()
    assert torch.equal(one, whole)
    torch.testing.assert_close(got.float(), whole.float(), atol=0.02,
                               rtol=0.02)


@pytest.mark.cuda
def test_decode_ffn_refuses_what_the_kernel_does_not_take(cuda_device):
    def rn(*shape):
        return torch.randn(*shape, device=cuda_device).bfloat16()

    before = decode_ffn_block.launches
    generic = decode_ffn_block_generic.launches
    x, w1, b1, w2, b2 = rn(4, 64), rn(64, 128), rn(128), rn(128, 64), rn(64)
    with pytest.raises(ValueError, match="contiguous"):
        decode_ffn_block(x, rn(128, 64).T, b1, w2, b2)
    with pytest.raises(ValueError, match="bf16.*bf16 or fp32"):
        decode_ffn_block(*(t.half() for t in (x, w1, b1, w2, b2)))
    with pytest.raises(ValueError, match="one dtype"):
        decode_ffn_block(x.float(), w1, b1, w2, b2)     # the generic route
    with pytest.raises(ValueError, match="expected"):
        decode_ffn_block(x, w1, b1, w2, rn(65))
    assert decode_ffn_block.launches == before
    assert decode_ffn_block_generic.launches == generic
    # The fast kernel's refusals of a width (C % 64, F % 32, its shared
    # memory) are the generic variant's launches.
    for args in [(rn(4, 96), rn(96, 128), b1, rn(128, 96), rn(96)),
                 (x, rn(64, 100), rn(100), rn(100, 64), b2),
                 (rn(4, 2048), rn(2048, 64), rn(64), rn(64, 2048),
                  rn(2048))]:
        got = decode_ffn_block(*args)
        torch.testing.assert_close(got.float(),
                                   decode_ffn_block_plain(*args).float(),
                                   atol=0.02, rtol=0.02)
    assert decode_ffn_block.launches == before
    assert decode_ffn_block_generic.launches == generic + 3


def _band_case(device, N, V, D=1024, seed=0, dup=()):
    """x and a table whose rows `dup` (pairs (dst, src)) are copies, so
    their logits tie exactly."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(N, D, generator=g).bfloat16()
    table = (torch.randn(V, D, generator=g) * D ** -0.5).bfloat16()
    for dst, src in dup:
        table[dst] = table[src]
    return x.to(device), table.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 5, 16])
@pytest.mark.parametrize("N,V,sel", [
    (16, 5002, 5000), (1, 15000, 15000), (16, 30265, 30265),   # the bands
    (80, 5002, 5000), (128, 15000, 15000), (130, 700, 700),    # beam rows
    (5, 63, 63), (16, 64, 64), (17, 65, 60), (32, 16, 16), (33, 200, 17)])
def test_band_topk_shapes_on_card(cuda_device, N, V, sel, k):
    """The walking kernel at the flagship's width: the three bands, beam
    row counts (x resident up to 32 rows, streamed above, two launches
    above 128), ragged and single tiles, sel_limit < V. Values within
    one bf16 rounding of a logit, the plain logit at every chosen id
    equal to the plain value there, lse within fp32 summation order,
    and a second call bit-equal."""
    k = min(k, sel)
    x, table = _band_case(cuda_device, N, V, seed=N + V)
    before = band_topk_lse.launches
    vals, ids, lse = band_topk_lse(x, table, k, sel)
    assert band_topk_lse.launches == before + -(-N // 128)
    again = band_topk_lse(x, table, k, sel)
    torch.cuda.synchronize()
    pv, pi, pl = band_topk_lse_plain(x, table, k, sel)
    logits = (x.float() @ table.float().T).bfloat16().float()
    assert bool((ids >= 0).all()) and bool((ids < sel).all())
    torch.testing.assert_close(vals, pv, atol=0.03125, rtol=0)
    torch.testing.assert_close(torch.gather(logits, 1, ids.long()), pv,
                               atol=0.03125, rtol=0)
    torch.testing.assert_close(lse, pl, atol=1e-3, rtol=1e-4)
    assert (ids == pi).float().mean().item() >= 0.9
    for a, b in zip((vals, ids, lse), again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [3, 40])
def test_band_topk_ties_go_to_the_lowest_id_on_card(cuda_device, N):
    """Copies of one table row in the same tile, in another tile of the
    same block and in other blocks tie exactly; with x = that row they
    are the largest logits, and the ids come back lowest first. A table
    of equal rows returns ids 0 .. k - 1."""
    V, k = 30265, 8
    src = 20000
    copies = [7, 70, 64 * 132 + 5, 64 * 133 + 9, 19999, 30264]
    x, table = _band_case(cuda_device, N, V, seed=1,
                          dup=[(c, src) for c in copies])
    x[:] = table[src] * 8
    vals, ids, _ = band_topk_lse(x, table, k)
    pv, pi, _ = band_topk_lse_plain(x, table, k)
    torch.cuda.synchronize()
    want = sorted(copies + [src])
    assert ids[:, :7].tolist() == [want] * N == pi[:, :7].tolist()
    torch.testing.assert_close(vals, pv, atol=0.0625, rtol=0)
    flat = table[:1].expand(V, -1).contiguous()
    vals, ids, lse = band_topk_lse(x, flat, k, 9000)
    assert ids.tolist() == [list(range(k))] * N
    pv, pi, pl = band_topk_lse_plain(x, flat, k, 9000)
    torch.testing.assert_close(vals, pv, atol=0.0625, rtol=0)
    torch.testing.assert_close(lse, pl, atol=1e-3, rtol=1e-4)


@pytest.mark.cuda
def test_band_topk_refuses_what_the_kernel_does_not_take(cuda_device):
    x, table = _band_case(cuda_device, 4, 300, D=128)
    before = band_topk_lse.launches
    generic = band_topk_lse_generic.launches
    for args, match in [((x.half(), table.half(), 1), "bf16.*bf16 or fp32"),
                        ((x, table, 17), "1 <= k.*1 <= k"),
                        ((x, table, 5, 4), "1 <= k.*1 <= k"),
                        ((x, table, 1, 301), "sel_limit <= V"),
                        ((x, table.T.contiguous().T, 1), "contiguous"),
                        ((x, table.float(), 1), "x's dtype")]:
        with pytest.raises(ValueError, match=match):
            band_topk_lse(*args)
    assert band_topk_lse.launches == before
    assert band_topk_lse_generic.launches == generic
    # D % 64 != 0 and fp32, which the fast kernel refuses, are the
    # generic variant's launches.
    for args in [(x[:, :96].contiguous(), table[:, :96].contiguous(), 3),
                 (x.float(), table.float(), 3)]:
        vals, ids, lse = band_topk_lse(*args)
        pv, _, pl = band_topk_lse_plain(*args)
        torch.testing.assert_close(vals, pv, atol=0.03125, rtol=1e-5)
        torch.testing.assert_close(lse, pl, atol=1e-3, rtol=1e-4)
    assert band_topk_lse.launches == before
    assert band_topk_lse_generic.launches == generic + 2


def _conv_case(device, N, C, H, K, seed=0):
    g = torch.Generator().manual_seed(seed)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).bfloat16().to(device)

    return (rn(N, C), rn(K - 1, N, C, scale=0.5), rn(C, 2 * C, scale=C ** -0.5),
            rn(2 * C, scale=0.05), rn(C, H * K, scale=0.05),
            rn(C, C, scale=C ** -0.5), rn(C, scale=0.05))


@pytest.mark.cuda
@pytest.mark.parametrize("K", [2, 3, 7, 15, 31, 32])
@pytest.mark.parametrize("N", [1, 5, 16, 17, 80, 128, 150])
def test_decode_conv_block_shapes_on_card(cuda_device, N, K):
    """The one-launch kernel at the flagship's width for every tap count
    class (8, 16, 32 padded taps), 1 to 16 rows, row tiles inside the
    launch shared by two groups of blocks (17, 80, 128 rows) and a second
    launch (150),
    at t before, at and past the ring's filling, with the packed taps
    and without: within the reference tests' bf16 tolerances of the
    plain version, and bit-equal on a second call."""
    H = 16
    x, cache, w1, b1, wl, w2, b2 = _conv_case(cuda_device, N, 1024, H, K,
                                              seed=N + K)
    taps = pack_taps(wl, H)
    for t in (0, K - 2, 2 * K + 3):
        args = (x, cache, t, w1, b1, wl, w2, b2, H)
        before = decode_conv_block.launches
        y, h = decode_conv_block(*args, taps=taps)
        assert decode_conv_block.launches == before + -(-N // 128)
        y2, h2 = decode_conv_block(*args)
        torch.cuda.synchronize()
        py, ph = decode_conv_block_plain(*args)
        torch.testing.assert_close(h.float(), ph.float(), atol=0.02, rtol=0.02)
        torch.testing.assert_close(y.float(), py.float(), atol=0.05, rtol=0.05)
        assert torch.equal(y, y2) and torch.equal(h, h2)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [2, 3, 7, 15, 31])
@pytest.mark.parametrize("N", [4, 16, 80, 150])
def test_decode_conv_block_per_row_positions_on_card(cuda_device, N, K):
    """A position a row (a slot pool's rows at their own depths): rows at
    0, K-2, K-1 and past a wrap of the ring, within the reference tests'
    bf16 tolerances of the plain version, bit-equal on a second call; one
    launch a 128 rows; every row at one position is the scalar-t kernel
    bit for bit."""
    H = 16
    x, cache, w1, b1, wl, w2, b2 = _conv_case(cuda_device, N, 1024, H, K,
                                              seed=N * K)
    taps = pack_taps(wl, H)
    base = torch.tensor([0, K - 2, K - 1, 3 * K + 5], dtype=torch.int32)
    pos = base.repeat(-(-N // 4))[:N].to(cuda_device)
    args = (x, cache, pos, w1, b1, wl, w2, b2, H)
    before = decode_conv_block.launches
    y, h = decode_conv_block(*args, taps=taps)
    assert decode_conv_block.launches == before + -(-N // 128)
    y2, h2 = decode_conv_block(*args, taps=taps)
    torch.cuda.synchronize()
    py, ph = decode_conv_block_plain(*args)
    torch.testing.assert_close(h.float(), ph.float(), atol=0.02, rtol=0.02)
    torch.testing.assert_close(y.float(), py.float(), atol=0.05, rtol=0.05)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    same = torch.full((N,), 2 * K + 3, dtype=torch.int32, device=cuda_device)
    ya, ha = decode_conv_block(x, cache, same, w1, b1, wl, w2, b2, H,
                               taps=taps)
    yt, ht = decode_conv_block(x, cache, 2 * K + 3, w1, b1, wl, w2, b2, H,
                               taps=taps)
    torch.cuda.synchronize()
    assert torch.equal(ya, yt) and torch.equal(ha, ht)


@pytest.mark.cuda
def test_decode_conv_block_refuses_positions_it_does_not_take(cuda_device):
    x, cache, w1, b1, wl, w2, b2 = _conv_case(cuda_device, 4, 64, 4, 7)
    before = decode_conv_block.launches
    for pos in (torch.zeros(4, dtype=torch.int64, device=cuda_device),
                torch.zeros(5, dtype=torch.int32, device=cuda_device),
                torch.zeros(4, dtype=torch.int32)):
        with pytest.raises(ValueError, match="positions int32"):
            decode_conv_block(x, cache, pos, w1, b1, wl, w2, b2, 4)
    assert decode_conv_block.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("N,C,H,K", [(5, 64, 4, 7), (16, 256, 2, 5),
                                     (3, 512, 32, 31), (16, 128, 1, 16)])
def test_decode_conv_block_small_widths_on_card(cuda_device, N, C, H, K):
    x, cache, w1, b1, wl, w2, b2 = _conv_case(cuda_device, N, C, H, K, seed=C)
    args = (x, cache, 4, w1, b1, wl, w2, b2, H)
    y, h = decode_conv_block(*args)
    torch.cuda.synchronize()
    py, ph = decode_conv_block_plain(*args)
    torch.testing.assert_close(h.float(), ph.float(), atol=0.02, rtol=0.02)
    torch.testing.assert_close(y.float(), py.float(), atol=0.05, rtol=0.05)


@pytest.mark.cuda
def test_decode_conv_block_refuses_what_the_kernel_does_not_take(cuda_device):
    x, cache, w1, b1, wl, w2, b2 = _conv_case(cuda_device, 4, 64, 4, 7)
    before = decode_conv_block.launches
    generic = decode_conv_block_generic.launches
    ok = (x, cache, 0, w1, b1, wl, w2, b2, 4)
    f16 = tuple(a.half() if isinstance(a, torch.Tensor) else a for a in ok)
    wide = torch.zeros(64, 4 * 33, dtype=x.dtype, device=cuda_device)
    for args, match in [
            (f16, "bf16.*bf16 or fp32"),
            ((x, cache, -1, w1, b1, wl, w2, b2, 4), "t >= 0"),
            ((x, cache, 0, w1, b1, wide, w2, b2, 4), "<= K <= 32.*<= K <= 32"),
            ((x, cache, 0, w1, b1, wl, w2, b2, 7), "head size.*C % H == 0"),
            ((x, cache[:, :3].contiguous(), 0, w1, b1, wl, w2, b2, 4),
             "expected"),
            ((x, cache, 0, w1.T.contiguous().T, b1, wl, w2, b2, 4),
             "expected|contiguous")]:
        with pytest.raises(ValueError, match=match):
            decode_conv_block(*args)
    assert decode_conv_block.launches == before
    assert decode_conv_block_generic.launches == generic
    # fp32, K = 1 and a width beyond the fast kernel's shared memory are
    # the generic variant's launches.
    f32 = tuple(a.float() if isinstance(a, torch.Tensor) else a for a in ok)
    big = _conv_case(cuda_device, 2, 2048, 16, 3)
    for args, tol in [
            (f32, (1e-5, 1e-5)),
            ((x, cache[:0], 5, w1, b1, wl[:, :4].contiguous(), w2, b2, 4),
             (0.05, 0.05)),
            ((big[0], big[1], 0, *big[2:], 16), (0.05, 0.05))]:
        y, h = decode_conv_block(*args)
        py, ph = decode_conv_block_plain(*args)
        torch.testing.assert_close(h.float(), ph.float(), atol=tol[0],
                                   rtol=tol[0])
        torch.testing.assert_close(y.float(), py.float(), atol=tol[1],
                                   rtol=tol[1])
    assert decode_conv_block.launches == before
    assert decode_conv_block_generic.launches == generic + 3


TINY = dict(vocab_size=64, embed_dim=16, ffn_dim=32, num_heads=4,
            num_layers=2, cutoff=(16, 32, 64), image_dim=16, article_dim=12,
            max_positions=64)   # configs/tiny_test.yaml


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kernel_sizes,match", [
    (torch.float32, (3, 5), "bf16"), (torch.bfloat16, (3, 5), "head size"),
    (torch.float32, (1, 3), "bf16")])
def test_models_no_kernel_admits_raise_on_card(cuda_device, dtype,
                                               kernel_sizes, match,
                                               monkeypatch):
    """A model the fast kernels do not admit (fp32, or embed 16 with 4
    heads and ffn 32, or a pointwise layer) decodes on the card through
    the generic variants: greedy and beam-3 launch each generic variant
    and no fast kernel, with the tokens of the same model's plain path on
    the card (the decode wrappers swapped for their plain versions where
    the decoder calls them). It trains through the generic flash kernels:
    the fast ones refuse its heads of 4 with `match` as their reason and
    never launch; its loss, forward and backward, launches the generic
    ones and equals the loss of the same model with the plain flash
    version in the attention's place (the same mask, `dropout_keep`'s):
    within 1e-5 relative in fp32, 0.01 in bf16 (a bf16 rounding of the
    attention's output)."""
    from news_image_caption_tpu_torch.generation.generator import \
        GenerationConfig
    from news_image_caption_tpu_torch.models import decoder_flattened
    from news_image_caption_tpu_torch.models.captioner import \
        TransformerFlattened
    from news_image_caption_tpu_torch.ops import adaptive, attention

    torch.backends.cuda.matmul.allow_tf32 = False
    model = TransformerFlattened(
        device=cuda_device, dtype=dtype, use_flash_train=True,
        generator=torch.Generator(device=cuda_device).manual_seed(0),
        kernel_sizes=kernel_sizes, **TINY)
    g = torch.Generator().manual_seed(1)
    batch = {"image": torch.randn(3, 4, 16, generator=g),
             "article": torch.randn(3, 16, 12, generator=g),
             "image_mask": torch.zeros(3, 4, dtype=torch.bool),
             "article_mask": torch.zeros(3, 16, dtype=torch.bool),
             "caption_ids": torch.randint(2, 64, (3, 12), generator=g)}
    batch = {k: v.to(cuda_device) for k, v in batch.items()}
    fast = (band_topk_lse, decode_cross_attention, decode_conv_block,
            decode_ffn_block)
    counted = fast + GENERIC + (flash_attention_fwd, flash_attention_bwd)
    before = [fn.launches for fn in counted]
    cfg = GenerationConfig(max_len=8, beam_size=3)
    with torch.no_grad():
        tokens, _ = model.generate(batch, cfg)
        beams, _ = model.generate_beam(batch, cfg)
    torch.cuda.synchronize()
    after = [fn.launches - n for fn, n in zip(counted, before)]
    assert after[:4] == [0] * 4 and all(n > 0 for n in after[4:8])
    assert after[8:] == [0, 0]
    monkeypatch.setattr(adaptive, "band_topk_lse", band_topk_lse_plain)
    monkeypatch.setattr(attention, "decode_cross_attention",
                        decode_cross_attention_plain)
    monkeypatch.setattr(decoder_flattened, "decode_conv_block",
                        lambda *a, taps=None: decode_conv_block_plain(*a))
    monkeypatch.setattr(decoder_flattened, "decode_ffn_block",
                        lambda *a, reduce=None: decode_ffn_block_plain(*a))
    with torch.no_grad():
        assert torch.equal(model.generate(batch, cfg)[0], tokens)
        assert torch.equal(model.generate_beam(batch, cfg)[0], beams)
    from news_image_caption_tpu_torch.ops.flash_attention import admits
    ok, why = admits(dtype, 4)
    assert not ok and match in why
    flash = (flash_attention_fwd, flash_attention_bwd,
             flash_attention_fwd_generic, flash_attention_bwd_generic)
    before = [fn.launches for fn in flash]
    loss, _ = model.loss_fn(batch,
                            torch.Generator(device=cuda_device).manual_seed(2))
    loss.backward()
    torch.cuda.synchronize()
    after = [fn.launches - n for fn, n in zip(flash, before)]
    assert after[:2] == [0, 0] and after[2] > 0 and after[3] > 0
    monkeypatch.setattr(attention, "flash_cross_attention",
                        flash_cross_attention_plain)
    with torch.no_grad():
        plain, _ = model.loss_fn(
            batch, torch.Generator(device=cuda_device).manual_seed(2))
    rtol = 1e-5 if dtype == torch.float32 else 0.01
    torch.testing.assert_close(loss.detach().float(), plain.float(),
                               rtol=rtol, atol=0)


NARROW = dict(vocab_size=640, embed_dim=256, ffn_dim=512, num_heads=4,
              num_layers=2, kernel_sizes=(3, 7), cutoff=(128, 384, 640),
              image_dim=64, article_dim=64, max_positions=64)


@pytest.mark.cuda
@pytest.mark.parametrize("quantize_kv,quantize_head", [
    (True, False), (False, True), (True, True)])
def test_int8_routes_launch_their_kernels_on_card(cuda_device, quantize_kv,
                                                  quantize_head):
    """The int8 routes on the card: greedy, beam-3 and speculative decode
    of a bf16 model the kernels admit (d 256, 4 heads of 64) launch the
    int8 variants where their switch is on and never the bf16 kernel of
    that route (K/V and tables are not widened to bf16 for it, and no
    plain twin stands in); the speculative tokens are greedy's."""
    from news_image_caption_tpu_torch.generation.generator import \
        GenerationConfig
    from news_image_caption_tpu_torch.models.captioner import \
        TransformerFlattened

    model = TransformerFlattened(
        device=cuda_device, dtype=torch.bfloat16,
        generator=torch.Generator(device=cuda_device).manual_seed(0),
        **NARROW)
    g = torch.Generator().manual_seed(1)
    batch = {"image": torch.randn(3, 5, 64, generator=g),
             "article": torch.randn(3, 20, 64, generator=g),
             "image_mask": torch.zeros(3, 5, dtype=torch.bool),
             "article_mask": torch.zeros(3, 20, dtype=torch.bool)}
    batch = {k: v.to(cuda_device) for k, v in batch.items()}
    cfg = GenerationConfig(max_len=10, beam_size=3, quantize_kv=quantize_kv,
                           quantize_head=quantize_head)
    counted = (band_topk_lse, band_topk_lse_int8, decode_cross_attention,
               decode_cross_attention_int8)
    before = [fn.launches for fn in counted]
    tokens, _ = model.generate(batch, cfg)
    model.generate_beam(batch, cfg)
    spec, _, _ = model.generate_speculative(
        dict(batch, article_ids=tokens[:, 1:]), cfg, spec_k=3)
    torch.cuda.synchronize()
    band, band8, attn, attn8 = (fn.launches - n
                                for fn, n in zip(counted, before))
    assert (band8 > 0, band == 0) == (quantize_head, quantize_head)
    assert (attn8 > 0, attn == 0) == (quantize_kv, quantize_kv)
    assert torch.equal(spec, tokens)


def _flash_case(device, B, T, S, E, seed):
    """q (pre-scaled as the layer gives it), k, v, g, and a key bias
    whose item 0 has every key padded and whose last item half of
    them."""
    g = torch.Generator().manual_seed(seed)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).bfloat16().to(device)

    bias = torch.zeros(B, S)
    bias[0] = -1e9
    bias[B - 1, S // 2:max(S - 2, S // 2)] = -1e9
    return (rn(B, T, E, scale=0.125), rn(B, S, E), rn(B, S, E),
            bias.to(device), rn(B, T, E, scale=0.1))


@pytest.mark.cuda
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("S", [1, 63, 65, 514])
@pytest.mark.parametrize("T", [2, 63, 64, 65, 128])
def test_flash_attention_edge_shapes_on_card(cuda_device, T, S, p):
    """Both flash kernels at flagship width (16 heads of 64) where the
    query and key tiles are ragged, T = 128 over S = 514 included (no
    bound on T * S), with a fully padded and a half-padded item: out
    within one bf16 rounding of a probability or of the output, lse
    within fp32 summation order, the gradients within a bf16 rounding
    of ds summed over the keys (2% of the item's largest entry plus
    2%), and both bit-equal on a second call."""
    H = 16
    q, k, v, bias, g = _flash_case(cuda_device, 3, T, S, 1024, 100 * T + S)
    seed = torch.tensor([11], dtype=torch.int32, device=cuda_device)
    before = flash_attention_fwd.launches, flash_attention_bwd.launches
    out, lse = flash_attention_fwd(q, k, v, bias, seed, H, p)
    grads = flash_attention_bwd(q, k, v, bias, seed, lse, g, H, p)
    out2, lse2 = flash_attention_fwd(q, k, v, bias, seed, H, p)
    grads2 = flash_attention_bwd(q, k, v, bias, seed, lse, g, H, p)
    torch.cuda.synchronize()
    assert (flash_attention_fwd.launches, flash_attention_bwd.launches) == (
        before[0] + 2, before[1] + 2)
    pout, plse = flash_attention_fwd_plain(q, k, v, bias, seed, H, p)
    pgrads = flash_attention_bwd_plain(q, k, v, bias, seed, plse, g, H, p)
    torch.testing.assert_close(out.float(), pout.float(), atol=0.02,
                               rtol=0.02)
    torch.testing.assert_close(lse, plse, atol=1e-3, rtol=1e-5)
    for name, got, want in zip(("dq", "dk", "dv"), grads, pgrads):
        got, want = got.float(), want.float()
        tol = 0.02 * want.abs().amax((1, 2), True) + 0.02 * want.abs()
        assert bool(((got - want).abs() <= tol).all()), name
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2))


@pytest.mark.cuda
@pytest.mark.parametrize("T,S,H", [(8, 64, 1), (130, 128, 2), (63, 16, 3)])
def test_flash_dropout_mask_on_card(cuda_device, T, S, H):
    """With v = I in every head the output is the dropped probability
    matrix, so its zeros are the dropped slots: they are `dropout_keep`'s
    in every head, T tile and key tile."""
    B, p = 2, 0.25
    g = torch.Generator().manual_seed(S)
    q = (torch.randn(B, T, H * S, generator=g) * 0.3).bfloat16()
    k = torch.randn(B, S, H * S, generator=g).bfloat16()
    v = torch.eye(S).repeat(B, 1, H).bfloat16()
    seed = torch.tensor([5], dtype=torch.int32, device=cuda_device)
    out, _ = flash_attention_fwd(q.to(cuda_device), k.to(cuda_device),
                                 v.to(cuda_device),
                                 torch.zeros(B, S, device=cuda_device), seed,
                                 H, p)
    keep = dropout_keep(seed, B, H, T, S, p)
    kept = (out.float() > 0).view(B, T, H, S).transpose(1, 2)
    assert torch.equal(kept, keep)
    assert 0.7 < keep.float().mean().item() < 0.8


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2, 4])
def test_flash_dropout_mask_with_head_offset_on_card(cuda_device, m):
    """A tensor-parallel rank's heads [r H/m, (r + 1) H/m), launched with
    h0 and the whole head count, drop exactly the whole launch's slots
    of those heads (v = I, as above)."""
    B, T, S, H, p = 2, 70, 64, 4, 0.25
    g = torch.Generator().manual_seed(m)
    n = H // m
    seed = torch.tensor([9], dtype=torch.int32, device=cuda_device)
    keep = dropout_keep(seed, B, H, T, S, p, row0=3)
    for r in range(m):
        q = (torch.randn(B, T, n * S, generator=g) * 0.3).bfloat16()
        k = torch.randn(B, S, n * S, generator=g).bfloat16()
        v = torch.eye(S).repeat(B, 1, n).bfloat16()
        out, _ = flash_attention_fwd(
            q.to(cuda_device), k.to(cuda_device), v.to(cuda_device),
            torch.zeros(B, S, device=cuda_device), seed, n, p, row0=3,
            h0=r * n, heads_total=H)
        kept = (out.float() > 0).view(B, T, n, S).transpose(1, 2)
        assert torch.equal(kept, keep[:, r * n:(r + 1) * n])


@pytest.mark.cuda
def test_flash_attention_refuses_what_the_kernels_do_not_take(cuda_device):
    q, k, v, bias, g = _flash_case(cuda_device, 2, 9, 51, 256, 0)
    seed = torch.tensor([1], dtype=torch.int32, device=cuda_device)
    lse = flash_attention_fwd_plain(q, k, v, bias, seed, 4)[1]
    before = flash_attention_fwd.launches, flash_attention_bwd.launches
    strided = k.transpose(0, 1).contiguous().transpose(0, 1)
    counts = (flash_attention_fwd_generic, flash_attention_bwd_generic)
    generic = [fn.launches for fn in counts]
    # fp16 (neither kernel's type), a strided k, a head of 257 (past the
    # generic kernels' 256).
    wide = _flash_case(cuda_device, 2, 9, 51, 257, 1)
    for H, args, match in [
            (4, (q.half(), k.half(), v.half()), "bf16 or fp32"),
            (4, (q, strided, v), "contiguous"),
            (1, wide[:3], "head size in 1..256")]:
        with pytest.raises(ValueError, match=match):
            flash_attention_fwd(*args, bias, seed, H)
        with pytest.raises(ValueError, match=match):
            flash_attention_bwd(*args, bias, seed, lse,
                                g[..., :args[0].shape[-1]].contiguous(), H)
    with pytest.raises(ValueError, match="g must be like q"):
        flash_attention_bwd(q, k, v, bias, seed, lse, g.float(), 4)
    assert (flash_attention_fwd.launches,
            flash_attention_bwd.launches) == before
    assert [fn.launches for fn in counts] == generic


# -- the generic flash kernels and the int8 generic variants ------------------

FP32_TOL = dict(atol=1e-5, rtol=1e-5)


def _assert_flash_close(got, want, dtype):
    """(out, lse, dq, dk, dv) against the plain versions': fp32 within
    1e-5 + 1e-5 |ref|, the gradients' absolute part times the item's
    largest entry where that is above 1 (an item whose keys are all
    padded has probs 1 in the backward and gradients S' times larger,
    summed over S' terms in another order); bf16 at the fast kernels'
    card tolerances."""
    if dtype == torch.float32:
        for name, a, b in zip(("out", "lse"), got, want):
            torch.testing.assert_close(a, b, **FP32_TOL, msg=name)
        for name, a, b in zip(("dq", "dk", "dv"), got[2:], want[2:]):
            scale = b.abs().amax((1, 2), True).clamp(min=1.0)
            assert bool(((a - b).abs() <= 1e-5 * scale
                         + 1e-5 * b.abs()).all()), name
        return
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=0.02,
                               rtol=0.02)
    torch.testing.assert_close(got[1], want[1], atol=1e-3, rtol=1e-5)
    for name, a, b in zip(("dq", "dk", "dv"), got[2:], want[2:]):
        a, b = a.float(), b.float()
        tol = 0.02 * b.abs().amax((1, 2), True) + 0.02 * b.abs()
        assert bool(((a - b).abs() <= tol).all()), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,S,E,H", [
    (63, 514, 1024, 16), (63, 51, 1024, 16), (11, 20, 16, 4),
    (70, 65, 32, 4), (10, 24, 96, 4), (33, 1, 256, 1), (1, 5, 129, 1)])
def test_flash_generic_matches_plain_on_card(cuda_device, dtype, T, S, E, H):
    """The generic flash kernels against their plain versions at p = 0.1
    (an item's keys all padded, another's half), heads of 64 (the fp32
    flagship), 4, 8, 24, 256 and 129, one or several query and key
    tiles: fp32 within 1e-5 + 1e-5 |ref|, bf16 at the fast kernels'
    tolerances; second calls bit-equal; the fast kernels never launch."""
    q, k, v, bias, g = (t.to(dtype) if t.is_floating_point() and t.dim() == 3
                        else t for t in _flash_case(cuda_device, 3, T, S, E,
                                                    T + S + E))
    seed = torch.tensor([3], dtype=torch.int32, device=cuda_device)
    counts = (flash_attention_fwd_generic, flash_attention_bwd_generic,
              flash_attention_fwd, flash_attention_bwd)
    before = [fn.launches for fn in counts]
    runs = []
    for _ in range(2):
        out, lse = flash_attention_fwd_generic(q, k, v, bias, seed, H, 0.1)
        grads = flash_attention_bwd_generic(q, k, v, bias, seed, lse, g, H,
                                            0.1)
        runs.append((out, lse, *grads))
    torch.cuda.synchronize()
    assert [fn.launches - n for fn, n in zip(counts, before)] == [2, 2, 0, 0]
    pout, plse = flash_attention_fwd_plain(q, k, v, bias, seed, H, 0.1)
    pgrads = flash_attention_bwd_plain(q, k, v, bias, seed, plse, g, H, 0.1)
    _assert_flash_close(runs[0], (pout, plse, *pgrads), dtype)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
@pytest.mark.parametrize("T,S,H", [(8, 64, 1), (130, 128, 2)])
def test_flash_generic_drops_the_fast_kernels_slots_on_card(cuda_device, T,
                                                            S, H):
    """At shapes both routes take (bf16, heads of 64 and 128, p = 0.25),
    v = I: the generic kernel's dropped slots are the fast kernel's and
    `dropout_keep`'s; at the flagship's article shape (p = 0.1) its lse
    within 1e-5 + 1e-5 |ref| and its output within one bf16 rounding of
    the fast kernel's."""
    B, p = 2, 0.25
    g = torch.Generator().manual_seed(T)
    q = (torch.randn(B, T, H * S, generator=g) * 0.3).bfloat16()
    k = torch.randn(B, S, H * S, generator=g).bfloat16()
    v = torch.eye(S).repeat(B, 1, H).bfloat16()
    seed = torch.tensor([5], dtype=torch.int32, device=cuda_device)
    args = (q.to(cuda_device), k.to(cuda_device), v.to(cuda_device),
            torch.zeros(B, S, device=cuda_device), seed, H, p)
    kept = [(fn(*args)[0].float() > 0).view(B, T, H, S).transpose(1, 2)
            for fn in (flash_attention_fwd_generic, flash_attention_fwd)]
    assert torch.equal(kept[0], kept[1])
    assert torch.equal(kept[0], dropout_keep(seed, B, H, T, S, p))
    q, k, v, bias, _ = _flash_case(cuda_device, 16, 63, 514, 1024, 5)
    (go, gl), (fo, fl) = (fn(q, k, v, bias, seed, 16, 0.1) for fn in (
        flash_attention_fwd_generic, flash_attention_fwd))
    torch.testing.assert_close(gl, fl, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(go.float(), fo.float(), atol=0.02, rtol=0.02)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,E,H", [(torch.float32, 1024, 16),
                                       (torch.bfloat16, 96, 4)])
def test_flash_generic_shard_forms_on_card(cuda_device, dtype, E, H):
    """Tensor parallelism at m = 2: the generic kernels over heads [h0,
    h0 + H / 2) of H (h0 = 0 and H / 2, the whole head count given) are
    bit-equal to the whole launch's heads: out, lse, dq, dk and dv."""
    q, k, v, bias, g = (t.to(dtype) if t.dim() == 3 else t
                        for t in _flash_case(cuda_device, 4, 63, 514, E, 7))
    seed = torch.tensor([9], dtype=torch.int32, device=cuda_device)
    out, lse = flash_attention_fwd_generic(q, k, v, bias, seed, H, 0.1)
    grads = flash_attention_bwd_generic(q, k, v, bias, seed, lse, g, H, 0.1)
    n, w = H // 2, E // 2
    for r in range(2):
        cols = slice(r * w, (r + 1) * w)
        sq, sk, sv, sg = (t[..., cols].contiguous() for t in (q, k, v, g))
        sout, slse = flash_attention_fwd_generic(
            sq, sk, sv, bias, seed, n, 0.1, h0=r * n, heads_total=H)
        sgrads = flash_attention_bwd_generic(
            sq, sk, sv, bias, seed, slse, sg, n, 0.1, h0=r * n,
            heads_total=H)
        assert torch.equal(sout, out[..., cols])
        assert torch.equal(slse, lse[:, r * n:(r + 1) * n])
        assert all(torch.equal(a, b[..., cols])
                   for a, b in zip(sgrads, grads))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,S,E,H", [
    (65, 1, 1024, 16), (63, 63, 1024, 16), (63, 64, 1024, 16),
    (63, 65, 1024, 16), (63, 129, 1024, 16),    # 64 held rows, 2, 3 slots
    (130, 514, 1024, 16),                       # 2 slots, T past a tile
    (63, 552, 1024, 16), (63, 553, 1024, 16),   # the last 64 rows hold
    (70, 2000, 1024, 16),                       # 16 rows
    (20, 2325, 1024, 16),                       # past 16 rows: two walks
    (70, 65, 1, 1), (70, 514, 96, 4),           # heads of 1 and 24
    (5, 300, 256, 1), (40, 514, 256, 1),        # heads of 256: 32, 16 rows
    (9, 1213, 256, 1), (33, 51, 16, 4)])        # two walks; heads of 4
def test_flash_generic_forward_held_rows_on_card(cuda_device, dtype, T, S,
                                                 E, H):
    """The generic forward where its plan changes (`generic_fwd_plan`):
    S' of one key, a chunk's 64 keys and one past, the flagship's 514,
    the last S' each row count holds and the first past it, up to where
    the two walks take over; T past one row tile; heads of 1, 4, 24, 64
    and 256; item 0's keys all padded: out and lse against the plain
    version (fp32 within 1e-5 + 1e-5 |ref|, bf16 at the fast kernels'
    tolerances), a second call bit-equal, one launch each."""
    q, k, v, bias, _ = (t.to(dtype) if t.is_floating_point() and t.dim() == 3
                        else t for t in _flash_case(cuda_device, 3, T, S, E,
                                                    T + S + E))
    seed = torch.tensor([13], dtype=torch.int32, device=cuda_device)
    before = flash_attention_fwd_generic.launches
    out, lse = flash_attention_fwd_generic(q, k, v, bias, seed, H, 0.1)
    out2, lse2 = flash_attention_fwd_generic(q, k, v, bias, seed, H, 0.1)
    torch.cuda.synchronize()
    assert flash_attention_fwd_generic.launches == before + 2
    pout, plse = flash_attention_fwd_plain(q, k, v, bias, seed, H, 0.1)
    if dtype == torch.float32:
        torch.testing.assert_close(out, pout, **FP32_TOL)
        torch.testing.assert_close(lse, plse, **FP32_TOL)
    else:
        torch.testing.assert_close(out.float(), pout.float(), atol=0.02,
                                   rtol=0.02)
        torch.testing.assert_close(lse, plse, atol=1e-3, rtol=1e-5)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, "int8"])
@pytest.mark.parametrize("B,Q,S,E,H", [
    (3, 1, 1, 1024, 16), (3, 5, 63, 1024, 16), (3, 1, 64, 1024, 16),
    (3, 16, 65, 1024, 16), (3, 1, 127, 1024, 16), (3, 5, 128, 1024, 16),
    (3, 1, 129, 1024, 16), (16, 1, 514, 1024, 16), (16, 5, 514, 1024, 16),
    (3, 16, 700, 16, 16),      # heads of 1, 11 splits
    (3, 3, 514, 96, 4),        # heads of 24
    (3, 16, 300, 256, 1),      # heads of 256, 16 queries
    (3, 2, 200, 39, 13),       # heads of 3: rows not 16-byte aligned
    (3, 4, 130, 16, 4)])       # heads of 4
def test_attention_generic_splits_on_card(cuda_device, dtype, B, Q, S, E, H):
    """The split generic attention (and its int8 instantiation) where its
    plan changes: S' of one key, a split's 64 keys and one either side,
    two splits' and one either side, the flagship's 514 (9 splits) at
    greedy and beam-5 B=16, 11 splits; Q 1 to 16; heads of 1, 3, 4, 24,
    64 and 256; item 0's keys all padded, the last item's half: against
    the plain version (fp32 within 1e-5 + 1e-5 |ref|, bf16 within 0.02 +
    0.02 |ref|), a second call bit-equal, one launch a call."""
    from news_image_caption_tpu_torch.ops.attention import (AttentionKV,
                                                            quantize_kv)
    int8 = dtype == "int8"
    dtype = torch.float32 if int8 else dtype
    g = torch.Generator().manual_seed(S + E + Q)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dtype).to(
            cuda_device)

    bias = torch.zeros(B, S, device=cuda_device)
    bias[0] = -1e9
    bias[B - 1, S // 2:] = -1e9
    q, k, v = rn(B, Q, E, scale=(E // H) ** -0.5), rn(B, S, E), rn(B, S, E)
    if int8:
        kv = quantize_kv(AttentionKV(k, v, bias), H)
        args = (q, kv.k_q, kv.k_scale, kv.v_q, kv.v_scale, kv.bias, H)
        fn, plain = (decode_cross_attention_int8_generic,
                     decode_cross_attention_int8_plain)
    else:
        args = (q, k, v, bias, H)
        fn, plain = (decode_cross_attention_generic,
                     decode_cross_attention_plain)
    before = fn.launches
    got, again = fn(*args), fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    tol = FP32_TOL if dtype == torch.float32 else dict(atol=0.02, rtol=0.02)
    torch.testing.assert_close(got.float(), plain(*args).float(), **tol)
    assert torch.equal(got, again)


def _block_inputs(device, dtype, seed, *shapes_scales):
    g = torch.Generator().manual_seed(seed)
    return [(torch.randn(*shape, generator=g) * scale).to(dtype).to(device)
            for shape, scale in shapes_scales]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("partial", [False, True])
@pytest.mark.parametrize("N,C,F", [
    (1, 1024, 4096), (16, 1024, 4096), (17, 1024, 4096), (32, 1024, 4096),
    (33, 1024, 4096), (80, 1024, 4096), (81, 1024, 4096), (640, 1024, 4096),
    (5, 100, 200), (81, 48, 200), (33, 200, 48), (3, 1, 5)])
def test_ffn_generic_plan_edges_on_card(cuda_device, dtype, partial, N, C, F):
    """The generic FFN where its plan changes (`generic_product_plan`):
    rows 1 to 640 at the row tiles' edges (16, 32, 80), the flagship's
    widths and widths off every tile and chunk (C, F of 1 to 200), the
    whole block and the partial mode's fp32 sums: against the plain
    version (fp32 within 1e-5 + 1e-5 |ref|; bf16 within 0.02 + 0.02
    |ref|, its fp32 sums 2e-3 + 1e-3 |ref|), a second call bit-equal,
    one launch a call."""
    x, w1, b1, w2, b2 = _block_inputs(
        cuda_device, dtype, N + C + F, ((N, C), 1.0), ((C, F), C ** -0.5),
        ((F,), 0.05), ((F, C), F ** -0.5), ((C,), 0.05))
    args = (x, w1, b1, w2, None if partial else b2)
    before = decode_ffn_block_generic.launches
    got, again = decode_ffn_block_generic(*args), decode_ffn_block_generic(*args)
    torch.cuda.synchronize()
    assert decode_ffn_block_generic.launches == before + 2
    if partial:
        want = decode_ffn_block_partial_plain(x, w1, b1, w2)
        tol = FP32_TOL if dtype == torch.float32 else dict(atol=2e-3,
                                                           rtol=1e-3)
    else:
        want = decode_ffn_block_plain(*args)
        tol = FP32_TOL if dtype == torch.float32 else dict(atol=0.02,
                                                           rtol=0.02)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows_pos", [False, True])
@pytest.mark.parametrize("N,C,H,K", [
    (1, 1024, 16, 3), (16, 1024, 16, 31), (17, 1024, 16, 32),
    (32, 1024, 16, 1), (33, 1024, 16, 15), (80, 1024, 16, 31),
    (81, 1024, 16, 7), (640, 1024, 16, 3), (5, 100, 4, 31), (40, 48, 3, 32),
    (81, 200, 8, 1), (3, 24, 3, 5)])
def test_conv_generic_plan_edges_on_card(cuda_device, dtype, rows_pos, N, C,
                                         H, K):
    """The generic conv block where its plan changes: rows 1 to 640 at
    the row tiles' edges, K = 1, 3, 7, 15, 31 and 32 (the tap logits'
    strips of whole heads), widths off every tile (C of 24 to 200, heads
    of 8 to 64), one step index or a position a row: h and y against the
    plain version (fp32 within 1e-5 + 1e-5 |ref|; bf16 h within 0.02 +
    0.02 |ref|, y 0.05 + 0.05 |ref|), a second call bit-equal, one launch
    a call."""
    x, cache, w1, b1, wl, w2, b2 = _block_inputs(
        cuda_device, dtype, N + C + K, ((N, C), 1.0), ((K - 1, N, C), 0.5),
        ((C, 2 * C), C ** -0.5), ((2 * C,), 0.05),
        ((C, H * K), 0.05 if dtype == torch.bfloat16 else 0.3),
        ((C, C), C ** -0.5), ((C,), 0.05))
    t = (torch.arange(N, dtype=torch.int32, device=cuda_device) * 7 % (
        3 * K + 3)) if rows_pos else 2 * K + 3
    args = (x, cache, t, w1, b1, wl, w2, b2, H)
    before = decode_conv_block_generic.launches
    y, h = decode_conv_block_generic(*args)
    y2, h2 = decode_conv_block_generic(*args)
    torch.cuda.synchronize()
    assert decode_conv_block_generic.launches == before + 2
    py, ph = decode_conv_block_plain(*args)
    fp32 = dtype == torch.float32
    torch.testing.assert_close(h.float(), ph.float(), **(
        FP32_TOL if fp32 else dict(atol=0.02, rtol=0.02)))
    torch.testing.assert_close(y.float(), py.float(), **(
        FP32_TOL if fp32 else dict(atol=0.05, rtol=0.05)))
    assert torch.equal(y, y2) and torch.equal(h, h2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,D,V,k", [(16, 1024, 5000, 1),
                                     (80, 1024, 30265, 5), (5, 16, 32, 5),
                                     (1, 32, 16, 1), (37, 100, 129, 16)])
def test_band_int8_generic_matches_plain_on_card(cuda_device, dtype, N, D, V,
                                                 k):
    """`band_topk_lse_int8_generic` over a table quantized by the port's
    quantizer against its plain version: fp32 values and lse within
    1e-5 + 1e-5 |ref|, bf16 values within one bf16 rounding of a logit
    (0.03125) and lse within 1e-3 + 1e-4 |lse|, ids equal where the
    values are; second calls bit-equal; the int8 kernel never launches."""
    from news_image_caption_tpu_torch.ops.adaptive import \
        quantize_embed_tables
    g = torch.Generator().manual_seed(N + V)
    ((qt, _),) = quantize_embed_tables([(
        (torch.randn(V, D, generator=g) * D ** -0.5).to(dtype).to(
            cuda_device), None)])
    x = torch.randn(N, D, generator=g).to(dtype).to(cuda_device)
    before = band_topk_lse_int8_generic.launches, band_topk_lse_int8.launches
    got = band_topk_lse_int8_generic(x, qt.q, qt.scale, k)
    again = band_topk_lse_int8_generic(x, qt.q, qt.scale, k)
    torch.cuda.synchronize()
    assert (band_topk_lse_int8_generic.launches,
            band_topk_lse_int8.launches) == (before[0] + 2, before[1])
    want = band_topk_lse_int8_plain(x, qt.q, qt.scale, k)
    if dtype == torch.float32:
        torch.testing.assert_close(got[0], want[0], **FP32_TOL)
        torch.testing.assert_close(got[2], want[2], **FP32_TOL)
    else:
        torch.testing.assert_close(got[0], want[0], atol=0.03125, rtol=0)
        torch.testing.assert_close(got[2], want[2], atol=1e-3, rtol=1e-4)
    same = got[0] == want[0]
    assert torch.equal(got[1][same], want[1][same])
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Q,S,E,H", [
    (16, 1, 514, 1024, 16), (16, 5, 51, 1024, 16), (2, 4, 18, 16, 4),
    (2, 1, 6, 32, 4), (2, 3, 33, 39, 13), (2, 16, 70, 512, 2)])
def test_attention_int8_generic_matches_plain_on_card(cuda_device, dtype, B,
                                                      Q, S, E, H):
    """`decode_cross_attention_int8_generic` over K/V quantized by the
    port's quantizer against its plain version (half an item's keys
    padded): fp32 within 1e-5 + 1e-5 |ref|, bf16 within 0.02 + 0.02
    |ref|; second calls bit-equal; the int8 kernel never launches."""
    from news_image_caption_tpu_torch.ops.attention import (AttentionKV,
                                                            quantize_kv)
    g = torch.Generator().manual_seed(S + E)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dtype).to(
            cuda_device)

    bias = torch.zeros(B, S, device=cuda_device)
    bias[B - 1, S // 2:] = -1e9
    kv = quantize_kv(AttentionKV(rn(B, S, E), rn(B, S, E), bias), H)
    args = (rn(B, Q, E, scale=(E // H) ** -0.5), kv.k_q, kv.k_scale, kv.v_q,
            kv.v_scale, kv.bias, H)
    before = (decode_cross_attention_int8_generic.launches,
              decode_cross_attention_int8.launches)
    got = decode_cross_attention_int8_generic(*args)
    again = decode_cross_attention_int8_generic(*args)
    torch.cuda.synchronize()
    assert (decode_cross_attention_int8_generic.launches,
            decode_cross_attention_int8.launches) == (before[0] + 2,
                                                      before[1])
    want = decode_cross_attention_int8_plain(*args)
    tol = FP32_TOL if dtype == torch.float32 else dict(atol=0.02, rtol=0.02)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,E,H,route", [
    (torch.float32, 1024, 16, "generic"), (torch.bfloat16, 1024, 16, "fast"),
    (torch.bfloat16, 16, 4, "generic")])
def test_int8_wrappers_route_on_card(cuda_device, dtype, E, H, route):
    """`band_topk_lse_int8` and `decode_cross_attention_int8` launch the
    int8 kernels where `route_*_int8` says "fast" (the flagship's widths
    in bf16) and their generic variants otherwise (fp32, heads of 4),
    one launch each, never both."""
    from news_image_caption_tpu_torch.ops.attention import (AttentionKV,
                                                            quantize_kv)
    from news_image_caption_tpu_torch.ops.adaptive import \
        quantize_embed_tables
    g = torch.Generator().manual_seed(E)

    def rn(*shape):
        return torch.randn(*shape, generator=g).to(dtype).to(cuda_device)

    ((qt, _),) = quantize_embed_tables([(rn(300, E), None)])
    kv = quantize_kv(AttentionKV(rn(2, 20, E), rn(2, 20, E),
                                 torch.zeros(2, 20, device=cuda_device)), H)
    counts = (band_topk_lse_int8, band_topk_lse_int8_generic,
              decode_cross_attention_int8,
              decode_cross_attention_int8_generic)
    before = [fn.launches for fn in counts]
    band_topk_lse_int8(rn(4, E), qt.q, qt.scale, 5)
    decode_cross_attention_int8(rn(2, 1, E), kv.k_q, kv.k_scale, kv.v_q,
                                kv.v_scale, kv.bias, H)
    torch.cuda.synchronize()
    fast = [1, 0, 1, 0] if route == "fast" else [0, 1, 0, 1]
    assert [fn.launches - n for fn, n in zip(counts, before)] == fast
