"""The port's decode kernels: plain twins vs the reference Pallas kernels.

Each kernel module of `news_image_caption_tpu_torch` keeps a plain
PyTorch version of its kernel; on the CPU that version is the path.
Here it is held against the reference TPU kernel run in Pallas
interpret mode on the same numpy inputs: at fp32 tightly (the sums
differ only in order), at bf16 at the reference tests' tolerances
(0.02 and 0.05, one bf16 rounding flip). The CUDA kernels themselves
are compared with the twins on the card (test_torch_dispatch.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from news_image_caption_tpu.ops.pallas_decode import (  # noqa: E402
    decode_conv_block as jax_conv_block, decode_ffn_block as jax_ffn_block)
from news_image_caption_tpu.ops.pallas_kernels import \
    decode_cross_attention as jax_xattn  # noqa: E402
from news_image_caption_tpu.ops.pallas_topk import \
    band_topk_lse as jax_band  # noqa: E402
from news_image_caption_tpu_torch.ops.band_topk import \
    band_topk_lse_plain  # noqa: E402
from news_image_caption_tpu_torch.ops.decode_attention import \
    decode_cross_attention_plain  # noqa: E402
from news_image_caption_tpu_torch.ops.decode_blocks import (  # noqa: E402
    decode_conv_block_plain, decode_ffn_block_plain)

DTYPES = {"fp32": (np.float32, jnp.float32, torch.float32),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, so that the suite's parallel
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(a, name):
    """The same values as a JAX array and a torch tensor of one dtype
    (bf16 rounding happens once, in JAX, and is carried bit-exact)."""
    _, jdt, tdt = DTYPES[name]
    j = jnp.asarray(a).astype(jdt)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)
    return j, t


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if not isinstance(x, torch.Tensor) else x.float().numpy()


# -- band_topk_lse -----------------------------------------------------

@pytest.mark.parametrize("V,sel_limit,k", [(300, None, 5), (260, 200, 4),
                                           (130, None, 1)])
def test_band_topk_plain_matches_pallas_fp32(V, sel_limit, k):
    rng = np.random.RandomState(V)
    xj, xt = _pair(rng.randn(6, 32), "fp32")
    tj, tt = _pair(rng.randn(V, 32) * 0.2, "fp32")
    jv, ji, jl = jax_band(xj, tj, k, sel_limit=sel_limit, tile=128,
                          interpret=True)
    tv, ti, tl = band_topk_lse_plain(xt, tt, k, sel_limit)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_band_topk_plain_ties_to_lowest_id(dtype):
    """Exact duplicate rows across tiles tie; the lowest id wins, as in
    the Pallas kernel and lax.top_k."""
    rng = np.random.RandomState(2)
    table = rng.randn(300, 32) * 0.2
    table[40] = table[10]
    table[270] = table[10]
    x = 0.1 * rng.randn(5, 32) + 5.0 * table[10]   # rows 10/40/270 lead
    xj, xt = _pair(x, dtype)
    tj, tt = _pair(table, dtype)
    jv, ji, _ = jax_band(xj, tj, 5, tile=128, interpret=True)
    tv, ti, _ = band_topk_lse_plain(xt, tt, 5)
    np.testing.assert_array_equal(ti.numpy()[:, :3], [[10, 40, 270]] * 5)
    np.testing.assert_array_equal(ti.numpy()[:, :3], np.asarray(ji)[:, :3])


def test_band_topk_plain_matches_pallas_bf16():
    rng = np.random.RandomState(0)
    xj, xt = _pair(rng.randn(6, 32), "bf16")
    tj, tt = _pair(rng.randn(300, 32) * 0.2, "bf16")
    jv, ji, jl = jax_band(xj, tj, 5, tile=128, interpret=True)
    tv, ti, tl = band_topk_lse_plain(xt, tt, 5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=0.02,
                               rtol=0.02)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=0.02,
                               rtol=0.02)


# -- decode_cross_attention ---------------------------------------------

@pytest.mark.parametrize("dtype,B,Q,S,atol", [
    ("fp32", 2, 1, 10, 2e-5), ("fp32", 3, 5, 13, 2e-5),
    ("bf16", 2, 1, 51, 0.02), ("bf16", 2, 5, 13, 0.02)])
def test_xattn_plain_matches_pallas(dtype, B, Q, S, atol):
    rng = np.random.RandomState(S)
    E, H = 64, 4
    qj, qt = _pair(rng.randn(B, Q, E) * 0.3, dtype)
    kj, kt = _pair(rng.randn(B, S, E), dtype)
    vj, vt = _pair(rng.randn(B, S, E), dtype)
    bias = np.where(rng.rand(B, S) < 0.8, 0.0, -1e9).astype(np.float32)
    got = decode_cross_attention_plain(qt, kt, vt, torch.from_numpy(bias), H)
    ref = jax_xattn(qj, kj, vj, jnp.asarray(bias), num_heads=H,
                    interpret=True)
    assert got.dtype == qt.dtype
    np.testing.assert_allclose(_f32(got), _f32(ref), atol=atol, rtol=atol)


# -- decode_conv_block ----------------------------------------------------

def _tap_major(wl, H, K):
    """The reference kernel's column order k*H + h (the port's kernel
    takes the stored head-major order h*K + k)."""
    perm = np.array([[h * K + k for h in range(H)] for k in range(K)])
    return wl[:, perm.reshape(-1)]


def _conv_inputs(N, C, H, K, dtype, seed):
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(N, C), rng.randn(K - 1, N, C),
              rng.randn(C, 2 * C) * 0.05, rng.randn(2 * C) * 0.05,
              rng.randn(C, H * K) * 0.05, rng.randn(C, C) * 0.05,
              rng.randn(C) * 0.05]
    return [_pair(a, dtype) for a in arrays]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("N,C,H,K,t", [(8, 64, 4, 7, 11), (4, 128, 8, 3, 0),
                                       (8, 64, 4, 31, 99), (4, 64, 4, 15, 2)])
def test_conv_block_plain_matches_pallas(dtype, N, C, H, K, t):
    (xj, xt), (cj, ct), (w1j, w1t), (b1j, b1t), (wlj, wlt), (w2j, w2t), \
        (b2j, b2t) = _conv_inputs(N, C, H, K, dtype, K)
    yj, hj = jax_conv_block(xj, cj, t, w1j, b1j, _tap_major(wlj, H, K), w2j,
                            b2j, num_heads=H, tile_n=4, interpret=True)
    yt, ht = decode_conv_block_plain(xt, ct, t, w1t, b1t, wlt, w2t, b2t, H)
    tol = (1e-5, 1e-5) if dtype == "fp32" else (0.02, 0.05)
    np.testing.assert_allclose(_f32(ht), _f32(hj), atol=tol[0], rtol=tol[0])
    np.testing.assert_allclose(_f32(yt), _f32(yj), atol=tol[1], rtol=tol[1])


def test_conv_block_plain_ring_slots_across_steps():
    """Steps t = 0..K+1 with the caller writing each GLU row into slot
    t mod (K-1): every step matches the reference kernel fed the same
    history (slots before the start stay zero)."""
    N, C, H, K = 4, 64, 4, 5
    inputs = _conv_inputs(N, C, H, K, "fp32", 0)
    (_, _), _, (w1j, w1t), (b1j, b1t), (wlj, wlt), (w2j, w2t), (b2j, b2t) = \
        inputs
    rng = np.random.RandomState(1)
    cache_t = torch.zeros(K - 1, N, C)
    cache_j = jnp.zeros((K - 1, N, C))
    for t in range(K + 2):
        xj, xt = _pair(rng.randn(N, C), "fp32")
        yj, hj = jax_conv_block(xj, cache_j, t, w1j, b1j,
                                _tap_major(wlj, H, K), w2j, b2j,
                                num_heads=H, tile_n=4, interpret=True)
        yt, ht = decode_conv_block_plain(xt, cache_t, t, w1t, b1t, wlt, w2t,
                                         b2t, H)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5,
                                   rtol=1e-5)
        cache_t[t % (K - 1)] = ht
        cache_j = cache_j.at[t % (K - 1)].set(hj)


# -- decode_ffn_block -----------------------------------------------------

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("N,C,F,chunk", [(8, 64, 256, 64),
                                         (4, 128, 128, 128)])
def test_ffn_block_plain_matches_pallas(dtype, N, C, F, chunk):
    rng = np.random.RandomState(F)
    (xj, xt), (w1j, w1t), (b1j, b1t), (w2j, w2t), (b2j, b2t) = [
        _pair(a, dtype) for a in (rng.randn(N, C), rng.randn(C, F) * 0.05,
                                  rng.randn(F) * 0.05,
                                  rng.randn(F, C) * 0.05,
                                  rng.randn(C) * 0.05)]
    yj = jax_ffn_block(xj, w1j, b1j, w2j, b2j, chunk=chunk, interpret=True)
    yt = decode_ffn_block_plain(xt, w1t, b1t, w2t, b2t)
    tol = 1e-5 if dtype == "fp32" else 0.02
    np.testing.assert_allclose(_f32(yt), _f32(yj), atol=tol, rtol=tol)
