"""The widths the generic decode kernels serve, on the CPU.

The generic variants (`csrc/decode_generic.cu`) take what the fast
kernels do not: fp32, the toy's widths (embed 32, 4 heads of 8, ffn 64,
bands of 18 / 16 / 32 ids; `serving/worker.py::TOY`), tiny_test's
(embed 16, 4 heads of 4, ffn 32) and pointwise conv layers (K = 1). On
the card they compute what the plain versions compute; here the plain
versions are held at those widths against the reference:

  (c) each plain version against the reference's Pallas kernel in
      interpret mode on the same numpy inputs, in fp32 (1e-5 + 1e-5
      |ref|: the sums differ only in order) and in bf16 (the tolerances
      of tests/test_torch_kernels.py: 0.02, and 0.02 / 0.05 for the conv
      block's h / y). The reference's conv block kernel refuses K = 1
      (its `fused_decode_ok` excludes it), so at K = 1 the plain version
      is held against the reference's XLA layer step instead
      (`_conv_block_pre`, `DynamicConv.step_ring`, linear2 and the
      residual);
  (d) the toy end to end: JAX's PRNGKey(0) init carried into the port
      by `params_from_jax`, greedy and beam-3 tokens equal to JAX's,
      log-probs and scores within 2e-4.

The CUDA kernels themselves are held against these plain versions on the
card (`tests/test_torch_dispatch.py -m cuda`, phase 26 of
`chip_smoke.py`).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from news_image_caption_tpu.generation.generator import \
    GenerationConfig as JaxGenerationConfig  # noqa: E402
from news_image_caption_tpu.models.captioner import \
    TransformerFlattened as JaxTransformerFlattened  # noqa: E402
from news_image_caption_tpu.ops.pallas_decode import (  # noqa: E402
    decode_conv_block as jax_conv_block, decode_ffn_block as jax_ffn_block)
from news_image_caption_tpu.ops.pallas_kernels import \
    decode_cross_attention as jax_xattn  # noqa: E402
from news_image_caption_tpu.ops.pallas_topk import \
    band_topk_lse as jax_band  # noqa: E402
from news_image_caption_tpu_torch.generation.generator import \
    GenerationConfig  # noqa: E402
from news_image_caption_tpu_torch.models.captioner import \
    TransformerFlattened  # noqa: E402
from news_image_caption_tpu_torch.models.from_jax import \
    params_from_jax  # noqa: E402
from news_image_caption_tpu_torch.ops.band_topk import \
    band_topk_lse_plain  # noqa: E402
from news_image_caption_tpu_torch.ops.decode_attention import \
    decode_cross_attention_plain  # noqa: E402
from news_image_caption_tpu_torch.ops.decode_blocks import (  # noqa: E402
    decode_conv_block_plain, decode_ffn_block_partial_plain,
    decode_ffn_block_plain)
from news_image_caption_tpu_torch.serving.worker import (  # noqa: E402
    TOY, TOY_ARTICLE_LEN, TOY_IMAGE_LEN)

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
FP32 = dict(atol=1e-5, rtol=1e-5)
# (embed, heads, ffn) of the toy and of configs/tiny_test.yaml.
WIDTHS = {"toy": (32, 4, 64), "tiny": (16, 4, 32)}
# The adaptive bands of cutoff (16, 32, 64): the head [table0; the two
# class rows] with its 16 words selectable, then the two tails.
BANDS = [(18, 16), (16, 16), (32, 32)]


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
    jdt, tdt = DTYPES[name]
    j = jnp.asarray(a).astype(jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# -- (c) band_topk_lse ----------------------------------------------------

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("width", ["toy", "tiny"])
@pytest.mark.parametrize("N,k", [(1, 1), (5, 5), (5, 16)])
@pytest.mark.parametrize("band", range(3))
def test_band_plain_matches_pallas_at_small_widths(dtype, width, N, k, band):
    """The toy's and tiny_test's bands: V = 18 (16 selectable), 16 and
    32 ids, smaller than one of the fast kernel's 64-id tiles; beam 5
    takes k = 5 from sel_limit 16."""
    D = WIDTHS[width][0]
    V, sel = BANDS[band]
    k = min(k, sel)
    rng = np.random.RandomState(100 * band + 10 * N + k)
    xj, xt = _pair(rng.randn(N, D), dtype)
    tj, tt = _pair(rng.randn(V, D) * D ** -0.5, dtype)
    jv, ji, jl = jax_band(xj, tj, k, sel_limit=sel, tile=128, interpret=True)
    tv, ti, tl = band_topk_lse_plain(xt, tt, k, sel)
    assert ti.dtype == torch.int32 and bool((ti < sel).all())
    if dtype == "fp32":
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **FP32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FP32)
    else:
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=0.02,
                                   rtol=0.02)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=0.02,
                                   rtol=0.02)


# -- (c) decode_cross_attention --------------------------------------------

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("width", ["toy", "tiny"])
@pytest.mark.parametrize("B,Q,S", [(1, 1, 5), (1, 1, 6), (2, 5, 8),
                                   (2, 4, 18), (3, 1, 6)])
def test_xattn_plain_matches_pallas_at_small_widths(dtype, width, B, Q, S):
    """Head sizes 8 (toy) and 4 (tiny_test) over S' = 5 to 18 keys (the
    image's or article's plus the bias and zero slots); Q = 1, a beam-5
    step's 5, a chunk's 4; one item whose keys are all masked but one."""
    E, H, _ = WIDTHS[width]
    rng = np.random.RandomState(10 * S + Q)
    qj, qt = _pair(rng.randn(B, Q, E) * (E // H) ** -0.5, dtype)
    kj, kt = _pair(rng.randn(B, S, E), dtype)
    vj, vt = _pair(rng.randn(B, S, E), dtype)
    bias = np.where(rng.rand(B, S) < 0.7, 0.0, -1e9).astype(np.float32)
    bias[-1] = -1e9
    bias[-1, S // 2] = 0.0
    got = decode_cross_attention_plain(qt, kt, vt, torch.from_numpy(bias), H)
    ref = jax_xattn(qj, kj, vj, jnp.asarray(bias), num_heads=H,
                    interpret=True)
    assert got.dtype == qt.dtype
    tol = FP32 if dtype == "fp32" else dict(atol=0.02, rtol=0.02)
    np.testing.assert_allclose(_f32(got), _f32(ref), **tol)


# -- (c) decode_ffn_block ---------------------------------------------------

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("width", ["toy", "tiny"])
@pytest.mark.parametrize("N", [1, 5])
def test_ffn_plain_matches_pallas_at_small_widths(dtype, width, N):
    """C = 32, F = 64 (toy) and C = 16, F = 32 (tiny_test); the partial
    mode's fp32 sum is the whole block before b2, the residual and the
    last roundings."""
    C, _, F = WIDTHS[width]
    rng = np.random.RandomState(F + N)
    (xj, xt), (w1j, w1t), (b1j, b1t), (w2j, w2t), (b2j, b2t) = [
        _pair(a, dtype) for a in (rng.randn(N, C), rng.randn(C, F) * 0.2,
                                  rng.randn(F) * 0.05,
                                  rng.randn(F, C) * 0.2,
                                  rng.randn(C) * 0.05)]
    yj = jax_ffn_block(xj, w1j, b1j, w2j, b2j, chunk=F, interpret=True)
    yt = decode_ffn_block_plain(xt, w1t, b1t, w2t, b2t)
    tol = FP32 if dtype == "fp32" else dict(atol=0.02, rtol=0.02)
    np.testing.assert_allclose(_f32(yt), _f32(yj), **tol)
    if dtype == "fp32":
        part = decode_ffn_block_partial_plain(xt, w1t, b1t, w2t)
        np.testing.assert_allclose((part + b2t + xt).numpy(), _f32(yj),
                                   **FP32)


# -- (c) decode_conv_block ---------------------------------------------------

def _tap_major(wl, H, K):
    """The reference kernel's column order k*H + h (the port's kernel
    takes the stored head-major order h*K + k)."""
    perm = np.array([[h * K + k for h in range(H)] for k in range(K)])
    return wl[:, perm.reshape(-1)]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("width", ["toy", "tiny"])
@pytest.mark.parametrize("N,K,t", [(1, 3, 0), (5, 3, 7), (5, 5, 2),
                                   (1, 5, 12)])
def test_conv_block_plain_matches_pallas_at_small_widths(dtype, width, N, K,
                                                         t):
    """Head sizes 8 (C = 32) and 4 (C = 16), below the fast kernel's
    16-channel strip; t before, at and past the ring filling."""
    C, H, _ = WIDTHS[width]
    rng = np.random.RandomState(K * 10 + t)
    arrays = [rng.randn(N, C), rng.randn(K - 1, N, C),
              rng.randn(C, 2 * C) * 0.2, rng.randn(2 * C) * 0.05,
              rng.randn(C, H * K) * 0.2, rng.randn(C, C) * 0.2,
              rng.randn(C) * 0.05]
    (xj, xt), (cj, ct), (w1j, w1t), (b1j, b1t), (wlj, wlt), (w2j, w2t), \
        (b2j, b2t) = [_pair(a, dtype) for a in arrays]
    yj, hj = jax_conv_block(xj, cj, t, w1j, b1j, _tap_major(wlj, H, K), w2j,
                            b2j, num_heads=H, tile_n=N, interpret=True)
    yt, ht = decode_conv_block_plain(xt, ct, t, w1t, b1t, wlt, w2t, b2t, H)
    tol = (1e-5, 1e-5) if dtype == "fp32" else (0.02, 0.05)
    np.testing.assert_allclose(_f32(ht), _f32(hj), atol=tol[0], rtol=tol[0])
    np.testing.assert_allclose(_f32(yt), _f32(yj), atol=tol[1], rtol=tol[1])


POINTWISE = dict(TOY, kernel_sizes=(1, 3))


@pytest.fixture(scope="module")
def pointwise():
    """JAX's init of the toy with a pointwise first layer (PRNGKey(3)),
    carried into the port."""
    B = 3
    init = {"caption_ids": jnp.zeros((B, 6), jnp.int32),
            "image": jnp.zeros((B, TOY_IMAGE_LEN, TOY["image_dim"])),
            "image_mask": jnp.zeros((B, TOY_IMAGE_LEN), bool),
            "article": jnp.zeros((B, TOY_ARTICLE_LEN, TOY["article_dim"])),
            "article_mask": jnp.zeros((B, TOY_ARTICLE_LEN), bool)}
    jmodel = JaxTransformerFlattened(**POINTWISE)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(3), init)
    model = TransformerFlattened(device="cpu", dtype=torch.float32,
                                 **POINTWISE)
    model.decoder.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, params), model.decoder))
    return jmodel, params, model


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("N", [1, 5])
def test_conv_block_plain_at_kernel_size_one_matches_xla_step(pointwise,
                                                              dtype, N):
    """K = 1, which the reference's kernel refuses (`fused_decode_ok`
    needs min(kernel_sizes) > 1): the plain version over the layer's
    decode weights against the reference's XLA layer step, linear1, the
    GLU, `DynamicConv.step_ring` over an empty ring, linear2 and the
    residual, before the LayerNorm. In bf16 the reference runs its step
    on the bf16-cast params, the port on its bf16 decode weights."""
    jmodel, params, model = pointwise
    jdt, tdt = DTYPES[dtype]
    x = np.random.RandomState(N).randn(N, TOY["embed_dim"])
    xj, xt = _pair(x, dtype)

    def step(dec, x_t):
        layer = dec.layers[0]
        h = layer._conv_block_pre(x_t[:, None, :], True)[:, 0]
        ht, cache = layer.conv.step_ring(h, jnp.zeros((N, 0, h.shape[-1]),
                                                      h.dtype), 3,
                                         deterministic=True)
        return layer.linear2(ht) + x_t, h, cache

    cast = jax.tree.map(lambda a: a.astype(jdt), params)
    yj, hj, cache = jmodel.decoder.apply(cast, xj, method=step)
    assert cache.shape == (N, 0, TOY["embed_dim"])
    with torch.no_grad():
        w = model.decoder.layers[0].decode_weights(tdt)
        yt, ht = decode_conv_block_plain(
            xt, torch.zeros(0, N, TOY["embed_dim"], dtype=tdt), 3,
            w.conv_w1, w.conv_b1, w.conv_wl, w.conv_w2, w.conv_b2,
            TOY["num_heads"])
    tol = (1e-5, 1e-5) if dtype == "fp32" else (0.02, 0.05)
    np.testing.assert_allclose(_f32(ht), _f32(hj), atol=tol[0], rtol=tol[0])
    np.testing.assert_allclose(_f32(yt), _f32(yj), atol=tol[1], rtol=tol[1])


# -- (d) the toy end to end ------------------------------------------------

@pytest.fixture(scope="module")
def toy():
    """The toy in both packages on JAX's PRNGKey(0) init, and a batch of
    three requests (one article padded)."""
    B = 3
    rng = np.random.RandomState(0)
    image = rng.randn(B, TOY_IMAGE_LEN, TOY["image_dim"]).astype(np.float32)
    article = rng.randn(B, TOY_ARTICLE_LEN,
                        TOY["article_dim"]).astype(np.float32)
    article_mask = np.zeros((B, TOY_ARTICLE_LEN), bool)
    article_mask[1, -2:] = True
    image_mask = np.zeros((B, TOY_IMAGE_LEN), bool)
    jbatch = {"caption_ids": jnp.zeros((B, 6), jnp.int32),
              "image": jnp.asarray(image),
              "image_mask": jnp.asarray(image_mask),
              "article": jnp.asarray(article),
              "article_mask": jnp.asarray(article_mask)}
    jmodel = JaxTransformerFlattened(**TOY)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jbatch)
    model = TransformerFlattened(device="cpu", dtype=torch.float32, **TOY)
    model.decoder.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, params), model.decoder))
    tbatch = {"image": torch.from_numpy(image),
              "image_mask": torch.from_numpy(image_mask),
              "article": torch.from_numpy(article),
              "article_mask": torch.from_numpy(article_mask)}
    return jmodel, params, jbatch, model, tbatch


@pytest.mark.parametrize("early_exit", [False, True])
def test_toy_greedy_matches_jax(toy, early_exit):
    jmodel, params, jbatch, model, tbatch = toy
    want, want_lp = jmodel.generate(
        params, jbatch, JaxGenerationConfig(max_len=16, early_exit=early_exit))
    got, got_lp = model.generate(
        tbatch, GenerationConfig(max_len=16, early_exit=early_exit))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp),
                               atol=2e-4, rtol=2e-4)


def test_toy_beam3_matches_jax(toy):
    jmodel, params, jbatch, model, tbatch = toy
    want, want_scores = jax.jit(
        lambda p, b: jmodel.generate_beam(
            p, b, JaxGenerationConfig(max_len=16, beam_size=3)))(params,
                                                                 jbatch)
    got, got_scores = model.generate_beam(
        tbatch, GenerationConfig(max_len=16, beam_size=3))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(got_scores.numpy(), np.asarray(want_scores),
                               atol=2e-4, rtol=2e-4)
