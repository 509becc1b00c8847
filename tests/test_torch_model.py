"""The port's flagship decoder against the JAX reference, on the CPU.

One small model (V=120, cutoff (40, 80, 120), D=32, H=4, FFN=64,
kernels (3, 5)) is initialized in JAX with PRNGKey(0) and carried into
the port by `params_from_jax`; the inputs are numpy arrays from a seed.
At fp32 the two packages must agree on teacher-forced log-probs
(rtol = atol = 2e-4, the tolerance of test_port_tell.py), on each
decode-path op, and on greedy tokens exactly, with early exit on and
off.
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
from news_image_caption_tpu.models.decoder_flattened import \
    DynamicConvDecoder as JaxDecoder  # noqa: E402
from news_image_caption_tpu.ops.attention import \
    MultiHeadAttention as JaxMultiHeadAttention  # noqa: E402
from news_image_caption_tpu.ops.conv import \
    DynamicConv as JaxDynamicConv  # noqa: E402
from news_image_caption_tpu_torch.generation.generator import \
    GenerationConfig  # noqa: E402
from news_image_caption_tpu_torch.models.captioner import \
    TransformerFlattened  # noqa: E402
from news_image_caption_tpu_torch.models.from_jax import \
    params_from_jax  # noqa: E402
from news_image_caption_tpu_torch.ops.attention import \
    MultiHeadAttention  # noqa: E402
from news_image_caption_tpu_torch.ops.conv import DynamicConv  # noqa: E402
from news_image_caption_tpu_torch.serving import worker  # noqa: E402

V, D, FFN, H = 120, 32, 64, 4
CUTOFF = (40, 80, V)
KERNELS = (3, 5)
IMG_DIM, ART_DIM = 48, 32
B, T, P, S = 3, 14, 5, 7
SMALL = dict(vocab_size=V, cutoff=CUTOFF, embed_dim=D, ffn_dim=FFN,
             num_heads=H, num_layers=len(KERNELS), kernel_sizes=KERNELS,
             image_dim=IMG_DIM, article_dim=ART_DIM, max_positions=64)
EOS_BIAS = 2.0   # eos row shift that makes the rows finish at steps 3-9


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, so that the suite's parallel
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.RandomState(0)
    caption = rng.randint(2, V, size=(B, T)).astype(np.int32)
    caption[:, 0] = 0
    caption[0, -3:] = 1    # right padding exercises pad-aware positions
    image = rng.randn(B, P, IMG_DIM).astype(np.float32)
    article = rng.randn(B, S, ART_DIM).astype(np.float32)
    image_mask = np.zeros((B, P), bool)
    article_mask = np.zeros((B, S), bool)
    article_mask[1, -2:] = True
    jbatch = {"caption_ids": jnp.asarray(caption), "image": jnp.asarray(image),
              "image_mask": jnp.asarray(image_mask),
              "article": jnp.asarray(article),
              "article_mask": jnp.asarray(article_mask)}
    jmodel = JaxTransformerFlattened(**SMALL)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jbatch)
    model = TransformerFlattened(device="cpu", dtype=torch.float32, **SMALL)
    model.decoder.load_state_dict(
        params_from_jax(_np_tree(params), model.decoder))
    tbatch = {"image": torch.from_numpy(image),
              "image_mask": torch.from_numpy(image_mask),
              "article": torch.from_numpy(article),
              "article_mask": torch.from_numpy(article_mask)}
    return dict(jmodel=jmodel, params=params, jbatch=jbatch, model=model,
                tbatch=tbatch, caption=caption)


def _decoder_jax(pair, method):
    """The JAX decoder's `method` over the pair's captions, jitted."""
    jm = pair["jmodel"]
    return jax.jit(lambda p, ids, ctx: jm.decoder.apply(
        p, ids, ctx, method=method))(
            pair["params"], pair["jbatch"]["caption_ids"],
            jm._contexts(pair["jbatch"]))


def _hidden_jax(pair):
    return _decoder_jax(pair, JaxDecoder.hidden)


def test_teacher_forced_log_prob_matches(pair):
    lp_jax = _decoder_jax(pair, JaxDecoder.log_prob)
    with torch.no_grad():
        lp = pair["model"].decoder.log_prob(
            torch.from_numpy(pair["caption"]).long(), pair["tbatch"])
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_jax), rtol=2e-4,
                               atol=2e-4)


def _eos_biased(pair):
    """Params whose eos word row leans toward the mean decoder state,
    so rows finish at different steps and early exit triggers."""
    h = np.asarray(_hidden_jax(pair)).reshape(-1, D)
    m = h.mean(0)
    params = jax.tree.map(lambda a: a, pair["params"])
    adaptive = params["params"]["embedder"]["adaptive"]
    e0 = np.array(adaptive["embed_0"])
    e0[2] += EOS_BIAS * m / (m @ m)
    adaptive["embed_0"] = jnp.asarray(e0)
    model = TransformerFlattened(device="cpu", dtype=torch.float32, **SMALL)
    model.decoder.load_state_dict(params_from_jax(_np_tree(params),
                                                  model.decoder))
    return params, model


@pytest.mark.parametrize("early_exit", [False, True])
def test_greedy_tokens_identical(pair, early_exit):
    params, model = _eos_biased(pair)
    max_len = 16
    want, want_lp = pair["jmodel"].generate(
        params, pair["jbatch"],
        JaxGenerationConfig(max_len=max_len, early_exit=early_exit))
    got, got_lp = model.generate(
        pair["tbatch"], GenerationConfig(max_len=max_len,
                                         early_exit=early_exit))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp),
                               atol=2e-4, rtol=2e-4)
    ends = [int(np.argmax(row == 2)) for row in got.numpy()]
    assert all(0 < e < max_len for e in ends)           # every row finished
    assert len(set(ends)) > 1                           # at different steps


def test_greedy_tokens_identical_without_eos(pair):
    """Unbiased random weights: no row finishes, all max_len steps."""
    cfg = dict(max_len=12, early_exit=True)
    want, _ = pair["jmodel"].generate(pair["params"], pair["jbatch"],
                                      JaxGenerationConfig(**cfg))
    got, _ = pair["model"].generate(pair["tbatch"], GenerationConfig(**cfg))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampling_default_generator_reproducible(pair):
    """Top-k sampling is ported: without a generator `generate` samples
    from one seeded with 0 (the same tokens as an explicit generator
    seeded with 0); speculative decoding, greedy-only, still raises for it."""
    cfg = GenerationConfig(max_len=4, sampling_topk=5)
    got, _ = pair["model"].generate(pair["tbatch"], cfg)
    again, _ = pair["model"].generate(
        pair["tbatch"], cfg, generator=torch.Generator().manual_seed(0))
    assert torch.equal(got, again)
    with pytest.raises(ValueError, match="greedy-only"):
        pair["model"].generate_speculative(
            dict(pair["tbatch"], article_ids=torch.ones(got.shape[0], 4,
                                                        dtype=torch.long)),
            cfg)


def test_max_len_past_positions_raises(pair):
    with pytest.raises(ValueError, match="max_positions"):
        pair["model"].generate(pair["tbatch"], GenerationConfig(max_len=65))


@pytest.mark.parametrize("context,kdim,beam", [("image", IMG_DIM, 1),
                                               ("article", ART_DIM, 1),
                                               ("article", ART_DIM, 3)])
def test_precompute_kv_and_attend_flat_beam_match(context, kdim, beam):
    rng = np.random.RandomState(kdim + beam)
    ctx = rng.randn(2, S, kdim).astype(np.float32)
    mask = np.zeros((2, S), bool)
    mask[0, -3:] = True
    query = rng.randn(2 * beam, D).astype(np.float32)
    jattn = JaxMultiHeadAttention(embed_dim=D, num_heads=H)
    params = jattn.init(jax.random.PRNGKey(1), jnp.asarray(query[:2, None]),
                        jnp.asarray(ctx), jnp.asarray(ctx))

    def jax_fn(m, q, c, msk):
        return m.attend_flat_beam(q, m.precompute_kv(c, c, msk), beam)

    want = jattn.apply(params, jnp.asarray(query), jnp.asarray(ctx),
                       jnp.asarray(mask), method=jax_fn)
    attn = MultiHeadAttention(D, H, kdim, device="cpu", dtype=torch.float32)
    attn.load_state_dict(params_from_jax(_np_tree(params), attn))
    with torch.no_grad():
        kv = attn.precompute_kv(torch.from_numpy(ctx), torch.from_numpy(ctx),
                                torch.from_numpy(mask))
        got = attn.attend_flat_beam(torch.from_numpy(query), kv, beam)
    assert kv.k.shape == (2, S + 2, D) and kv.bias.shape == (2, S + 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("K", [3, 5])
def test_dynamic_conv_forward_and_step_ring_match(K):
    rng = np.random.RandomState(K)
    C, steps = D, 8
    xs = rng.randn(2, steps, C).astype(np.float32)
    jconv = JaxDynamicConv(input_size=C, kernel_size=K, num_heads=H)
    params = jconv.init(jax.random.PRNGKey(2), jnp.asarray(xs))
    conv = DynamicConv(C, K, H, device="cpu", dtype=torch.float32)
    conv.load_state_dict(params_from_jax(_np_tree(params), conv))
    with torch.no_grad():
        full = conv(torch.from_numpy(xs))
    np.testing.assert_allclose(
        full.numpy(), np.asarray(jconv.apply(params, jnp.asarray(xs))),
        atol=1e-5, rtol=1e-5)
    jcache = jnp.zeros((2, K - 1, C))
    cache = torch.zeros(2, K - 1, C)
    for t in range(steps):
        jout, jcache = jconv.apply(params, jnp.asarray(xs[:, t]), jcache, t,
                                   method=JaxDynamicConv.step_ring)
        with torch.no_grad():
            out, cache = conv.step_ring(torch.from_numpy(xs[:, t]), cache, t)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(out.numpy(), full.numpy()[:, t],
                                   atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(cache.numpy(), np.asarray(jcache))


def test_topk_log_prob_matches(pair):
    """The band-kernel form of topk_log_prob (head [table0; class_projᵀ],
    tails through band_topk_lse) against the reference's XLA form."""
    x = np.array(_hidden_jax(pair)).reshape(-1, D)

    def jax_fn(m, x):
        return m.adaptive_softmax.topk_log_prob(x, 5,
                                                m.embedder.embed_tables())

    jv, ji = pair["jmodel"].decoder.apply(pair["params"], jnp.asarray(x),
                                          method=jax_fn)
    dec = pair["model"].decoder
    with torch.no_grad():
        tv, ti = dec.adaptive_softmax.topk_log_prob(
            torch.from_numpy(x), 5, dec.embedder.embed_tables())
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5,
                               rtol=1e-5)


def test_decode_steps_match_teacher_forcing(pair):
    """Feeding the caption through step_topk reproduces the
    teacher-forced log-prob of each step's best token (ring cache,
    folded weights and all four kernel twins against the
    full-sequence path)."""
    dec = pair["model"].decoder
    caption = torch.from_numpy(pair["caption"]).long()
    with torch.no_grad():
        lp = dec.log_prob(caption, pair["tbatch"])
        kvs = dec.precompute_kv(pair["tbatch"])
        caches = dec.init_cache(B, "cpu")
        weights = dec.decode_weights()
        for t in range(T):
            v, ids = dec.step_topk(caption[:, t], t, kvs, caches, 3, weights)
            want = torch.topk(lp[:, t], 3)
            np.testing.assert_array_equal(ids.numpy(), want.indices.numpy())
            np.testing.assert_allclose(v.numpy(), want.values.numpy(),
                                       atol=1e-4, rtol=1e-4)


def test_serving_builder_job_contract(monkeypatch):
    """predict(job) on the CPU at a small width: numpy job in, int32
    tokens [B, max_len + 1] out, bos first, pad after eos; the same
    tokens as model.generate with the builder's weights."""
    monkeypatch.setattr(worker, "FLAGSHIP", SMALL)
    monkeypatch.setattr(worker, "FLAGSHIP_IMAGE_LEN", P)
    monkeypatch.setattr(worker, "FLAGSHIP_ARTICLE_LEN", S)
    predict = worker.flagship_model_builder("cpu", batch_size=2, max_len=6)
    predict.warmup()
    rng = np.random.RandomState(3)
    job = {"image": rng.randn(2, P, IMG_DIM).astype(np.float32),
           "image_mask": np.zeros((2, P), bool),
           "article": rng.randn(2, S, ART_DIM).astype(np.float32),
           "article_mask": np.zeros((2, S), bool)}
    job["article_mask"][1, 4:] = True
    tokens = predict(job)["tokens"]
    assert tokens.shape == (2, 7) and tokens.dtype == np.int32
    assert (tokens[:, 0] == 0).all() and (tokens < V).all()
    batch = {k: torch.from_numpy(v) for k, v in job.items()}
    batch["image"] = batch["image"].bfloat16()
    batch["article"] = batch["article"].bfloat16()
    want, _ = predict.model.generate(batch, predict.config, predict.weights)
    np.testing.assert_array_equal(tokens, want.numpy())
    with pytest.raises(ValueError, match="max_len"):
        predict(dict(job, max_len=np.array([3])))
