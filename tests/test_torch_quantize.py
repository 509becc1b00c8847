"""The port's int8 routes (`quantize_kv`, `quantize_head`) against the
JAX package, on the CPU in fp32.

A small captioner (2 layers, conv kernels 3 and 7, d = 32, 4 heads,
bands 40 / 40 / 40; `tests/torch_decode_pair.py`) is initialised in JAX
with PRNGKey(0) and carried into the port by `params_from_jax`; the
requests are numpy arrays from a seed. Held: the int8 K/V and their
scales against `to_decode_kv(quantize=True)` after the layout transpose
(int8 values equal, scales at rtol 1e-6), the int8 head tables against
`quantize_embed_tables` the same way, `attend_flat_beam` over int8 K/V
and `topk_log_prob` over int8 tables against JAX's XLA route (atol =
rtol = 2e-4, ids equal), greedy and beam-topk tokens equal to JAX's
under each switch and both, and, in the port alone, speculative greedy
and both slot pools token for token the quantized `generate` /
`generate_beam` (the reference's `tests/test_speculative.py:246` and
`tests/test_continuous.py:151`, `:384`). At configs/tiny_test.yaml's
widths (embed 16, heads of 4: on the card the int8 generic variants'),
greedy and beam tokens under both switches equal JAX's too. What the
int8 kernels admit is held against their launch checks with the C entry
points stubbed. Every JAX call is jitted, and JAX's decodes are computed
once a module.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from news_image_caption_tpu.generation.generator import \
    GenerationConfig as JaxConfig  # noqa: E402
from news_image_caption_tpu.models.captioner import \
    TransformerFlattened as JaxTransformerFlattened  # noqa: E402
from news_image_caption_tpu.models.decoder_flattened import \
    DynamicConvDecoder as JaxDecoder  # noqa: E402
from news_image_caption_tpu.ops.attention import \
    MultiHeadAttention as JaxMultiHeadAttention  # noqa: E402
from news_image_caption_tpu.ops.attention import (  # noqa: E402
    decode_kv_tree, to_decode_kv)
from news_image_caption_tpu_torch.generation.continuous import (  # noqa: E402
    ContinuousBatcher, ContinuousBeamBatcher)
from news_image_caption_tpu_torch.generation.generator import \
    GenerationConfig  # noqa: E402
from news_image_caption_tpu_torch.models.captioner import \
    TransformerFlattened  # noqa: E402
from news_image_caption_tpu_torch.models.from_jax import \
    params_from_jax  # noqa: E402
from news_image_caption_tpu_torch.ops import (_build, band_topk,  # noqa: E402
                                              decode_attention)
from news_image_caption_tpu_torch.ops.adaptive import QuantTable  # noqa: E402
from news_image_caption_tpu_torch.ops.attention import (  # noqa: E402
    MultiHeadAttention, QuantAttentionKV, quantize_kv)

import torch_decode_pair as tp  # noqa: E402

B, MAX_LEN, BEAM = 3, 12, 3
SWITCHES = {"kv": (True, False), "head": (False, True), "both": (True, True)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    jmodel, params, model = tp.make_pair((3, 7), eos_bias=4.0)
    arrays = tp.request_arrays(B, 11)
    return dict(jmodel=jmodel, params=params, model=model,
                jbatch=tp.jax_batch(arrays), tbatch=tp.torch_batch(arrays))


@pytest.fixture(scope="module")
def jax_decodes(pair):
    """JAX's greedy and beam decodes under each switch, computed on
    first use: {(kind, switch): numpy arrays}."""
    jmodel, params = pair["jmodel"], pair["params"]
    cache = {}

    def get(kind, switch):
        if (kind, switch) not in cache:
            qk, qh = SWITCHES[switch]
            cfg = JaxConfig(max_len=MAX_LEN, beam_size=BEAM, quantize_kv=qk,
                            quantize_head=qh)
            fn = jmodel.generate if kind == "greedy" else jmodel.generate_beam
            run = jax.jit(lambda b: fn(params, b, cfg))
            cache[kind, switch] = _np(run(pair["jbatch"]))
        return cache[kind, switch]
    return get


def _config(switch, **kw):
    qk, qh = SWITCHES[switch]
    return GenerationConfig(max_len=MAX_LEN, beam_size=BEAM, quantize_kv=qk,
                            quantize_head=qh, **kw)


# -- the quantizers --------------------------------------------------------

def test_kv_int8_and_scales_equal_jax(pair):
    """Every layer's and context's int8 K/V equal JAX's head-major
    `QuantDecodeKV` after the transpose, and the scales within 1e-6; the
    zero slot (amax 0) quantizes to 0."""
    jmodel, params, model = pair["jmodel"], pair["params"], pair["model"]
    want = jax.jit(lambda p, b: decode_kv_tree(jmodel.decoder.apply(
        p, jmodel._contexts(b), method=JaxDecoder.precompute_kv),
        quantize=True))(params, pair["jbatch"])
    with torch.no_grad():
        got = model.decoder.precompute_kv(
            model._contexts(pair["tbatch"]), quantize=True)
    assert len(got) == len(want) == 2
    for layer_got, layer_want in zip(got, want):
        assert sorted(layer_got) == sorted(layer_want) == ["article",
                                                           "image"]
        for name, kv in layer_got.items():
            w = _np(layer_want[name])
            Bq, H, Dh, S = w.kT_q.shape
            assert isinstance(kv, QuantAttentionKV)
            assert kv.k_q.dtype == kv.v_q.dtype == torch.int8
            np.testing.assert_array_equal(
                kv.k_q.numpy(), w.kT_q.transpose(0, 3, 1, 2).reshape(
                    Bq, S, H * Dh))
            np.testing.assert_array_equal(
                kv.v_q.numpy(), w.vT_q.transpose(0, 2, 1, 3).reshape(
                    Bq, S, H * Dh))
            np.testing.assert_allclose(
                kv.k_scale.numpy(), w.k_scale[:, :, 0].transpose(0, 2, 1),
                rtol=1e-6, atol=0)
            np.testing.assert_allclose(
                kv.v_scale.numpy(), w.v_scale[..., 0].transpose(0, 2, 1),
                rtol=1e-6, atol=0)
            assert not kv.k_q[:, -1].any() and not kv.v_q[:, -1].any()


def test_head_tables_int8_and_scales_equal_jax(pair):
    """Each band's int8 table equals JAX's `quantize_embed_tables`, the
    row scales within 1e-6; the projections pass through."""
    jmodel, params, model = pair["jmodel"], pair["params"], pair["model"]
    want = jax.jit(lambda p: jmodel.decoder.apply(
        p, method=JaxDecoder.quantized_embed_tables))(params)
    got = model.decoder.quantized_embed_tables()
    assert len(got) == len(want) == 3
    for (tab, proj), (wtab, wproj) in zip(got, _np(want)):
        assert isinstance(tab, QuantTable) and tab.q.dtype == torch.int8
        np.testing.assert_array_equal(tab.q.numpy(), wtab.q)
        np.testing.assert_allclose(tab.scale.numpy(), wtab.scale,
                                   rtol=1e-6, atol=0)
        np.testing.assert_array_equal(proj.detach().numpy(), wproj)


# -- the routes' ops -------------------------------------------------------

@pytest.mark.parametrize("beam", [1, 3])
def test_attend_flat_beam_over_int8_kv_matches_jax(beam):
    """`attend_flat_beam` over `quantize_kv`'s K/V against JAX's over
    `to_decode_kv(quantize=True)`, item 0 with three keys padded."""
    S, kdim, D, H = 7, 48, tp.D, tp.H
    rng = np.random.RandomState(beam)
    ctx = rng.randn(2, S, kdim).astype(np.float32)
    mask = np.zeros((2, S), bool)
    mask[0, -3:] = True
    query = rng.randn(2 * beam, D).astype(np.float32)
    jattn = JaxMultiHeadAttention(embed_dim=D, num_heads=H)
    params = jax.jit(jattn.init)(jax.random.PRNGKey(1),
                                 jnp.asarray(query[:2, None]),
                                 jnp.asarray(ctx), jnp.asarray(ctx))

    def jax_fn(m, q, c, msk):
        kv = to_decode_kv(m.precompute_kv(c, c, msk), quantize=True)
        return m.attend_flat_beam(q, kv, beam)

    want = jax.jit(lambda p, q, c, m: jattn.apply(p, q, c, m,
                                                   method=jax_fn))(
        params, jnp.asarray(query), jnp.asarray(ctx), jnp.asarray(mask))
    attn = MultiHeadAttention(D, H, kdim, device="cpu", dtype=torch.float32)
    attn.load_state_dict(params_from_jax(_np(params), attn))
    with torch.no_grad():
        kv = quantize_kv(attn.precompute_kv(
            torch.from_numpy(ctx), torch.from_numpy(ctx),
            torch.from_numpy(mask)), H)
        got = attn.attend_flat_beam(torch.from_numpy(query), kv, beam)
    assert kv.k_scale.shape == (2, S + 2, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=2e-4)


@pytest.mark.parametrize("k", [1, 5])
def test_topk_log_prob_over_int8_tables_matches_jax(pair, k):
    """The exact top-k head over int8 tables against JAX's XLA route:
    log-probs within 2e-4, ids equal."""
    jmodel, params, model = pair["jmodel"], pair["params"], pair["model"]
    x = np.random.RandomState(k).randn(6, tp.D).astype(np.float32) * 2.0

    def jax_fn(m, h):
        tables = m.quantized_embed_tables()
        return m.adaptive_softmax.topk_log_prob(h, k, tables)

    want_v, want_i = _np(jax.jit(lambda p, h: jmodel.decoder.apply(
        p, h, method=jax_fn))(params, jnp.asarray(x)))
    with torch.no_grad():
        got_v, got_i = model.decoder.adaptive_softmax.topk_log_prob(
            torch.from_numpy(x), k, model.decoder.quantized_embed_tables())
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_allclose(got_v.numpy(), want_v, atol=2e-4, rtol=2e-4)


# -- decoding ---------------------------------------------------------------

@pytest.mark.parametrize("switch", sorted(SWITCHES))
def test_greedy_tokens_equal_jax(pair, jax_decodes, switch):
    """Greedy tokens equal JAX's under the switch, log-probs within
    2e-4; the full-vocab step's decode (`generate_full`, the int8
    branch of `log_prob`) gives the same tokens."""
    want_t, want_lp = jax_decodes("greedy", switch)
    got_t, got_lp = pair["model"].generate(pair["tbatch"], _config(switch))
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    np.testing.assert_allclose(got_lp.numpy(), want_lp, atol=2e-4,
                               rtol=2e-4)
    # Some captions end before max_len, so the eos path is reached.
    assert (want_t == 2).any()
    full_t, full_lp = pair["model"].generate_full(pair["tbatch"],
                                                  _config(switch))
    np.testing.assert_array_equal(full_t.numpy(), want_t)
    np.testing.assert_allclose(full_lp.numpy(), want_lp, atol=2e-4,
                               rtol=2e-4)


@pytest.mark.parametrize("switch", sorted(SWITCHES))
def test_beam_tokens_equal_jax(pair, jax_decodes, switch):
    want_t, want_s = jax_decodes("beam", switch)
    got_t, got_s = pair["model"].generate_beam(pair["tbatch"],
                                               _config(switch))
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    np.testing.assert_allclose(got_s.numpy(), want_s, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("switch", sorted(SWITCHES))
def test_speculative_equals_quantized_greedy(pair, switch):
    """Exact speculative greedy over int8 K/V and tables gives the
    quantized greedy's tokens, with oracle drafts (the greedy caption)
    in fewer chunks than steps, and with the article's garbage ids."""
    model, batch = pair["model"], pair["tbatch"]
    cfg = _config(switch)
    want, want_lp = model.generate(batch, cfg)
    for source in (want[:, 1:], torch.randint(3, tp.V, (B, 7))):
        got, got_lp, n_chunks = model.generate_speculative(
            dict(batch, article_ids=source), cfg, spec_k=4)
        assert torch.equal(got, want)
        np.testing.assert_allclose(got_lp.numpy(), want_lp.numpy(),
                                   atol=1e-5, rtol=1e-5)
    oracle = model.generate_speculative(dict(batch, article_ids=want[:, 1:]),
                                        cfg, spec_k=4)[2]
    assert oracle < MAX_LEN


def _request(batch, i):
    return {k: v[i:i + 1] for k, v in batch.items()}


@pytest.mark.parametrize("switch", sorted(SWITCHES))
def test_greedy_pool_equals_generate(pair, switch):
    """The greedy slot pool (2 slots, 3 requests, speculative at k = 3)
    under int8 routes: each request its row of the quantized `generate`;
    the slots hold int8 K/V and their scales."""
    model, batch = pair["model"], pair["tbatch"]
    cfg = _config(switch)
    want, _ = model.generate(batch, cfg)
    for spec_k in (1, 3):
        eng = ContinuousBatcher.for_flattened(model, cfg, 2, inner_steps=3,
                                              spec_k=spec_k, source_len=7)
        ids = [eng.submit(_request(batch, i),
                          source_row=want[i, 1:8].numpy())
               for i in range(B)]
        out = eng.run()
        for i, rid in enumerate(ids):
            np.testing.assert_array_equal(out[rid][0], want[i].numpy())
        leaves = eng.kvs[0]["article"]
        assert isinstance(leaves, QuantAttentionKV) == cfg.quantize_kv


@pytest.mark.parametrize("switch", sorted(SWITCHES))
def test_beam_pool_equals_generate_beam(pair, switch):
    model, batch = pair["model"], pair["tbatch"]
    cfg = _config(switch)
    want_t, want_s = model.generate_beam(batch, cfg)
    eng = ContinuousBeamBatcher(model, cfg, 2, inner_steps=3)
    ids = [eng.submit(_request(batch, i)) for i in range(B)]
    out = eng.run()
    for i, rid in enumerate(ids):
        np.testing.assert_array_equal(out[rid][0], want_t[i].numpy())
        np.testing.assert_allclose(out[rid][1], want_s[i].numpy(), atol=1e-6,
                                   rtol=1e-6)
    assert (eng.tables is not None) == cfg.quantize_head


# -- configs/tiny_test.yaml's widths -----------------------------------------

TINY_WIDTHS = dict(vocab_size=64, cutoff=(16, 32, 64), embed_dim=16,
                   ffn_dim=32, num_heads=4, num_layers=2, kernel_sizes=(3, 5),
                   image_dim=16, article_dim=12, max_positions=64)


@pytest.fixture(scope="module")
def tiny_pair():
    """JAX's captioner at tiny_test's widths (PRNGKey(0)), the port's
    with its weights (fp32), and a batch of 3 requests as both take it."""
    rng = np.random.RandomState(27)
    mask = np.zeros((B, 16), bool)
    mask[1, -5:] = True
    arrays = {"image": rng.randn(B, 4, 16).astype(np.float32),
              "image_mask": np.zeros((B, 4), bool),
              "article": rng.randn(B, 16, 12).astype(np.float32),
              "article_mask": mask}
    caption = rng.randint(2, 64, size=(B, 10)).astype(np.int32)
    caption[:, 0] = 0
    jbatch = tp.jax_batch(arrays)
    jmodel = JaxTransformerFlattened(**TINY_WIDTHS)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  {"caption_ids": jnp.asarray(caption),
                                   **jbatch})
    model = TransformerFlattened(device="cpu", dtype=torch.float32,
                                 **TINY_WIDTHS)
    model.decoder.load_state_dict(params_from_jax(_np(params), model.decoder))
    model.decoder.eval()
    return dict(jmodel=jmodel, params=params, model=model, jbatch=jbatch,
                tbatch=tp.torch_batch(arrays))


@pytest.mark.parametrize("kind", ["greedy", "beam"])
def test_tiny_widths_under_both_switches_match_jax(tiny_pair, kind):
    """quantize_kv and quantize_head at heads of 4 in fp32 (the int8
    generic variants' shapes on the card): greedy and beam-3 tokens equal
    JAX's, log-probs and beam scores within 2e-4."""
    jmodel, params = tiny_pair["jmodel"], tiny_pair["params"]
    jcfg = JaxConfig(max_len=MAX_LEN, beam_size=BEAM, quantize_kv=True,
                     quantize_head=True)
    jfn = jmodel.generate if kind == "greedy" else jmodel.generate_beam
    want_t, want_s = _np(jax.jit(lambda b: jfn(params, b, jcfg))(
        tiny_pair["jbatch"]))
    model = tiny_pair["model"]
    fn = model.generate if kind == "greedy" else model.generate_beam
    got_t, got_s = fn(tiny_pair["tbatch"], _config("both"))
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    np.testing.assert_allclose(got_s.numpy(), want_s, atol=2e-4, rtol=2e-4)


# -- what the int8 kernels admit ----------------------------------------------

@pytest.fixture
def stub_library(monkeypatch):
    """The kernel library's entry points as stubs that succeed, so a
    `_launch*` runs its checks on CPU tensors and 'launches'."""
    monkeypatch.setattr(_build, "function", lambda name, argtypes:
                        lambda *args: 0)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(_build, "sms_of", lambda device: _build.H100_SMS)


def _outcome(launch, *args):
    try:
        launch(*args)
    except ValueError as e:
        return False, str(e)
    return True, ""


DTYPES = [torch.bfloat16, torch.float32]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N,D,V,k", [(16, 1024, 5000, 1), (80, 1024, 30265, 5),
                                     (130, 64, 300, 5), (4, 96, 300, 1),
                                     (4, 128, 300, 17)])
def test_band_int8_admits_is_what_its_launch_accepts(stub_library, dtype, N,
                                                     D, V, k):
    ok, why = band_topk.admits_int8(dtype, N, D, V, k, V)
    before = band_topk.band_topk_lse_int8.launches
    args = (torch.zeros(N, D, dtype=dtype),
            torch.zeros(V, D, dtype=torch.int8), torch.ones(V, dtype=dtype),
            k, V)
    assert _outcome(band_topk._launch_int8, *args) == (ok, why)
    assert band_topk.band_topk_lse_int8.launches == before + (
        -(-N // band_topk.MAX_ROWS) if ok else 0)
    assert ok == (dtype == torch.bfloat16 and D % 64 == 0 and k <= 16)
    if dtype != torch.bfloat16:
        assert "bf16 x, an int8 table" in why
    # The bf16 kernel never takes an int8 table in its place.
    assert not _outcome(band_topk._launch, args[0], args[1], k, V)[0]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("Q,E,H", [(1, 1024, 16), (5, 1024, 16), (16, 64, 4),
                                   (17, 1024, 16), (1, 32, 4)])
def test_attention_int8_admits_is_what_its_launch_accepts(stub_library, dtype,
                                                          Q, E, H):
    Bq, S = 2, 9
    ok, why = decode_attention.admits_int8(dtype, Q, E // H)
    i8 = torch.zeros(Bq, S, E, dtype=torch.int8)
    scale = torch.ones(Bq, S, H, dtype=dtype)
    args = (torch.zeros(Bq, Q, E, dtype=dtype), i8, scale, i8, scale,
            torch.zeros(Bq, S), H)
    assert _outcome(decode_attention._launch_int8, *args) == (ok, why)
    assert ok == (dtype == torch.bfloat16 and Q <= 16
                  and E // H in (16, 32, 64, 128))
    if dtype != torch.bfloat16:
        assert "bf16 q, int8 k/v" in why
    assert not _outcome(decode_attention._launch, args[0], i8, i8, args[5],
                        H)[0]


def test_int8_plans_fit_the_card():
    """The int8 variants' plans at the flagship's shapes fit in shared
    memory; their int8 rows take less of it than the bf16 kernels', so
    the band walk's ring is as deep or deeper (four slots at 128 rows,
    where the bf16 walk fits three)."""
    for N in (1, 16, 80, 128):
        for V in (5000, 15000, 30265):
            p8 = band_topk.band_plan(N, 1024, V, 5, _build.H100_SMS, True)
            p16 = band_topk.band_plan(N, 1024, V, 5, _build.H100_SMS)
            assert p8.smem_bytes <= _build.MAX_SMEM_BYTES
            assert (p8.stages, p8.kc, p8.x_resident) >= (
                p16.stages, p16.kc, p16.x_resident)
            assert p8.stages == 4
    for B, Q in ((1, 1), (16, 1), (16, 4), (16, 5), (128, 5), (16, 16)):
        for S in (51, 514):
            a8 = decode_attention.attention_plan(B, Q, S, 16, 64,
                                                 _build.H100_SMS, True)
            a16 = decode_attention.attention_plan(B, Q, S, 16, 64,
                                                  _build.H100_SMS)
            assert a8.splits <= a16.splits and a8.smem_bytes < a16.smem_bytes
