"""The port's beam search and full-vocab decode step against JAX, on the
CPU.

The small model of test_torch_model.py (V=120, cutoff (40, 80, 120),
D=32, H=4, FFN=64, kernels (3, 5), B=3) is initialized in JAX with
PRNGKey(0), its eos word row biased toward the mean decoder state, and
carried into the port by `params_from_jax`. At fp32 the port's
`generate_beam(impl="topk")` must give JAX's tokens exactly and its
scores within rtol = atol = 2e-4, with early exit and harvest on and off;
the full-vocab `beam_search` and greedy `generate` over `step` must give
the same tokens as the candidate paths; `beam_combine`, `rank_beams` and
the done-list merge must give JAX's outputs on crafted ties. JAX's beam
loop is compiled once a configuration (four in all) and shared by the
tests through a module-scoped cache. The reference's two other cache
layouts, `impl="shift"` and `impl="lazy"`, must give JAX's same impl's
tokens and the port's `topk` tokens, and `DynamicConv`'s shift and lazy
ring steps JAX's steps under beam-like row permutations.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from news_image_caption_tpu.generation import generator as jgen  # noqa: E402
from news_image_caption_tpu.models.captioner import \
    TransformerFlattened as JaxTransformerFlattened  # noqa: E402
from news_image_caption_tpu.models.decoder_flattened import \
    DynamicConvDecoder as JaxDecoder  # noqa: E402
from news_image_caption_tpu_torch.generation import \
    generator as gen  # noqa: E402
from news_image_caption_tpu_torch.models.captioner import \
    TransformerFlattened  # noqa: E402
from news_image_caption_tpu_torch.models.from_jax import \
    params_from_jax  # noqa: E402

V, D, FFN, H = 120, 32, 64, 4
CUTOFF = (40, 80, V)
KERNELS = (3, 5)
IMG_DIM, ART_DIM = 48, 32
B, T, P, S = 3, 14, 5, 7
SMALL = dict(vocab_size=V, cutoff=CUTOFF, embed_dim=D, ffn_dim=FFN,
             num_heads=H, num_layers=len(KERNELS), kernel_sizes=KERNELS,
             image_dim=IMG_DIM, article_dim=ART_DIM, max_positions=64)
# The eos shift of test_torch_model.py's weights, made stronger: at 3.0
# every beam of every item has finished by step 8, so early exit cuts
# the loop short of MAX_LEN; the beams finish at steps 1 to 8.
EOS_BIAS = 3.0
BEAM, MAX_LEN = 3, 10
CONFIGS = {
    "plain": dict(early_exit=False, harvest_finished=False,
                  length_penalty=1.0),
    "early_exit": dict(early_exit=True, harvest_finished=False),
    "harvest": dict(early_exit=False, harvest_finished=True,
                    length_penalty=0.0),
    "early_exit_harvest": dict(early_exit=True, harvest_finished=True),
}


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
    params = jmodel.init(jax.random.PRNGKey(0), jbatch)
    # Lean the eos word row toward the mean decoder state.
    h = np.asarray(jmodel.decoder.apply(
        params, jbatch["caption_ids"], jmodel._contexts(jbatch),
        method=JaxDecoder.hidden)).reshape(-1, D)
    m = h.mean(0)
    params = jax.tree.map(lambda a: a, params)
    adaptive = params["params"]["embedder"]["adaptive"]
    e0 = np.array(adaptive["embed_0"])
    e0[2] += EOS_BIAS * m / (m @ m)
    adaptive["embed_0"] = jnp.asarray(e0)
    model = TransformerFlattened(device="cpu", dtype=torch.float32, **SMALL)
    model.decoder.load_state_dict(params_from_jax(_np_tree(params),
                                                  model.decoder))
    tbatch = {"image": torch.from_numpy(image),
              "image_mask": torch.from_numpy(image_mask),
              "article": torch.from_numpy(article),
              "article_mask": torch.from_numpy(article_mask)}
    return dict(jmodel=jmodel, params=params, jbatch=jbatch, model=model,
                tbatch=tbatch, jax_beams={})


def _config(name, module):
    return module.GenerationConfig(beam_size=BEAM, max_len=MAX_LEN,
                                   **CONFIGS[name])


def _jax_beam(pair, name):
    """JAX's generate_beam(impl="topk") for one configuration, compiled
    once and cached for the module."""
    if name not in pair["jax_beams"]:
        tokens, scores = pair["jmodel"].generate_beam(
            pair["params"], pair["jbatch"], _config(name, jgen), impl="topk")
        pair["jax_beams"][name] = (np.asarray(tokens), np.asarray(scores))
    return pair["jax_beams"][name]


def _count_steps(monkeypatch, decoder, method):
    calls = []
    real = getattr(decoder, method)

    def counted(*args, **kwargs):
        calls.append(args[1])
        return real(*args, **kwargs)

    monkeypatch.setattr(decoder, method, counted)
    return calls


@pytest.mark.parametrize("name", list(CONFIGS))
def test_generate_beam_matches_jax(pair, name, monkeypatch):
    want, want_s = _jax_beam(pair, name)
    steps = _count_steps(monkeypatch, pair["model"].decoder, "step_topk")
    got, got_s = pair["model"].generate_beam(pair["tbatch"],
                                             _config(name, gen))
    assert got.shape == (B, BEAM, MAX_LEN + 1) and got.dtype == torch.long
    assert got_s.shape == (B, BEAM) and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(got_s.numpy(), want_s, atol=2e-4, rtol=2e-4)
    # The weights make beams finish, at different steps.
    ends = {int(np.argmax(row == 2)) for row in got.numpy().reshape(-1,
                                                                   MAX_LEN + 1)
            if (row == 2).any()}
    assert len(ends) > 1
    if name == "early_exit":
        assert len(steps) < MAX_LEN          # every beam finished early
    else:
        assert steps == list(range(MAX_LEN))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_full_vocab_beam_search_matches(pair, name):
    """beam_search over the full-vocab step: the same tokens as JAX's
    candidate-path beam (and so as the port's)."""
    want, want_s = _jax_beam(pair, name)
    model, cfg = pair["model"], _config(name, gen)
    dec = model.decoder
    with torch.inference_mode():
        kvs, caches, seed, weights = model._decode_setup(
            pair["tbatch"], cfg, None, BEAM)

        def step(tok, i):
            lp = dec.step(tok, i, kvs, caches, weights, beam=BEAM)
            assert lp.shape == (B * BEAM, V)
            return lp

        got, got_s = gen.beam_search(step, seed, cfg,
                                     gen.index_reorder(caches))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(got_s.numpy(), want_s, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_beam_scores_match_teacher_forcing(pair, name):
    """Each returned beam's score times len**alpha is the sum of its
    tokens' teacher-forced log-probs up to and including its eos (len
    counts the tokens that are not pad, bos included)."""
    cfg = _config(name, gen)
    model = pair["model"]
    tokens, scores = model.generate_beam(pair["tbatch"], cfg)
    flat = tokens.view(B * BEAM, -1)
    ctx = {k: v.repeat_interleave(BEAM, 0)
           for k, v in model._contexts(pair["tbatch"]).items()}
    with torch.no_grad():
        lp = model.decoder.log_prob(flat[:, :-1], ctx)
    step_lp = torch.gather(lp, 2, flat[:, 1:, None])[..., 0]
    eos = (flat[:, 1:] == cfg.eos_id).int()
    live = (torch.cumsum(eos, 1) - eos) == 0
    lengths = (flat != cfg.pad_id).sum(1).float()
    raw = scores.view(-1) * lengths ** cfg.length_penalty
    np.testing.assert_allclose(raw.numpy(), (step_lp * live).sum(1).numpy(),
                               atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("early_exit", [False, True])
def test_full_vocab_greedy_matches_step_topk(pair, early_exit):
    cfg = gen.GenerationConfig(max_len=12, early_exit=early_exit)
    want, want_lp = pair["model"].generate(pair["tbatch"], cfg)
    got, got_lp = pair["model"].generate_full(pair["tbatch"], cfg)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_allclose(got_lp.numpy(), want_lp.numpy(), atol=1e-5,
                               rtol=1e-5)
    assert (got.numpy() == 2).any(axis=1).all()     # every row finished


def test_step_with_hidden_matches_step_topk(pair):
    """The full-vocab step's log-probs, at the ids step_topk picks, and
    its hidden state, which feeds the same head."""
    dec = pair["model"].decoder
    with torch.inference_mode():
        kvs = dec.precompute_kv(pair["tbatch"])
        weights = dec.decode_weights()
        c_full, c_topk = dec.init_cache(B, "cpu"), dec.init_cache(B, "cpu")
        tok = torch.zeros(B, dtype=torch.long)
        for t in range(6):
            lp, x = dec.step_with_hidden(tok, t, kvs, c_full, weights)
            v, ids = dec.step_topk(tok, t, kvs, c_topk, 4, weights)
            assert lp.shape == (B, V) and x.shape == (B, D)
            np.testing.assert_allclose(
                torch.gather(lp, 1, ids).numpy(), v.numpy(), atol=1e-5,
                rtol=1e-5)
            np.testing.assert_array_equal(
                ids.numpy(), torch.topk(lp, 4).indices.numpy())
            hv, hi = dec.adaptive_softmax.topk_log_prob(
                x, 4, dec.embedder.embed_tables())
            np.testing.assert_array_equal(hi.numpy(), ids.numpy())
            np.testing.assert_allclose(hv.numpy(), v.numpy(), atol=1e-5,
                                       rtol=1e-5)
            for a, b in zip(c_full, c_topk):
                np.testing.assert_array_equal(a.numpy(), b.numpy())
            tok = ids[:, 0]


def _combine_case(name):
    """(scores [B*K], rv, ri [B*K, K], finished [B*K], B, K): crafted
    inputs with ties."""
    Bc, K = 3, 3
    if name == "start":
        # Step 0: beam 0 live, the others at -1e9; -1e9 + lp rounds to
        # -1e9 in fp32, so the dead candidates tie.
        scores = np.tile(np.array([0.0, -1e9, -1e9], np.float32), Bc)
        rv = -np.abs(np.random.RandomState(1).randn(Bc * K, K)).astype(
            np.float32)
        rv.sort(axis=1)
        rv = rv[:, ::-1].copy()
        rv[:, 1] = rv[:, 0]                     # a tie inside each row
    elif name == "equal":
        # Every candidate of an item equal: the lowest positions win.
        scores = np.full(Bc * K, -1.5, np.float32)
        rv = np.full((Bc * K, K), -0.25, np.float32)
    else:   # "finished"
        # Finished rows contribute pad at +0.0, tying with live ones.
        scores = np.array([-1.0, -1.0, -2.0, -3.0, -1e9, -1e9,
                           -0.5, -0.5, -0.5], np.float32)
        rv = np.array([[0.0, -1.0, -2.0]] * (Bc * K), np.float32)
        rv[3] = [-1e9, -1e9, -1e9]
    ri = np.random.RandomState(2).randint(3, V, size=(Bc * K, K)).astype(
        np.int32)
    finished = np.zeros(Bc * K, bool)
    if name == "finished":
        finished[[1, 2, 4, 7]] = True
    return scores, rv, ri, finished, Bc, K


@pytest.mark.parametrize("name", ["start", "equal", "finished"])
def test_beam_combine_ties_match_jax(name):
    scores, rv, ri, finished, Bc, K = _combine_case(name)
    want = jgen.beam_combine(jnp.asarray(scores), jnp.asarray(rv),
                             jnp.asarray(ri), jnp.asarray(finished), Bc, K, 1)
    got = gen.beam_combine(torch.from_numpy(scores), torch.from_numpy(rv),
                           torch.from_numpy(ri).long(),
                           torch.from_numpy(finished), Bc, K, 1)
    assert got[0].dtype == torch.float32
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _rank_case(name):
    """(tokens [B, K, L+1], scores [B, K], alpha) with ties."""
    pad = 1
    tokens = np.full((2, 4, 6), pad, np.int32)
    tokens[:, :, 0] = 0
    lens = np.array([[3, 5, 2, 5], [4, 4, 1, 6]])   # non-pad tokens a beam
    for b in range(2):
        for k in range(4):
            tokens[b, k, 1:lens[b, k]] = 10 + 4 * b + k
    if name == "equal_scores":
        scores, alpha = np.full((2, 4), -2.0, np.float32), 0.0
    elif name == "equal_after_penalty":
        # -3/3 == -5/5 == -2/2 and -4/4 == -4/4 == -6/6: all tie at
        # alpha = 1 once divided by the length.
        scores, alpha = -lens.astype(np.float32), 1.0
    else:   # "sentinel"
        scores = np.array([[-1e9, -1.0, -1e9, -2.0],
                           [-1e9, -1e9, -1e9, -1e9]], np.float32)
        alpha = 0.6
    return tokens, scores, alpha


@pytest.mark.parametrize("name", ["equal_scores", "equal_after_penalty",
                                  "sentinel"])
def test_rank_beams_ties_match_jax(name):
    tokens, scores, alpha = _rank_case(name)
    wt, ws = jgen.rank_beams(jnp.asarray(tokens), jnp.asarray(scores), 1,
                             alpha)
    gt, gs = gen.rank_beams(torch.from_numpy(tokens).long(),
                            torch.from_numpy(scores), 1, alpha)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-6)


def _jax_merge_done(done_s, done_t, tokens, scores, mask):
    """The done-list merge of JAX's `beam_search_candidates` (a closure
    there), as it is written: concatenate, `lax.top_k`, gather."""
    Bm, K = done_s.shape
    cand_s = jnp.where(mask, scores, jnp.float32(-1e9)).reshape(Bm, K)
    all_s = jnp.concatenate([done_s, cand_s], axis=1)
    all_t = jnp.concatenate([done_t, tokens.reshape(Bm, K, -1)], axis=1)
    s, j = jax.lax.top_k(all_s, K)
    return s, jnp.take_along_axis(all_t, j[:, :, None], axis=1)


@pytest.mark.parametrize("name", ["empty", "ties", "final"])
def test_merge_done_ties_match_jax(name):
    Bm, K, L1 = 2, 3, 5
    rng = np.random.RandomState(4)
    done_s = np.full((Bm, K), -1e9, np.float32)
    done_t = np.ones((Bm, K, L1), np.int32)
    tokens = rng.randint(3, V, size=(Bm * K, L1)).astype(np.int32)
    scores = np.array([-1.0, -2.0, -1.0, -0.5, -0.5, -3.0], np.float32)
    mask = np.array([True, False, True, True, True, False])
    if name != "empty":
        # Done entries equal to new ones: the done entries win the tie.
        done_s = np.array([[-1.0, -2.0, -1e9], [-0.5, -1e9, -1e9]],
                          np.float32)
        done_t = rng.randint(3, V, size=(Bm, K, L1)).astype(np.int32)
    if name == "final":
        mask[:] = True
        scores[4] = -1e9
    want = _jax_merge_done(*map(jnp.asarray, (done_s, done_t, tokens, scores,
                                              mask)))
    got = gen.merge_done(torch.from_numpy(done_s),
                         torch.from_numpy(done_t).long(),
                         torch.from_numpy(tokens).long(),
                         torch.from_numpy(scores), torch.from_numpy(mask))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_index_reorder_moves_every_slot_into_a_second_buffer():
    caches = [torch.arange(2 * 4 * 3.).view(2, 4, 3),
              torch.zeros(0, 4, 3)]
    before = [c.clone() for c in caches]
    ptrs = {caches[0].data_ptr()}
    reorder = gen.index_reorder(caches)
    src = torch.tensor([2, 2, 0, 3])
    reorder(src)
    np.testing.assert_array_equal(caches[0].numpy(),
                                  before[0][:, src].numpy())
    assert caches[1].shape == (0, 4, 3)
    ptrs.add(caches[0].data_ptr())
    reorder(src)
    np.testing.assert_array_equal(caches[0].numpy(),
                                  before[0][:, src][:, src].numpy())
    assert caches[0].data_ptr() in ptrs and len(ptrs) == 2


# The cases keep the ids of the time when "shift" and "lazy" raised
# NotImplementedError.
@pytest.mark.parametrize("impl", [
    pytest.param("shift", id="shift-NotImplementedError"),
    pytest.param("lazy", id="lazy-NotImplementedError"),
    pytest.param("flat", id="flat-ValueError")])
def test_generate_beam_impls_raise(pair, impl, monkeypatch):
    """Only an unknown impl raises. The reference's two other cache
    layouts, "shift" (shifted-copy caches) and "lazy" (stationary caches
    read through slot maps), give JAX's same impl's tokens and the port's
    "topk" tokens, scores within 2e-4, through the full-vocab step of
    their layout every step."""
    if impl == "flat":
        with pytest.raises(ValueError, match="unknown beam impl"):
            pair["model"].generate_beam(pair["tbatch"],
                                        _config("plain", gen), impl=impl)
        return
    want, want_s = pair["model"].generate_beam(pair["tbatch"],
                                               _config("plain", gen))
    jtokens, jscores = pair["jmodel"].generate_beam(
        pair["params"], pair["jbatch"], _config("plain", jgen), impl=impl)
    method = {"shift": "step_shift", "lazy": "step_beam_lazy"}[impl]
    steps = _count_steps(monkeypatch, pair["model"].decoder, method)
    got, got_s = pair["model"].generate_beam(pair["tbatch"],
                                             _config("plain", gen), impl=impl)
    assert steps == list(range(MAX_LEN))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jtokens))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_allclose(got_s.numpy(), np.asarray(jscores),
                               atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(got_s.numpy(), want_s.numpy(), atol=2e-4,
                               rtol=2e-4)


def test_generate_beam_max_len_past_positions_raises(pair):
    with pytest.raises(ValueError, match="max_positions"):
        pair["model"].generate_beam(
            pair["tbatch"], gen.GenerationConfig(beam_size=BEAM, max_len=65))


def test_full_vocab_generate_samples_like_generate(pair):
    """Top-k sampling is ported: the full-vocab step's top-5 are the
    candidate step's, so with the same generator `generate_full` samples
    the tokens of `generate`."""
    cfg = gen.GenerationConfig(max_len=4, sampling_topk=5)
    want, want_lp = pair["model"].generate(
        pair["tbatch"], cfg, generator=torch.Generator().manual_seed(3))
    got, got_lp = pair["model"].generate_full(
        pair["tbatch"], cfg, generator=torch.Generator().manual_seed(3))
    assert torch.equal(got, want)
    np.testing.assert_allclose(got_lp.numpy(), want_lp.numpy(), atol=2e-4,
                               rtol=2e-4)


@pytest.mark.parametrize("K,conv_bias", [(1, False), (3, True), (5, False)])
def test_dynamic_conv_shift_and_lazy_steps_match_jax(K, conv_bias):
    """`DynamicConv.step` over a shifted cache and `step_ring_lazy` over a
    stationary cache read through a slot map, 8 steps with the rows
    permuted between steps as a beam reorder moves them (the shifted
    cache gathered, the map composed m[:, perm]): outputs, caches and
    maps equal to JAX's same steps (1e-5), and lazy's outputs equal to
    shift's."""
    from news_image_caption_tpu.ops.conv import \
        DynamicConv as JaxDynamicConv
    from news_image_caption_tpu_torch.ops.conv import DynamicConv
    rng = np.random.RandomState(K)
    N, steps = 4, 8
    xs = rng.randn(steps, N, D).astype(np.float32)
    perms = [rng.permutation(N) for _ in range(steps)]
    jconv = JaxDynamicConv(input_size=D, kernel_size=K, num_heads=H,
                           conv_bias=conv_bias)
    params = jax.jit(jconv.init)(jax.random.PRNGKey(K),
                                 jnp.asarray(xs.transpose(1, 0, 2)))
    conv = DynamicConv(D, K, H, device="cpu", dtype=torch.float32,
                       conv_bias=conv_bias)
    conv.load_state_dict(params_from_jax(_np_tree(params), conv))
    jstep = jax.jit(lambda p, x, c: jconv.apply(p, x, c,
                                                method=JaxDynamicConv.step))
    jlazy = jax.jit(lambda p, x, c, m, t: jconv.apply(
        p, x, c, m, t, method=JaxDynamicConv.step_ring_lazy))
    shift = conv.init_cache(N, "cpu")
    ring = conv.init_cache(N, "cpu")
    smap = torch.arange(N).repeat(K - 1, 1)
    jshift, jring = jnp.zeros((N, K - 1, D)), jnp.zeros((N, K - 1, D))
    jmap = jnp.tile(jnp.arange(N, dtype=jnp.int32), (K - 1, 1))
    assert tuple(shift.shape) == (N, K - 1, D)
    with torch.no_grad():
        for t in range(steps):
            x = torch.from_numpy(xs[t])
            out, shift = conv.step(x, shift)
            lout, ring, smap = conv.step_ring_lazy(x, ring, smap, t)
            jout, jshift = jstep(params, jnp.asarray(xs[t]), jshift)
            jlout, jring, jmap = jlazy(params, jnp.asarray(xs[t]), jring,
                                       jmap, jnp.int32(t))
            for got, want in ((out, jout), (shift, jshift), (lout, jlout),
                              (ring, jring), (lout, out)):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-5, atol=1e-5)
            np.testing.assert_array_equal(smap.numpy(), np.asarray(jmap))
            perm = perms[t]
            shift, jshift = shift[perm], jshift[perm]
            smap, jmap = smap[:, perm], jmap[:, perm]
