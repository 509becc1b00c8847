"""The port's speculative greedy decoding and per-row positions against
JAX, on the CPU.

A small captioner (2 layers, conv kernels 3 and 7, d = 32, 4 heads) is
initialised in JAX and carried into the port
(`tests/torch_decode_pair.py`); a model with a pointwise layer (kernels
1 and 3) takes the chunk, commit and exactness cases too. At fp32:
`step_chunk` against JAX's `step_chunk` and the port's own sequential
steps, from a fresh ring and from mid-sequence; `commit_conv_caches` on
the port's ring-major rings (read back oldest first) against JAX's
shifted copies, a row committing more than K-1 inputs keeping its last
K-1; speculative greedy with oracle, garbage and n-gram drafts and an
emitted eos, tokens equal to JAX's greedy `generate` and log-probs
within 1e-5; `generate_speculative` taking JAX's number of chunks;
`ngram_drafts`, `greedy_verify` and `write_rows` on crafted inputs;
`step_topk` with rows at different depths; a chunk whose tail runs past
the positional table; `decode_conv_block_plain` with a position a row
against JAX's `DynamicConv.step` on shifted caches; in bf16, speculative
greedy equal to greedy; and `evaluate` with `generation.speculative_k`
writing the reference command's files. JAX's greedy references are
computed once a module.
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from news_image_caption_tpu import cli as jax_cli  # noqa: E402
from news_image_caption_tpu import config as jax_config  # noqa: E402
from news_image_caption_tpu_torch import cli  # noqa: E402
from news_image_caption_tpu_torch.config import (build_model,  # noqa: E402
                                                 load_config)
from news_image_caption_tpu_torch.models.from_jax import \
    params_from_jax  # noqa: E402

from news_image_caption_tpu.generation import \
    speculative as jspec  # noqa: E402
from news_image_caption_tpu.generation.generator import \
    GenerationConfig as JaxConfig  # noqa: E402
from news_image_caption_tpu.models.decoder_flattened import \
    DynamicConvDecoder as JaxDecoder  # noqa: E402
from news_image_caption_tpu.ops.conv import \
    DynamicConv as JaxDynamicConv  # noqa: E402
from news_image_caption_tpu_torch.generation import \
    speculative as spec  # noqa: E402
from news_image_caption_tpu_torch.generation.generator import \
    GenerationConfig  # noqa: E402
from news_image_caption_tpu_torch.models.captioner import \
    TransformerFlattened  # noqa: E402
from news_image_caption_tpu_torch.ops.decode_blocks import \
    decode_conv_block_plain  # noqa: E402

import torch_decode_pair as tp  # noqa: E402

B, MAX_LEN, SPEC_K = 3, 12, 4
TINY = str(Path(__file__).resolve().parent.parent / "configs" /
           "tiny_test.yaml")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny models: one intra-op thread (the suite runs files in
    parallel workers)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _setup(jmodel, params, model, arrays):
    jb, tb = tp.jax_batch(arrays), tp.torch_batch(arrays)
    jkvs = jmodel._decode_setup(params, jmodel._contexts(jb))
    tkvs = model.decoder.precompute_kv(model._contexts(tb))
    return jb, tb, jkvs, tkvs


def _pair(kernels):
    jmodel, params, model = tp.make_pair(kernels)
    arrays = tp.request_arrays(B, 10)
    jb, tb, jkvs, tkvs = _setup(jmodel, params, model, arrays)
    cfg = JaxConfig(max_len=MAX_LEN, sampling_topk=1)
    toks, lps = jmodel.generate(params, jb, cfg)
    dec = jmodel.decoder
    return dict(jmodel=jmodel, params=params, model=model, arrays=arrays,
                kernels=kernels,
                jb=jb, tb=tb, jkvs=jkvs, tkvs=tkvs,
                greedy=(np.asarray(toks), np.asarray(lps)),
                weights=model.decoder.decode_weights(), mid={},
                # JAX's decoder methods, jitted once a module.
                step_shift=jax.jit(lambda tok, t, c: dec.apply(
                    params, tok, t, jkvs, c, method=JaxDecoder.step_shift)),
                step_chunk=jax.jit(lambda tok, pos, c: dec.apply(
                    params, tok, pos, jkvs, c,
                    method=JaxDecoder.step_chunk)),
                step_topk_pos=jax.jit(lambda tok, pos, c: dec.apply(
                    params, tok, pos, jkvs, c, 4,
                    method=JaxDecoder.step_topk_pos)))


@pytest.fixture(scope="module")
def pair():
    """Kernels 3 and 7."""
    return _pair((3, 7))


@pytest.fixture(scope="module")
def pointwise_pair():
    """Kernels 1 and 3: a pointwise layer has no ring."""
    return _pair((1, 3))


@pytest.fixture(params=["pair", "pointwise_pair"], ids=["k3_7", "pointwise"])
def both(request):
    return request.getfixturevalue(request.param)


def _jax_caches_after(pair, toks, n):
    """JAX's shifted-copy caches after n sequential steps over toks."""
    caches = pair["jmodel"].decoder.init_cache(B)
    for t in range(n):
        _, caches = pair["step_shift"](jnp.asarray(toks[:, t]),
                                       jnp.int32(t), caches)
    return caches


def _port_rings_after(pair, toks, n):
    """The port's ring-major caches after n sequential steps, and the
    steps' (log-prob, id) of the top candidate."""
    dec, w = pair["model"].decoder, pair["weights"]
    caches = dec.init_cache(B, "cpu")
    outs = []
    with torch.inference_mode():
        for t in range(n):
            outs.append(dec.step_topk(torch.from_numpy(toks[:, t]).long(), t,
                                      pair["tkvs"], caches, 1, w))
    return caches, outs


def _chunk_case(pair, start):
    """Tokens [B, 9], and for a chunk over toks[:, start:]: JAX's
    (lp, ids, hs) and caches, the port's (lp, ids, hs) and rings."""
    if start not in pair["mid"]:
        toks = np.random.RandomState(7).randint(2, tp.V, (B, 9))
        jc = _jax_caches_after(pair, toks, start)
        jlp, jids, jhs = pair["step_chunk"](
            jnp.asarray(toks[:, start:]), jnp.full((B,), start, jnp.int32),
            jc)
        rings, _ = _port_rings_after(pair, toks, start)
        with torch.inference_mode():
            tlp, tids, ths = pair["model"].decoder.step_chunk(
                torch.from_numpy(toks[:, start:]).long(),
                torch.full((B,), start, dtype=torch.int32), pair["tkvs"],
                rings, pair["weights"])
        pair["mid"][start] = (toks, jc, (jlp, jids, jhs), rings,
                              (tlp, tids, ths))
    return pair["mid"][start]


def _oldest_first(ring, pos):
    """A ring-major cache [K-1, B, C] read back as the shifted copy
    [B, K-1, C] (oldest first) of rows at positions pos [B]."""
    Km1 = ring.shape[0]
    if Km1 == 0:
        return np.zeros((ring.shape[1], 0, ring.shape[2]), np.float32)
    slots = (np.asarray(pos)[:, None] + np.arange(Km1)[None, :]) % Km1
    return np.stack([ring.numpy()[slots[b], b] for b in range(ring.shape[1])])


@pytest.mark.parametrize("start", [0, 4])
def test_step_chunk_matches_jax_and_sequential_steps(both, start):
    pair = both
    toks, _, (jlp, jids, jhs), rings, (tlp, tids, ths) = _chunk_case(pair,
                                                                    start)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=1e-5,
                               rtol=1e-5)
    assert len(ths) == len(jhs)
    for th, jh in zip(ths, jhs):
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5,
                                   rtol=1e-5)
    # The same outputs as sequential one-token steps; the chunk left the
    # rings as they were.
    before = [r.clone() for r in rings]
    _, outs = _port_rings_after(pair, toks, toks.shape[1])
    for j, (lp, ids) in enumerate(outs[start:]):
        np.testing.assert_array_equal(tids[:, j].numpy(), ids[:, 0].numpy())
        np.testing.assert_allclose(tlp[:, j].numpy(), lp[:, 0].numpy(),
                                   atol=1e-5, rtol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(before, rings))


def test_step_chunk_past_the_table_matches_jax(both):
    """Rows whose chunk runs past the positional table (positions up to
    max_positions + 4). Every output at a position in the table equals
    JAX's `step_chunk` (the conv is causal, so the tail cannot reach
    them); the tail, which a commit never keeps, takes the table's last
    row and stays finite, where JAX's out-of-range gather fills NaN. The
    shared embedder itself stays strict."""
    pair = both
    dec = pair["model"].decoder
    toks = np.random.RandomState(11).randint(2, tp.V, (B, 5))
    pos = np.array([dec.max_positions - 4, dec.max_positions - 1,
                    dec.max_positions])
    inside = pos[:, None] + np.arange(5)[None, :] <= dec.max_positions
    jlp, jids, jhs = pair["step_chunk"](
        jnp.asarray(toks), jnp.asarray(pos, jnp.int32),
        pair["jmodel"].decoder.init_cache(B))
    with torch.inference_mode():
        tlp, tids, ths = dec.step_chunk(
            torch.from_numpy(toks).long(), torch.from_numpy(pos).int(),
            pair["tkvs"], dec.init_cache(B, "cpu"), pair["weights"])
        np.testing.assert_array_equal(tids.numpy()[inside],
                                      np.asarray(jids)[inside])
        np.testing.assert_allclose(tlp.numpy()[inside],
                                   np.asarray(jlp)[inside], atol=1e-5,
                                   rtol=1e-5)
        assert torch.isfinite(tlp).all()
        for th, jh in zip(ths, jhs):
            np.testing.assert_allclose(th.numpy()[inside],
                                       np.asarray(jh)[inside],
                                       atol=1e-5, rtol=1e-5)
            assert torch.isfinite(th).all()
        with pytest.raises(IndexError):
            dec.embedder(torch.from_numpy(toks).long(),
                         start_pos=torch.from_numpy(pos)[:, None])


@pytest.mark.parametrize("start", [0, 5])
@pytest.mark.parametrize("m", ["0", "1", "3", "5", "mixed"])
def test_commit_conv_caches_matches_jax(both, start, m):
    """Committing m chunk inputs leaves the ring that m sequential steps
    leave, read oldest first: JAX's shifted copy. With K = 3 a row that
    commits 3 or 5 keeps its last 2; start 5 wraps every ring."""
    pair = both
    toks, jc, (_, _, jhs), rings, (_, _, ths) = _chunk_case(pair, start)
    k = toks.shape[1] - start
    mm = (np.array([1, k, 2]) if m == "mixed"
          else np.full(B, min(int(m), k)))
    want = jspec.commit_conv_caches(jc, jhs, jnp.asarray(mm, jnp.int32))
    got = [r.clone() for r in rings]
    spec.commit_conv_caches(got, ths, torch.from_numpy(mm).int(),
                            torch.full((B,), start, dtype=torch.int32))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_oldest_first(g, start + mm),
                                   np.asarray(w), atol=1e-5, rtol=1e-5)
    # And the sequential steps' own rings, where every row commits alike.
    if m != "mixed":
        seq, _ = _port_rings_after(pair, toks, start + int(mm[0]))
        for g, s in zip(got, seq):
            np.testing.assert_allclose(g.numpy(), s.numpy(), atol=1e-5,
                                       rtol=1e-5)


def _run_spec(pair, cfg, spec_k, draft_fn):
    model, w = pair["model"], pair["weights"]
    dec = model.decoder
    caches = dec.init_cache(B, "cpu")
    seed = torch.full((B,), cfg.bos_id, dtype=torch.long)

    def chunk_fn(t, pos):
        return dec.step_chunk(t, pos, pair["tkvs"], caches, w)

    def commit_fn(hs, m, pos):
        spec.commit_conv_caches(caches, hs, m, pos)

    with torch.inference_mode():
        return spec.speculative_greedy(chunk_fn, commit_fn, seed, cfg,
                                       spec_k, draft_fn)


def _oracle(ref, width):
    ref = torch.from_numpy(np.array(ref)).long()

    def draft_fn(tokens, pos, finished):
        idx = pos.long()[:, None] + 1 + torch.arange(width)[None, :]
        return ref.gather(1, idx.clamp(0, ref.shape[1] - 1))
    return draft_fn


@pytest.mark.parametrize("drafts", ["oracle", "garbage"])
def test_speculative_greedy_equals_jax_greedy(both, drafts):
    pair = both
    ref_toks, ref_lps = pair["greedy"]
    cfg = GenerationConfig(max_len=MAX_LEN)
    if drafts == "oracle":
        draft_fn = _oracle(ref_toks, SPEC_K - 1)
    else:
        def draft_fn(tokens, pos, finished):
            return torch.full((B, SPEC_K - 1), cfg.pad_id, dtype=torch.long)
    toks, lps, n_chunks = _run_spec(pair, cfg, SPEC_K, draft_fn)
    np.testing.assert_array_equal(toks.numpy(), ref_toks)
    np.testing.assert_allclose(lps.numpy(), ref_lps, atol=1e-5, rtol=1e-5)
    if drafts == "oracle":
        assert n_chunks == -(-MAX_LEN // SPEC_K)
    else:
        assert n_chunks == MAX_LEN


def test_speculative_eos_handling(pair):
    """An eos the model emits ends its row in both paths alike."""
    jmodel, params = pair["jmodel"], pair["params"]
    eos = int(pair["greedy"][0][0, 3])
    jcfg = JaxConfig(max_len=MAX_LEN, sampling_topk=1, eos_id=eos)
    ref_toks, ref_lps = (np.asarray(a) for a in
                         jmodel.generate(params, pair["jb"], jcfg))
    assert (ref_toks[:, 1:] == jcfg.pad_id).any()      # a row ended
    cfg = GenerationConfig(max_len=MAX_LEN, eos_id=eos)
    toks, lps, _ = _run_spec(pair, cfg, 5, _oracle(ref_toks, 4))
    np.testing.assert_array_equal(toks.numpy(), ref_toks)
    np.testing.assert_allclose(lps.numpy(), ref_lps, atol=1e-5, rtol=1e-5)


def test_generate_speculative_ngram_article_matches_jax(pair):
    """The entry point with prompt-lookup drafts from an article that
    holds the caption: JAX's greedy tokens, and JAX's own
    `generate_speculative`'s number of chunks, fewer than the steps."""
    ref_toks, ref_lps = pair["greedy"]
    noise = np.random.RandomState(9).randint(2, tp.V, (B, 4))
    source = np.concatenate([noise, ref_toks, noise], axis=1)
    jb = dict(pair["jb"], article_ids=jnp.asarray(source, jnp.int32))
    _, _, j_chunks = pair["jmodel"].generate_speculative(
        pair["params"], jb, JaxConfig(max_len=MAX_LEN, sampling_topk=1),
        spec_k=SPEC_K)
    tb = dict(pair["tb"], article_ids=torch.from_numpy(source))
    toks, lps, n_chunks = pair["model"].generate_speculative(
        tb, GenerationConfig(max_len=MAX_LEN), pair["weights"],
        spec_k=SPEC_K)
    np.testing.assert_array_equal(toks.numpy(), ref_toks)
    np.testing.assert_allclose(lps.numpy(), ref_lps, atol=1e-5, rtol=1e-5)
    assert n_chunks == int(j_chunks) < MAX_LEN


def test_generate_speculative_rejects_what_the_reference_rejects(pair):
    tb = dict(pair["tb"], article_ids=torch.ones(B, 4, dtype=torch.long))
    with pytest.raises(ValueError, match="greedy-only"):
        pair["model"].generate_speculative(
            tb, GenerationConfig(max_len=4, sampling_topk=3))
    with pytest.raises(ValueError, match="spec_k must be >= 2"):
        pair["model"].generate_speculative(
            tb, GenerationConfig(max_len=4), spec_k=1)


# -- the small tensor functions, on crafted inputs ------------------------

NGRAM_CASES = {
    # source, tokens, pos, k_draft, n
    "match": ([[5, 6, 7, 8, 9, 10]], [[0, 6, 7, 1, 1]], [2], 3, 2),
    "no_match": ([[5, 6, 7, 8, 9, 10]], [[0, 3, 4, 1, 1]], [2], 3, 2),
    "runs_off_the_end": ([[5, 6, 7, 8, 9, 10]], [[0, 8, 9, 1, 1]], [2], 3,
                         2),
    "short_prefix": ([[0, 6, 7, 0, 4, 11], [3, 3, 3, 3, 3, 3]],
                     [[0, 1, 1, 1, 1], [0, 1, 1, 1, 1]], [0, 0], 2, 3),
}


@pytest.mark.parametrize("case", list(NGRAM_CASES))
def test_ngram_drafts_matches_jax(case):
    source, tokens, pos, k_draft, n = NGRAM_CASES[case]
    want = jspec.ngram_drafts(jnp.asarray(source, jnp.int32),
                              jnp.asarray(tokens, jnp.int32),
                              jnp.asarray(pos, jnp.int32), k_draft, n=n)
    got = spec.ngram_drafts(torch.tensor(source), torch.tensor(tokens),
                            torch.tensor(pos, dtype=torch.int32), k_draft,
                            n=n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_greedy_verify_and_write_rows_match_jax():
    ids = np.array([[4, 5, 6, 7], [4, 9, 6, 7], [2, 5, 6, 7], [4, 5, 2, 7],
                    [4, 5, 6, 7], [4, 5, 6, 7]])
    drafts = np.array([[4, 5, 6], [4, 5, 6], [2, 5, 6], [4, 5, 2],
                       [4, 5, 6], [4, 5, 6]])
    finished = np.array([False, False, False, False, True, False])
    pos = np.array([0, 3, 1, 2, 5, 9])
    limit = np.array([12, 12, 12, 12, 12, 11])
    jm, je = jspec.greedy_verify(jnp.asarray(ids), jnp.asarray(drafts),
                                 jnp.asarray(finished), jnp.asarray(pos),
                                 jnp.asarray(limit), 2)
    tm, te = spec.greedy_verify(torch.tensor(ids), torch.tensor(drafts),
                                torch.tensor(finished),
                                torch.tensor(pos, dtype=torch.int32),
                                torch.tensor(limit, dtype=torch.int32), 2)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    jm1, _ = jspec.greedy_verify(jnp.asarray(ids[:, :1]), None,
                                 jnp.asarray(finished), jnp.asarray(pos),
                                 12, 2)
    tm1, _ = spec.greedy_verify(torch.tensor(ids[:, :1]), None,
                                torch.tensor(finished), torch.tensor(pos),
                                12, 2)
    np.testing.assert_array_equal(tm1.numpy(), np.asarray(jm1))
    buf = np.arange(6 * 8).reshape(6, 8)
    starts = np.array([0, 2, 5, 4, 1, 3])
    want = jspec.write_rows(jnp.asarray(buf), jnp.asarray(ids),
                            jnp.asarray(starts))
    got = spec.write_rows(torch.tensor(buf), torch.tensor(ids),
                          torch.tensor(starts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- per-row positions ------------------------------------------------------

def test_step_topk_pos_matches_jax_at_staggered_positions(pair):
    """Rows at depths 0, 3 and 7 stepped together for 5 steps (zero
    history before each row's start): JAX's `step_topk_pos` over shifted
    caches and the port's `step_topk` with a tensor of positions over
    ring-major ones give the same top-4."""
    jdec = pair["jmodel"].decoder
    dec = pair["model"].decoder
    toks = np.random.RandomState(3).randint(2, tp.V, (B, 5))
    start = np.array([0, 3, 7])
    jc = jdec.init_cache(B)
    rings = dec.init_cache(B, "cpu")
    for t in range(5):
        pos = start + t
        jv, ji, jc = pair["step_topk_pos"](jnp.asarray(toks[:, t]),
                                           jnp.asarray(pos, jnp.int32), jc)
        with torch.inference_mode():
            tv, ti = dec.step_topk(torch.from_numpy(toks[:, t]).long(),
                                   torch.from_numpy(pos).int(),
                                   pair["tkvs"], rings, 4, pair["weights"])
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5,
                                   rtol=1e-5)
    for ring, shifted in zip(rings, jc):
        np.testing.assert_allclose(_oldest_first(ring, start + 5),
                                   np.asarray(shifted), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("K", [3, 7])
def test_conv_block_plain_per_row_positions_matches_dynamic_conv_step(K):
    """decode_conv_block_plain with a position a row (0, K-2, K-1 and a
    wrap past the ring) against JAX's GLU and `DynamicConv.step` over
    each row's ring read back oldest first."""
    N, C, Hh = 4, 32, 4
    rng = np.random.RandomState(K)
    x, ring = rng.randn(N, C), rng.randn(K - 1, N, C)
    w1, b1 = rng.randn(C, 2 * C) * 0.1, rng.randn(2 * C) * 0.1
    wl = rng.randn(C, Hh * K) * 0.1
    w2, b2 = rng.randn(C, C) * 0.1, rng.randn(C) * 0.1
    pos = np.array([0, K - 2, K - 1, 3 * K + 1])
    f = lambda a: torch.from_numpy(a.astype(np.float32))   # noqa: E731
    y, h = decode_conv_block_plain(f(x), f(ring), torch.from_numpy(pos).int(),
                                   f(w1), f(b1), f(wl), f(w2), f(b2), Hh)
    pre = x @ w1 + b1
    hj = pre[:, :C] / (1 + np.exp(-pre[:, C:]))
    conv = JaxDynamicConv(input_size=C, kernel_size=K, num_heads=Hh)
    shifted = _oldest_first(f(ring), pos)
    out, _ = conv.apply({"params": {"weight_linear": {
        "kernel": jnp.asarray(wl, jnp.float32)}}},
        jnp.asarray(hj, jnp.float32), jnp.asarray(shifted),
        method=JaxDynamicConv.step)
    yj = np.asarray(out) @ w2 + b2 + x
    np.testing.assert_allclose(h.numpy(), hj, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(y.numpy(), yj, atol=1e-5, rtol=1e-5)
    # Every row at one position: the scalar path, bit for bit.
    same = decode_conv_block_plain(f(x), f(ring),
                                   torch.full((N,), 5, dtype=torch.int32),
                                   f(w1), f(b1), f(wl), f(w2), f(b2), Hh)
    scalar = decode_conv_block_plain(f(x), f(ring), 5, f(w1), f(b1), f(wl),
                                     f(w2), f(b2), Hh)
    assert all(torch.equal(a, b) for a, b in zip(same, scalar))


# -- the evaluate command -----------------------------------------------------

def test_evaluate_speculative_k_writes_the_reference_files(tmp_path,
                                                           monkeypatch):
    """`evaluate configs/tiny_test.yaml` with generation.speculative_k 4
    (the reference's own check of its speculative route): the port's
    generations.jsonl and metrics byte-equal to the reference command's,
    every batch through `generate_speculative` (the batches carry
    article_ids), with JAX's PRNGKey(0) init carried into the port."""
    files = {}
    for who in ("ref", "port"):
        overrides = json.dumps({
            "generation": {"speculative_k": 4},
            "trainer": {"serialization_dir": str(tmp_path / who)}})
        argv = ["evaluate", TINY, "--platform", "cpu", "-o", overrides]
        if who == "ref":
            assert jax_cli.main(argv) == 0
            jcfg = jax_config.load_config(TINY, overrides)
            sample = next(jax_config.build_dataset(jcfg, "test").batches(
                jcfg["iterator"]["batch_size"], shuffle=False))
            params = jax_config.build_model(jcfg).init(
                jax.random.PRNGKey(0), sample)
        else:
            model = build_model(load_config(TINY, overrides), "cpu")
            model.decoder.load_state_dict(params_from_jax(
                jax.tree.map(np.asarray, params), model.decoder))
            model.decoder.eval()
            monkeypatch.setattr(cli, "evaluation_model",
                                lambda cfg, device: model)
            calls = []
            real = type(model).generate_speculative
            monkeypatch.setattr(
                type(model), "generate_speculative",
                lambda self, *a, **kw: calls.append(kw) or real(self, *a,
                                                                **kw))
            assert cli.main(argv) == 0
            assert len(calls) == 2 and calls[0]["spec_k"] == 4
        files[who] = [(tmp_path / who / name).read_bytes() for name in
                      ("generations.jsonl", "evaluate-metrics.json")]
    assert files["port"] == files["ref"]


def test_bf16_speculative_chunks_give_greedy_tokens(pair):
    """In bf16 too: a chunk's conv block is the one-token step's, position
    by position, so on the CPU's plain twins speculative greedy gives the
    sequential steps' greedy tokens (chip_smoke.py phase 11 reads the
    agreement on the card)."""
    bf = TransformerFlattened(device="cpu", dtype=torch.bfloat16,
                              **tp.small(pair["kernels"]))
    bf.decoder.load_state_dict(pair["model"].decoder.state_dict())
    bf.decoder.eval()
    w = bf.decoder.decode_weights()
    cfg = GenerationConfig(max_len=MAX_LEN)
    want, _ = bf.generate(pair["tb"], cfg, w)
    source = torch.cat([want, want], dim=1)
    got, _, n_chunks = bf.generate_speculative(
        dict(pair["tb"], article_ids=source), cfg, w, spec_k=SPEC_K)
    assert torch.equal(got, want) and n_chunks < MAX_LEN
