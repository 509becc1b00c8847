"""The port's Gen-2 captioner (`models/gen2.py`), its slot pool
(`ContinuousBatcher.for_gen2`) and the Noam optimizer against the JAX
reference's, on the CPU.

A small model (V=64, d=16, 4 heads, FFN 32, two layers; image 12 and
article 10 wide, pad id 1, dropout 0) is initialised in JAX with
PRNGKey(0) and carried into the port by `params_from_jax`; batches are
drawn with numpy from a seed (padded article tokens and caption tails).
At fp32:

- `interleaved_sinusoidal_table` equal to the reference's, the norm's
  Bessel std with eps outside the sqrt;
- teacher-forced log-probs within 1e-5, the loss at smoothing 0 and 0.1
  within 1e-5 and every gradient within rtol 1e-5 / atol 1e-6; both
  label-smoothing losses against the reference's functions;
- `step_chunk` at positions a row against JAX's (log-probs, ids, the
  cache rows written); greedy tokens exact; top-k sampling fed JAX's
  draws exact; speculative tokens JAX's and greedy's, with oracle drafts
  in fewer chunks; `for_gen2` exactly JAX's pool, and a pooled request
  `generate` alone;
- each step runs one band top-k over the folded head and two
  `decode_cross_attention` calls a layer, and never the full head;
- `NoamAdam` against optax's `noam_adam` over 5 updates within 1e-5,
  the first two rates equal; a JAX Noam train state carried by
  `state_from_jax` resumes on JAX's trajectory.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from flax import serialization  # noqa: E402

from news_image_caption_tpu.generation.continuous import \
    ContinuousBatcher as JaxBatcher  # noqa: E402
from news_image_caption_tpu.generation.generator import \
    GenerationConfig as JaxConfig  # noqa: E402
from news_image_caption_tpu.models import gen2 as jax_gen2  # noqa: E402
from news_image_caption_tpu.ops import positional as jax_positional  # noqa
from news_image_caption_tpu.training import optim as jax_optim  # noqa: E402
from news_image_caption_tpu.training import \
    train_step as jax_train_step  # noqa: E402
from news_image_caption_tpu_torch.generation import \
    generator as gen  # noqa: E402
from news_image_caption_tpu_torch.generation.continuous import \
    ContinuousBatcher  # noqa: E402
from news_image_caption_tpu_torch.generation.generator import \
    GenerationConfig  # noqa: E402
from news_image_caption_tpu_torch.models import gen2  # noqa: E402
from news_image_caption_tpu_torch.models.from_jax import (  # noqa: E402
    params_from_jax, state_from_jax)
from news_image_caption_tpu_torch.ops import attention  # noqa: E402
from news_image_caption_tpu_torch.ops import band_topk  # noqa: E402
from news_image_caption_tpu_torch.ops import positional  # noqa: E402
from news_image_caption_tpu_torch.ops.decode_attention import (  # noqa
    admits, attention_plan)
from news_image_caption_tpu_torch.training.optim import NoamAdam  # noqa
from news_image_caption_tpu_torch.training.train_step import (  # noqa
    create_train_state, make_train_step)

V = 64
KW = dict(vocab_size=V, d_model=16, d_ff=32, num_heads=4, num_layers=2,
          img_dim=12, sent_dim=10, max_len=32, pad_id=1, dropout_rate=0.0)
MAX_LEN = 8
P, S = 4, 6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(B=3, T=9, seed=0):
    rng = np.random.RandomState(seed)
    cap = rng.randint(3, V, size=(B, T))
    cap[:, 0] = 0
    cap[1, 6:] = 1                              # a padded tail
    article_mask = np.zeros((B, S), bool)
    article_mask[1, -2:] = True
    return {"caption_ids": cap.astype(np.int32),
            "image": rng.randn(B, P, 12).astype(np.float32),
            "article": rng.randn(B, S, 10).astype(np.float32),
            "article_mask": article_mask,
            "article_ids": rng.randint(3, V, size=(B, S)).astype(np.int32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _build(smoothing=0.0):
    jmodel = jax_gen2.gen2_transformer(smoothing=smoothing, **KW)
    model = gen2.gen2_transformer(smoothing=smoothing, device="cpu", **KW)
    return jmodel, model


@pytest.fixture(scope="module")
def pair():
    jmodel, model = _build()
    batch = _arrays()
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), _jax(batch))
    model.param_module.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, variables), model.param_module))
    return dict(jmodel=jmodel, variables=variables, model=model, batch=batch,
                test=_arrays(B=4, seed=1))


@pytest.mark.parametrize("n,d", [(520, 16), (40, 512), (7, 6)])
def test_interleaved_table_is_the_references(n, d):
    np.testing.assert_array_equal(
        positional.interleaved_sinusoidal_table(n, d),
        jax_positional.interleaved_sinusoidal_table(n, d))


def test_layer_norm_is_the_references():
    x = np.random.RandomState(0).randn(3, 8).astype(np.float32)
    jln = jax_gen2.Gen2LayerNorm()
    ln = gen2.Gen2LayerNorm(8, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        ln.a_2.copy_(torch.linspace(0.5, 1.5, 8))
        ln.b_2.copy_(torch.linspace(-0.1, 0.1, 8))
    variables = {"params": {"a_2": jnp.asarray(ln.a_2.detach().numpy()),
                            "b_2": jnp.asarray(ln.b_2.detach().numpy())}}
    np.testing.assert_allclose(
        ln(torch.from_numpy(x)).detach().numpy(),
        np.asarray(jln.apply(variables, jnp.asarray(x))), rtol=1e-6,
        atol=1e-6)


def test_teacher_forced_log_probs_match(pair):
    jm, batch = pair["jmodel"], pair["batch"]
    jb = _jax(batch)
    want = jax.jit(lambda v: jm.module.apply(
        v, jm._memory(jb), jb["caption_ids"][:, :-1],
        src_masks=jm._src_masks(jb),
        method=jax_gen2.Gen2Transformer.log_probs))(pair["variables"])
    m, tb = pair["model"], _torch(batch)
    with torch.no_grad():
        got = m.module.log_probs(m._memory(tb), tb["caption_ids"][:, :-1],
                                 src_masks=m._src_masks(tb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_loss_and_gradients_match(pair, smoothing):
    jmodel, model = _build(smoothing)
    model.param_module.load_state_dict(pair["model"].param_module.state_dict())
    batch = pair["batch"]
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda v: jmodel.loss_fn(v, _jax(batch)), has_aux=True))(
            pair["variables"])
    loss, aux = model.loss_fn(_torch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(aux["loss_sum"].item(),
                               float(jaux["loss_sum"]), rtol=1e-5)
    assert aux["sample_size"].item() == int(jaux["sample_size"])
    want = params_from_jax(jax.tree.map(np.asarray, jgrads),
                           model.param_module)
    for k, p in model.param_module.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_label_smoothing_losses_match(smoothing):
    rng = np.random.RandomState(3)
    logits = rng.randn(5, 7, 11).astype(np.float32)
    targets = rng.randint(0, 11, size=(5, 7))
    targets[0, :3] = 1
    lp = np.array(jax.nn.log_softmax(jnp.asarray(logits), -1))
    for fn, jfn, x in (
            (gen2.label_smoothing_loss, jax_gen2.label_smoothing_loss, lp),
            (gen2.label_smoothing_loss_from_logits,
             jax_gen2.label_smoothing_loss_from_logits, logits)):
        loss, n = fn(torch.from_numpy(x), torch.from_numpy(targets), 1,
                     smoothing)
        jloss, jn = jfn(jnp.asarray(x), jnp.asarray(targets), 1, smoothing)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
        assert n.item() == int(jn) == int((targets != 1).sum())


def test_step_chunk_matches_jax(pair):
    """Two rows a position apart and one further on: a chunk of 3 after
    a first chunk, log-probs, ids and every cache row JAX's."""
    jm, m = pair["jmodel"], pair["model"]
    batch = pair["test"]
    jb, tb = _jax(batch), _torch(batch)
    L = MAX_LEN + 3
    variables = pair["variables"]
    jkvs = jax.jit(lambda v: jm.module.apply(
        v, jm._memory(jb), method=jax_gen2.Gen2Transformer.precompute_kv))(
            variables)
    jcaches = jm.module.init_cache(4, L)
    kvs = m.prep(tb)
    caches = m.module.init_cache(4, L)
    weights = m.decode_weights()
    chunk = jax.jit(lambda v, t, p, c: jm.module.apply(
        v, t, p, jkvs, c, jm._src_masks(jb),
        method=jax_gen2.Gen2Transformer.step_chunk))
    rng = np.random.RandomState(4)
    for pos in ([0, 0, 0, 0], [3, 2, 3, 4]):
        toks = rng.randint(3, V, size=(4, 3)).astype(np.int32)
        pos = np.array(pos, np.int32)
        jlp, jids, jcaches = chunk(variables, jnp.asarray(toks),
                                   jnp.asarray(pos), jcaches)
        with torch.no_grad():
            lp, ids = m.module.step_chunk(torch.from_numpy(toks),
                                          torch.from_numpy(pos), kvs, caches,
                                          weights)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-5,
                                   atol=1e-5)
    for (k_c, v_c), (jk, jv) in zip(caches, jcaches):
        np.testing.assert_allclose(k_c.numpy(), np.asarray(jk), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(v_c.numpy(), np.asarray(jv), rtol=1e-5,
                                   atol=1e-6)


def _jax_generate(pair, batch, cfg, rng=None):
    jm = pair["jmodel"]
    tokens, lps = jax.jit(lambda v, b: jm.generate(v, b, cfg, rng=rng))(
        pair["variables"], _jax(batch))
    return np.asarray(tokens), np.asarray(lps)


@pytest.fixture(scope="module")
def greedy(pair):
    return _jax_generate(pair, pair["test"], JaxConfig(max_len=MAX_LEN))


def test_greedy_tokens_exact(pair, greedy):
    want_t, want_lp = greedy
    got_t, got_lp = pair["model"].generate(_torch(pair["test"]),
                                           GenerationConfig(max_len=MAX_LEN))
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    np.testing.assert_allclose(got_lp.numpy(), want_lp, rtol=1e-5,
                               atol=1e-5)


class JaxKeys:
    """A stand-in generator: JAX's key schedule, one split a draw."""

    def __init__(self, key):
        self.key = key

    def draw(self, shape):
        self.key, sub = jax.random.split(self.key)
        return torch.from_numpy(np.array(jax.random.gumbel(sub, shape)))


def test_sampling_matches_jax_with_its_draws(pair, greedy, monkeypatch):
    monkeypatch.setattr(gen, "gumbel_noise",
                        lambda generator, shape: generator.draw(shape))
    key = jax.random.PRNGKey(9)
    cfg = dict(max_len=MAX_LEN, sampling_topk=4, sampling_temp=0.8)
    want_t, want_lp = _jax_generate(pair, pair["test"], JaxConfig(**cfg),
                                    rng=key)
    got_t, got_lp = pair["model"].generate(
        _torch(pair["test"]), GenerationConfig(**cfg),
        generator=JaxKeys(key))
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    np.testing.assert_allclose(got_lp.numpy(), want_lp, rtol=1e-5,
                               atol=1e-5)
    assert not np.array_equal(want_t, greedy[0])     # it did sample


@pytest.mark.parametrize("spec_k", [2, 4])
def test_speculative_exact(pair, greedy, spec_k):
    jm = pair["jmodel"]
    want_t, _, want_n = jax.jit(lambda v, b: jm.generate_speculative(
        v, b, JaxConfig(max_len=MAX_LEN), spec_k=spec_k))(
            pair["variables"], _jax(pair["test"]))
    got_t, got_lp, n = pair["model"].generate_speculative(
        _torch(pair["test"]), GenerationConfig(max_len=MAX_LEN),
        spec_k=spec_k)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_t.numpy(), greedy[0])
    np.testing.assert_allclose(got_lp.numpy(), greedy[1], rtol=1e-5,
                               atol=1e-5)
    assert n == int(want_n)


def test_speculative_with_oracle_drafts_takes_fewer_chunks(pair, greedy):
    tokens = torch.from_numpy(greedy[0]).long()
    got_t, _, n = pair["model"].generate_speculative(
        _torch(pair["test"]), GenerationConfig(max_len=MAX_LEN), spec_k=4,
        draft_source=tokens)
    assert torch.equal(got_t, tokens)
    assert n < MAX_LEN
    with pytest.raises(ValueError, match="greedy-only"):
        pair["model"].generate_speculative(
            _torch(pair["test"]), GenerationConfig(sampling_topk=2))


def test_decode_runs_the_two_kernels_a_step(pair, monkeypatch):
    """A greedy step: one band top-k over the folded head [V, d + 64]
    and two cross-attention calls a layer; a chunk of 3 the same
    counts at Q = 3; the generator's full product never runs."""
    calls = {"band": [], "attn": []}
    real_band, real_attn = gen2.band_topk_lse, attention.decode_cross_attention

    def band(x, table, k, *a):
        calls["band"].append((tuple(x.shape), tuple(table.shape), k))
        return real_band(x, table, k, *a)

    def attn(q, k, v, bias, H):
        calls["attn"].append(tuple(q.shape))
        return real_attn(q, k, v, bias, H)

    def no_full_head(*args, **kw):
        raise AssertionError("a decode step ran the full generator")

    monkeypatch.setattr(gen2, "band_topk_lse", band)
    monkeypatch.setattr(attention, "decode_cross_attention", attn)
    m = pair["model"]
    monkeypatch.setattr(m.module.generator, "forward", no_full_head)
    tb = _torch(pair["test"])
    m.generate(tb, GenerationConfig(max_len=MAX_LEN))
    assert calls["band"] == [((4, 16 + 64), (V, 16 + 64), 1)] * MAX_LEN
    assert calls["attn"] == [(4, 1, 16)] * (2 * 2 * MAX_LEN)
    calls["band"].clear()
    calls["attn"].clear()
    with torch.no_grad():
        m.module.step_chunk(torch.zeros(4, 3, dtype=torch.long),
                            torch.zeros(4, dtype=torch.long), m.prep(tb),
                            m.module.init_cache(4, MAX_LEN + 3),
                            m.decode_weights())
    assert calls["band"] == [((12, 80), (V, 80), 1)]
    assert calls["attn"] == [(4, 3, 16)] * 4


@pytest.mark.parametrize("d,heads,article", [(512, 8, 500), (1024, 8, 512)])
def test_the_kernels_admit_the_configs_shapes(d, heads, article):
    """gen2_word's and gen2_roberta's decode shapes: the attention at
    head sizes 64 / 128 over 196 image and 500 / 512 article keys, Q = 1
    and 16, batch 1 to 16 on 132 multiprocessors; the head's folded
    width a multiple of 64."""
    hd = d // heads
    for Q in (1, 4, 16):
        assert admits(torch.bfloat16, Q, hd) == (True, "")
        for B in (1, 16):
            for keys in (196, article):
                plan = attention_plan(B, Q, keys, heads, hd, 132)
                assert plan.splits * plan.per >= keys
    assert band_topk.admits(torch.bfloat16, 64, d + gen2.HEAD_PAD, 30000, 1,
                            30000)[0]


def _requests(n, seed):
    batch = _arrays(B=n, seed=seed)
    return [{k: batch[k][i:i + 1] for k in ("image", "article",
                                            "article_mask", "article_ids")}
            for i in range(n)]


@pytest.mark.parametrize("spec_k", [1, 3])
def test_for_gen2_matches_jax(pair, spec_k):
    """Five requests through three slots, two steps a dispatch, caps of
    4 to 8 tokens: each result JAX's pool's."""
    reqs = _requests(5, 11)
    caps = [8, 5, 8, 4, 7]
    jcfg, cfg = JaxConfig(max_len=MAX_LEN), GenerationConfig(max_len=MAX_LEN)
    jeng = JaxBatcher.for_gen2(pair["jmodel"], pair["variables"], jcfg, 3,
                               inner_steps=2, spec_k=spec_k, source_len=S)
    eng = ContinuousBatcher.for_gen2(pair["model"], cfg, 3, inner_steps=2,
                                     spec_k=spec_k, source_len=S)
    jids = [jeng.submit(_jax(r), source_row=r["article_ids"][0], max_len=c)
            for r, c in zip(reqs, caps)]
    ids = [eng.submit(_torch(r), source_row=r["article_ids"][0], max_len=c)
           for r, c in zip(reqs, caps)]
    want, got = jeng.run(), eng.run()
    for jid, rid in zip(jids, ids):
        np.testing.assert_array_equal(got[rid][0], np.asarray(want[jid][0]))
        np.testing.assert_allclose(got[rid][1], np.asarray(want[jid][1]),
                                   rtol=1e-5, atol=1e-5)
    assert eng.stats()["spec_k"] == spec_k


def test_pool_request_equals_generate_alone(pair):
    reqs = _requests(3, 12)
    cfg = GenerationConfig(max_len=MAX_LEN)
    eng = ContinuousBatcher.for_gen2(pair["model"], cfg, 2, inner_steps=3)
    ids = [eng.submit(_torch(r)) for r in reqs]
    got = eng.run()
    for rid, r in zip(ids, reqs):
        tokens, _ = pair["model"].generate(_torch(r), cfg)
        np.testing.assert_array_equal(got[rid][0], tokens[0].numpy())


def test_noam_matches_optax_over_five_updates():
    rng = np.random.RandomState(0)
    shapes = [(5, 3), (7,), (2, 2, 4)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) for s in shapes]
             for _ in range(5)]
    tx = jax_optim.noam_adam(model_size=16, factor=2.0, warmup=3)
    jparams = {str(i): jnp.asarray(p) for i, p in enumerate(params)}
    jstate = tx.init(jparams)
    update = jax.jit(tx.update)
    opt = NoamAdam(model_size=16, factor=2.0, warmup=3)
    master = [torch.from_numpy(p.copy()) for p in params]
    state = opt.init(master)
    for g in grads:
        u, jstate = update({str(i): jnp.asarray(x) for i, x in enumerate(g)},
                           jstate, jparams)
        jparams = optax.apply_updates(jparams, u)
        opt.apply([torch.from_numpy(x.copy()) for x in g], state, master)
        for i, p in enumerate(master):
            np.testing.assert_allclose(p.numpy(), np.asarray(jparams[str(i)]),
                                       rtol=1e-5, atol=1e-6)
    assert state.count == 5
    # optax reads the schedule at the count before its increment, and
    # s = max(count, 1): the first two updates take the same rate.
    assert opt.lr_schedule(0) == opt.lr_schedule(1) > 0.0
    assert opt.lr_schedule(2) > opt.lr_schedule(1)
    jsched = jax.jit(jax_optim.noam_schedule(16, 2.0, 3))
    for n in (0, 1, 2, 3, 4, 100):
        np.testing.assert_allclose(opt.lr_schedule(n),
                                   float(jsched(jnp.int32(n))), rtol=1e-6)


def test_state_from_jax_resumes_a_gen2_noam_run(pair):
    """Two JAX updates, the state carried into the port, three more in
    each package: losses within 1e-5 and the params within rtol 1e-5 /
    atol 1e-6 (the attentions' key biases aside: the softmax cancels
    them, so their gradients are rounding noise that Adam scales up)."""
    jm, m = pair["jmodel"], pair["model"]
    batches = [_arrays(seed=s) for s in range(5)]
    tx = jax_optim.noam_adam(model_size=16, warmup=4)
    jstate = jax_train_step.create_train_state(pair["variables"], tx)
    jstep = jax_train_step.make_train_step(jm.loss_fn, tx, donate=False)
    jlosses = []
    for i, b in enumerate(batches):
        if i == 2:
            tree = jax.tree.map(np.asarray,
                                serialization.to_state_dict(jstate))
        jstate, metrics = jstep(jstate, _jax(b), jax.random.PRNGKey(0))
        jlosses.append(float(metrics["loss"]))
    _, model = _build()
    state = state_from_jax(tree, create_train_state(
        model.param_module, NoamAdam(model_size=16, warmup=4)))
    assert state.step == 2 and state.opt_state.count == 2
    step = make_train_step(model.loss_fn, NoamAdam(model_size=16, warmup=4),
                           compute_dtype=torch.float32)
    for b, want in zip(batches[2:], jlosses[2:]):
        state, metrics = step(state, _torch(b))
        np.testing.assert_allclose(metrics["loss"].item(), want, rtol=1e-5)
    assert state.step == 5 and state.opt_state.count == 5
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params),
                           m.param_module)
    for k, p in state.params.items():
        if not k.endswith("k_lin.bias"):
            np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


def test_remat_and_unknown_keys_raise():
    """remat builds (ROADMAP Queue 1 item 8b; its numbers are held in
    tests/test_torch_decoder_options.py); an unknown key raises."""
    assert gen2.gen2_transformer(device="meta", remat=True,
                                 **KW).module.remat
    from news_image_caption_tpu_torch import config
    cfg = config.load_config("configs/goodnews/gen2_word.yaml")
    cfg["model"]["d_key"] = 64
    with pytest.raises(TypeError, match="d_key"):
        config.build_model(cfg, "meta")
