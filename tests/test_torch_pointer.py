"""The port's pointer family (`models/pointer.py`) against the JAX
reference's `models/pointer.py`, on the CPU.

The model is `configs/tiny_pointer.yaml`'s (V=64, cutoff (16, 32, 64),
D=16, H=4, FFN=32, kernels (3, 5); image 16 and article 12 wide) with
every dropout 0, built by each package's `build_model`, JAX's PRNGKey(0)
init carried into the port by `params_from_jax`. The batches are the
synthetic set's: each caption's body is an entity span copied from its
article (caption_copy_masks 1, context_proper_masks 1), so the gate,
the copy head and the copy loss all see entities. At fp32:

- the entity self-attention's full pass, its sequential `step`s and a
  `chunk` at positions a row agree with JAX's (1e-5), and with each
  other; the copy scores with and without article padding (1e-5);
  `copy_target_prob` and `copy_distribution` over repeated ids (1e-6),
  the distribution bit-equal on a second call;
- `loss_fn`'s three components and every gradient of the decoder and
  the three heads within rtol 1e-5 / atol 1e-6 for loss weights
  (0, 1, 1) and (1, 1, 1), a batch without entities, high entity
  indices and `use_entity_head=False`, each with the flash route off and
  on (JAX's Pallas kernel in interpret mode);
- greedy `generate`'s tokens and copied flags exactly JAX's, also with
  the gate forced open (every flagged token a relevant article id, none
  copied twice); `generate_speculative` exactly JAX's and `generate`'s;
  top-k sampling fed JAX's draws (`generation/generator.py::
  gumbel_noise`, JAX's split(key, 3) a step: copy draw, then generated
  draw) exactly JAX's;
- `ContinuousBatcher.for_pointer` exactly JAX's `for_pointer` (tokens,
  log-probs within 1e-5, flags), greedy and speculative.
"""

import functools
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402

from news_image_caption_tpu import config as jax_config  # noqa: E402
from news_image_caption_tpu.generation.continuous import \
    ContinuousBatcher as JaxBatcher  # noqa: E402
from news_image_caption_tpu.generation.generator import \
    GenerationConfig as JaxConfig  # noqa: E402
from news_image_caption_tpu.models import pointer as jax_pointer  # noqa: E402
from news_image_caption_tpu.training import optim as jax_optim  # noqa: E402
from news_image_caption_tpu.training import \
    train_step as jax_train_step  # noqa: E402
from news_image_caption_tpu_torch import config  # noqa: E402
from news_image_caption_tpu_torch.generation import \
    generator as gen  # noqa: E402
from news_image_caption_tpu_torch.generation.continuous import \
    ContinuousBatcher  # noqa: E402
from news_image_caption_tpu_torch.generation.generator import \
    GenerationConfig  # noqa: E402
from news_image_caption_tpu_torch.models import pointer  # noqa: E402
from news_image_caption_tpu_torch.models.from_jax import (  # noqa: E402
    params_from_jax, state_from_jax)
from news_image_caption_tpu_torch.training.optim import \
    make_bert_adam  # noqa: E402
from news_image_caption_tpu_torch.training.train_step import \
    create_o2_train_state  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
TINY = str(REPO / "configs" / "tiny_pointer.yaml")
NO_DROPOUT = dict(dropout=0.0, weight_dropout=0.0, input_dropout=0.0,
                  attention_dropout=0.0)
MAX_LEN = 8
REQUEST_KEYS = ("image", "image_mask", "article", "article_mask",
                "article_ids", "context_proper_masks")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(model_overrides=None, flash=False, dtype=None):
    """(JAX model, port model in `dtype`) of the tiny config with
    `model_overrides`; the JAX copy head's dropout off as the port's (the
    reference fixes it at 0.1)."""
    over = json.dumps({"model": dict(NO_DROPOUT, **(model_overrides or {}),
                                     **({"use_flash_train": True}
                                        if flash else {}))})
    jcfg = jax_config.load_config(TINY, over)
    if flash:
        jcfg["model"]["flash_interpret"] = True
    jmodel = jax_config.build_model(jcfg)
    jmodel.copy_attn = jax_pointer.CopyAttentionScores(
        jmodel.embed_dim, jmodel.copy_attn.num_heads,
        kdim=jmodel.article_dim, dropout_rate=0.0)
    model = config.build_model(config.load_config(TINY, over), "cpu", dtype)
    model.copy_attn.dropout = 0.0
    return jmodel, model


def _batch(split="train", n=4):
    cfg = jax_config.load_config(TINY)
    return next(jax_config.build_dataset(cfg, split).batches(
        n, shuffle=False))


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _jitted(module, method=None):
    """module.apply(variables, *args, method=method), jitted: one XLA
    compile in place of every primitive's own."""
    return jax.jit(functools.partial(module.apply, method=method))


@pytest.fixture(scope="module")
def pair():
    jmodel, model = _models()
    batch = _batch()
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), _jax(batch))
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, variables),
                                          model))
    return dict(jmodel=jmodel, model=model, variables=variables,
                batch=batch, test=_batch("test"))


def _carried(pair, model):
    model.load_state_dict(pair["model"].state_dict())
    return model


# -- the heads ------------------------------------------------------------

def test_entity_attention_full_step_and_chunk(pair):
    ea = pair["model"].entity_attn
    jea = pair["jmodel"].entity_attn
    params = pair["variables"]["entity_attn"]
    x = np.random.RandomState(3).randn(3, 7, 16).astype(np.float32)
    want = np.asarray(_jitted(jea)(params, jnp.asarray(x)))
    full = ea(torch.from_numpy(x))
    np.testing.assert_allclose(full.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    # Sequential steps: position 0 attends only the zero slot.
    cache = ea.init_cache(3, 9, "cpu", torch.float32)
    jcache = jea.init_cache(3, 9)
    jstep = _jitted(jea, jax_pointer.EntitySelfAttention.step)
    with torch.no_grad():
        for t in range(7):
            got = ea.step(torch.from_numpy(x[:, t]), t, cache)
            out, jcache = jstep(params, jnp.asarray(x[:, t]), jnp.int32(t),
                                jcache)
            np.testing.assert_allclose(got.numpy(), np.asarray(out),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got.numpy(), want[:, t], rtol=1e-5,
                                       atol=1e-5)
    # A chunk of 3 at positions 0, 2 and 4, over the steps' cache.
    pos = np.array([0, 2, 4], np.int32)
    xc = np.stack([x[b, p:p + 3] for b, p in enumerate(pos)])
    with torch.no_grad():
        got = ea.chunk(torch.from_numpy(xc), torch.from_numpy(pos), cache)
    out, jc = _jitted(jea, jax_pointer.EntitySelfAttention.chunk)(
        params, jnp.asarray(xc), jnp.asarray(pos), jcache)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), rtol=1e-5,
                               atol=1e-5)
    for b, p in enumerate(pos):
        np.testing.assert_allclose(got[b].numpy(), want[b, p:p + 3],
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cache[0].numpy(), np.asarray(jc[0]),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("padded", [False, True])
def test_copy_attention_scores(pair, padded):
    rng = np.random.RandomState(4)
    q = rng.randn(3, 5, 16).astype(np.float32)
    k = rng.randn(3, 6, 12).astype(np.float32)
    mask = np.zeros((3, 6), bool)
    if padded:
        mask[1, 3:] = True
        mask[2, :] = True          # every article row padded
    jca = pair["jmodel"].copy_attn
    want = np.asarray(jca.apply(pair["variables"]["copy_attn"],
                                jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(mask) if padded else None))
    with torch.no_grad():
        got = pair["model"].copy_attn(torch.from_numpy(q),
                                      torch.from_numpy(k),
                                      torch.from_numpy(mask) if padded
                                      else None)
    assert got.dtype == torch.float32 and got.shape == (3, 5, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    if padded:
        assert float(got[1, :, 3:].abs().max()) == 0.0
        assert float(got[2].abs().max()) == 0.0   # mass on bias_k, zero


def test_copy_target_prob_and_distribution_repeated_ids():
    rng = np.random.RandomState(5)
    attn = rng.rand(2, 3, 8).astype(np.float32)
    ids = np.array([[5, 9, 5, 5, 2, 9, 7, 1], [3, 3, 3, 3, 4, 4, 0, 63]],
                   np.int32)
    tgt = np.array([[5, 9, 11], [3, 0, 4]], np.int32)
    want = np.asarray(jax_pointer.copy_target_prob(
        jnp.asarray(attn), jnp.asarray(ids), jnp.asarray(tgt)))
    got = pointer.copy_target_prob(torch.from_numpy(attn),
                                   torch.from_numpy(ids),
                                   torch.from_numpy(tgt))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    flat = attn[:, 0]
    want = np.asarray(jax_pointer.copy_distribution(
        jnp.asarray(flat), jnp.asarray(ids), 64))
    got = pointer.copy_distribution(torch.from_numpy(flat),
                                    torch.from_numpy(ids), 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    again = pointer.copy_distribution(torch.from_numpy(flat),
                                      torch.from_numpy(ids), 64)
    assert torch.equal(got, again)
    assert got[0, 5].item() == pytest.approx(flat[0, [0, 2, 3]].sum(), 1e-6)


def test_decoder_hidden_states_match(pair):
    """What the heads read: the teacher-forced `hidden`, the hidden of
    `step_with_hidden` (with its full-vocab log-probs) over three steps
    and of a `step_chunk_with_hidden` chunk, against JAX's (1e-5)."""
    from news_image_caption_tpu.models.decoder_flattened import \
        DynamicConvDecoder as JaxDecoder
    from news_image_caption_tpu.ops.attention import decode_kv_tree
    jm, model = pair["jmodel"], pair["model"]
    jdec, dec = jm.captioner.decoder, model.decoder
    params = pair["variables"]["captioner"]
    batch = pair["test"]
    jctx = jm.captioner._contexts(_jax(batch))
    ctx = model._contexts(_torch(batch))
    tokens = np.asarray(batch["caption_ids"][:, :6])
    want = _jitted(jdec, JaxDecoder.hidden)(params, jnp.asarray(tokens), jctx)
    with torch.no_grad():
        got = dec.hidden(torch.from_numpy(tokens).long(), ctx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    jkvs = decode_kv_tree(_jitted(jdec, JaxDecoder.precompute_kv)(params,
                                                                  jctx))
    jcaches = jdec.init_cache(tokens.shape[0])
    weights = dec.decode_weights()
    jstep = _jitted(jdec, JaxDecoder.step_with_hidden)
    with torch.no_grad():
        kvs = dec.precompute_kv(ctx)
        caches = dec.init_cache(tokens.shape[0], "cpu")
        for i in range(3):
            lp, h = dec.step_with_hidden(torch.from_numpy(tokens[:, i]).long(),
                                         i, kvs, caches, weights)
            jlp, jh, jcaches = jstep(params, jnp.asarray(tokens[:, i]),
                                     jnp.int32(i), jkvs, jcaches)
            np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(lp.numpy(), np.asarray(jlp),
                                       rtol=1e-5, atol=1e-5)
        chunk = torch.from_numpy(tokens[:, :4]).long()
        pos = torch.zeros(tokens.shape[0], dtype=torch.int32)
        v, ids, x, _ = dec.step_chunk_with_hidden(
            chunk, pos, kvs, dec.init_cache(tokens.shape[0], "cpu"), weights)
    jv, jids, jx, _ = _jitted(jdec, JaxDecoder.step_chunk_with_hidden)(
        params, jnp.asarray(tokens[:, :4]),
        jnp.zeros(tokens.shape[0], jnp.int32), jkvs,
        jdec.init_cache(tokens.shape[0]))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)


# -- loss and gradients -----------------------------------------------------

LOSS_CASES = {
    "heads_only": ({}, None),                   # loss_weights (0, 1, 1)
    "joint": ({"loss_weights": [1.0, 1.0, 1.0]}, None),
    "no_entities": ({"loss_weights": [1.0, 1.0, 1.0]}, "none"),
    "high_indices": ({"loss_weights": [1.0, 1.0, 1.0]}, "high"),
    "no_entity_head": ({"use_entity_head": False}, None),
}


def _loss_batch(batch, kind):
    batch = {k: np.array(v) for k, v in batch.items()}
    masks = batch["caption_copy_masks"]
    if kind == "none":
        masks[masks >= 1] = 0
    elif kind == "high":
        # Entity indices up to the caption length: the segment count.
        masks[0][masks[0] >= 1] = masks.shape[1]
        masks[1][masks[1] >= 1] = 7
        masks[2, 1:3] = 11
    return batch


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_parts_and_gradients_match(pair, case, flash):
    overrides, kind = LOSS_CASES[case]
    jmodel, model = _models(overrides, flash)
    _carried(pair, model)
    batch = _loss_batch(pair["batch"], kind)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda v, b: jmodel.loss_fn(v, b), has_aux=True))(
            pair["variables"], _jax(batch))
    loss, aux = model.loss_fn(_torch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k in ("gen_loss", "entity_loss", "copy_loss"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert aux["sample_size"].item() == int(jaux["sample_size"])
    if kind == "none" or case == "no_entity_head":
        assert aux["entity_loss"].item() == aux["copy_loss"].item() == 0.0
    else:
        assert aux["copy_loss"].item() > 0.0
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), model)
    assert any(k.startswith("copy_attn.") for k in want)
    for k, p in model.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_load_pretrained_captioner_merges_the_decoder(pair):
    state = pair["model"].state_dict()
    decoder = {k: torch.full_like(v, 0.5)
               for k, v in pair["model"].decoder.state_dict().items()}
    merged = pointer.TransformerPointer.load_pretrained_captioner(state,
                                                                  decoder)
    assert set(merged) == set(state)
    assert torch.equal(merged["copy_attn.bias_k"], state["copy_attn.bias_k"])
    assert bool((merged["decoder.layers.0.fc1.kernel"] == 0.5).all())


def test_state_from_jax_carries_a_pointer_state(pair):
    jstate = jax_train_step.create_o2_train_state(
        pair["variables"], jax_optim.make_bert_adam(1e-3, 100))
    tree = jax.tree.map(np.asarray, serialization.to_state_dict(jstate))
    _, model = _models(dtype=torch.bfloat16)
    state = state_from_jax(tree, create_o2_train_state(
        model, make_bert_adam(1e-3, 100)))
    for k, v in state.opt_state["master"].items():
        np.testing.assert_array_equal(
            v.numpy(), pair["model"].state_dict()[k].numpy(), err_msg=k)
    del tree["params"]["entity_fc"]
    with pytest.raises(ValueError, match="entity_fc"):
        state_from_jax(tree, create_o2_train_state(
            model, make_bert_adam(1e-3, 100)))


# -- decoding ---------------------------------------------------------------

def _jax_generate(pair, batch, cfg, rng=None):
    jm = pair["jmodel"]
    tokens, flags = jax.jit(lambda v, b: jm.generate(v, b, cfg, rng=rng))(
        pair["variables"], _jax(batch))
    return np.asarray(tokens), np.asarray(flags)


def _gate_open(pair):
    """Variables and a port model whose gate always says copy."""
    variables = jax.tree.map(lambda a: a, pair["variables"])
    bias = np.array(variables["entity_fc"]["params"]["bias"])
    bias[1] = 1e4
    variables["entity_fc"]["params"]["bias"] = jnp.asarray(bias)
    _, model = _models()
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, variables),
                                          model))
    return variables, model


@pytest.mark.parametrize("gate", ["learned", "open"])
def test_greedy_tokens_and_flags_exact(pair, gate):
    batch = pair["test"]
    if gate == "open":
        variables, model = _gate_open(pair)
        pair = dict(pair, variables=variables, model=model)
    want_t, want_f = _jax_generate(pair, batch, JaxConfig(max_len=MAX_LEN))
    got_t, got_f = pair["model"].generate(_torch(batch),
                                          GenerationConfig(max_len=MAX_LEN))
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    np.testing.assert_array_equal(got_f.numpy(), want_f)
    assert got_f.any() and not got_f.all()
    if gate == "open":
        for b in range(got_t.shape[0]):
            relevant = set(batch["article_ids"][b][
                batch["context_proper_masks"][b] >= 1].tolist())
            copied = got_t[b, 1:][got_f[b]].tolist()
            assert set(copied) <= relevant
            assert len(copied) == len(set(copied))


@pytest.mark.parametrize("spec_k", [2, 4])
def test_speculative_exact(pair, spec_k):
    batch = pair["test"]
    jm = pair["jmodel"]
    want_t, want_f, _ = jax.jit(lambda v, b: jm.generate_speculative(
        v, b, JaxConfig(max_len=MAX_LEN), spec_k=spec_k))(
            pair["variables"], _jax(batch))
    got_t, got_f, n = pair["model"].generate_speculative(
        _torch(batch), GenerationConfig(max_len=MAX_LEN), spec_k=spec_k)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    greedy_t, greedy_f = pair["model"].generate(
        _torch(batch), GenerationConfig(max_len=MAX_LEN))
    assert torch.equal(got_t, greedy_t) and torch.equal(got_f, greedy_f)
    assert 0 < n <= MAX_LEN


def test_speculative_with_oracle_drafts_takes_fewer_chunks(pair):
    batch = _torch(pair["test"])
    cfg = GenerationConfig(max_len=MAX_LEN)
    greedy_t, greedy_f = pair["model"].generate(batch, cfg)
    got_t, got_f, n = pair["model"].generate_speculative(
        batch, cfg, spec_k=4, draft_source=greedy_t)
    assert torch.equal(got_t, greedy_t) and torch.equal(got_f, greedy_f)
    assert n < MAX_LEN


class JaxKeys:
    """A stand-in generator replaying the pointer's JAX key schedule:
    key, k1, k2 = split(key, 3) a step; the copy draw from k1, then the
    generated token's from k2."""

    def __init__(self, key):
        self.key, self.pending = key, None

    def draw(self, shape):
        if self.pending is None:
            self.key, k1, self.pending = jax.random.split(self.key, 3)
            sub = k1
        else:
            sub, self.pending = self.pending, None
        return torch.from_numpy(np.array(jax.random.gumbel(sub, shape)))


def test_sampling_matches_jax_with_its_draws(pair, monkeypatch):
    monkeypatch.setattr(gen, "gumbel_noise",
                        lambda generator, shape: generator.draw(shape))
    batch = pair["test"]
    key = jax.random.PRNGKey(7)
    want_t, want_f = _jax_generate(
        pair, batch, JaxConfig(max_len=MAX_LEN, sampling_topk=3,
                               sampling_temp=0.8), rng=key)
    got_t, got_f = pair["model"].generate(
        _torch(batch), GenerationConfig(max_len=MAX_LEN, sampling_topk=3,
                                        sampling_temp=0.8),
        generator=JaxKeys(key))
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    np.testing.assert_array_equal(got_f.numpy(), want_f)
    greedy, _ = _jax_generate(pair, batch, JaxConfig(max_len=MAX_LEN))
    assert not np.array_equal(want_t, greedy)      # it did sample


def test_only_pointer_decodes_through_the_captioner(pair):
    _, model = _models({"type": "transformer_only_pointer"})
    _carried(pair, model)
    batch = _torch(pair["test"])
    cfg = GenerationConfig(max_len=MAX_LEN)
    tokens, flags = model.generate(batch, cfg)
    want, _ = model.captioner.generate(batch, cfg)
    assert torch.equal(tokens, want) and not flags.any()
    spec, spec_flags, _ = model.generate_speculative(batch, cfg, spec_k=3)
    assert torch.equal(spec, want) and not spec_flags.any()
    with pytest.raises(ValueError, match="for_flattened"):
        ContinuousBatcher.for_pointer(model, cfg, 2)


def _requests(n, seed):
    ds = jax_config.build_dataset(jax_config.load_config(
        TINY, json.dumps({"dataset": {"test": {"size": n, "seed": seed}}})),
        "test")
    batch = next(ds.batches(n, shuffle=False))
    return [{k: batch[k][i:i + 1] for k in REQUEST_KEYS} for i in range(n)]


@pytest.mark.parametrize("spec_k", [1, 3])
def test_for_pointer_matches_jax(pair, spec_k):
    """Five requests through three slots, two steps a dispatch, caps of
    4 to 8 tokens: each result JAX's pool's (tokens, flags exact)."""
    reqs = _requests(5, 11)
    caps = [8, 5, 8, 4, 7]
    jcfg, cfg = JaxConfig(max_len=MAX_LEN), GenerationConfig(max_len=MAX_LEN)
    jeng = JaxBatcher.for_pointer(pair["jmodel"], pair["variables"], jcfg, 3,
                                  inner_steps=2, spec_k=spec_k, source_len=16)
    eng = ContinuousBatcher.for_pointer(pair["model"], cfg, 3, inner_steps=2,
                                        spec_k=spec_k, source_len=16)
    jids = [jeng.submit(_jax(r), source_row=r["article_ids"][0], max_len=c)
            for r, c in zip(reqs, caps)]
    ids = [eng.submit(_torch(r), source_row=r["article_ids"][0], max_len=c)
           for r, c in zip(reqs, caps)]
    want, got = jeng.run(), eng.run()
    flagged = 0
    for jid, rid in zip(jids, ids):
        w, g = want[jid], got[rid]
        assert len(g) == 3
        np.testing.assert_array_equal(g[0], np.asarray(w[0]))
        np.testing.assert_allclose(g[1], np.asarray(w[1]), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(g[2], np.asarray(w[2]))
        flagged += int(g[2].sum())
    assert flagged > 0
    assert eng.stats()["spec_k"] == spec_k


def test_pool_request_equals_generate_alone(pair):
    reqs = _requests(3, 12)
    cfg = GenerationConfig(max_len=MAX_LEN)
    eng = ContinuousBatcher.for_pointer(pair["model"], cfg, 2, inner_steps=3)
    ids = [eng.submit(_torch(r)) for r in reqs]
    got = eng.run()
    for rid, r in zip(ids, reqs):
        tokens, flags = pair["model"].generate(_torch(r), cfg)
        np.testing.assert_array_equal(got[rid][0], tokens[0].numpy())
        np.testing.assert_array_equal(got[rid][2], flags[0].numpy())


def test_pointer_pool_is_greedy_only(pair):
    with pytest.raises(ValueError, match="greedy-only"):
        ContinuousBatcher.for_pointer(
            pair["model"], GenerationConfig(max_len=4, sampling_topk=3), 2)
