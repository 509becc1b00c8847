"""The port's TGNC (`models/tgnc.py`) and its slot pool
(`ContinuousBatcher.for_tgnc`) against the JAX reference's, on the CPU.

A small model (V=120 in bands 40/80/120, d=32, 4 heads, FFN 64, a trunk
of kernels 3 and 7, three template heads of kernel 7, image 48 and
article 32 wide, template loss weight 1) is initialised in JAX with
PRNGKey(0) and carried into the port by `params_from_jax`; batches are
drawn with numpy from a seed (padded article rows, a padded caption
tail, multi-hot template labels). Every JAX call is jitted. At fp32:

- the loss and its `template_loss` (the BCE) within 1e-5, and every
  gradient within rtol 1e-5 / atol 1e-6; the loss without
  `template_label` is the caption loss alone;
- the teacher-forced log-probs through the mixed heads within 1e-5;
- greedy tokens equal to JAX's full-vocab `generate` (log-probs within
  1e-5); top-k sampling fed JAX's draws equal; speculative tokens equal
  to JAX's and to greedy, in JAX's number of chunks;
- `for_tgnc`, greedy and speculative, each pooled request's tokens
  equal to `generate` on it alone; the engine refuses sampling and a
  TGNC without template decoder, as the reference's does;
- a decode step takes its candidates from the bands (`band_topk_lse`
  three times a step) and never forms the full-vocab log-probs;
- without the template decoder, the loss and the greedy tokens are the
  flattened captioner's under `captioner.`.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from news_image_caption_tpu.generation.generator import \
    GenerationConfig as JaxConfig  # noqa: E402
from news_image_caption_tpu.models import tgnc as jax_tgnc  # noqa: E402
from news_image_caption_tpu_torch.generation import \
    generator as gen  # noqa: E402
from news_image_caption_tpu_torch.generation.continuous import \
    ContinuousBatcher  # noqa: E402
from news_image_caption_tpu_torch.generation.generator import \
    GenerationConfig  # noqa: E402
from news_image_caption_tpu_torch.models import tgnc  # noqa: E402
from news_image_caption_tpu_torch.models.from_jax import \
    params_from_jax  # noqa: E402
from news_image_caption_tpu_torch.ops import adaptive  # noqa: E402

V, D = 120, 32
DECODER = dict(vocab_size=V, cutoff=(40, 80, V), embed_dim=D, ffn_dim=64,
               num_heads=4, num_layers=2, kernel_sizes=(3, 7), head_kernel=7,
               max_positions=64)
KW = dict(n_templates=3, image_dim=48, article_dim=32,
          template_loss_weight=1.0, use_template_decoder=True, **DECODER)
# Without the template decoder the model is the flattened captioner,
# which has no head layers.
FLATTENED = {k: v for k, v in KW.items() if k != "head_kernel"}
FLATTENED.update(use_template_decoder=False, template_loss_weight=0.0)
P, S, MAX_LEN = 5, 7, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(B=3, T=10, seed=0):
    rng = np.random.RandomState(seed)
    cap = rng.randint(3, V, size=(B, T))
    cap[:, 0] = 0
    cap[1, 7:] = 1                              # a padded tail
    article_mask = np.zeros((B, S), bool)
    article_mask[1:, -2:] = True
    label = (rng.rand(B, 3) < 0.5).astype(np.float32)
    return {"caption_ids": cap.astype(np.int32),
            "image": rng.randn(B, P, 48).astype(np.float32),
            "image_mask": np.zeros((B, P), bool),
            "article": rng.randn(B, S, 32).astype(np.float32),
            "article_mask": article_mask,
            "article_ids": rng.randint(3, V, size=(B, S)).astype(np.int32),
            "template_label": label}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _pair(kw=KW):
    jmodel = jax_tgnc.TGNC(**kw)
    batch = _arrays()
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), _jax(batch))
    model = tgnc.TGNC(device="cpu", **kw)
    model.param_module.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, variables), model.param_module))
    model.param_module.eval()
    return jmodel, variables, model


@pytest.fixture(scope="module")
def pair():
    jmodel, variables, model = _pair()
    return dict(jmodel=jmodel, variables=variables, model=model,
                batch=_arrays(), test=_arrays(B=4, seed=1))


def _jax_generate(pair, arrays, cfg, rng=None):
    fn = jax.jit(lambda v, b, key: pair["jmodel"].generate(v, b, cfg, key))
    tokens, lps = fn(pair["variables"], _jax(arrays), rng)
    return np.asarray(tokens), np.asarray(lps)


def test_parameters_are_the_references(pair):
    names = set(pair["model"].param_module.state_dict())
    assert "classifier.dense.kernel" in names
    assert "decoder.head_2.linear1.kernel" in names
    assert "decoder.layers.1.conv.weight_linear.kernel" in names
    assert pair["model"].param_module.decoder.head_0.kernel_size == 7


def test_loss_and_template_loss_match_jax(pair):
    jloss, jaux = jax.jit(pair["jmodel"].loss_fn)(pair["variables"],
                                                  _jax(pair["batch"]))
    with torch.no_grad():
        loss, aux = pair["model"].loss_fn(_torch(pair["batch"]))
    assert set(aux) == {"loss_sum", "sample_size", "caption_loss",
                        "template_loss"} == set(jaux)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k in ("loss_sum", "caption_loss", "template_loss"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=1e-5,
                                   err_msg=k)
    assert int(aux["sample_size"]) == int(jaux["sample_size"])
    assert aux["template_loss"].item() > 0.1


def test_loss_without_template_label_is_the_caption_loss(pair):
    batch = _torch(pair["batch"])
    del batch["template_label"]
    with torch.no_grad():
        loss, aux = pair["model"].loss_fn(batch)
        full, _ = pair["model"].loss_fn(_torch(pair["batch"]))
    assert "template_loss" not in aux
    assert loss.item() == aux["caption_loss"].item()
    assert abs(full.item() - loss.item()) > 0.1
    assert pair["model"].batch_keys == ("template_label",)


def test_gradients_match_jax(pair):
    def jloss(v, b):
        return pair["jmodel"].loss_fn(v, b)[0]

    grads = jax.jit(jax.grad(jloss))(pair["variables"], _jax(pair["batch"]))
    module = pair["model"].param_module
    module.zero_grad()
    loss, _ = pair["model"].loss_fn(_torch(pair["batch"]))
    loss.backward()
    want = params_from_jax(jax.tree.map(np.asarray, grads), module)
    for name, p in module.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    module.zero_grad()


def test_teacher_forced_log_probs_match_jax(pair):
    jmodel = pair["jmodel"]
    arrays = pair["batch"]

    def jlog_prob(v, b):
        logits = jmodel.classifier.apply(v["classifier"], b["article"],
                                         b["image"])

        def fn(mdl, ids, ctx, tl):
            x = mdl.hidden(ids, ctx, tl)
            return mdl.adaptive_softmax.log_prob(
                x.reshape(-1, x.shape[-1]), mdl.embedder.embed_tables())

        return jmodel.tg_decoder.apply(v["decoder"], b["caption_ids"][:, :-1],
                                       jmodel._contexts(b), logits, method=fn)

    want = np.asarray(jax.jit(jlog_prob)(pair["variables"], _jax(arrays)))
    model = pair["model"]
    batch = _torch(arrays)
    with torch.no_grad():
        got = model.tg_decoder.log_prob(
            batch["caption_ids"][:, :-1].long(), model._contexts(batch),
            model.template_logits(batch))
    np.testing.assert_allclose(got.reshape(-1, V).numpy(), want, rtol=1e-5,
                               atol=1e-5)


def test_greedy_tokens_equal_jax(pair):
    want_t, want_lp = _jax_generate(pair, pair["test"],
                                    JaxConfig(max_len=MAX_LEN))
    got_t, got_lp = pair["model"].generate(_torch(pair["test"]),
                                           GenerationConfig(max_len=MAX_LEN))
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    np.testing.assert_allclose(got_lp.numpy(), want_lp, rtol=1e-5, atol=1e-5)


class JaxKeys:
    """A stand-in generator: JAX's key schedule, one split a draw."""

    def __init__(self, key):
        self.key = key

    def draw(self, shape):
        self.key, sub = jax.random.split(self.key)
        return torch.from_numpy(np.array(jax.random.gumbel(sub, shape)))


def test_sampling_matches_jax_with_its_draws(pair, monkeypatch):
    monkeypatch.setattr(gen, "gumbel_noise",
                        lambda generator, shape: generator.draw(shape))
    key = jax.random.PRNGKey(3)
    jcfg = JaxConfig(max_len=MAX_LEN, sampling_topk=4, sampling_temp=0.8)
    want_t, want_lp = _jax_generate(pair, pair["test"], jcfg, rng=key)
    got_t, got_lp = pair["model"].generate(
        _torch(pair["test"]), GenerationConfig(max_len=MAX_LEN,
                                               sampling_topk=4,
                                               sampling_temp=0.8),
        generator=JaxKeys(key))
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    np.testing.assert_allclose(got_lp.numpy(), want_lp, rtol=1e-5,
                               atol=1e-5)
    greedy, _ = _jax_generate(pair, pair["test"], JaxConfig(max_len=MAX_LEN))
    assert not np.array_equal(want_t, greedy)      # it did sample


@pytest.mark.parametrize("drafts", ["oracle", "article"])
def test_speculative_tokens_equal_greedy_and_jax(pair, drafts):
    arrays = dict(pair["test"])
    greedy, _ = pair["model"].generate(_torch(arrays),
                                       GenerationConfig(max_len=MAX_LEN))
    if drafts == "oracle":
        arrays["article_ids"] = greedy.numpy()[:, 1:].astype(np.int32)
    jfn = jax.jit(functools.partial(pair["jmodel"].generate_speculative,
                                    config=JaxConfig(max_len=MAX_LEN),
                                    spec_k=3))
    want_t, want_lp, want_n = jfn(pair["variables"], _jax(arrays))
    got_t, got_lp, got_n = pair["model"].generate_speculative(
        _torch(arrays), GenerationConfig(max_len=MAX_LEN), spec_k=3)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_t.numpy(), greedy.numpy())
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp),
                               rtol=1e-5, atol=1e-5)
    assert int(got_n) == int(want_n)
    if drafts == "oracle":
        assert int(got_n) < MAX_LEN


def _request(arrays, b):
    return {k: torch.from_numpy(np.asarray(v[b:b + 1]))
            for k, v in arrays.items() if k != "article_ids"}


@pytest.mark.parametrize("spec_k", [1, 3])
def test_for_tgnc_requests_equal_generate(pair, spec_k):
    model, arrays = pair["model"], pair["test"]
    cfg = GenerationConfig(max_len=MAX_LEN)
    pool = ContinuousBatcher.for_tgnc(model, cfg, 2, inner_steps=3,
                                      spec_k=spec_k, source_len=S)
    rids = [pool.submit(_request(arrays, b),
                        source_row=arrays["article_ids"][b])
            for b in range(4)]
    results = pool.run()
    for b, rid in enumerate(rids):
        want_t, want_lp = model.generate(_request(arrays, b), cfg)
        np.testing.assert_array_equal(results[rid][0], want_t[0].numpy())
        np.testing.assert_allclose(results[rid][1], want_lp[0].numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_for_tgnc_refuses_sampling_and_a_flattened_tgnc(pair):
    with pytest.raises(ValueError, match="greedy-only"):
        ContinuousBatcher.for_tgnc(pair["model"], GenerationConfig(
            max_len=4, sampling_topk=3), 2)
    plain = tgnc.TGNC(device="meta", **FLATTENED)
    with pytest.raises(ValueError, match="no template decoder"):
        ContinuousBatcher.for_tgnc(plain, GenerationConfig(max_len=4), 2)


def test_decode_takes_the_band_head(pair, monkeypatch):
    """Three band top-k calls a step (head and two tails) over the mixed
    heads, and no full-vocab log-probs."""
    calls = []
    real = adaptive.band_topk_lse

    def counted(*args, **kw):
        calls.append(tuple(args[0].shape))
        return real(*args, **kw)

    def no_full_vocab(*args, **kw):
        raise AssertionError("a decode step took full-vocab log-probs")

    monkeypatch.setattr(adaptive, "band_topk_lse", counted)
    monkeypatch.setattr(adaptive.AdaptiveSoftmax, "log_prob", no_full_vocab)
    pair["model"].generate(_torch(pair["test"]),
                           GenerationConfig(max_len=MAX_LEN))
    assert len(calls) == 3 * MAX_LEN
    assert all(s == (4, D) for s in calls)


def test_without_template_decoder_it_is_the_flattened_captioner():
    jmodel, variables, model = _pair(FLATTENED)
    names = set(model.param_module.state_dict())
    assert {n.split(".")[0] for n in names} == {"classifier", "captioner"}
    arrays = _arrays()
    jloss, _ = jax.jit(jmodel.loss_fn)(variables, _jax(arrays))
    with torch.no_grad():
        loss, aux = model.loss_fn(_torch(arrays))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert "template_loss" not in aux
    cfg = JaxConfig(max_len=MAX_LEN)
    want, _ = jax.jit(lambda v, b: jmodel.generate(v, b, cfg))(
        variables, _jax(_arrays(B=4, seed=1)))
    got, _ = model.generate(_torch(_arrays(B=4, seed=1)),
                            GenerationConfig(max_len=MAX_LEN))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("key", ["remat", "tie_adaptive_proj"])
def test_options_not_ported_raise_naming_item_8b(key):
    """Ported by item 8b: each builds (remat's numbers and the tied
    tails' are held in tests/test_torch_decoder_options.py)."""
    dec = tgnc.TGNC(device="meta", **dict(KW, **{key: True})).tg_decoder
    assert (dec.remat if key == "remat" else dec.adaptive_softmax.tie_proj)
