"""The port's LSTM captioner (`models/decoder_lstm.py`) against the JAX
reference's `models/decoder_lstm.py`, on the CPU.

A small model (V=64, cutoff (16, 32, 64), embed and hidden 16, two
cells; image 12 and article 10 wide, dropout 0) is initialised in JAX
with PRNGKey(0) and carried into the port by `params_from_jax`. The
batch, drawn with numpy from a seed, has a padded image patch, padded
article tokens and padded caption tails. At fp32:

- the loss (bits per token) within 1e-5 and every gradient within
  rtol 1e-5 / atol 1e-6; the teacher-forced log-probs within 1e-5;
- greedy tokens exactly JAX's (their log-probs within 1e-5), and top-k
  sampling fed JAX's draws (one split a step) exactly JAX's;
- a decode step takes its candidates from the adaptive bands
  (`band_topk_lse` three times a step, no full-vocab log-probs);
- the model block's keys are checked as the reference's dataclass
  checks them.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from news_image_caption_tpu.generation.generator import \
    GenerationConfig as JaxConfig  # noqa: E402
from news_image_caption_tpu.models.decoder_lstm import (  # noqa: E402
    LSTMDecoder as JaxDecoder, LSTMFlattenedModel as JaxModel)
from news_image_caption_tpu_torch import config  # noqa: E402
from news_image_caption_tpu_torch.generation import \
    generator as gen  # noqa: E402
from news_image_caption_tpu_torch.generation.generator import \
    GenerationConfig  # noqa: E402
from news_image_caption_tpu_torch.models.decoder_lstm import \
    LSTMFlattenedModel  # noqa: E402
from news_image_caption_tpu_torch.models.from_jax import \
    params_from_jax  # noqa: E402
from news_image_caption_tpu_torch.ops import adaptive  # noqa: E402

KW = dict(vocab_size=64, embed_dim=16, hidden_size=16, num_layers=2,
          cutoff=(16, 32, 64), image_dim=12, article_dim=10,
          max_positions=64, dropout_rate=0.0)
MAX_LEN = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(B=3, T=9, P=4, S=6, seed=0):
    rng = np.random.RandomState(seed)
    cap = rng.randint(3, 64, size=(B, T))
    cap[:, 0] = 0
    cap[1, 6:] = 1                            # a padded tail
    image_mask = np.zeros((B, P), bool)
    image_mask[2, -1] = True
    article_mask = np.zeros((B, S), bool)
    article_mask[1, -2:] = True
    return {"caption_ids": cap.astype(np.int32),
            "image": rng.randn(B, P, 12).astype(np.float32),
            "image_mask": image_mask,
            "article": rng.randn(B, S, 10).astype(np.float32),
            "article_mask": article_mask}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def pair():
    jmodel = JaxModel(JaxDecoder(**KW))
    batch = _arrays()
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), _jax(batch))
    model = LSTMFlattenedModel(device="cpu", **KW)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, variables),
                                          model))
    return dict(jmodel=jmodel, variables=variables, model=model, batch=batch,
                test=_arrays(B=4, seed=1))


def test_loss_and_gradients_match(pair):
    jm, batch = pair["jmodel"], pair["batch"]
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda v: jm.loss_fn(v, _jax(batch)), has_aux=True))(
            pair["variables"])
    model = pair["model"]
    model.zero_grad()
    loss, aux = model.loss_fn(_torch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(aux["loss_sum"].item(),
                               float(jaux["loss_sum"]), rtol=1e-5)
    assert aux["sample_size"].item() == int(jaux["sample_size"])
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), model)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert float(np.abs(model.h0_0.grad.numpy()).max()) > 0.0
    model.zero_grad()


def test_teacher_forced_log_probs_match(pair):
    jm, batch = pair["jmodel"], pair["batch"]
    x = jax.jit(jm._hidden)(pair["variables"], _jax(batch))
    B, T, H = x.shape
    want = jm.decoder.apply(pair["variables"], x.reshape(B * T, H),
                            method=JaxDecoder.log_prob_from_hidden)
    tb = _torch(batch)
    with torch.no_grad():
        got = pair["model"].log_prob(tb["caption_ids"][:, :-1].long(),
                                     pair["model"]._contexts(tb))
    np.testing.assert_allclose(got.reshape(B * T, -1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


def _jax_generate(pair, batch, cfg, rng=None):
    jm = pair["jmodel"]
    tokens, lps = jax.jit(lambda v, b: jm.generate(v, b, cfg, rng=rng))(
        pair["variables"], _jax(batch))
    return np.asarray(tokens), np.asarray(lps)


@pytest.mark.parametrize("early_exit", [False, True])
def test_greedy_tokens_exact(pair, early_exit):
    want_t, want_lp = _jax_generate(pair, pair["test"],
                                    JaxConfig(max_len=MAX_LEN))
    got_t, got_lp = pair["model"].generate(
        _torch(pair["test"]), GenerationConfig(max_len=MAX_LEN,
                                               early_exit=early_exit))
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


def test_sampling_matches_jax_with_its_draws(pair, monkeypatch):
    monkeypatch.setattr(gen, "gumbel_noise",
                        lambda generator, shape: generator.draw(shape))
    key = jax.random.PRNGKey(5)
    want_t, want_lp = _jax_generate(
        pair, pair["test"], JaxConfig(max_len=MAX_LEN, sampling_topk=4,
                                      sampling_temp=0.8), rng=key)
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


def test_decode_takes_the_band_head(pair, monkeypatch):
    """Three band top-k calls a step (head and two tails) and no
    full-vocab log-probs; the masks are read (padded article rows moved
    change no token)."""
    calls = []
    real = adaptive.band_topk_lse

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    def no_full_vocab(*args, **kw):
        raise AssertionError("a decode step took full-vocab log-probs")

    monkeypatch.setattr(adaptive, "band_topk_lse", counted)
    monkeypatch.setattr(adaptive.AdaptiveSoftmax, "log_prob", no_full_vocab)
    batch = _torch(pair["test"])
    cfg = GenerationConfig(max_len=MAX_LEN)
    tokens, _ = pair["model"].generate(batch, cfg)
    assert len(calls) == 3 * MAX_LEN
    assert all(s == (4, 16) for s in calls)
    moved = dict(batch, article=batch["article"].clone())
    moved["article"][batch["article_mask"]] = 100.0
    again, _ = pair["model"].generate(moved, cfg)
    assert torch.equal(again, tokens)


@pytest.mark.parametrize("extra,error,match", [
    ({"dtype": "bfloat16"}, TypeError, "unknown keys"),
    pytest.param({"tie_adaptive_proj": True}, None, "item 8",
                 id="extra1-NotImplementedError-item 8"),
    ({"hidden_size": 32}, ValueError, "embed_dim"),
    ({"decoder": {"type": "dynamic_conv_decoder_flattened"}}, TypeError,
     "lstm_decoder_flattened"),
])
def test_model_block_keys_are_checked(extra, error, match):
    """Each key is checked; tie_adaptive_proj, ported by item 8b, builds
    a head without tail projections of its own."""
    cfg = config.load_config("configs/goodnews/lstm_roberta.yaml",
                             json.dumps({"model": extra}))
    if error is None:
        head = config.build_model(cfg, "meta").adaptive_softmax
        assert head.tie_proj
        assert not any(n.startswith("tail_proj")
                       for n, _ in head.named_parameters())
        return
    with pytest.raises(error, match=match):
        config.build_model(cfg, "meta")


def test_decoder_block_builds_the_decoder():
    """A `decoder:` block of type lstm_decoder_flattened is the model's
    keys; the model block's others are dropped, as the reference's
    wrapper drops them."""
    cfg = {"model": {"type": "lstm_flattened", "vocab_size": 7,
                     "decoder": dict(KW, type="lstm_decoder_flattened",
                                     cutoff=[16, 32, 64])}}
    model = config.build_model(cfg, "meta")
    assert model.vocab_size == 64 and model.num_layers == 2
    assert isinstance(model, LSTMFlattenedModel)
