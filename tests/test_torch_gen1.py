"""The port's Gen-1 captioners (`models/gen1.py`) and `gen1_adam`
against the JAX reference's, on the CPU.

Every core at small widths (vocab 30, so 31 outputs; input encoding,
rnn and attention 16 wide; fc and att features 12 wide over 4 patches;
5 sentences of 8), `show_attend_tell` with each sentence_embed_method,
is initialised in JAX with PRNGKey(0) and carried into the port by
`params_from_jax`; batches are drawn with numpy from a seed (a padded
caption tail). Every JAX call is jitted. At fp32:

- the loss within 1e-5 and every gradient within rtol 1e-5 / atol
  1e-6 (dropout 0; the teacher-forced log-probs within 1e-5);
- `generate`, `sample` and `sample_beam` (beam 3) tokens equal to JAX's
  full-vocab ones, each step's candidates from the folded head through
  `band_topk_lse`;
- top-k `generate` and `sample(sample_max=False)` fed JAX's draws
  equal;
- `sample_with_attention`'s tokens and maps, and
  `forward_with_attention`'s coverage loss with the reference's break
  at an all-pad column, within 1e-5;
- scheduled sampling draws from the given generator (one seeded with 0
  without one);
- `step_decay_schedule` equal to the reference's jitted schedule, and
  five `gen1_adam` updates (clamped gradients) within 1e-6 of optax's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from news_image_caption_tpu.generation.generator import \
    GenerationConfig as JaxConfig  # noqa: E402
from news_image_caption_tpu.models import gen1 as jax_gen1  # noqa: E402
from news_image_caption_tpu.training import optim as jax_optim  # noqa: E402
from news_image_caption_tpu_torch.generation import \
    generator as gen  # noqa: E402
from news_image_caption_tpu_torch.generation.generator import \
    GenerationConfig  # noqa: E402
from news_image_caption_tpu_torch.models import gen1  # noqa: E402
from news_image_caption_tpu_torch.models.from_jax import \
    params_from_jax  # noqa: E402
from news_image_caption_tpu_torch.training.optim import (  # noqa: E402
    gen1_adam, step_decay_schedule)

V, W, F, P, L, ES = 30, 16, 12, 4, 5, 8
MAX_LEN = 6
BASE = dict(vocab_size=V, input_encoding_size=W, rnn_size=W, att_hid_size=W,
            fc_feat_size=F, att_feat_size=F, drop_prob=0.0,
            seq_length=MAX_LEN)
CORES = ["show_tell", "fc", "att2in", "att2in2", "topdown", "adaatt",
         "adaatt_mo", "all_img"]
METHODS = ["", "concat", "fc", "fc_max", "conv", "conv_deep", "bnews"]
CASES = [(c, "") for c in CORES] + [("show_attend_tell", m) for m in METHODS]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(B=3, T=MAX_LEN + 2, seed=0):
    rng = np.random.RandomState(seed)
    cap = rng.randint(3, V, size=(B, T))
    cap[:, 0] = 0
    cap[1, 5:] = 1                               # a padded tail
    return {"caption_ids": cap.astype(np.int32),
            "image": rng.randn(B, P, F).astype(np.float32),
            "article": rng.randn(B, L, ES).astype(np.float32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _kw(model_type, method):
    kw = dict(BASE, model_type=model_type)
    if model_type == "show_attend_tell":
        kw.update(sentence_embed_method=method, sentence_embed_size=ES,
                  sentence_length=L)
    return kw


_PAIRS = {}


def _pair(model_type, method=""):
    """(JAX model, its params, the port's model), built once a case."""
    key = (model_type, method)
    if key not in _PAIRS:
        kw = _kw(model_type, method)
        jmodel = jax_gen1.gen1_factory(**kw)
        params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                      _jax(_arrays()))
        model = gen1.gen1_factory(device="cpu", **kw)
        model.param_module.load_state_dict(params_from_jax(
            jax.tree.map(np.asarray, params), model.param_module))
        model.param_module.eval()
        _PAIRS[key] = (jmodel, params, model)
    return _PAIRS[key]


@pytest.mark.parametrize("model_type,method", CASES)
def test_loss_and_gradients_match_jax(model_type, method):
    jmodel, params, model = _pair(model_type, method)
    batch = _arrays()
    (jloss, jaux), grads = jax.jit(jax.value_and_grad(
        jmodel.loss_fn, has_aux=True))(params, _jax(batch))
    module = model.param_module
    module.zero_grad()
    loss, aux = model.loss_fn(_torch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(aux["loss_sum"].item(),
                               float(jaux["loss_sum"]), rtol=1e-5)
    assert aux["sample_size"].item() == float(jaux["sample_size"])
    want = params_from_jax(jax.tree.map(np.asarray, grads), module)
    for name, p in module.named_parameters():
        # A layer the loss does not reach (att2in2's fc_embed, fc_max's
        # sentence scores, read only by an argmax) has no gradient: the
        # train step reads it as zeros, JAX's is zeros.
        got = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(got.numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    module.zero_grad()


def test_teacher_forced_log_probs_match_jax():
    jmodel, params, model = _pair("show_attend_tell", "fc")
    batch = _arrays()
    want = jax.jit(jmodel.forward)(params, _jax(batch))
    with torch.no_grad():
        got = model.forward(_torch(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("model_type,method", CASES)
def test_decoded_tokens_equal_jax(model_type, method):
    """`generate` (the news ids: bos 0, eos 2, pad 1), `sample` and
    `sample_beam` at beam 3."""
    jmodel, params, model = _pair(model_type, method)
    arrays = _arrays(B=4, seed=1)
    cfg = JaxConfig(max_len=MAX_LEN)

    def jdecode(p, b):
        return (jmodel.generate(p, b, cfg), jmodel.sample(p, b),
                jmodel.sample_beam(p, b, beam_size=3))

    (jt, jlp), (st, slp), (bt, bs) = jax.jit(jdecode)(params, _jax(arrays))
    batch = _torch(arrays)
    got_t, got_lp = model.generate(batch, GenerationConfig(max_len=MAX_LEN))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(jt))
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(jlp), rtol=1e-5,
                               atol=1e-5)
    got_s, got_slp = model.sample(batch)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(st))
    np.testing.assert_allclose(got_slp.numpy(), np.asarray(slp), rtol=1e-5,
                               atol=1e-5)
    got_b, got_bs = model.sample_beam(batch, beam_size=3)
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(bt))
    np.testing.assert_allclose(got_bs.numpy(), np.asarray(bs), rtol=1e-5,
                               atol=1e-5)


def test_decode_takes_the_folded_band_head(monkeypatch):
    """One band top-k over [Wᵀ | b | 0 ...] a step, no full log-softmax."""
    _, _, model = _pair("show_attend_tell", "fc")
    calls = []
    real = gen1.band_topk_lse

    def counted(x, table, k, *args, **kw):
        calls.append((tuple(x.shape), tuple(table.shape), k))
        return real(x, table, k, *args, **kw)

    def no_full_vocab(*args, **kw):
        raise AssertionError("a decode step took the full log-softmax")

    monkeypatch.setattr(gen1, "band_topk_lse", counted)
    monkeypatch.setattr(gen1.Gen1Captioner, "log_probs", no_full_vocab)
    batch = _torch(_arrays(B=4, seed=1))
    model.sample(batch)
    assert calls == [((4, W + 64), (V + 1, W + 64), 1)] * MAX_LEN
    calls.clear()
    model.sample_beam(batch, beam_size=3)
    assert calls == [((12, W + 64), (V + 1, W + 64), 3)] * MAX_LEN


class JaxKeys:
    """A stand-in generator: JAX's key schedule, one split a draw."""

    def __init__(self, key):
        self.key = key

    def draw(self, shape):
        self.key, sub = jax.random.split(self.key)
        return torch.from_numpy(np.array(jax.random.gumbel(sub, shape)))


@pytest.mark.parametrize("how", ["topk", "whole_vocab"])
def test_sampling_matches_jax_with_its_draws(how, monkeypatch):
    monkeypatch.setattr(gen, "gumbel_noise",
                        lambda generator, shape: generator.draw(shape))
    jmodel, params, model = _pair("show_attend_tell", "fc")
    arrays = _arrays(B=4, seed=1)
    key = jax.random.PRNGKey(7)
    batch = _torch(arrays)
    if how == "topk":
        cfg = JaxConfig(max_len=MAX_LEN, sampling_topk=4, sampling_temp=0.8)
        want = jax.jit(lambda p, b, k: jmodel.generate(p, b, cfg, k))(
            params, _jax(arrays), key)
        got = model.generate(batch, GenerationConfig(
            max_len=MAX_LEN, sampling_topk=4, sampling_temp=0.8),
            generator=JaxKeys(key))
    else:
        want = jax.jit(lambda p, b, k: jmodel.sample(
            p, b, sample_max=False, temperature=0.8, rng=k))(
            params, _jax(arrays), key)
        got = model.sample(batch, sample_max=False, temperature=0.8,
                           generator=JaxKeys(key))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-5, atol=1e-5)


def test_sample_with_attention_matches_jax():
    jmodel, params, model = _pair("show_attend_tell", "fc")
    arrays = _arrays(B=4, seed=1)
    jt, jlp, (jvis, jsen) = jax.jit(jmodel.sample_with_attention)(
        params, _jax(arrays))
    t, lp, (vis, sen) = model.sample_with_attention(_torch(arrays))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-5,
                               atol=1e-5)
    assert vis.shape == (MAX_LEN, 4, P) and sen.shape == (MAX_LEN, 4, L)
    np.testing.assert_allclose(vis.numpy(), np.asarray(jvis), atol=1e-5)
    np.testing.assert_allclose(sen.numpy(), np.asarray(jsen), atol=1e-5)


@pytest.mark.parametrize("method", ["fc", "conv", "bnews"])
def test_coverage_loss_matches_jax(method):
    jmodel, params, model = _pair("show_attend_tell", method)
    arrays = _arrays()
    rng = np.random.RandomState(3)
    seq = rng.randint(1, V, size=(3, MAX_LEN + 2)).astype(np.int32)
    seq[:, 0] = 0
    seq[:, 6:] = 0                  # all-pad columns: the steps stop there
    batch = {"seq": seq, "mask": (seq != 0).astype(np.float32),
             "fc_feats": arrays["image"].mean(axis=1),
             "att_feats": arrays["image"], "sen_embed": arrays["article"]}
    jlp, jcov = jax.jit(jmodel.forward_with_attention)(params, _jax(batch))
    with torch.no_grad():
        lp, cov = model.forward_with_attention(_torch(batch))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(cov.item(), float(jcov), rtol=1e-5,
                               atol=1e-7)
    assert (cov.item() > 0) == (method != "bnews")


def test_scheduled_sampling_draws_from_its_generator():
    _, _, model = _pair("show_attend_tell", "fc")
    batch = _torch(_arrays())
    with torch.no_grad():
        plain = model.forward(batch)
        a = model.forward(batch, ss_prob=1.0)
        b = model.forward(batch, ss_prob=1.0)
        c = model.forward(batch, torch.Generator().manual_seed(1),
                          ss_prob=1.0)
    assert torch.equal(a, b)                      # seeded with 0
    assert torch.equal(a[:, 0], plain[:, 0])      # step 0 is never sampled
    assert not torch.equal(a, plain) and not torch.equal(a, c)


def test_only_show_attend_tell_returns_attention():
    _, _, model = _pair("topdown")
    batch = _torch(_arrays())
    for fn in (model.forward_with_attention, model.sample_with_attention):
        with pytest.raises(ValueError, match="show_attend_tell"):
            fn(batch)


@pytest.mark.parametrize("start,every", [(0, 3), (2, 4), (-1, 3)])
def test_step_decay_schedule_is_the_references(start, every):
    want = jax.jit(jax_optim.step_decay_schedule(5e-4, start, every, 0.8))
    got = step_decay_schedule(5e-4, start, every, 0.8)
    for n in range(0, 40, 3):
        assert got(n) == float(want(jnp.int32(n))), n


def test_gen1_adam_updates_match_optax():
    rng = np.random.RandomState(0)
    shapes = [(4, 3), (5,)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[(rng.randn(*s) * 4).astype(np.float32) for s in shapes]
             for _ in range(5)]
    jtx = jax_optim.gen1_adam(lr=1e-2, decay_start=0, decay_every=2,
                              decay_rate=0.8, grad_clip_value=5.0)
    jp = [jnp.asarray(p) for p in params]
    jstate = jtx.init(jp)
    tx = gen1_adam(lr=1e-2, decay_start=0, decay_every=2, decay_rate=0.8,
                   grad_clip_value=5.0)
    master = [torch.from_numpy(p.copy()) for p in params]
    state = tx.init(master)
    for g in grads:
        updates, jstate = jtx.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = optax.apply_updates(jp, updates)
        tx.apply([torch.from_numpy(x.copy()) for x in g], state, master)
    assert state.count == 5
    for got, want in zip(master, jp):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
