"""The decoder's options in the port against the JAX reference, on the CPU.

A small flattened captioner (V=120 in bands 40/80/120, D=64, 4 heads,
FFN 128, kernels 3 and 5, image 48 and article 32 wide) is built in both
packages under three option sets, JAX's PRNGKey(0) init carried into
the port by `params_from_jax`, the inputs numpy arrays from a seed:

- A: `conv_type: lightweight`, `decoder_glu: false`, `weight_softmax:
  false`, `normalize_before: true`, `final_norm: true`, `conv_dim: 32`
  (the plain decode step: no conv block or FFN kernel);
- B: `remat: true`, `tie_adaptive_proj: true`,
  `adaptive_softmax_dropout: 0.1` (the flagship's structure: the four
  decode kernels);
- C: `param_dtype: bfloat16` (bf16 parameters, fp32 compute).

For each: teacher-forced log-probs within 2e-4 and attention maps within
1e-5 (test_torch_model.py's), the loss within rtol 1e-5 and every
gradient within rtol 5e-4 / atol 5e-5 (test_torch_train.py's; for C's
bf16 gradients one bf16 unit more, both packages rounding an fp32
gradient to the parameter's dtype, and a weight-normed bf16 kernel's
and scale's gradients within 2^-8 of the reference's in norm, the
reference running
the weight norm's backward in bf16 arithmetic and the port in fp32
from the same rounded forward), greedy and beam-5 tokens exact,
speculative tokens equal to greedy's, and every decode step form
(`step_topk`, `step`, `step_shift`, `step_beam_lazy`, `step_chunk`)
against teacher forcing. Remat changes memory, not numbers: with every
dropout on (flash's seed too), the loss and the gradients with and
without it are bit-identical for the flattened decoder (sets A and B)
and Gen-2, and within the reference test's rtol 1e-5 / atol 1e-7 for
TGNC, whose heads fan the trunk's output out. The decode route follows
the configuration alone: set B and the flagship YAML take the kernels,
set A the plain step (a meta model in bf16, and the wrappers' calls
counted on the CPU). Each set's options on the flagship YAML build at
full width on the meta device as JAX's `eval_shape` tree, and every
field of the reference's decoder dataclasses builds from YAML. Last,
each set through both packages' `train` and `evaluate -m best` on
`configs/tiny_test.yaml` narrowed by overrides (16 train records, 2
epochs: 8 steps; every dropout 0, the tail dropout too, since the
packages draw different bits): the losses within 1e-5 (C's within
1e-4: its weight-norm gradients differ by the reference's bf16
rounding, above), the other metrics equal, and `generations.jsonl` /
`evaluate-metrics.json` byte-equal.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from news_image_caption_tpu import cli as jax_cli  # noqa: E402
from news_image_caption_tpu import config as jax_config  # noqa: E402
from news_image_caption_tpu.generation.generator import \
    GenerationConfig as JaxConfig  # noqa: E402
from news_image_caption_tpu.models import decoder_lstm as jax_lstm  # noqa: E402
from news_image_caption_tpu.models import gen2 as jax_gen2  # noqa: E402
from news_image_caption_tpu.models import tgnc as jax_tgnc  # noqa: E402
from news_image_caption_tpu.models.captioner import \
    TransformerFlattened as JaxTransformerFlattened  # noqa: E402
from news_image_caption_tpu.models.decoder_flattened import \
    DynamicConvDecoder as JaxDecoder  # noqa: E402
from news_image_caption_tpu_torch import cli  # noqa: E402
from news_image_caption_tpu_torch import config  # noqa: E402
from news_image_caption_tpu_torch.generation.generator import \
    GenerationConfig  # noqa: E402
from news_image_caption_tpu_torch.models import \
    decoder_flattened as port_decoder  # noqa: E402
from news_image_caption_tpu_torch.models import gen2, tgnc  # noqa: E402
from news_image_caption_tpu_torch.models.captioner import \
    TransformerFlattened  # noqa: E402
from news_image_caption_tpu_torch.models.from_jax import (  # noqa: E402
    params_from_jax, torch_key)
from news_image_caption_tpu_torch.ops import adaptive  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
V, D, H = 120, 64, 4
SMALL = dict(vocab_size=V, cutoff=(40, 80, V), embed_dim=D, ffn_dim=128,
             num_heads=H, num_layers=2, kernel_sizes=(3, 5), image_dim=48,
             article_dim=32, max_positions=64)
SETS = {
    "A": dict(conv_type="lightweight", decoder_glu=False,
              weight_softmax=False, normalize_before=True, final_norm=True,
              conv_dim=32),
    "B": dict(remat=True, tie_adaptive_proj=True,
              adaptive_softmax_dropout=0.1),
    "C": dict(param_dtype="bfloat16"),
}
B, T, P, S = 3, 12, 5, 7
MAX_LEN = 10


def _port_opts(name):
    return {k: (config.config_dtype(v) if k == "param_dtype" else v)
            for k, v in SETS[name].items()}


def _jax_opts(name):
    return {k: (jnp.bfloat16 if k == "param_dtype" else v)
            for k, v in SETS[name].items()}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, so that the suite's parallel
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _arrays(seed=0):
    rng = np.random.RandomState(seed)
    caption = rng.randint(2, V, size=(B, T)).astype(np.int32)
    caption[:, 0] = 0
    caption[0, -3:] = 1
    article_mask = np.zeros((B, S), bool)
    article_mask[1, -2:] = True
    return {"caption_ids": caption,
            "image": rng.randn(B, P, 48).astype(np.float32),
            "image_mask": np.zeros((B, P), bool),
            "article": rng.randn(B, S, 32).astype(np.float32),
            "article_mask": article_mask}


@pytest.fixture(scope="module", params=sorted(SETS))
def pair(request):
    name = request.param
    arrays = _arrays()
    jbatch = {k: jnp.asarray(v) for k, v in arrays.items()}
    jmodel = JaxTransformerFlattened(**SMALL, **_jax_opts(name))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jbatch)
    model = TransformerFlattened(device="cpu", dtype=torch.float32,
                                 **SMALL, **_port_opts(name))
    model.decoder.load_state_dict(params_from_jax(_np(params),
                                                  model.decoder))
    tbatch = {k: torch.from_numpy(v) for k, v in arrays.items()
              if k != "caption_ids"}
    greedy = jmodel.generate(params, jbatch, JaxConfig(max_len=MAX_LEN))
    return dict(name=name, jmodel=jmodel, params=params, jbatch=jbatch,
                model=model, tbatch=tbatch, caption=arrays["caption_ids"],
                greedy=tuple(np.asarray(a) for a in greedy))


def _jax_decoder(pair, method, *args):
    jm = pair["jmodel"]
    return jax.jit(lambda p, ids, ctx, *a: jm.decoder.apply(
        p, ids, ctx, *a, method=method))(
            pair["params"], pair["jbatch"]["caption_ids"],
            jm._contexts(pair["jbatch"]), *args)


def _caption(pair):
    return torch.from_numpy(pair["caption"]).long()


def test_parameters_are_stored_as_the_reference_stores_them(pair):
    want = {torch_key(k): v.dtype for k, v in
            flatten_dict(pair["params"]["params"], sep="/").items()}
    got = dict(pair["model"].decoder.named_parameters())
    assert set(got) == set(want)
    for k, p in got.items():
        assert str(p.dtype).split(".")[-1] == str(want[k]), k
    if pair["name"] == "C":
        assert got["layers.0.fc1.kernel"].dtype == torch.bfloat16
        assert got["layers.0.final_layer_norm.scale"].dtype == torch.float32


def test_log_prob_and_attention_maps_match(pair):
    with torch.no_grad():
        lp = pair["model"].decoder.log_prob(_caption(pair), pair["tbatch"])
        maps = pair["model"].decoder.attention_maps(_caption(pair),
                                                    pair["tbatch"])
    np.testing.assert_allclose(lp.numpy(), np.asarray(
        _jax_decoder(pair, JaxDecoder.log_prob)), rtol=2e-4, atol=2e-4)
    want = _jax_decoder(pair, JaxDecoder.attention_maps)
    for got_l, want_l in zip(maps, want):
        for name in ("image", "article"):
            np.testing.assert_allclose(got_l[name].numpy(),
                                       np.asarray(want_l[name]), atol=1e-5)


def _bf16_unit(w):
    """One unit in the last place of bf16 at each |w|."""
    e = np.floor(np.log2(np.maximum(np.abs(w), 1e-30)))
    return np.exp2(e - 7)


def test_loss_and_gradients_match(pair):
    inp, tgt = _caption(pair)[:, :-1], _caption(pair)[:, 1:]
    jm = pair["jmodel"]

    def jloss(p):
        return jm.decoder.apply(p, pair["jbatch"]["caption_ids"][:, :-1],
                                jm._contexts(pair["jbatch"]),
                                pair["jbatch"]["caption_ids"][:, 1:],
                                method=JaxDecoder.loss)[0]

    want_loss, jgrads = jax.jit(jax.value_and_grad(jloss))(pair["params"])
    dec = pair["model"].decoder
    dec.zero_grad()
    loss, n = dec.loss(inp, pair["tbatch"], tgt)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert n.item() == int((pair["caption"][:, 1:] != 1).sum())
    want = {torch_key(k): np.asarray(v, np.float32) for k, v in
            flatten_dict(jgrads["params"], sep="/").items()}
    params = dict(dec.named_parameters())
    for k, p in params.items():
        g, w = p.grad.float().numpy(), want[k]
        owner = k.rsplit(".", 1)[0]
        if p.dtype == torch.bfloat16 and k.endswith((".kernel", ".scale")) \
                and {owner + ".kernel", owner + ".scale"} <= set(params):
            # A weight-normed linear's kernel and scale in bf16: the
            # reference's backward of the norm runs in bf16 arithmetic,
            # the port's in fp32 from the same rounded forward; held as
            # a whole tensor.
            err = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert err <= 2.0 ** -8, (k, err)
            continue
        tol = 5e-4 * np.abs(w) + 5e-5
        if p.dtype == torch.bfloat16:
            tol = tol + _bf16_unit(np.maximum(np.abs(g), np.abs(w)))
        bad = np.abs(g - w) > tol
        assert not bad.any(), (k, g[bad][:5], w[bad][:5])
    dec.zero_grad()


def test_greedy_tokens_match(pair):
    want, want_lp = pair["greedy"]
    got, lp = pair["model"].generate(pair["tbatch"],
                                     GenerationConfig(max_len=MAX_LEN))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(lp.numpy(), want_lp, rtol=2e-4, atol=2e-4)


def test_beam5_tokens_match(pair):
    want, want_scores = pair["jmodel"].generate_beam(
        pair["params"], pair["jbatch"], JaxConfig(max_len=8, beam_size=5))
    got, scores = pair["model"].generate_beam(
        pair["tbatch"], GenerationConfig(max_len=8, beam_size=5))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores),
                               rtol=2e-4, atol=2e-4)


def test_speculative_tokens_equal_greedy(pair):
    greedy, greedy_lp = pair["greedy"]
    noise = np.random.RandomState(9).randint(2, V, (B, 4))
    source = np.concatenate([noise, greedy, noise], axis=1)
    toks, lps, n_chunks = pair["model"].generate_speculative(
        dict(pair["tbatch"], article_ids=torch.from_numpy(source)),
        GenerationConfig(max_len=MAX_LEN), spec_k=4)
    np.testing.assert_array_equal(toks.numpy(), greedy)
    np.testing.assert_allclose(lps.numpy(), greedy_lp, rtol=2e-4, atol=2e-4)
    assert n_chunks < MAX_LEN


def test_every_decode_step_matches_teacher_forcing(pair):
    """Feeding the caption through `step_topk` (ring caches, positions
    as an int and as a tensor), `step` (full vocab), `step_shift`,
    `step_beam_lazy` and `step_chunk` gives each position's
    teacher-forced log-probs."""
    dec = pair["model"].decoder
    cap = _caption(pair)
    with torch.no_grad():
        lp = dec.log_prob(cap, pair["tbatch"])
        kvs = dec.precompute_kv(pair["tbatch"])
        w = dec.decode_weights()
        ring, ring_pos = dec.init_cache(B, "cpu"), dec.init_cache(B, "cpu")
        full, lazy = dec.init_cache(B, "cpu"), dec.init_cache(B, "cpu")
        shift = dec.init_cache(B, "cpu", ring_major=False)
        maps = dec.init_slot_maps(B, "cpu")
        for t in range(T):
            tok = cap[:, t]
            want = torch.topk(lp[:, t], 3)
            v, ids = dec.step_topk(tok, t, kvs, ring, 3, w)
            np.testing.assert_array_equal(ids.numpy(), want.indices.numpy())
            np.testing.assert_allclose(v.numpy(), want.values.numpy(),
                                       atol=1e-4, rtol=1e-4)
            v, _ = dec.step_topk(tok, torch.full((B,), t), kvs, ring_pos, 3,
                                 w)
            np.testing.assert_allclose(v.numpy(), want.values.numpy(),
                                       atol=1e-4, rtol=1e-4)
            for got in (dec.step(tok, t, kvs, full, w),
                        dec.step_shift(tok, t, kvs, shift, w),
                        dec.step_beam_lazy(tok, t, kvs, lazy, maps, w, 1)):
                np.testing.assert_allclose(got.numpy(), lp[:, t].numpy(),
                                           atol=1e-4, rtol=1e-4)
        caches = dec.init_cache(B, "cpu")
        pos = torch.zeros(B, dtype=torch.int32)
        v, ids, _ = dec.step_chunk(cap[:, :5], pos, kvs, caches, w)
        want = lp[:, :5].max(dim=-1)
        np.testing.assert_array_equal(ids.numpy(), want.indices.numpy())
        np.testing.assert_allclose(v.numpy(), want.values.numpy(),
                                   atol=1e-4, rtol=1e-4)


# -- remat --------------------------------------------------------------------

DROPS = dict(dropout=0.1, weight_dropout=0.1, relu_dropout=0.1,
             input_dropout=0.1, attention_dropout=0.1)


def _batch_t(arrays):
    return {k: torch.from_numpy(v) for k, v in arrays.items()}


def _loss_and_grads(model, params, loss_fn, seed=3):
    torch.manual_seed(0)
    for p in params.values():
        p.grad = None
    loss = loss_fn(torch.Generator().manual_seed(seed))
    loss.backward()
    return loss.detach(), {k: p.grad.clone() for k, p in params.items()}


@pytest.mark.parametrize("structure", ["A", "B"])
def test_remat_flattened_is_bit_identical(structure):
    opts = {k: v for k, v in _port_opts(structure).items() if k != "remat"}
    opts.update(adaptive_softmax_dropout=0.1, use_flash_train=True, **DROPS)
    batch = _batch_t(_arrays(1))
    out = []
    for remat in (False, True):
        model = TransformerFlattened(
            device="cpu", dtype=torch.float32, remat=remat,
            generator=torch.Generator().manual_seed(0), **SMALL, **opts)
        out.append(_loss_and_grads(
            model, dict(model.decoder.named_parameters()),
            lambda g: model.loss_fn(batch, g)[0]))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    assert set(g0) == set(g1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    # the run drew dropout masks: another seed gives another loss
    model = TransformerFlattened(device="cpu", dtype=torch.float32,
                                 remat=True, generator=torch.Generator()
                                 .manual_seed(0), **SMALL, **opts)
    other = model.loss_fn(batch, torch.Generator().manual_seed(4))[0]
    assert not torch.equal(other.detach(), l0)


def test_remat_tgnc_matches():
    kw = dict(n_templates=2, image_dim=48, article_dim=32,
              template_loss_weight=1.0, use_template_decoder=True,
              vocab_size=V, cutoff=(40, 80, V), embed_dim=32, ffn_dim=64,
              num_heads=4, num_layers=2, kernel_sizes=(3, 5), head_kernel=5,
              max_positions=64, dropout=0.1, tie_adaptive_proj=True)
    arrays = _arrays(2)
    arrays["article_ids"] = np.random.RandomState(0).randint(
        3, V, (B, S)).astype(np.int32)
    arrays["template_label"] = np.ones((B, 2), np.float32)
    batch = _batch_t(arrays)
    out = []
    for remat in (False, True):
        model = tgnc.TGNC(device="cpu", remat=remat,
                          generator=torch.Generator().manual_seed(0), **kw)
        out.append(_loss_and_grads(
            model, dict(model.param_module.named_parameters()),
            lambda g: model.loss_fn(batch, g)[0]))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for k in g0:
        np.testing.assert_allclose(g1[k].numpy(), g0[k].numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_remat_gen2_is_bit_identical():
    kw = dict(vocab_size=V, d_model=16, d_ff=32, num_heads=4, num_layers=2,
              img_dim=48, sent_dim=32, dropout_rate=0.1, max_len=32)
    batch = _batch_t(_arrays(3))
    out = []
    for remat in (False, True):
        model = gen2.gen2_transformer(
            device="cpu", remat=remat,
            generator=torch.Generator().manual_seed(0), **kw)
        out.append(_loss_and_grads(
            model, dict(model.param_module.named_parameters()),
            lambda g: model.loss_fn(batch, g)[0]))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


# -- the decode route ---------------------------------------------------------

FLAGSHIP_YAML = str(REPO / "configs" / "goodnews_transformer_roberta.yaml")


def _flagship(over=None):
    cfg = config.load_config(FLAGSHIP_YAML)
    if over:
        cfg = config.merge_overrides(cfg, {"model": {"decoder": over}})
    return cfg


@pytest.mark.parametrize("name,fused", [("A", False), ("B", True),
                                        ("flagship", True)])
def test_route_follows_the_configuration(name, fused):
    """A CUDA-typed (bf16) model on the meta device: the layers'
    predicates and the decode weights they build."""
    over = None if name == "flagship" else SETS[name]
    model = config.build_model(_flagship(over), "meta", torch.bfloat16)
    for layer in model.decoder.layers:
        assert layer.fused_decode_ok() is fused
        assert layer.fused_ffn_ok() is (name != "A")
    w = model.decoder.decode_weights()
    for lw in w.layers:
        assert (lw.conv_w1 is not None) is fused
        assert (lw.ffn_w1 is not None) is (name != "A")
        assert lw.context_w.device.type == "meta"


# Wrapper calls a greedy step (band / attention / conv / FFN) at the
# small model's 2 layers: set A takes the plain step, B and C the kernels.
PER_STEP = {"A": (3, 4, 0, 0), "B": (3, 4, 2, 2), "C": (3, 4, 2, 2)}


def test_kernel_wrappers_called_per_step(pair, monkeypatch):
    """Calls of the four decode wrappers a greedy step on the CPU, where
    each takes its plain twin: band / attention / conv / FFN."""
    from news_image_caption_tpu_torch.ops import attention
    calls = {"band": 0, "attn": 0, "conv": 0, "ffn": 0}

    def counting(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(adaptive, "band_topk_lse",
                        counting("band", adaptive.band_topk_lse))
    monkeypatch.setattr(attention, "decode_cross_attention",
                        counting("attn", attention.decode_cross_attention))
    monkeypatch.setattr(port_decoder, "decode_conv_block",
                        counting("conv", port_decoder.decode_conv_block))
    monkeypatch.setattr(port_decoder, "decode_ffn_block",
                        counting("ffn", port_decoder.decode_ffn_block))
    steps = 4
    toks, _ = pair["model"].generate(
        pair["tbatch"], GenerationConfig(max_len=steps, early_exit=False))
    assert tuple(calls.values()) == tuple(c * steps
                                          for c in PER_STEP[pair["name"]])


# -- configurations -----------------------------------------------------------

def _jax_shapes(cfg):
    model = jax_config.build_model(cfg)
    ds = jax_config.build_dataset(cfg, "test")
    ex = ds.collate([ds[0]])
    sample = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
              for k, v in ex.items()}
    return jax.eval_shape(model.init, jax.random.PRNGKey(0), sample)


@pytest.mark.parametrize("name", sorted(SETS))
def test_flagship_with_options_builds_at_full_width(name):
    cfg = _flagship(SETS[name])
    model = config.build_model(cfg, "meta")
    shapes = _jax_shapes(cfg)
    tree = jax.tree.map(lambda s: np.lib.stride_tricks.as_strided(
        np.zeros(1, np.float32), s.shape, (0,) * len(s.shape)), shapes)
    params_from_jax(tree, model.decoder)      # strict: names and shapes
    want = {torch_key(k): str(v.dtype) for k, v in
            flatten_dict(shapes["params"], sep="/").items()}
    for k, p in model.decoder.named_parameters():
        assert str(p.dtype).split(".")[-1] == want[k], k


def _fields(cls):
    return {f.name: f for f in dataclasses.fields(cls)
            if f.name not in ("parent", "name")}


@pytest.mark.parametrize("cls,mtype", [
    (JaxDecoder, "transformer_flattened"),
    (jax_tgnc.TemplateGuidedDecoder, "tgnc"),
    (jax_gen2.Gen2Transformer, "gen2_transformer"),
    (jax_lstm.LSTMDecoder, "lstm_flattened")],
    ids=["flattened", "tgnc", "gen2", "lstm"])
def test_every_reference_decoder_field_builds(cls, mtype):
    """Each field of the reference's dataclass, set to a value other
    than its default where it has a boolean or float one, builds in the
    port from a YAML model block (narrow widths, the meta device)."""
    values = dict(vocab_size=V, cutoff=[40, 80, V], embed_dim=32,
                  ffn_dim=64, num_heads=4, num_layers=2, kernel_sizes=[3, 5],
                  image_dim=16, article_dim=12, hidden_size=32, d_model=16,
                  d_ff=32, img_dim=16, sent_dim=12, max_len=32,
                  max_positions=64, conv_dim=16, extra_contexts=[["faces", 8]],
                  conv_type="lightweight", param_dtype="bfloat16",
                  dtype="float32", head_kernel=5, n_templates=2)
    block = {"type": mtype}
    for fname, f in _fields(cls).items():
        if fname in values:
            block[fname] = values[fname]
        elif isinstance(f.default, bool):
            block[fname] = not f.default
        elif isinstance(f.default, float):
            block[fname] = 0.25
        else:
            block[fname] = f.default
    if mtype == "tgnc":
        block.update(use_template_decoder=True)
        for k in ("n_templates", "image_dim", "article_dim"):
            block.setdefault(k, values[k])
    if mtype == "transformer_flattened":
        block["normalize_before"] = True
    model = config.build_model({"model": block}, "meta")
    assert model is not None


# -- train, then evaluate -m best ---------------------------------------------

TINY = str(REPO / "configs" / "tiny_test.yaml")
# C's bf16 parameters take updates from gradients that differ from the
# reference's by the rounding of its bf16 weight-norm backward (bounded
# in test_loss_and_gradients_match), so its losses drift by ~3e-5 over
# the 8 steps while its updates are optax's operation for operation.
LOSS_RTOL = {"A": 1e-5, "B": 1e-5, "C": 1e-4}
ZERO_DROPS = dict(dropout=0.0, weight_dropout=0.0, relu_dropout=0.0,
                  input_dropout=0.0, attention_dropout=0.0)


def _overrides(name, out):
    dec = dict(SETS[name], **ZERO_DROPS)
    if "adaptive_softmax_dropout" in dec:
        dec["adaptive_softmax_dropout"] = 0.0
    return json.dumps({
        "model": {"decoder": dec},
        "dataset": {"train": {"size": 16}},
        "trainer": {"serialization_dir": str(out), "log_every": 2}})


def _records(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Per set, (reference dir, port dir): each package's train, then
    evaluate -m best from its own checkpoints, the port's train from
    the reference's PRNGKey(0) init."""
    runs = {}
    for name in sorted(SETS):
        ref = tmp_path_factory.mktemp(f"reference_{name}")
        port = tmp_path_factory.mktemp(f"port_{name}")
        over = _overrides(name, ref)
        assert jax_cli.main(["train", TINY, "--platform", "cpu", "-o",
                             over]) == 0
        assert jax_cli.main(["evaluate", TINY, "--platform", "cpu", "-o",
                             over, "-m", "best"]) == 0
        over = _overrides(name, port)
        jcfg = jax_config.load_config(TINY, over)
        sample = next(jax_config.build_dataset(jcfg, "train").batches(4))
        params = jax_config.build_model(jcfg).init(jax.random.PRNGKey(0),
                                                   sample)
        model = config.build_model(config.load_config(TINY, over), "cpu")
        model.decoder.load_state_dict(params_from_jax(_np(params),
                                                      model.decoder))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(cli, "training_model", lambda cfg, device, seed:
                       model)
            assert cli.main(["train", TINY, "--platform", "cpu", "-o",
                             over]) == 0
        assert cli.main(["evaluate", TINY, "--platform", "cpu", "-o", over,
                         "-m", "best"]) == 0
        runs[name] = (ref, port)
    return runs


@pytest.mark.parametrize("name", sorted(SETS))
def test_train_metrics_match_reference(cli_runs, name):
    ref, port = cli_runs[name]
    want = _records(ref / "metrics.jsonl")
    got = _records(port / "metrics.jsonl")
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k, v in w.items():
            if k == "loss":
                np.testing.assert_allclose(g[k], v, rtol=LOSS_RTOL[name])
            elif k != "input_wait":
                assert g[k] == v, k


@pytest.mark.parametrize("file", ["generations.jsonl",
                                  "evaluate-metrics.json"])
@pytest.mark.parametrize("name", sorted(SETS))
def test_evaluate_best_files_are_byte_equal(cli_runs, name, file):
    ref, port = cli_runs[name]
    assert (port / file).read_bytes() == (ref / file).read_bytes()
