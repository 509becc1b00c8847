"""The port's online pipeline (`models/roberta.py`, `models/resnet.py`,
`models/pipeline.py`, the masked optimizer) against the JAX reference's,
on the CPU.

Narrow widths, as the reference's `tests/test_frozen_optim.py` builds
them: ResNet-18 and ResNet-50 trunks, a 2-layer RoBERTa 16 or 32 wide, a
1-layer decoder 16 wide. The inputs come from numpy seeds, the weights
from the JAX init (PRNGKey(0)) carried across by `params_from_jax`, and
every JAX call is jitted (`jax_default_matmul_precision` highest, from
the conftest). At fp32 the two must agree on:

- `position_ids_from_tokens` exactly;
- the RoBERTa's last hidden and all L + 1 hiddens on padded articles,
  and the weighted sum, within 1e-5 (fp32 weights over bf16 hiddens
  give fp32 in both);
- the ResNet's patches (BasicBlock and Bottleneck, 3 and 4 stages, odd
  sides) within 1e-4 of their scale, in the reference's row-major
  (H, W) order;
- `preprocess_image` within 1e-6 (center crops) and 1e-5 (the bilinear
  resize of a side under 224);
- the pipeline's loss within 1e-5 and the gradients of the decoder and
  `bert_weight` within rtol 5e-4 / atol 5e-5 (tests/test_torch_train.py's)
  with `weigh_bert` on and off; the encoders get none;
- greedy and beam-3 tokens exactly;
- the masked BertAdam over 5 updates against `optax.masked` within 1e-6,
  the frozen leaves bit-equal and without moments, and a JAX masked state
  resumed through `state_from_jax`;
- the HuggingFace and torchvision state-dict loaders against
  `port_hf_roberta` / `port_torch_resnet` then `params_from_jax`,
  exactly, on synthetic state dicts.
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402

from news_image_caption_tpu.generation.generator import \
    GenerationConfig as JaxGenerationConfig  # noqa: E402
from news_image_caption_tpu.models import pipeline as jax_pipeline  # noqa: E402
from news_image_caption_tpu.models import resnet as jax_resnet  # noqa: E402
from news_image_caption_tpu.models import roberta as jax_roberta  # noqa: E402
from news_image_caption_tpu.training import optim as jax_optim  # noqa: E402
from news_image_caption_tpu_torch import config  # noqa: E402
from news_image_caption_tpu_torch.generation.generator import \
    GenerationConfig  # noqa: E402
from news_image_caption_tpu_torch.models import resnet, roberta  # noqa: E402
from news_image_caption_tpu_torch.models.from_jax import (  # noqa: E402
    params_from_jax, state_from_jax)
from news_image_caption_tpu_torch.models.pipeline import \
    Gen3Pipeline  # noqa: E402
from news_image_caption_tpu_torch.training.optim import (  # noqa: E402
    make_bert_adam, mask_frozen)
from news_image_caption_tpu_torch.training.train_step import (  # noqa: E402
    create_train_state, make_train_step)

REPO = Path(__file__).resolve().parent.parent
ROBERTA = dict(vocab_size=40, hidden=16, num_layers=2, heads=4,
               intermediate=32, max_positions=24)
DECODER = dict(vocab_size=40, cutoff=(12, 24, 40), embed_dim=16, ffn_dim=32,
               num_heads=4, num_layers=1, kernel_sizes=(3,), image_dim=256,
               article_dim=16, max_positions=64)
RESNET = dict(depth=18, num_stages=3)
B, MAX_LEN, BEAM = 2, 8, 3
CONFIGS = ["configs/goodnews/transformer_weighted_roberta.yaml",
           "configs/nytimes/transformer_weighted_roberta.yaml"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _article_ids(rng, lengths, S=8, vocab=40):
    return np.where(np.arange(S)[None] < np.asarray(lengths)[:, None],
                    rng.randint(4, vocab, (len(lengths), S)), 1
                    ).astype(np.int32)


def _batch(seed=0, uint8=False):
    rng = np.random.RandomState(seed)
    image = (rng.randint(0, 256, (B, 40, 48, 3)).astype(np.uint8) if uint8
             else rng.rand(B, 64, 64, 3).astype(np.float32))
    return {"image": image, "article_ids": _article_ids(rng, [8, 5]),
            "caption_ids": rng.randint(4, 40, (B, 7)).astype(np.int32)}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=[True, False],
                ids=["weigh_bert", "last_layer"])
def pair(request):
    """The tiny pipeline in both packages with the same weights."""
    weigh_bert = request.param
    jmodel = jax_pipeline.Gen3Pipeline(
        resnet=jax_resnet.ResNetTrunk(**RESNET), roberta=dict(ROBERTA),
        weigh_bert=weigh_bert, **DECODER)
    batch = _batch()
    variables = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()})
    model = Gen3Pipeline(resnet=dict(RESNET), roberta=dict(ROBERTA),
                         weigh_bert=weigh_bert, device="cpu",
                         dtype=torch.float32, **DECODER)
    model.load_state_dict(params_from_jax(_np(variables), model))
    return {"jmodel": jmodel, "variables": variables, "model": model,
            "batch": batch, "weigh_bert": weigh_bert}


# -- the pieces ---------------------------------------------------------------

def test_copied_constants_match_reference():
    np.testing.assert_array_equal(resnet.IMAGENET_MEAN,
                                  jax_resnet.IMAGENET_MEAN)
    np.testing.assert_array_equal(resnet.IMAGENET_STD, jax_resnet.IMAGENET_STD)
    assert resnet.DEPTHS == jax_resnet.DEPTHS


@pytest.mark.parametrize("padding_idx", [1, 0])
def test_position_ids_match_reference(padding_idx):
    rng = np.random.RandomState(3)
    ids = np.where(rng.rand(4, 10) < 0.3, padding_idx,
                   rng.randint(2, 40, (4, 10))).astype(np.int32)
    ids[0] = padding_idx                       # all padding
    want = jax.jit(jax_roberta.position_ids_from_tokens,
                   static_argnums=1)(jnp.asarray(ids), padding_idx)
    got = roberta.position_ids_from_tokens(torch.from_numpy(ids), padding_idx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _carried(col, variables, module):
    """`module`'s state dict from the JAX `col` collection's variables,
    through `params_from_jax`'s mapping of that collection."""
    holder = torch.nn.ModuleDict({col: module})
    return {k[len(col) + 1:]: v for k, v in params_from_jax(
        {col: _np(variables["params"])}, holder).items()}


def _roberta_pair(hidden=32, heads=4):
    kw = dict(ROBERTA, hidden=hidden, heads=heads, intermediate=2 * hidden)
    jenc = jax_roberta.RobertaEncoder(**kw)
    rng = np.random.RandomState(1)
    ids = _article_ids(rng, [12, 7, 1], S=12)
    variables = jax.jit(jenc.init)(jax.random.PRNGKey(0), jnp.asarray(ids))
    enc = roberta.RobertaEncoder(**kw, device="cpu", dtype=torch.float32)
    enc.load_state_dict(_carried("roberta", variables, enc))
    return jenc, variables, enc, ids


@pytest.mark.parametrize("hidden,heads", [(16, 2), (32, 4)])
def test_roberta_hiddens_match_reference(hidden, heads):
    jenc, variables, enc, ids = _roberta_pair(hidden, heads)
    want_last, want = jax.jit(jenc.apply)(variables, jnp.asarray(ids))
    with torch.no_grad():
        last, got = enc(torch.from_numpy(ids))
    assert len(got) == len(want) == ROBERTA["num_layers"] + 1
    np.testing.assert_allclose(last.numpy(), np.asarray(want_last),
                               rtol=1e-5, atol=1e-5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("hidden_dtype", ["float32", "bfloat16"])
def test_weighted_sum_matches_reference(hidden_dtype):
    rng = np.random.RandomState(2)
    hiddens = [rng.randn(3, 5, 16).astype(np.float32) for _ in range(4)]
    jws = jax_roberta.WeightedSumFeatures(num_layers=4)
    jh = tuple(jnp.asarray(h, hidden_dtype) for h in hiddens)
    variables = jws.init(jax.random.PRNGKey(0), jh)
    want = jax.jit(jws.apply)(variables, jh)
    ws = roberta.WeightedSumFeatures(4, device="cpu", dtype=torch.float32)
    ws.bert_weight.data.copy_(torch.from_numpy(
        np.array(variables["params"]["bert_weight"])))
    th = tuple(torch.from_numpy(h).to(getattr(torch, hidden_dtype))
               for h in hiddens)
    with torch.no_grad():
        got = ws(th)
    assert str(want.dtype) == "float32" and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("depth,num_stages", [(18, 3), (18, 4), (50, 3),
                                              (50, 4)])
def test_resnet_patches_match_reference(depth, num_stages):
    """Odd sides (37 x 45) so that every stride-2 layer meets an odd
    input: flax's SAME 1x1 and explicit 3x3 / 7x7 padding, the max
    pool's -inf."""
    jtrunk = jax_resnet.ResNetTrunk(depth=depth, num_stages=num_stages)
    x = np.random.RandomState(4).randn(2, 37, 45, 3).astype(np.float32)
    variables = jax.jit(jtrunk.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    want = jax.jit(lambda v, a: jtrunk.apply(
        v, a, method=jax_resnet.ResNetTrunk.patches))(variables,
                                                      jnp.asarray(x))
    trunk = resnet.ResNetTrunk(depth, num_stages, device="cpu",
                               dtype=torch.float32)
    trunk.load_state_dict(_carried("resnet", variables, trunk))
    with torch.no_grad():
        got = trunk.patches(torch.from_numpy(x))
        grid = trunk(torch.from_numpy(x))
    assert got.shape == want.shape == (2, grid.shape[1] * grid.shape[2],
                                       trunk.out_channels)
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4 * scale)
    # Row-major over (H, W): patch i * W + j is the grid's (i, j).
    H, W = grid.shape[1:3]
    np.testing.assert_array_equal(got[:, (H - 1) * W].numpy(),
                                  grid[:, H - 1, 0].numpy())


@pytest.mark.parametrize("shape", [(224, 224), (1, 256, 300), (2, 231, 224),
                                   (1, 100, 150), (2, 180, 256), (60, 70)],
                         ids=["hwc_224", "crop", "crop_odd", "resize",
                              "resize_one_side", "hwc_resize"])
def test_preprocess_image_matches_reference(shape):
    img = np.random.RandomState(5).randint(0, 256, shape + (3,)
                                           ).astype(np.uint8)
    want = jax.jit(jax_resnet.preprocess_image)(jnp.asarray(img))
    got = resnet.preprocess_image(torch.from_numpy(img))
    assert got.shape == want.shape and got.shape[1:3] == (224, 224)
    resized = min(shape[-2:]) < 224
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5 if resized else 1e-6,
                               atol=1e-5 if resized else 1e-6)


def test_preprocess_random_crop_draws_from_the_generator():
    img = torch.from_numpy(np.random.RandomState(6).randint(
        0, 256, (1, 240, 250, 3)).astype(np.uint8))
    full = resnet.preprocess_image(img, crop=240)[:, :, :250]
    crops = [resnet.preprocess_image(
        img, random_crop=True, generator=torch.Generator().manual_seed(seed))
        for seed in (0, 0, 1)]
    assert torch.equal(crops[0], crops[1])
    found = []
    for c in crops:
        hits = [(t, l) for t in range(17) for l in range(27)
                if torch.equal(full[:, t:t + 224, l:l + 224], c)]
        assert len(hits) == 1
        found.append(hits[0])
    assert found[0] != found[2]
    assert torch.equal(resnet.preprocess_image(img, random_crop=True),
                       resnet.preprocess_image(img))   # no generator: center


# -- the pipeline -------------------------------------------------------------

def test_encode_matches_reference(pair):
    jm, v = pair["jmodel"], pair["variables"]
    batch = pair["batch"]
    want = jax.jit(jm.encode)(v, {k: jnp.asarray(x) for k, x in batch.items()})
    with torch.no_grad():
        got = pair["model"].encode(_t(batch))
    assert set(got) == set(want)
    for k in ("image_mask", "article_mask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert got["image"].shape == (B, 16, 256)
    for k in ("image", "article"):
        scale = max(1.0, float(np.abs(np.asarray(want[k])).max()))
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5 * scale, err_msg=k)


def test_loss_and_gradients_match_reference(pair):
    jm, v, model = pair["jmodel"], pair["variables"], pair["model"]
    jb = {k: jnp.asarray(x) for k, x in pair["batch"].items()}
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, jb), has_aux=True))(v)
    model.zero_grad(set_to_none=True)
    loss, aux = model.loss_fn(_t(pair["batch"]))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert aux["sample_size"].item() == int(jaux["sample_size"])
    want = params_from_jax(_np({k: jgrads[k] for k in jgrads}), model)
    got = {k: p.grad for k, p in model.named_parameters()}
    trained = [k for k in got if k.split(".")[0] in ("decoder",
                                                     "weighted_sum")]
    assert ("weighted_sum.bert_weight" in trained) == pair["weigh_bert"]
    for k, g in got.items():
        if k in trained:
            np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=5e-4,
                                       atol=5e-5, err_msg=k)
        else:   # the frozen encoders: no gradient in either package
            assert g is None and not bool(want[k].any()), k
    if pair["weigh_bert"]:
        assert float(got["weighted_sum.bert_weight"].abs().max()) > 0
    model.zero_grad(set_to_none=True)


def test_greedy_tokens_match_reference(pair):
    """From raw uint8 images (resized to 224, normalized in both)."""
    jm, v, model = pair["jmodel"], pair["variables"], pair["model"]
    batch = _batch(seed=7, uint8=True)
    want, want_lp = jax.jit(lambda p, b: jm.generate(
        p, b, JaxGenerationConfig(max_len=MAX_LEN)))(
            v, {k: jnp.asarray(x) for k, x in batch.items()})
    got, got_lp = model.generate(_t(batch), GenerationConfig(max_len=MAX_LEN))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp), rtol=1e-5,
                               atol=1e-5)


def test_beam_tokens_match_reference(pair):
    jm, v, model = pair["jmodel"], pair["variables"], pair["model"]
    cfg = dict(beam_size=BEAM, max_len=MAX_LEN)
    want, want_scores = jax.jit(lambda p, b: jm.generate_beam(
        p, b, JaxGenerationConfig(**cfg)))(
            v, {k: jnp.asarray(x) for k, x in pair["batch"].items()})
    got, scores = model.generate_beam(_t(pair["batch"]),
                                      GenerationConfig(**cfg))
    assert got.shape == (B, BEAM, MAX_LEN + 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores),
                               rtol=2e-4, atol=2e-4)


def test_weigh_bert_without_weighted_sum_raises(pair):
    if not pair["weigh_bert"]:
        assert pair["model"].weighted_sum is None
        return
    model = pair["model"]
    kept, model.weighted_sum = model.weighted_sum, None
    try:
        with pytest.raises(KeyError, match="weighted_sum"):
            model.encode(_t(pair["batch"]))
    finally:
        model.weighted_sum = kept


def test_load_npz_carries_the_pipeline(pair, tmp_path):
    """The reference server's '/'-joined .npz of the four collections
    reads back through `load_npz` into the same state dict."""
    from flax.traverse_util import flatten_dict

    from news_image_caption_tpu_torch.models.from_jax import load_npz
    flat = flatten_dict(_np(pair["variables"]), sep="/")
    np.savez(tmp_path / "pipe.npz", **flat)
    got = params_from_jax(load_npz(str(tmp_path / "pipe.npz")), pair["model"])
    for k, v in pair["model"].state_dict().items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("block,key", [
    (None, "image_encoder"), ("resnet", "width"), ("roberta", "layers")])
def test_unknown_pipeline_keys_raise(block, key):
    cfg = config.load_config(str(REPO / CONFIGS[0]))
    model = cfg["model"]
    (model if block is None else model.setdefault(block, {}))[key] = 1
    with pytest.raises(TypeError, match=rf"gen3_pipeline: unknown .*{key}"):
        config.build_model(cfg, "meta")


@pytest.mark.parametrize("key", ["ring", "pipe"])
def test_multi_device_encoders_raise_naming_item_11(key):
    """The multi-device encoders were ported with ROADMAP Queue 1 item 11
    and no longer raise: a model built for its layout (the meta device)
    takes `roberta.ring` / `roberta.pipe` and joins no process group;
    `pipe` with `weigh_bert` raises as the reference's does
    (tests/test_torch_ring_pipe.py runs both forms on gloo ranks)."""
    import torch.distributed as dist
    model = Gen3Pipeline(roberta=dict(ROBERTA, **{key: {"data": 1}}),
                         device="meta", dtype=torch.float32, **DECODER)
    assert model.roberta.ring_mesh is None and model.roberta_pipe is None
    assert not dist.is_initialized()
    if key == "pipe":
        with pytest.raises(ValueError, match="weigh_bert"):
            Gen3Pipeline(roberta=dict(ROBERTA, pipe={"data": 1}),
                         weigh_bert=True, device="meta",
                         dtype=torch.float32, **DECODER)


# -- the masked optimizer -----------------------------------------------------

def _grads(variables, seed):
    """Random gradients of the trainable leaves, zeros for the frozen
    encoders (which get none)."""
    rng = np.random.RandomState(seed)
    return {col: jax.tree.map(
        lambda x: (np.zeros(x.shape, np.float32) if col in ("resnet",
                                                            "roberta")
                   else rng.randn(*x.shape).astype(np.float32) * 0.1),
        tree) for col, tree in _np(variables).items()}


def test_masked_bert_adam_matches_optax_masked():
    """5 updates of BertAdam with weight decay: the trainable parameters
    within 1e-6 of optax's, the frozen ones bit-equal and holding no
    moments; then JAX's masked state carried in by `state_from_jax` and
    one more update in each."""
    jm = jax_pipeline.Gen3Pipeline(
        resnet=jax_resnet.ResNetTrunk(**RESNET), roberta=dict(ROBERTA),
        weigh_bert=True, **DECODER)
    batch = _batch()
    variables = jax.jit(jm.init)(
        jax.random.PRNGKey(0), {k: jnp.asarray(x) for k, x in batch.items()})
    jtx = jax_optim.mask_frozen(jax_optim.make_bert_adam(
        1e-2, 100, warmup=0.1, weight_decay=1e-2), jm.frozen_collections)
    model = Gen3Pipeline(resnet=dict(RESNET), roberta=dict(ROBERTA),
                         weigh_bert=True, device="cpu", dtype=torch.float32,
                         **DECODER)
    model.load_state_dict(params_from_jax(_np(variables), model))
    tx = mask_frozen(make_bert_adam(1e-2, 100, warmup=0.1, weight_decay=1e-2),
                     model.frozen_collections)
    state = create_train_state(model, tx)
    assert all(n.split(".")[0] in ("decoder", "weighted_sum")
               for n in state.trainable)
    assert set(state.state_dict()["opt_state"]["mu"]) == set(state.trainable)
    before = {k: v.clone() for k, v in state.params.items()}

    @jax.jit
    def jstep(params, opt, grads):
        updates, opt = jtx.update(grads, opt, params)
        import optax
        return optax.apply_updates(params, updates), opt

    params, opt = variables, jtx.init(variables)
    for i in range(5):
        grads = _grads(variables, i)
        params, opt = jstep(params, opt, grads)
        flat = params_from_jax(grads, model)
        with torch.no_grad():
            tx.apply([flat[n] for n in state.trainable], state.opt_state,
                     [state.params[n] for n in state.trainable])
    want = params_from_jax(_np(params), model)
    for k, p in state.params.items():
        if k in state.trainable:
            np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
        else:
            assert torch.equal(p, before[k]) and torch.equal(p, want[k]), k
    assert not torch.equal(state.params["weighted_sum.bert_weight"],
                           before["weighted_sum.bert_weight"])

    # JAX's masked state resumed by the port.
    tree = {"step": 5, "params": _np(params),
            "opt_state": _np(serialization.to_state_dict(opt))}
    fresh = Gen3Pipeline(resnet=dict(RESNET), roberta=dict(ROBERTA),
                         weigh_bert=True, device="cpu", dtype=torch.float32,
                         **DECODER)
    resumed = state_from_jax(tree, create_train_state(fresh, tx))
    assert resumed.step == 5 and resumed.opt_state.count == 5
    grads = _grads(variables, 9)
    params, opt = jstep(params, opt, grads)
    flat = params_from_jax(grads, fresh)
    with torch.no_grad():
        tx.apply([flat[n] for n in resumed.trainable], resumed.opt_state,
                 [resumed.params[n] for n in resumed.trainable])
    want = params_from_jax(_np(params), fresh)
    for k, p in resumed.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_train_step_leaves_the_encoders_alone(precision):
    """Two train steps through the config's optimizer: the frozen
    encoders bit-equal (in the bf16 compute copy too), bert_weight and
    the decoder moved, no moments for the encoders."""
    model = Gen3Pipeline(resnet=dict(RESNET), roberta=dict(ROBERTA),
                         weigh_bert=True, device="cpu", dtype=torch.float32,
                         generator=torch.Generator().manual_seed(0), **DECODER)
    cfg = {"trainer": {"optimizer": {"type": "bert_adam", "lr": 1e-2,
                                     "t_total": 100, "warmup": 0.05,
                                     "weight_decay": 1e-2}}}
    tx = config.build_optimizer(cfg, model)
    compute = None
    if precision == "bf16":
        compute = Gen3Pipeline(resnet=dict(RESNET), roberta=dict(ROBERTA),
                               weigh_bert=True, device="cpu",
                               dtype=torch.bfloat16, **DECODER)
    state = create_train_state(model, tx, compute=compute)
    before = {k: v.detach().clone() for k, v in state.params.items()}
    net = compute or model
    step = make_train_step(net.loss_fn, tx, compute_dtype=(
        torch.bfloat16 if compute is not None else torch.float32))
    for seed in range(2):
        state, metrics = step(state, _t(_batch(seed)), seed)
        assert metrics["skipped"] == 0
        assert np.isfinite(metrics["loss"].item())
    frozen = [k for k in state.params if k.split(".")[0] in ("resnet",
                                                             "roberta")]
    assert len(frozen) == len(state.params) - len(state.trainable) > 0
    for k in frozen:
        assert torch.equal(state.params[k], before[k]), k
        if compute is not None:
            assert torch.equal(state.compute[k], before[k].bfloat16()), k
    assert set(state.state_dict()["opt_state"]["mu"]) == set(state.trainable)
    for k in ("weighted_sum.bert_weight", "decoder.layers.0.fc1.kernel"):
        assert not torch.equal(state.params[k], before[k]), k
    assert all(p.grad is None for p in net.parameters())


# -- the loaders --------------------------------------------------------------

def test_hf_roberta_loader_matches_reference():
    rng = np.random.RandomState(8)
    H, L, V, P, inter = 16, 2, 40, 24, 32

    def a(*shape):
        return rng.randn(*shape).astype(np.float32)

    sd = {"embeddings.word_embeddings.weight": a(V, H),
          "embeddings.position_embeddings.weight": a(P, H),
          "embeddings.token_type_embeddings.weight": a(1, H),
          "embeddings.LayerNorm.weight": a(H),
          "embeddings.LayerNorm.bias": a(H)}
    for i in range(L):
        base = f"encoder.layer.{i}"
        for name, (o, n) in {"attention.self.query": (H, H),
                             "attention.self.key": (H, H),
                             "attention.self.value": (H, H),
                             "attention.output.dense": (H, H),
                             "intermediate.dense": (inter, H),
                             "output.dense": (H, inter)}.items():
            sd[f"{base}.{name}.weight"] = a(o, n)
            sd[f"{base}.{name}.bias"] = a(o)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[f"{base}.{name}.weight"] = a(H)
            sd[f"{base}.{name}.bias"] = a(H)
    enc = roberta.RobertaEncoder(V, H, L, 4, inter, P, device="meta",
                                 dtype=torch.float32)
    want = _carried("roberta", jax_roberta.port_hf_roberta(sd, L), enc)
    for prefix in ("", "roberta."):
        got = roberta.state_from_hf({prefix + k: v for k, v in sd.items()},
                                    L)
        assert set(got) == set(want) == set(enc.state_dict())
        for k, w in want.items():
            assert torch.equal(got[k], w), k


@pytest.mark.parametrize("depth,num_stages", [(18, 4), (50, 3)])
def test_torchvision_resnet_loader_matches_reference(depth, num_stages):
    """A synthetic torchvision-layout state dict (fc head and
    num_batches_tracked included, as torchvision writes them)."""
    rng = np.random.RandomState(9)
    trunk = resnet.ResNetTrunk(depth, 4, device="meta", dtype=torch.float32)
    sd = {"fc.weight": rng.randn(10, trunk.out_channels).astype(np.float32),
          "fc.bias": np.zeros(10, np.float32)}
    for k, p in trunk.state_dict().items():
        parts = k.split(".")
        block = parts[0].replace("_", ".")
        mod, leaf = parts[-2], parts[-1]
        prefix = block if len(parts) == 3 else ""
        if mod == "downsample_conv":
            mod = "downsample.0"
        elif mod == "downsample_bn":
            mod = "downsample.1"
        tv = {"scale": "weight", "mean": "running_mean",
              "var": "running_var"}.get(leaf, leaf)
        name = ".".join(x for x in (prefix, mod, tv) if x)
        value = rng.randn(*p.shape).astype(np.float32)
        if tv == "running_var":
            value = np.abs(value) + 0.5
        sd[name] = value
        if tv == "running_var":
            sd[name.replace("running_var", "num_batches_tracked")] = \
                np.array(7)
    cut = resnet.ResNetTrunk(depth, num_stages, device="meta",
                             dtype=torch.float32)
    want = _carried("resnet", jax_resnet.port_torch_resnet(sd, depth,
                                                            num_stages), cut)
    got = resnet.state_from_torchvision(sd, depth, num_stages)
    assert set(got) == set(want) == set(cut.state_dict())
    for k, w in want.items():
        assert torch.equal(got[k], w), k


# -- the configs --------------------------------------------------------------

@pytest.mark.parametrize("path", CONFIGS)
def test_config_builds_the_full_pipeline(path):
    """Full width on the meta device: ResNet-152 with 4 stages (2048
    channels), RoBERTa-large with 25 weighted hiddens, the flagship's
    decoder; the encoders frozen and left out of the optimizer.
    (tests/test_torch_pointer_cli.py holds the names and shapes against
    JAX's `eval_shape` tree.)"""
    cfg = config.load_config(str(REPO / path))
    model = config.build_model(cfg, "meta")
    assert isinstance(model, Gen3Pipeline) and model.param_module is model
    assert (model.resnet.depth, model.resnet.num_stages,
            model.resnet.out_channels) == (152, 4, 2048)
    assert model.roberta.num_layers == 24 and model.weigh_bert
    assert model.weighted_sum.bert_weight.shape == (25,)
    assert model.decoder.embed_dim == 1024
    assert model.decoder.layers[0].context_names == ["image", "article"]
    frozen = {k for k, p in model.named_parameters() if not p.requires_grad}
    assert frozen == {k for k in dict(model.named_parameters())
                      if k.split(".")[0] in ("resnet", "roberta")}
    n_frozen = sum(p.numel() for p in model.parameters()
                   if not p.requires_grad)
    assert 410e6 < n_frozen < 420e6            # the reference's "415M"
    tx = config.build_optimizer(cfg, model)
    assert tx.frozen == ("resnet", "roberta")
    assert cfg["trainer"]["mixed_precision"] == "bf16"
    assert json.loads(json.dumps(cfg["dataset"]))["raw_image_size"] == 224
