"""The port's faces, faces-and-objects, GloVe and no-image captioners
against the JAX reference's `models/variants.py`, on the CPU.

Each variant is built at the reference tests' tiny widths (V=40, cutoff
(12, 24, 40), D=16, H=4, FFN=32, kernels (3, 5); image 12 and article 10
wide, faces 8 and objects 6 wide, the GloVe article at its 300), its
JAX init (PRNGKey(0)) carried into the port by `params_from_jax`. The
batch, from a seed with numpy, holds an item whose face rows are all
NaN and one whose object rows are, masked through each package's
`nan_to_mask` as the reference's server feeds them, so only the bias
and zero slots of those contexts are attendable. At fp32 the two must
agree on teacher-forced log-probs and the loss (1e-5), on every
gradient with the flash route on (JAX's Pallas kernel in interpret
mode) and off (rtol 5e-4, atol 5e-5, tests/test_torch_train.py's), on
greedy and beam-5 tokens exactly and on each context's attention maps
(1e-5).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from news_image_caption_tpu.generation.generator import \
    GenerationConfig as JaxGenerationConfig  # noqa: E402
from news_image_caption_tpu.models import \
    variants as jax_variants  # noqa: E402
from news_image_caption_tpu.models.decoder_flattened import \
    DynamicConvDecoder as JaxDecoder  # noqa: E402
from news_image_caption_tpu.training import optim as jax_optim  # noqa: E402
from news_image_caption_tpu.training import \
    train_step as jax_train_step  # noqa: E402
from news_image_caption_tpu_torch.generation.generator import \
    GenerationConfig  # noqa: E402
from news_image_caption_tpu_torch.models import variants  # noqa: E402
from news_image_caption_tpu_torch.models.from_jax import (  # noqa: E402
    params_from_jax, state_from_jax, torch_key)
from news_image_caption_tpu_torch.training.optim import \
    make_bert_adam  # noqa: E402
from news_image_caption_tpu_torch.training.train_step import \
    create_o2_train_state  # noqa: E402

TINY = dict(vocab_size=40, cutoff=(12, 24, 40), embed_dim=16, ffn_dim=32,
            num_heads=4, num_layers=2, kernel_sizes=(3, 5), image_dim=12,
            max_positions=64)
FACE_DIM, OBJ_DIM, ARTICLE_DIM = 8, 6, 10
# Each variant's own keywords; GloVe keeps its 300-wide article.
KINDS = {
    "transformer_faces": dict(face_dim=FACE_DIM, article_dim=ARTICLE_DIM),
    "transformer_faces_objects": dict(face_dim=FACE_DIM, obj_dim=OBJ_DIM,
                                      article_dim=ARTICLE_DIM),
    "transformer_glove": {},
    "transformer_no_image": dict(article_dim=ARTICLE_DIM),
}
CONTEXTS = {"transformer_faces": ["image", "article", "faces"],
            "transformer_faces_objects": ["image", "article", "faces", "obj"],
            "transformer_glove": ["image", "article"],
            "transformer_no_image": ["article"]}
B, T, P, S, N_FACES, N_OBJ = 3, 9, 4, 6, 3, 5
MAX_LEN, BEAM = 8, 5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny models: one intra-op thread, so that the suite's parallel
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _features(article_dim: int):
    """The batch's arrays: captions (item 0 right-padded), image,
    article (item 1 padded), and NaN-padded faces and objects: item 1
    has no face, item 2 no object, item 0 three of five objects."""
    rng = np.random.RandomState(0)
    caption = rng.randint(3, 40, size=(B, T)).astype(np.int32)
    caption[:, 0] = 0
    caption[0, -3:] = 1
    article_mask = np.zeros((B, S), bool)
    article_mask[1, -2:] = True
    faces = rng.randn(B, N_FACES, FACE_DIM).astype(np.float32)
    faces[1] = np.nan
    faces[2, 2, 3] = np.nan
    obj = rng.randn(B, N_OBJ, OBJ_DIM).astype(np.float32)
    obj[2] = np.nan
    obj[0, 3:] = np.nan
    return {"caption_ids": caption,
            "image": rng.randn(B, P, TINY["image_dim"]).astype(np.float32),
            "image_mask": np.zeros((B, P), bool),
            "article": rng.randn(B, S, article_dim).astype(np.float32),
            "article_mask": article_mask, "faces": faces, "obj": obj}


def _batches(kind: str, article_dim: int):
    """(JAX batch, port batch): the same arrays, NaN rows turned into
    masks by each package's `nan_to_mask`."""
    raw = _features(article_dim)
    jbatch = {k: jnp.asarray(v) for k, v in raw.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in raw.items()
              if k != "caption_ids"}
    for name in ("faces", "obj"):
        jbatch[name], jbatch[f"{name}_mask"] = jax_variants.nan_to_mask(
            jbatch[name])
        tbatch[name], tbatch[f"{name}_mask"] = variants.nan_to_mask(
            tbatch[name])
    if kind != "transformer_faces_objects":
        for d in (jbatch, tbatch):
            d.pop("obj"), d.pop("obj_mask")
    return jbatch, tbatch


def _build(kind: str, flash: bool = False):
    kw = dict(TINY, **KINDS[kind])
    jflags = dict(use_flash_train=True, flash_interpret=True) if flash else {}
    jmodel = getattr(jax_variants, kind)(**kw, **jflags)
    model = variants.VARIANTS[kind](device="cpu", dtype=torch.float32,
                                    use_flash_train=flash, **kw)
    return jmodel, model


@pytest.fixture(scope="module", params=sorted(KINDS))
def pair(request):
    kind = request.param
    jmodel, model = _build(kind)
    article_dim = KINDS[kind].get("article_dim", variants.GLOVE_DIM)
    jbatch, tbatch = _batches(kind, article_dim)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jbatch)
    model.decoder.load_state_dict(
        params_from_jax(jax.tree.map(np.asarray, params), model.decoder))
    model.decoder.eval()
    return dict(kind=kind, jmodel=jmodel, params=params, jbatch=jbatch,
                model=model, tbatch=tbatch,
                caption=np.array(jbatch["caption_ids"]))


def test_nan_to_mask_matches_reference():
    rng = np.random.RandomState(1)
    feats = rng.randn(3, 4, 5).astype(np.float32)
    feats[0, 1, 2] = np.nan
    feats[1] = np.nan
    feats[2, 3, :] = np.nan
    jf, jm = jax_variants.nan_to_mask(jnp.asarray(feats))
    tf, tm = variants.nan_to_mask(torch.from_numpy(feats))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert tm.tolist() == [[False, True, False, False], [True] * 4,
                           [False, False, False, True]]
    assert bool(torch.isfinite(tf).all())


def test_variants_follow_the_reference_defaults():
    assert (variants.FACE_DIM, variants.OBJ_DIM, variants.GLOVE_DIM) == (
        jax_variants.FACE_DIM, jax_variants.OBJ_DIM, jax_variants.GLOVE_DIM)
    assert set(variants.VARIANTS) == set(KINDS)
    D = 1024
    shapes = {}
    for kind in KINDS:
        dec = variants.VARIANTS[kind](device="meta",
                                      dtype=torch.float32).decoder
        sd = dec.state_dict()
        shapes[kind] = {k: tuple(v.shape) for k, v in sd.items()
                        if k.startswith("layers.0.") and "k_proj.kernel" in k}
        assert dec.layers[0].context_names == CONTEXTS[kind]
        assert tuple(sd["layers.0.context_fc.kernel"].shape) == (
            len(CONTEXTS[kind]) * D, D)
    assert shapes["transformer_faces"]["layers.0.faces_attn.k_proj.kernel"] \
        == (512, D)
    assert shapes["transformer_faces_objects"][
        "layers.0.obj_attn.k_proj.kernel"] == (2048, D)
    assert shapes["transformer_glove"][
        "layers.0.article_attn.k_proj.kernel"] == (300, D)
    assert "layers.0.image_attn.k_proj.kernel" not in \
        shapes["transformer_no_image"]


def test_log_prob_and_loss_match(pair):
    jm = pair["jmodel"]
    want = jax.jit(lambda p, ids, ctx: jm.decoder.apply(
        p, ids, ctx, method=JaxDecoder.log_prob))(
            pair["params"], pair["jbatch"]["caption_ids"],
            jm._contexts(pair["jbatch"]))
    caption = torch.from_numpy(pair["caption"]).long()
    with torch.no_grad():
        got = pair["model"].decoder.log_prob(caption, pair["tbatch"])
        loss, aux = pair["model"].loss_fn(
            dict(pair["tbatch"], caption_ids=caption))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    jloss, jaux = jax.jit(jm.loss_fn)(pair["params"], pair["jbatch"])
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(aux["loss_sum"].item(),
                               float(jaux["loss_sum"]), rtol=1e-5)
    assert aux["sample_size"].item() == int(jaux["sample_size"])


@pytest.mark.parametrize("kind,moved", [
    ("transformer_faces", ("faces",)),
    ("transformer_faces_objects", ("faces", "obj")),
    ("transformer_no_image", ("image",))])
def test_unread_rows_do_not_reach_the_loss(kind, moved):
    """Masked face and object rows may hold anything, and so may the
    image of the no-image variant."""
    model = variants.VARIANTS[kind](
        device="cpu", dtype=torch.float32,
        generator=torch.Generator().manual_seed(0), **TINY, **KINDS[kind])
    _, batch = _batches(kind, ARTICLE_DIM)
    batch["caption_ids"] = torch.from_numpy(_features(ARTICLE_DIM)[
        "caption_ids"]).long()
    other = dict(batch)
    for name in moved:
        mask = batch.get(f"{name}_mask")
        other[name] = (batch[name] + 50.0 if name == "image" else
                       batch[name].masked_fill(mask[..., None], 50.0))
    with torch.no_grad():
        a, _ = model.loss_fn(batch)
        b, _ = model.loss_fn(other)
    assert a.item() == b.item()


@pytest.mark.parametrize("flash", [False, True])
def test_gradients_match(pair, flash):
    kind = pair["kind"]
    jmodel, model = _build(kind, flash)
    model.decoder.load_state_dict(pair["model"].decoder.state_dict())
    jbatch = pair["jbatch"]
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, b, None), has_aux=True))(
            pair["params"], jbatch)
    loss, _ = model.loss_fn(dict(
        pair["tbatch"], caption_ids=torch.from_numpy(pair["caption"]).long()))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = {torch_key(k): np.asarray(v) for k, v in
            flatten_dict(jgrads["params"], sep="/").items()}
    got = {k: p.grad for k, p in model.decoder.named_parameters()}
    assert set(got) == set(want)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k], rtol=5e-4, atol=5e-5,
                                   err_msg=k)


def test_greedy_tokens_identical(pair):
    want, want_lp = pair["jmodel"].generate(
        pair["params"], pair["jbatch"], JaxGenerationConfig(max_len=MAX_LEN))
    got, got_lp = pair["model"].generate(pair["tbatch"],
                                         GenerationConfig(max_len=MAX_LEN))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp),
                               rtol=1e-5, atol=1e-5)


def test_beam5_tokens_identical(pair):
    cfg = dict(beam_size=BEAM, max_len=MAX_LEN)
    want, want_scores = pair["jmodel"].generate_beam(
        pair["params"], pair["jbatch"], JaxGenerationConfig(**cfg),
        impl="topk")
    got, scores = pair["model"].generate_beam(pair["tbatch"],
                                              GenerationConfig(**cfg))
    assert got.shape == (B, BEAM, MAX_LEN + 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores),
                               rtol=2e-4, atol=2e-4)


def test_attention_maps_match(pair):
    tokens, _ = pair["model"].generate(pair["tbatch"],
                                       GenerationConfig(max_len=MAX_LEN))
    want = pair["jmodel"].attention_maps(pair["params"], pair["jbatch"],
                                         jnp.asarray(tokens.numpy()))
    got = pair["model"].attention_maps(pair["tbatch"], tokens)
    assert len(got) == len(want) == TINY["num_layers"]
    for layer_got, layer_want in zip(got, want):
        assert list(layer_got) == CONTEXTS[pair["kind"]]
        assert set(layer_want) == set(layer_got)
        for name, arr in layer_got.items():
            np.testing.assert_allclose(arr.numpy(),
                                       np.asarray(layer_want[name]),
                                       rtol=1e-5, atol=1e-5, err_msg=name)
    # An item with no face attends its bias and zero slots only.
    if "faces" in got[0]:
        assert float(got[0]["faces"][1, :, :N_FACES].abs().max()) == 0.0


def test_state_from_jax_carries_a_variant_state(pair):
    """A JAX O2 train state of the variant carried into the port's, and
    strict on the variant's tree: a missing faces or article key, or a
    misshapen one, raises."""
    jstate = jax_train_step.create_o2_train_state(
        pair["params"], jax_optim.make_bert_adam(1e-3, 100))
    tree = jax.tree.map(np.asarray, serialization.to_state_dict(jstate))
    kind = pair["kind"]
    kw = dict(TINY, **KINDS[kind])

    def port_state():
        compute = variants.VARIANTS[kind](device="cpu", dtype=torch.bfloat16,
                                          **kw)
        return create_o2_train_state(compute.decoder,
                                     make_bert_adam(1e-3, 100),
                                     master=pair["model"].decoder)

    state = state_from_jax(tree, port_state())
    for k, w in flatten_dict(pair["params"]["params"], sep="/").items():
        np.testing.assert_array_equal(
            state.opt_state["master"][torch_key(k)].numpy(), np.asarray(w))
    name = CONTEXTS[kind][-1]
    layer = tree["params"]["params"]["layers_1"]
    kernel = layer[f"{name}_attn"]["k_proj"]["kernel"]
    del layer[f"{name}_attn"]["k_proj"]["kernel"]
    with pytest.raises(ValueError, match=rf"missing \['layers.1.{name}_attn"):
        state_from_jax(tree, port_state())
    layer[f"{name}_attn"]["k_proj"]["kernel"] = kernel.T
    with pytest.raises(ValueError, match="shape mismatch"):
        state_from_jax(tree, port_state())
