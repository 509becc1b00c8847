"""The port's ring attention and pipeline (`parallel/ring.py`,
`parallel/pipe.py`) and the RoBERTa encoder's ring and pipelined forms
against the JAX reference's, on gloo ranks on the CPU.

Two spawns, one a module fixture each (`tests/torch_parallel_workers.py`
holds the rank bodies): two ranks (ring attention on `context` 2, the
pipeline on `pipe` 2 with 1, 2 and 4 microbatches, both `Gen3Pipeline`
YAML forms, alone and under the eval step of a data-parallel mesh that
splits the encoder's partners, which raises, or keeps them together)
and four ranks (ring attention on `context` 4 and on `data`
2 x `context` 2 with a fully padded row, the pipeline on `data` 2 x
`pipe` 2, the raises, the ring and pipelined RoBERTa encoders). Each
rank computes on its slice (its rows along `data`, its sequence slice
along `context`, its stage's layers along `pipe`); the test puts the
slices together and holds them against JAX's on its virtual CPU
devices: ring attention within 1e-5 and its q / k / v gradients within
1e-4, the pipeline within 1e-6 and its layer and input gradients within
1e-5 (summed over the ranks that hold a share), the encoders and the
YAML forms within 2e-5. The inputs are numpy draws; the encoders'
weights JAX's PRNGKey(0) init carried across by `params_from_jax`.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_parallel_workers as workers  # noqa: E402
from news_image_caption_tpu.models import pipeline as jax_pipeline  # noqa: E402
from news_image_caption_tpu.models import resnet as jax_resnet  # noqa: E402
from news_image_caption_tpu.models import roberta as jax_roberta  # noqa: E402
from news_image_caption_tpu.parallel import pipe as jax_pipe  # noqa: E402
from news_image_caption_tpu.parallel import ring as jax_ring  # noqa: E402
from news_image_caption_tpu.parallel.mesh import (  # noqa: E402
    MeshConfig, make_mesh)
from news_image_caption_tpu_torch.models import roberta  # noqa: E402
from news_image_caption_tpu_torch.models.from_jax import \
    params_from_jax  # noqa: E402
from news_image_caption_tpu_torch.models.pipeline import \
    Gen3Pipeline  # noqa: E402
from news_image_caption_tpu_torch.parallel.mesh import \
    MeshConfig as TorchMeshConfig  # noqa: E402
from news_image_caption_tpu_torch.parallel.mesh import (  # noqa: E402
    check_rows_shared, mesh_layout)

ROBERTA = dict(vocab_size=64, hidden=32, num_layers=4, heads=4,
               intermediate=64, max_positions=40)
YAML_ROBERTA = dict(vocab_size=40, hidden=16, num_layers=2, heads=4,
                    intermediate=32, max_positions=24)
DECODER = dict(vocab_size=40, cutoff=(12, 24, 40), embed_dim=16, ffn_dim=32,
               num_heads=4, num_layers=1, kernel_sizes=(3,), image_dim=256,
               article_dim=16, max_positions=64)
RESNET = dict(depth=18, num_stages=3)
RING2 = [{"context": 2}]
RING4 = [{"context": 4}, {"data": 2, "context": 2}, {"data": 2, "context": 2}]
PIPE2 = [({"pipe": 2}, m) for m in (1, 2, 4)]
PIPE4 = [({"data": 2, "pipe": 2}, 2)]
RAISES = {"ring_no_axis": ("no axis", {"data": 4}),
          "ring_indivisible": ("not divisible", {"context": 4}),
          "pipe_no_axis": ("no axis", {"data": 4}),
          "pipe_layers": ("not divisible", {"pipe": 4}),
          "pipe_batch": ("not divisible", {"data": 2, "pipe": 2}),
          "pipe_microbatch": ("microbatch", {"data": 2, "pipe": 2})}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _ring_case(key, padded_row=False, B=2, S=16, H=4, D=8):
    rng = np.random.RandomState(key)
    q, k, v, w = (rng.randn(B, S, H, D).astype(np.float32) for _ in range(4))
    mask = np.ones((B, S), bool)
    # Row 0: the second half padded (on context 4 two ranks hold fully
    # masked key blocks); row 1: scattered pads.
    mask[0, S // 2:] = False
    mask[1, ::3] = False
    if padded_row:
        mask[0] = False
    return dict(q=q, k=k, v=v, mask=mask, w=w)


def _pipe_case(n_micro, key=3, L=4, B=8, T=6, D=16):
    rng = np.random.RandomState(key)
    layers = [{"w": (rng.randn(D, D) / np.sqrt(D)).astype(np.float32),
               "b": rng.randn(D).astype(np.float32)} for _ in range(L)]
    mask = np.ones((B, T), bool)
    mask[0, T // 2:] = False
    mask[1, ::2] = False
    return dict(layers=layers, x=rng.randn(B, T, D).astype(np.float32),
                mask=mask, w=rng.randn(B, T, D).astype(np.float32),
                n_micro=n_micro)


def _jax_ring(case, cfg):
    devices = jax.devices()[:int(np.prod(list(cfg.values())))]
    mesh = make_mesh(MeshConfig(**cfg), devices)
    q, k, v, w = (jnp.asarray(case[n]) for n in "qkvw")
    mask = jnp.asarray(case["mask"])

    def loss(q, k, v):
        out = jax_ring.ring_attention(q, k, v, mask, mesh)
        return jnp.sum(out * w), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _stage_fn(lp, carry):
    x = jnp.tanh(carry["x"] @ lp["w"] + lp["b"])
    x = jnp.where(carry["mask"][..., None], x, 0.0)
    return {"x": x, "mask": carry["mask"]}


def _jax_pipe(case, cfg):
    devices = jax.devices()[:int(np.prod(list(cfg.values())))]
    mesh = make_mesh(MeshConfig(**cfg), devices)
    mask = jnp.asarray(case["mask"])
    stacked = jax_pipe.stack_layers([jax.tree.map(jnp.asarray, lp)
                                     for lp in case["layers"]])

    def loss(stacked, x):
        out = jax_pipe.pipeline_apply(_stage_fn, stacked,
                                      {"x": x, "mask": mask}, mesh=mesh,
                                      n_micro=case["n_micro"])
        return jnp.sum(out["x"] * case["w"]), out["x"]

    (_, out), (g_stack, g_x) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(stacked, jnp.asarray(case["x"]))
    return np.asarray(out), _np(g_stack), np.asarray(g_x)


def _coords(cfg, r):
    """Rank r's (data, context or pipe) coordinates on a mesh of cfg."""
    inner = cfg.get("context", cfg.get("pipe", 1))
    return r // inner, r % inner


def _ids():
    ids = np.full((4, 16), 1, np.int32)
    rng = np.random.RandomState(0)
    for b, n in enumerate([16, 11, 16, 5]):     # ragged pads
        ids[b, :n] = rng.randint(4, 64, n)
    return ids


def _yaml_batch():
    rng = np.random.RandomState(1)
    ids = np.where(np.arange(8)[None] < [[8], [5], [8], [2]],
                   rng.randint(4, 40, (4, 8)), 1).astype(np.int32)
    return {"image": rng.rand(4, 64, 64, 3).astype(np.float32),
            "article_ids": ids,
            "caption_ids": rng.randint(4, 40, (4, 7)).astype(np.int32)}


@pytest.fixture(scope="module")
def encoders():
    """JAX's RoBERTa and pipeline inits, their port state dicts, and
    JAX's encoder outputs."""
    ids = _ids()
    jenc = jax_roberta.RobertaEncoder(**ROBERTA)
    variables = jax.jit(jenc.init)(jax.random.PRNGKey(0), jnp.asarray(ids))
    holder = torch.nn.ModuleDict({"roberta": roberta.RobertaEncoder(
        **ROBERTA, device="cpu", dtype=torch.float32)})
    state = {k[len("roberta."):]: v.numpy() for k, v in params_from_jax(
        {"roberta": _np(variables["params"])}, holder).items()}
    ring_mesh = make_mesh(MeshConfig(data=2, context=2), jax.devices()[:4])
    ring_last, ring_all = jax.jit(jax_roberta.RobertaEncoder(
        **ROBERTA, ring_mesh=ring_mesh).apply)(variables, jnp.asarray(ids))
    pipe_mesh = make_mesh(MeshConfig(data=2, pipe=2), jax.devices()[:4])
    # n_micro 2 is also the default on these rows (one row a microbatch
    # and data rank), in both packages.
    piped = np.asarray(jax.jit(lambda v, i: jenc.encode_pipelined(
        v, i, pipe_mesh))(variables, jnp.asarray(ids)))

    # The YAML forms are held to the reference's dense pipeline: the
    # reference's own tests hold its ring and pipe forms to it.
    batch = _yaml_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    dense = jax_pipeline.Gen3Pipeline(
        resnet=jax_resnet.ResNetTrunk(**RESNET), roberta=dict(YAML_ROBERTA),
        **DECODER)
    pvars = jax.jit(dense.init)(jax.random.PRNGKey(0), jbatch)
    model = Gen3Pipeline(resnet=dict(RESNET), roberta=dict(YAML_ROBERTA),
                         device="cpu", dtype=torch.float32, **DECODER)
    pstate = {k: v.numpy() for k, v in params_from_jax(_np(pvars),
                                                       model).items()}
    article = jax.jit(lambda v, b: dense.encode(v, b)["article"])(pvars,
                                                                  jbatch)
    loss = jax.jit(lambda v, b: dense.loss_fn(v, b)[0])(pvars, jbatch)
    yaml = (np.asarray(article), float(loss))
    return {"ids": ids, "roberta_state": state, "ring": np.asarray(ring_last),
            "ring_len": len(ring_all), "pipe": piped, "batch": batch,
            "pipeline_state": pstate, "yaml": yaml}


def _payload(ring_cfgs, pipe_cfgs, extra=None):
    ring = [(cfg, _ring_case(i, padded_row=i == 2))
            for i, cfg in enumerate(ring_cfgs)]
    pipe = [(cfg, _pipe_case(m)) for cfg, m in pipe_cfgs]
    return {"ring": ring, "pipe": pipe, **(extra or {})}


@pytest.fixture(scope="module")
def two(encoders, tmp_path_factory):
    payload = _payload(RING2, PIPE2, {
        "roberta_kw": YAML_ROBERTA, "resnet_kw": RESNET,
        "decoder_kw": DECODER, "batch": encoders["batch"],
        "pipeline_state": encoders["pipeline_state"],
        "ring_yaml": {"context": 2},
        "pipe_yaml": {"pipe": 2, "n_micro": 2},
        "row_meshes": {"ring": ({"data": 2}, {"data": 1, "context": 2}),
                       "pipe": ({"data": 2}, {"data": 1, "pipe": 2})}})
    return payload, workers.spawn(2, "ring_pipe", payload,
                                  tmp_path_factory.mktemp("two"))


@pytest.fixture(scope="module")
def four(encoders, tmp_path_factory):
    payload = _payload(RING4, PIPE4, {
        "raises": {n: cfg for n, (_, cfg) in RAISES.items()},
        "roberta_kw": ROBERTA, "roberta_state": encoders["roberta_state"],
        "ids": encoders["ids"],
        "encoders": ({"data": 2, "context": 2}, {"data": 2, "pipe": 2}, 2)})
    return payload, workers.spawn(4, "ring_pipe", payload,
                                  tmp_path_factory.mktemp("four"))


def _ring_check(payload, results, i):
    cfg, case = payload["ring"][i]
    want, want_grads = _jax_ring(case, cfg)
    B, S = case["mask"].shape
    d, c = cfg.get("data", 1), cfg["context"]
    got = np.zeros_like(want)
    grads = [np.zeros_like(want) for _ in range(3)]
    for r, res in enumerate(results):
        di, ci = _coords(cfg, r)
        at = (slice(di * B // d, (di + 1) * B // d),
              slice(ci * S // c, (ci + 1) * S // c))
        got[at] = res["ring"][i]["out"]
        for g, part in zip(grads, res["ring"][i]["grads"]):
            g[at] = part
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)


def test_ring_attention_context2_matches_jax(two):
    _ring_check(*two, 0)


@pytest.mark.parametrize("i", range(len(RING4)),
                         ids=["context4", "data2_context2",
                              "fully_padded_row"])
def test_ring_attention_four_ranks_matches_jax(four, i):
    _ring_check(*four, i)


def _pipe_check(payload, results, i):
    cfg, case = payload["pipe"][i]
    want, want_stack, want_x = _jax_pipe(case, cfg)
    B = case["x"].shape[0]
    d, P = cfg.get("data", 1), cfg["pipe"]
    got, gx = np.zeros_like(want), np.zeros_like(want_x)
    g_layers = [{k: np.zeros_like(v) for k, v in lp.items()}
                for lp in case["layers"]]
    for r, res in enumerate(results):
        di, _ = _coords(cfg, r)
        rows = slice(di * B // d, (di + 1) * B // d)
        part = res["pipe"][i]
        got[rows] = part["out"]
        assert part["mask"].dtype == np.int8
        np.testing.assert_array_equal(part["mask"], case["mask"][rows])
        gx[rows] += part["x_grad"]
        for lp, g in zip(g_layers, part["layer_grads"]):
            if g is not None:
                for k in lp:
                    lp[k] += g[k]
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(gx, want_x, atol=1e-5, rtol=1e-5)
    for j, lp in enumerate(g_layers):
        for k, g in lp.items():
            np.testing.assert_allclose(g, want_stack[k][j], atol=1e-5,
                                       rtol=1e-5, err_msg=f"layer {j} {k}")


@pytest.mark.parametrize("i", range(len(PIPE2)),
                         ids=[f"n_micro{m}" for _, m in PIPE2])
def test_pipeline_pipe2_matches_jax(two, i):
    _pipe_check(*two, i)


def test_pipeline_data2_pipe2_matches_jax(four):
    _pipe_check(*four, 0)


@pytest.mark.parametrize("name", list(RAISES))
def test_raises_as_the_reference(four, name):
    pattern = RAISES[name][0]
    for res in four[1]:
        assert pattern in res["errors"][name], res["errors"][name]


def test_reference_raises_the_same_messages(four):
    """The messages the port's raises share with the reference's own."""
    payload, results = four
    errors = results[0]["errors"]
    mesh = make_mesh(MeshConfig(data=4, model=2))
    case = _ring_case(0)
    with pytest.raises(ValueError) as e:
        jax_ring.ring_attention(*(jnp.asarray(case[n]) for n in "qkv"),
                                jnp.asarray(case["mask"]), mesh)
    assert str(e.value) == errors["ring_no_axis"]
    mesh = make_mesh(MeshConfig(data=2, model=1, pipe=4))
    layers = [jax.tree.map(jnp.asarray, lp)
              for lp in _pipe_case(2, L=3, D=2)["layers"]]
    with pytest.raises(ValueError) as e:
        jax_pipe.pipeline_apply(_stage_fn, jax_pipe.stack_layers(layers),
                                {"x": jnp.zeros((4, 3, 2)),
                                 "mask": jnp.ones((4, 3), bool)},
                                mesh=mesh, n_micro=2)
    assert str(e.value) == errors["pipe_layers"]


def test_ring_encoder_matches_jax(encoders, four):
    got = np.zeros_like(encoders["ring"])
    for r, res in enumerate(four[1]):
        last, n_hiddens = res["ring_encoder"]
        assert n_hiddens == encoders["ring_len"] == ROBERTA["num_layers"] + 1
        di, _ = _coords({"context": 2}, r)
        got[di * 2:(di + 1) * 2] = last
    np.testing.assert_allclose(got, encoders["ring"], atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("which", [0, 1], ids=["n_micro2", "default"])
def test_pipelined_encoder_matches_jax(encoders, four, which):
    want = encoders["pipe"]
    got = np.zeros_like(want)
    for r, res in enumerate(four[1]):
        di, _ = _coords({"pipe": 2}, r)
        got[di * 2:(di + 1) * 2] = res["pipe_encoder"][which]
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("form", ["ring", "pipe"])
def test_gen3_pipeline_yaml_forms_match_jax(encoders, two, form):
    """`roberta: {ring: {context: 2}}` and `{pipe: {pipe: 2, n_micro: 2}}`
    on two ranks against the reference's dense pipeline."""
    want, want_loss = encoders["yaml"]
    for res in two[1]:
        article, loss = res[form + "_yaml"]
        np.testing.assert_allclose(article, want, atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(loss, want_loss, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("form", ["ring", "pipe"])
def test_gen3_pipeline_rejects_partners_on_other_rows(two, form):
    """`trainer.mesh: {data: 2}` with `roberta.ring: {context: 2}` (or
    `pipe: {pipe: 2}`) on two ranks: each rank holds other rows, so the
    encoder's partners would mix two articles; every rank raises."""
    for res in two[1]:
        assert f"roberta.{form}" in res[form + "_apart"]
        assert "trainer.mesh" in res[form + "_apart"]


@pytest.mark.parametrize("form", ["ring", "pipe"])
def test_gen3_pipeline_under_a_matching_data_mesh_matches_jax(encoders,
                                                              two, form):
    """A data-parallel mesh with the encoder's axis ({data: 1, context:
    2} or {data: 1, pipe: 2}) keeps the partners on their rows: the eval
    step's loss is the reference's."""
    _, want_loss = encoders["yaml"]
    for res in two[1]:
        np.testing.assert_allclose(res[form + "_along"], want_loss,
                                   atol=2e-5, rtol=2e-5)


class _Layout:
    """A mesh's rank grid and axis names, as `DeviceMesh` gives them."""

    def __init__(self, cfg, n):
        shape, names = mesh_layout(TorchMeshConfig(**cfg), n)
        self.mesh = torch.arange(n).reshape(shape)
        self.mesh_dim_names = tuple(names)


@pytest.mark.parametrize("n,rows,enc,axis,ok", [
    (2, {"data": 2}, {"context": 2}, "context", False),
    (4, {"data": 4}, {"pipe": 2}, "pipe", False),
    (4, {"data": 2, "context": 2}, {"context": 2}, "context", True),
    (4, {"data": 2, "context": 2}, {"data": 2, "context": 2}, "context",
     True),
    (4, {"data": 2, "pipe": 2}, {"pipe": 2}, "pipe", True),
    (4, {"data": 2, "pipe": 2}, {"context": 2}, "context", True),
    (4, {"data": 1, "context": 4}, {"context": 2}, "context", True),
    (8, {"data": 2, "context": 4}, {"context": 2}, "context", True),
    (8, {"data": 4, "context": 2}, {"context": 4}, "context", False),
    (4, {"data": 4}, {"data": 4}, "context", True),
])
def test_check_rows_shared_layouts(n, rows, enc, axis, ok):
    """Partners of an encoder line must share their data coordinate on
    the data-parallel mesh, in the row-major layouts of both."""
    def check():
        check_rows_shared(_Layout(rows, n), _Layout(enc, n), axis,
                          "roberta")
    if ok:
        check()
    else:
        with pytest.raises(ValueError, match="trainer.mesh"):
            check()


def test_gen3_pipeline_pipe_rejects_weigh_bert():
    with pytest.raises(ValueError, match="weigh_bert"):
        Gen3Pipeline(roberta={**YAML_ROBERTA, "pipe": {"data": 2,
                                                       "pipe": 2}},
                     weigh_bert=True, resnet=dict(RESNET), device="meta",
                     dtype=torch.float32, **DECODER)


def test_workers_import_no_jax():
    """The spawned ranks re-import the worker module: it must not pull
    in JAX or the reference package."""
    text = Path(workers.__file__).read_text()
    assert "import jax" not in text and "news_image_caption_tpu." not in \
        text.replace("news_image_caption_tpu_torch", "")
