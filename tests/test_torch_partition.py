"""Tensor parallelism of the port (`parallel/partition.py` and the split
forms of `ops/linear.py`, `ops/attention.py`, `ops/adaptive.py`,
`ops/flash_attention.py`, `ops/decode_blocks.py`,
`models/decoder_flattened.py`, `training/`) against the JAX reference's
`parallel/partition.py`, on the CPU.

In one process: the rules give every parameter of the flagship (built
on the meta device) the split of its JAX leaf (`jax.eval_shape` of the
reference's model, names through `params_from_jax`'s map); the
flagship's 30265-row band refuses a `model` axis of 2 and 4 in both
packages; every kernel's plain twin in shard form, concatenated or
summed, equals the whole twin (the flash masks exactly the whole mask's
heads); the weight-norm fold of a row-split fc2 with the summed norm
equals the whole fold.

One spawn of four gloo ranks (`tests/torch_parallel_workers.py::
tensor_parallel`), at the reference tests' tiny widths (4 heads, FFN 32,
bands 12/12/16) with JAX's PRNGKey(0) init carried across: meshes
{data: 2, model: 2} and {data: 1, model: 4}, each held against JAX
unsharded and JAX sharded on four virtual devices with the reference's
tolerances (`tests/test_parallel.py`): the loss (rtol 2e-5), greedy,
beam-3 (tokens exact, scores rtol 1e-4, atol 1e-5), speculative, the
continuous engine and the beam engine, one greedy with int8 K/V and
head; the split is real (fc1 [D, F/m], H/m heads, the model group's
collectives called). Then the `train` command with `trainer.mesh:
{data: 2, model: 2}`: dropouts and flash on against the port's one
process (losses within 2e-5, `best.pt` with its keys and shapes, loaded
by `evaluate -m best` in one process), and dropouts off from JAX's init
against the reference's command on the same mesh (2e-5); resumed for
a third epoch against one process's uninterrupted run; into the
sharded store (a DCP file of slices a rank, read whole in one process,
evaluated byte-equal to the single file); and the pointer family's
command against its one process.
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

import torch_parallel_workers as workers  # noqa: E402
from news_image_caption_tpu import cli as jax_cli  # noqa: E402
from news_image_caption_tpu import config as jax_config  # noqa: E402
from news_image_caption_tpu.generation.continuous import (  # noqa: E402
    ContinuousBatcher as JaxBatcher, ContinuousBeamBatcher as JaxBeamBatcher)
from news_image_caption_tpu.generation.generator import \
    GenerationConfig as JaxGenerationConfig  # noqa: E402
from news_image_caption_tpu.models.captioner import \
    TransformerFlattened as JaxTransformerFlattened  # noqa: E402
from news_image_caption_tpu.parallel import mesh as jax_mesh  # noqa: E402
from news_image_caption_tpu.parallel.partition import (  # noqa: E402
    param_shardings, spec_for_path)
from news_image_caption_tpu.training.train_step import \
    shard_batch  # noqa: E402
from news_image_caption_tpu_torch import cli  # noqa: E402
from news_image_caption_tpu_torch.config import (build_model,  # noqa: E402
                                                 load_config)
from news_image_caption_tpu_torch.models.captioner import \
    TransformerFlattened  # noqa: E402
from news_image_caption_tpu_torch.models.from_jax import (  # noqa: E402
    params_from_jax, torch_key)
from news_image_caption_tpu_torch.ops import (band_topk,  # noqa: E402
                                              decode_attention, decode_blocks,
                                              flash_attention, linear)
from news_image_caption_tpu_torch.ops.adaptive import \
    merge_candidates  # noqa: E402
from news_image_caption_tpu_torch.parallel.mesh import MODEL_AXIS  # noqa: E402
from news_image_caption_tpu_torch.parallel.partition import (  # noqa: E402
    ModelShard, shard_params, spec_for_name, split_dim)

from tests.test_decoder import tiny_batch, tiny_decoder  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
TINY = str(REPO / "configs" / "tiny_test.yaml")
POINTER = str(REPO / "configs" / "tiny_pointer.yaml")
FLAGSHIP = REPO / "configs" / "goodnews_transformer_roberta.yaml"
MESHES = [{"data": 2, "model": 2}, {"data": 1, "model": 4}]
# The reference tests' tiny decoder (tests/test_decoder.py::tiny_decoder).
DIMS = dict(vocab_size=40, embed_dim=16, ffn_dim=32, num_heads=4,
            num_layers=2, kernel_sizes=(3, 5), cutoff=(12, 24, 40),
            image_dim=12, article_dim=10, max_positions=64)
NO_DROPOUT = {"decoder": dict(dropout=0.0, weight_dropout=0.0,
                              relu_dropout=0.0, input_dropout=0.0,
                              attention_dropout=0.0)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the rules ------------------------------------------------------------

@pytest.fixture(scope="module")
def flagship():
    """(the reference's `jax.eval_shape` params of the flagship config,
    flattened by path; the port's flagship decoder on the meta
    device)."""
    cfg = jax_config.load_config(str(FLAGSHIP))
    model = jax_config.build_model(cfg)
    ds = jax_config.build_dataset(cfg, "test")
    ex = ds.collate([ds[0]])
    sample = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
              for k, v in ex.items()}
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), sample)
    leaves = flatten_dict(shapes["params"], sep="/")
    port = build_model(load_config(str(FLAGSHIP)), "meta").decoder
    return leaves, port


def _jax_split(spec, ndim):
    spec = tuple(spec)[:ndim]
    return spec.index("model") if "model" in spec else None


def test_rules_split_every_parameter_as_jax(flagship):
    """Every port parameter gets the split dim of its JAX leaf (the
    reference's `spec_for_path` on `decoder/<path>`, cut to the leaf's
    rank as `param_shardings` cuts it): 75 split leaves."""
    leaves, port = flagship
    params = dict(port.named_parameters())
    assert set(params) == {torch_key(k) for k in leaves}
    split = 0
    for path, leaf in leaves.items():
        want = _jax_split(spec_for_path(f"decoder/{path}"), len(leaf.shape))
        name = torch_key(path)
        got = split_dim(spec_for_name(name), params[name].dim())
        assert got == want, (path, got, want)
        split += want is not None
    assert split == 75
    assert spec_for_name("layers.0.fc1.kernel") == (None, MODEL_AXIS)
    assert spec_for_name("layers.0.conv.weight_linear.kernel") == ()


@pytest.mark.parametrize("m", [2, 4])
def test_flagship_band_refuses_model_axis_in_both(flagship, m):
    """The last band table, (30265, 1024), does not split over 2 or 4
    model ranks: JAX's sharding refuses the leaf, the port raises naming
    it, before anything is sliced."""
    leaves, port = flagship
    leaf = leaves["embedder/adaptive/embed_2"]
    devices = np.asarray(jax.devices()[:m]).reshape(1, m)
    mesh = jax.sharding.Mesh(devices, ("data", "model"))
    sharding = NamedSharding(mesh, spec_for_path("embedder/adaptive/embed_2"))
    with pytest.raises(ValueError, match="evenly divide"):
        sharding.shard_shape(leaf.shape)
    before = {n: tuple(p.shape) for n, p in port.named_parameters()}
    with pytest.raises(ValueError, match=r"embedder\.adaptive\.embed_2 .*"
                       r"\(30265, 1024\).*divisible by "
                       f"{m}.*equal to 30265"):
        shard_params(port, ModelShard(0, m))
    assert {n: tuple(p.shape) for n, p in port.named_parameters()} == before


# -- the kernels' plain twins in shard form ---------------------------------

@pytest.mark.parametrize("m", [2, 4])
def test_flash_masks_with_head_offset_are_the_whole_masks_heads(m):
    B, H, T, S, p = 3, 8, 5, 9, 0.3
    seed = torch.tensor([1234], dtype=torch.int32)
    whole = flash_attention.dropout_keep(seed, B, H, T, S, p, row0=2)
    n = H // m
    for r in range(m):
        part = flash_attention.dropout_keep(seed, B, n, T, S, p, row0=2,
                                            h0=r * n, heads_total=H)
        assert torch.equal(part, whole[:, r * n:(r + 1) * n])
    assert torch.equal(flash_attention.dropout_keep(seed, B, H, T, S, p, 2, 0,
                                                    H), whole)


@pytest.mark.parametrize("m", [2, 4])
def test_flash_shard_forms_equal_whole(m):
    """Forward (out, lse) and backward (dq, dk, dv) over each rank's heads
    with h0, concatenated, equal the whole call's."""
    rng = np.random.RandomState(0)
    B, H, hd, T, S, p = 2, 8, 4, 6, 7, 0.2
    E = H * hd
    q, g = (torch.from_numpy(rng.randn(B, T, E).astype(np.float32))
            for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(B, S, E).astype(np.float32))
            for _ in range(2))
    bias = torch.zeros(B, S)
    bias[1, -2:] = -1e9
    seed = torch.tensor([7], dtype=torch.int32)
    out, lse = flash_attention.flash_attention_fwd(q, k, v, bias, seed, H, p)
    grads = flash_attention.flash_attention_bwd(q, k, v, bias, seed, lse, g,
                                                H, p)
    n = H // m
    parts = []
    for r in range(m):
        cols = slice(r * n * hd, (r + 1) * n * hd)
        qs, ks, vs, gs = (t[..., cols].contiguous() for t in (q, k, v, g))
        o, ls = flash_attention.flash_attention_fwd(qs, ks, vs, bias, seed, n,
                                                    p, h0=r * n,
                                                    heads_total=H)
        parts.append((o, ls) + flash_attention.flash_attention_bwd(
            qs, ks, vs, bias, seed, ls, gs, n, p, h0=r * n, heads_total=H))
    dims = (-1, 1, -1, -1, -1)
    for i, want in enumerate((out, lse) + tuple(grads)):
        got = torch.cat([part[i] for part in parts], dim=dims[i])
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ffn_partials_summed_equal_whole(m, dtype):
    """The partial mode's fp32 sums over each rank's F/m columns, added,
    then `ffn_epilogue`, equal the whole block's plain twin (bit for bit
    at one rank)."""
    rng = np.random.RandomState(1)
    N, C, F = 5, 16, 32

    def t(*shape, s=0.3):
        return torch.from_numpy((rng.randn(*shape) * s).astype(
            np.float32)).to(dtype)

    x, w1, b1, w2, b2 = t(N, C), t(C, F), t(F), t(F, C), t(C)
    whole = decode_blocks.decode_ffn_block_plain(x, w1, b1, w2, b2)
    one = decode_blocks.decode_ffn_block(x, w1, b1, w2, b2,
                                         reduce=lambda s: s)
    assert torch.equal(one, whole)
    n = F // m
    total = sum(decode_blocks.decode_ffn_block_partial(
        x, w1[:, r * n:(r + 1) * n], b1[r * n:(r + 1) * n],
        w2[r * n:(r + 1) * n]) for r in range(m))
    got = decode_blocks.ffn_epilogue(total, b2, x)
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float(), whole.float(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_band_topk_rank_rows_merged_equal_whole(m, k):
    """Each rank's rows through the kernel's plain twin, ids offset by
    the rank's first row, merged (`merge_candidates`): ids and values
    equal the whole band's, the logsumexp within 1e-6; a tie across two
    ranks goes to the lower id; the head band with the class rows in
    rank 0's table and sel_limit its word rows."""
    rng = np.random.RandomState(2)
    N, D, V = 6, 8, 24
    x = torch.from_numpy(rng.randn(N, D).astype(np.float32))
    table = torch.from_numpy(rng.randn(V, D).astype(np.float32))
    table[V // 2 + 1] = table[1]            # equal logits on two ranks
    n = V // m

    def merged(tables_sel):
        every = []
        for r, (tab, sel) in enumerate(tables_sel):
            vals, ids, lse = band_topk.band_topk_lse(x, tab, min(k, sel), sel)
            every.append(torch.cat([vals, (ids + r * n).float(), lse], -1))
        return merge_candidates(torch.stack(every), k)

    want = band_topk.band_topk_lse(x, table, k)
    got = merged([(table[r * n:(r + 1) * n], n) for r in range(m)])
    assert torch.equal(got[1], want[1].long())
    # The CPU's fp32 product may round a logit differently at another
    # table size; the kernel's does not (phase 25 of chip_smoke.py).
    torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=0)
    torch.testing.assert_close(got[2], want[2], rtol=1e-6, atol=0)
    cls = torch.from_numpy(rng.randn(2, D).astype(np.float32))
    want = band_topk.band_topk_lse(x, torch.cat([table, cls]), k, V)
    got = merged([(torch.cat([table[:n], cls]) if r == 0
                   else table[r * n:(r + 1) * n], n) for r in range(m)])
    assert torch.equal(got[1], want[1].long())
    torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=0)
    torch.testing.assert_close(got[2], want[2], rtol=1e-6, atol=0)


@pytest.mark.parametrize("m", [2, 4])
def test_decode_attention_head_slices_equal_whole(m):
    rng = np.random.RandomState(3)
    B, Q, S, H, hd = 2, 3, 7, 8, 4
    E = H * hd
    q = torch.from_numpy(rng.randn(B, Q, E).astype(np.float32))
    k, v = (torch.from_numpy(rng.randn(B, S, E).astype(np.float32))
            for _ in range(2))
    bias = torch.zeros(B, S)
    bias[0, -3:] = -1e9
    whole = decode_attention.decode_cross_attention(q, k, v, bias, H)
    n = H // m
    got = torch.cat([decode_attention.decode_cross_attention(
        *(t[..., r * n * hd:(r + 1) * n * hd].contiguous()
          for t in (q, k, v)), bias, n) for r in range(m)], dim=-1)
    torch.testing.assert_close(got, whole, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("m", [2, 4])
def test_row_split_weight_norm_fold_uses_the_summed_norm(m, monkeypatch):
    """A row-split fc2's fold (`GehringLinear.folded`) and forward use the
    norm over the whole input dim: the rank's slice of the whole fold,
    and the ranks' partial products summed equal the whole forward. The
    psum is the sum of the ranks' sums of squares here."""
    gen = torch.Generator().manual_seed(4)
    whole = linear.GehringLinear(32, 8, device="cpu", dtype=torch.float32,
                                 generator=gen)
    with torch.no_grad():
        whole.scale.mul_(1.7)
        whole.bias.normal_(generator=gen)
    n = 32 // m
    sumsq = torch.sum(whole.kernel.float() ** 2, dim=0)
    x = torch.randn(3, 32, generator=gen)
    ranks = []
    for r in range(m):
        part = linear.GehringLinear(n, 8, device="cpu", dtype=torch.float32)
        with torch.no_grad():
            part.kernel.copy_(whole.kernel[r * n:(r + 1) * n])
            part.scale.copy_(whole.scale)
            part.bias.copy_(whole.bias)
        part.split = "row"
        ranks.append(part)
    kernel, bias = whole.folded(torch.float32)
    partials = []
    with monkeypatch.context() as mp:
        mp.setattr(linear, "reduce_out", lambda t, shard: (
            sumsq if t.shape == sumsq.shape else t))
        for r, part in enumerate(ranks):
            k_r, b_r = part.folded(torch.float32)
            torch.testing.assert_close(k_r, kernel[r * n:(r + 1) * n],
                                       rtol=1e-6, atol=1e-7)
            assert torch.equal(b_r, bias)
            partials.append(x[:, r * n:(r + 1) * n] @ part.kernel
                            * part._norm_scale(torch.float32))
    got = sum(partials) + whole.bias
    torch.testing.assert_close(got, whole(x), rtol=1e-5, atol=1e-6)


# -- four gloo ranks against JAX -------------------------------------------

def _jax_decodes(model, params, batch, reqs, beam_reqs):
    """Every case's JAX values for params (sharded or not)."""
    greedy = JaxGenerationConfig(max_len=10, sampling_topk=1)
    gen_batch = {k: v for k, v in batch.items() if k != "caption_ids"}
    out = {"loss": float(jax.jit(model.loss_fn)(params, batch)[0])}
    out["greedy"] = jax.jit(lambda p, b: model.generate(p, b, greedy))(
        params, gen_batch)
    beam = JaxGenerationConfig(max_len=10, beam_size=3, sampling_topk=1)
    out["beam"] = jax.jit(lambda p, b: model.generate_beam(p, b, beam))(
        params, gen_batch)
    out["speculative"] = jax.jit(lambda p, b: model.generate_speculative(
        p, b, greedy, spec_k=4))(params, batch)
    quant = JaxGenerationConfig(max_len=10, sampling_topk=1,
                                quantize_kv=True, quantize_head=True)
    out["quantized"] = jax.jit(lambda p, b: model.generate(p, b, quant))(
        params, gen_batch)
    eng = JaxBatcher.for_flattened(model, params, JaxGenerationConfig(
        max_len=8, sampling_topk=1), n_slots=2, inner_steps=2)
    ids = [eng.submit(r) for r in reqs]
    got = eng.run()
    out["continuous"] = [got[i][0] for i in ids]
    eng = JaxBeamBatcher(model, params, JaxGenerationConfig(
        max_len=8, beam_size=3), n_slots=2, inner_steps=2)
    ids = [eng.submit(r) for r in beam_reqs]
    got = eng.run()
    out["beam_engine"] = [(got[i][0], got[i][1]) for i in ids]
    return jax.tree.map(np.asarray, out)


def _overrides(out: Path, model: dict, mesh=None, epochs=None,
               **trainer) -> str:
    over = {"model": model, "trainer": {"log_every": 4,
                                        "serialization_dir": str(out),
                                        **trainer}}
    if mesh:
        over["trainer"]["mesh"] = mesh
    if epochs:
        over["trainer"]["num_epochs"] = epochs
    return json.dumps(over)


def _records(path: Path):
    return [json.loads(line) for line in path.read_text().splitlines()]


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """JAX's values unsharded and sharded on each mesh over four virtual
    devices, the four ranks' results, and the train runs' directories."""
    root = tmp_path_factory.mktemp("tp")
    model = JaxTransformerFlattened(tiny_decoder())
    batch = tiny_batch(B=8)
    batch["article_ids"] = jax.random.randint(jax.random.PRNGKey(9), (8, 6),
                                              2, 40)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), batch)
    reqs = [{k: v for k, v in tiny_batch(B=1, key=70 + i).items()
             if k != "caption_ids"} for i in range(3)]
    beam_reqs = [{k: v for k, v in tiny_batch(B=1, key=80 + i).items()
                  if k != "caption_ids"} for i in range(2)]
    ref = _jax_decodes(model, params, batch, reqs, beam_reqs)
    sharded = []
    for cfg in MESHES:
        mesh = jax_mesh.make_mesh(jax_mesh.MeshConfig(**cfg),
                                  jax.devices()[:4])
        with mesh:
            sp = jax.tree.map(jax.device_put, params,
                              param_shardings(params, mesh))
            sharded.append(_jax_decodes(model, sp, shard_batch(batch, mesh),
                                        reqs, beam_reqs))
    port = TransformerFlattened(device="cpu", dtype=torch.float32, **DIMS)
    state = params_from_jax(jax.tree.map(np.asarray, params), port.decoder)
    np_batch = jax.tree.map(np.asarray, batch)

    # The train command: the port's one process (dropouts and flash on),
    # the reference's on {data: 2, model: 2} (dropouts off, four virtual
    # devices), then the four ranks (both, the latter from JAX's init).
    d = {k: root / k for k in ("one", "one3", "four_on", "four_dcp",
                               "four_off", "jax", "pointer_one",
                               "pointer_four")}
    on = {"decoder": {"use_flash_train": True}}
    assert cli.main(["train", TINY, "--platform", "cpu", "-o",
                     _overrides(d["one"], on)]) == 0
    assert cli.main(["train", TINY, "--platform", "cpu", "-o",
                     _overrides(d["one3"], on, epochs=3)]) == 0
    assert cli.main(["train", POINTER, "--platform", "cpu", "-o",
                     _overrides(d["pointer_one"], {})]) == 0
    with pytest.MonkeyPatch.context() as mp:
        make = jax_mesh.make_mesh
        mp.setattr(jax_mesh, "make_mesh", lambda c, devices=None: make(
            c, jax.devices()[:4]))
        assert jax_cli.main(["train", TINY, "--platform", "cpu", "-o",
                             _overrides(d["jax"], NO_DROPOUT,
                                        MESHES[0])]) == 0
    off = _overrides(d["four_off"], NO_DROPOUT, MESHES[0])
    cfg = jax_config.load_config(TINY, off)
    sample = next(jax_config.build_dataset(cfg, "train").batches(4))
    variables = jax.tree.map(np.asarray, jax_config.build_model(cfg).init(
        jax.random.PRNGKey(0), sample))
    target = build_model(load_config(TINY, off), "cpu",
                         torch.float32).decoder
    init = {k: v.numpy() for k, v in
            params_from_jax(variables, target).items()}
    payload = {
        "dims": DIMS, "meshes": MESHES,
        "state": {k: v.numpy() for k, v in state.items()},
        "batch": {k: v for k, v in np_batch.items()},
        "requests": [jax.tree.map(np.asarray, r) for r in reqs],
        "beam_requests": [jax.tree.map(np.asarray, r) for r in beam_reqs],
        "train": [(TINY, _overrides(d["four_on"], on, MESHES[0]), None, []),
                  (TINY, off, init, []),
                  (TINY, _overrides(d["four_dcp"], on, MESHES[0],
                                    checkpoint_format="sharded"), None, []),
                  # The single-file run resumed for a third epoch.
                  (TINY, _overrides(d["four_on"], on, MESHES[0], epochs=3),
                   None, ["-r"]),
                  (POINTER, _overrides(d["pointer_four"], {}, MESHES[0]),
                   None, [])],
        "init": f"file://{root / 'store'}"}
    results = workers.spawn(4, "tensor_parallel", payload, root / "spawn")
    return ref, sharded, results, d


def _assemble(results, i, key, what):
    """The rows every rank decoded for mesh i, placed by their rows; the
    ranks that share rows (the model axis) agree exactly."""
    parts = {}
    for res in results:
        case = res["cases"][i]
        rows = tuple(case["rows"])
        got = case[key][what] if what is not None else case[key]
        if rows in parts:
            np.testing.assert_array_equal(got, parts[rows])
        parts[rows] = got
    return np.concatenate([parts[r] for r in sorted(parts)])


@pytest.mark.parametrize("i", range(len(MESHES)),
                         ids=["data2-model2", "data1-model4"])
def test_split_loss_matches_jax(tp, i):
    ref, sharded, results, _ = tp
    for res in results:
        np.testing.assert_allclose(res["cases"][i]["loss"], ref["loss"],
                                   rtol=2e-5)
        np.testing.assert_allclose(res["cases"][i]["loss"],
                                   sharded[i]["loss"], rtol=2e-5)


@pytest.mark.parametrize("i", range(len(MESHES)),
                         ids=["data2-model2", "data1-model4"])
@pytest.mark.parametrize("case", ["greedy", "beam", "quantized"])
def test_split_decode_matches_jax(tp, i, case):
    """Tokens exact; log-probs / scores within the reference's rtol 1e-4,
    atol 1e-5."""
    ref, sharded, results, _ = tp
    toks, vals = (_assemble(results, i, case, j) for j in (0, 1))
    for want in (ref[case], sharded[i][case]):
        np.testing.assert_array_equal(toks, want[0])
        np.testing.assert_allclose(vals, want[1], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("i", range(len(MESHES)),
                         ids=["data2-model2", "data1-model4"])
def test_split_speculative_matches_jax(tp, i):
    ref, sharded, results, _ = tp
    toks, lps = (_assemble(results, i, "speculative", j) for j in (0, 1))
    for want in (ref["speculative"], sharded[i]["speculative"]):
        np.testing.assert_array_equal(toks, want[0])
        np.testing.assert_allclose(lps, want[1], rtol=1e-4, atol=1e-5)
    if MESHES[i]["data"] == 1:
        assert all(res["cases"][i]["speculative"][2]
                   == int(ref["speculative"][2]) for res in results)


@pytest.mark.parametrize("i", range(len(MESHES)),
                         ids=["data2-model2", "data1-model4"])
def test_split_engines_match_jax(tp, i):
    """The continuous engine's and the beam engine's captions (B=1
    requests replicated on every rank) equal JAX's, unsharded and
    sharded."""
    ref, sharded, results, _ = tp
    for res in results:
        case = res["cases"][i]
        for want in (ref, sharded[i]):
            for got, w in zip(case["continuous"], want["continuous"]):
                np.testing.assert_array_equal(got, w)
            for (tok, score), (wt, ws) in zip(case["beam_engine"],
                                              want["beam_engine"]):
                np.testing.assert_array_equal(tok, wt)
                np.testing.assert_allclose(score, ws, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("i", range(len(MESHES)),
                         ids=["data2-model2", "data1-model4"])
def test_split_is_real(tp, i):
    """fc1 [D, F/m] (kernels are [in, out]), H/m heads, the last band's
    rows over m, and the model group's collectives called in the loss."""
    m = MESHES[i]["model"]
    for res in tp[2]:
        case = res["cases"][i]
        assert case["fc1"] == (DIMS["embed_dim"], DIMS["ffn_dim"] // m)
        assert case["heads"] == DIMS["num_heads"] // m
        assert case["embed_2"] == (16 // m, DIMS["embed_dim"])
        assert case["model_collectives"] > 0


def _losses_match(got, want, rtol):
    assert [r["split"] for r in got] == [r["split"] for r in want] \
        == ["train", "train", "val"] * 2
    for g, w in zip(got, want):
        assert g["step"] == w["step"]
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=rtol)


def test_train_command_split_matches_one_process(tp):
    """Dropouts and flash on: the four ranks' losses within 2e-5 of the
    port's one process; resumed from their own checkpoint (`-r`, the
    whole tensors sliced back) for a third epoch, within 2e-5 of the one
    process's uninterrupted third epoch."""
    d = tp[3]
    got = _records(d["four_on"] / "metrics.jsonl")
    _losses_match(got[:6], _records(d["one"] / "metrics.jsonl"), 2e-5)
    want = _records(d["one3"] / "metrics.jsonl")[6:]
    assert [(r["split"], r["step"]) for r in got[6:]] == [
        (r["split"], r["step"]) for r in want] and len(want) == 3
    for g, w in zip(got[6:], want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=2e-5)


def test_train_command_split_pointer_matches_one_process(tp):
    """The pointer family (`configs/tiny_pointer.yaml`, its dropouts on):
    its decoder split as the flagship's, its entity and copy heads'
    split linears whole in and whole out; losses within 2e-5 of one
    process."""
    d = tp[3]
    _losses_match(_records(d["pointer_four"] / "metrics.jsonl"),
                  _records(d["pointer_one"] / "metrics.jsonl"), 2e-5)


def test_train_command_split_sharded_store(tp):
    """`checkpoint_format: sharded` on the split model: every rank writes
    its slices (a DCP file a rank); the records equal the single-file
    run's; the store read in one process holds best.pt's whole params,
    and `evaluate -m best` from it writes the single-file run's
    generations byte for byte."""
    d = tp[3]
    from news_image_caption_tpu_torch.training.checkpoint_sharded import \
        ShardedCheckpointStore
    def losses(path):
        return [{k: v for k, v in r.items() if k != "input_wait"}
                for r in _records(path)]

    assert losses(d["four_dcp"] / "metrics.jsonl") == losses(
        d["four_on"] / "metrics.jsonl")[:6]
    files = sorted((d["four_dcp"] / "checkpoints" / "ckpt_16").iterdir())
    assert [f.name for f in files] == [".metadata"] + [
        f"__{r}_0.distcp" for r in range(4)]
    got = ShardedCheckpointStore(str(d["four_dcp"] / "checkpoints")).read(
        "best", "params")
    want = torch.load(d["four_on"] / "checkpoints" / "ckpt_16.pt",
                      weights_only=True)["params"]
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    over = {"trainer": {"serialization_dir": str(d["four_dcp"]),
                        "checkpoint_format": "sharded"},
            "model": {"decoder": {"use_flash_train": True}}}
    assert cli.main(["evaluate", TINY, "--platform", "cpu", "-m", "16",
                     "-s", "_dcp", "-o", json.dumps(over)]) == 0
    over["trainer"] = {"serialization_dir": str(d["four_on"])}
    assert cli.main(["evaluate", TINY, "--platform", "cpu", "-m", "16",
                     "-s", "_pt", "-o", json.dumps(over)]) == 0
    assert (d["four_dcp"] / "generations_dcp.jsonl").read_bytes() == (
        d["four_on"] / "generations_pt.jsonl").read_bytes()


def test_train_command_split_matches_jax_sharded(tp):
    d = tp[3]
    _losses_match(_records(d["four_off"] / "metrics.jsonl"),
                  _records(d["jax"] / "metrics.jsonl"), 2e-5)


def test_split_best_checkpoint_is_whole_and_evaluates(tp, tmp_path):
    """`best.pt` of the four ranks holds the one-process run's keys,
    shapes and dtypes (the split tensors gathered whole, the moments and
    master too), and `evaluate -m best` loads it in one process."""
    d = tp[3]
    got = torch.load(d["four_on"] / "checkpoints" / "best.pt",
                     weights_only=True)
    want = torch.load(d["one"] / "checkpoints" / "best.pt",
                      weights_only=True)

    def layout(tree):
        if isinstance(tree, dict):
            return {k: layout(v) for k, v in tree.items()}
        if isinstance(tree, torch.Tensor):
            return (tuple(tree.shape), tree.dtype)
        return type(tree)

    assert layout(got) == layout(want)
    over = {"trainer": {"serialization_dir": str(d["four_on"])},
            "model": {"decoder": {"use_flash_train": True}}}
    assert cli.main(["evaluate", TINY, "--platform", "cpu", "-m", "best",
                     "-o", json.dumps(over)]) == 0
    assert (d["four_on"] / "generations.jsonl").exists()
