"""The port's rank mesh, bootstrap, data placement and data-parallel
`train` command (`parallel/mesh.py`, `parallel/distributed.py`,
`parallel/collectives.py`, `training/train_step.py`) against the JAX
reference's, on gloo ranks on the CPU.

Two spawns (`tests/torch_parallel_workers.py` holds the rank bodies):

- four ranks: `make_mesh`'s axis names, shape and every rank's
  coordinates against JAX's mesh over four of its virtual devices (rank
  r where device r sits), its error for a layout that does not cover
  the world, `place_local`'s rows, `global_sums` and `any_rank`;
- two ranks: the `train` command with `trainer.mesh: {data: 2}` and
  `trainer.distributed` by a `file://` store, on `configs/tiny_test.yaml`
  and `configs/tiny_pointer.yaml` (32 records in batches of 4, 16 steps),
  twice each: with the YAML's dropouts (and flash attention on for the
  flagship) against the port's one-process run, losses within 2e-5
  (each rank draws the global batch's masks and keeps its rows); and with
  every dropout 0 from JAX's PRNGKey(0) init against the reference's
  `train` with `trainer.mesh: {data: 2, model: 1}` on two virtual
  devices, losses within 1e-5 (the existing command tests' settings and
  tolerance).

`shard_iterator` against JAX's on ragged and even streams, the bootstrap
in one process (a no-op without a cluster, an explicit spec that cannot
be joined raises), a world of one for a mesh in one process and a
`trainer.mesh` of two model ranks over a world of one raising the mesh's
error before anything is built run here (tensor parallelism itself is
`tests/test_torch_partition.py`'s).
"""

import functools
import json
import socket
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402

import torch_parallel_workers as workers  # noqa: E402
from news_image_caption_tpu import cli as jax_cli  # noqa: E402
from news_image_caption_tpu import config as jax_config  # noqa: E402
from news_image_caption_tpu.models import pointer as jax_pointer  # noqa: E402
from news_image_caption_tpu.parallel import distributed as jax_dist  # noqa: E402
from news_image_caption_tpu.parallel import mesh as jax_mesh  # noqa: E402
from news_image_caption_tpu_torch import cli  # noqa: E402
from news_image_caption_tpu_torch.config import (build_model,  # noqa: E402
                                                 load_config)
from news_image_caption_tpu_torch.models.from_jax import \
    params_from_jax  # noqa: E402
from news_image_caption_tpu_torch.parallel import distributed  # noqa: E402
from news_image_caption_tpu_torch.parallel.mesh import (  # noqa: E402
    MeshConfig, make_mesh)

REPO = Path(__file__).resolve().parent.parent
TINY = str(REPO / "configs" / "tiny_test.yaml")
POINTER = str(REPO / "configs" / "tiny_pointer.yaml")
MESHES = [{"data": 2, "context": 2}, {"data": 2, "pipe": 2},
          {"data": 1, "model": 2, "pipe": 2}, {"data": 2, "model": 2},
          {"data": -1}]
FLAGSHIP_DROPOUTS = {"decoder": dict(dropout=0.0, weight_dropout=0.0,
                                     relu_dropout=0.0, input_dropout=0.0,
                                     attention_dropout=0.0)}
POINTER_DROPOUTS = dict(dropout=0.0, weight_dropout=0.0, input_dropout=0.0,
                        attention_dropout=0.0)
# (name, config, the model block's overrides with dropouts on, with them
# off, attributes the YAML cannot zero)
FAMILIES = [
    ("flagship", TINY, {"decoder": {"use_flash_train": True}},
     FLAGSHIP_DROPOUTS, []),
    ("pointer", POINTER, {}, POINTER_DROPOUTS, ["copy_attn.dropout"]),
]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    rng = np.random.RandomState(0)
    payload = {"configs": MESHES, "bad": {"data": 3},
               "batch": {"x": rng.randn(8, 3).astype(np.float32),
                         "ids": np.arange(16, dtype=np.int32).reshape(8, 2)}}
    return payload, workers.spawn(4, "mesh_checks", payload,
                                  tmp_path_factory.mktemp("meshes"))


@pytest.mark.parametrize("i", range(len(MESHES)),
                         ids=["-".join(f"{k}{v}" for k, v in m.items())
                              for m in MESHES])
def test_mesh_layout_matches_jax(meshes, i):
    """Axis names and shape as JAX's, and rank r at JAX's device r."""
    devices = jax.devices()[:4]
    want = jax_mesh.make_mesh(jax_mesh.MeshConfig(**MESHES[i]), devices)
    for r, res in enumerate(meshes[1]):
        names, shape, coord = res["meshes"][i]
        assert tuple(names) == want.axis_names
        assert tuple(shape) == want.devices.shape
        where = np.argwhere(want.devices == devices[r])
        assert coord == list(where[0]), (r, coord, where)


def test_mesh_error_matches_jax(meshes):
    with pytest.raises(ValueError) as e:
        jax_mesh.make_mesh(jax_mesh.MeshConfig(data=3), jax.devices()[:4])
    for res in meshes[1]:
        assert res["bad"] == str(e.value)


def test_place_local_rows(meshes):
    payload, results = meshes
    for k, want in payload["batch"].items():
        got = np.concatenate([res["rows"][k] for res in results])
        np.testing.assert_array_equal(got, want)
    assert all("does not split evenly" in res["uneven"] for res in results)


def test_global_sums(meshes):
    """Values summed over the data ranks; each rank's gradient is its
    own terms' (so the ranks' gradients add up to the sum's)."""
    for res in meshes[1]:
        xs, n, grad = res["sums"]
        np.testing.assert_array_equal(xs, [10.0, 12.0])
        assert n == 3 + 4 + 5 + 6
        np.testing.assert_array_equal(grad, [1.0, 3.0])


def test_any_rank_agrees_on_a_host_group(meshes):
    """A flag set on one rank is seen on every rank through a gloo group
    of CPU tensors (the trainer's preemption check); none set, none
    seen."""
    assert all(res["any"] == (True, False) for res in meshes[1])


@pytest.mark.parametrize("n", [9, 10], ids=["even", "ragged"])
def test_shard_iterator_matches_jax(n):
    for count in (1, 3):
        for index in range(count):
            assert list(distributed.shard_iterator(
                iter(range(n)), index=index, count=count)) == list(
                jax_dist.shard_iterator(iter(range(n)), index=index,
                                        count=count))
    # One node: the identity, as one JAX process.
    assert list(distributed.shard_iterator(iter(range(n)))) == list(range(n))


def test_initialize_single_process_is_noop():
    distributed.initialize()
    distributed.initialize()
    assert not dist.is_initialized()


def test_initialize_explicit_bad_spec_raises(monkeypatch):
    """A spec that cannot be joined (the second rank never comes) is an
    error, not a single-process run."""
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with pytest.raises(Exception):
        distributed.initialize(f"127.0.0.1:{port}", 2, 0, timeout=1)
    assert not dist.is_initialized()


def test_make_mesh_world_of_one():
    assert not dist.is_initialized()
    try:
        mesh = make_mesh(MeshConfig(), "cpu")
        assert mesh.mesh_dim_names == ("data", "model")
        assert list(mesh.mesh.shape) == [1, 1]
    finally:
        distributed.shutdown()
    assert not dist.is_initialized()


def test_gradient_buffer_views_hold_the_grads():
    """Each view holds its gradient in fp32 exactly (bf16 and fp32 in,
    zeros for None), starts on a 512-byte boundary of the flat buffer,
    and the buffer fits only the shapes it was laid out for."""
    from news_image_caption_tpu_torch.parallel.collectives import (
        ALIGN_ELEMS, GradientBuffer)
    g = torch.Generator().manual_seed(0)
    params = [torch.zeros(s) for s in ((3, 5), (7,), (130,), (2, 2))]
    grads = [torch.randn(3, 5, generator=g).bfloat16(),
             torch.randn(7, generator=g), None,
             torch.randn(2, 2, generator=g)]
    buf = GradientBuffer(params)
    buf.flat.fill_(9.0)
    views = buf.fill(grads)
    for v, gr, p in zip(views, grads, params):
        assert v.dtype == torch.float32 and v.shape == p.shape
        assert (v.data_ptr() - buf.flat.data_ptr()) % (ALIGN_ELEMS * 4) == 0
        want = torch.zeros_like(p) if gr is None else gr.float()
        assert torch.equal(v, want)
    assert buf.fits(params) and not buf.fits(params[:3])


def test_one_rank_mesh_train_equals_plain_bit_for_bit(tmp_path):
    """`train` with `trainer.mesh` in one process (a world of one, the
    flat buffer's all-reduce, global sums, row offset 0) logs the plain
    command's records bit for bit, dropouts on."""
    recs = []
    for name, extra in (("plain", {}), ("mesh", {"mesh": {"data": -1}})):
        over = {"trainer": {"serialization_dir": str(tmp_path / name),
                            "num_epochs": 1, "log_every": 2, **extra}}
        assert cli.main(["train", TINY, "--platform", "cpu", "-o",
                         json.dumps(over)]) == 0
        recs.append([{k: v for k, v in r.items() if k != "input_wait"}
                     for r in _records(tmp_path / name / "metrics.jsonl")])
    assert recs[0] == recs[1] and len(recs[0]) > 2
    assert not dist.is_initialized()


def test_mesh_model_axis_raises_naming_11b(tmp_path, monkeypatch):
    """`trainer.mesh.model > 1` trains since tensor parallelism was
    ported (`tests/test_torch_partition.py`); over a world of one rank,
    {data: 1, model: 2} raises the mesh's "does not cover" error before
    anything is built, and leaves no process group behind."""
    def never(*a, **k):
        raise AssertionError("built before the mesh was checked")

    monkeypatch.setattr(cli, "training_model", never)
    over = {"trainer": {"serialization_dir": str(tmp_path),
                        "mesh": {"data": 1, "model": 2}}}
    with pytest.raises(ValueError, match="does not cover 1 devices"):
        cli.main(["train", TINY, "--platform", "cpu", "-o",
                  json.dumps(over)])
    assert not dist.is_initialized()


def _overrides(out: Path, model: dict, mesh=None) -> str:
    over = {"model": model, "trainer": {"log_every": 4,
                                        "serialization_dir": str(out)}}
    if mesh:
        over["trainer"]["mesh"] = mesh
    return json.dumps(over)


def _jax_init(path: str, overrides: str, model):
    """The port's state dict of `model` holding the reference's
    PRNGKey(0) init of the config."""
    cfg = jax_config.load_config(path, overrides)
    sample = next(jax_config.build_dataset(cfg, "train").batches(4))
    variables = jax.tree.map(np.asarray, jax_config.build_model(cfg).init(
        jax.random.PRNGKey(0), sample))
    target = model.decoder if path == TINY else model
    target.load_state_dict(params_from_jax(variables, target))
    return {k: v.numpy() for k, v in model.param_module.state_dict().items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per family: the port's one-process run with dropouts, the two-rank
    runs with and without, and the reference's data-parallel run without
    (on two of its virtual devices)."""
    root = tmp_path_factory.mktemp("runs")
    spawned, out = [], {}
    for name, path, on, off, patch in FAMILIES:
        d = {k: root / f"{name}_{k}" for k in ("one", "two_on", "two_off",
                                              "jax")}
        assert cli.main(["train", path, "--platform", "cpu", "-o",
                         _overrides(d["one"], on)]) == 0
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_pointer, "CopyAttentionScores", functools.partial(
                jax_pointer.CopyAttentionScores, dropout_rate=0.0))
            make = jax_mesh.make_mesh
            mp.setattr(jax_mesh, "make_mesh", lambda c, devices=None: make(
                c, jax.devices()[:2]))
            over = _overrides(d["jax"], off, {"data": 2, "model": 1})
            assert jax_cli.main(["train", path, "--platform", "cpu", "-o",
                                 over]) == 0
            over = _overrides(d["two_off"], off, {"data": 2})
            init = _jax_init(path, over, build_model(
                load_config(path, over), "cpu", torch.float32))
        spawned += [(path, _overrides(d["two_on"], on, {"data": 2}), None,
                     []),
                    (path, over, init, patch)]
        out[name] = d
    workers.spawn(2, "train_commands", {
        "runs": spawned, "init": f"file://{root / 'store'}"},
        root / "spawn", join=False)
    return out


def _records(path: Path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def _losses_match(got, want, rtol):
    assert [r["split"] for r in got] == [r["split"] for r in want] \
        == ["train", "train", "val"] * 2
    for g, w in zip(got, want):
        assert g["step"] == w["step"]
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=rtol)


@pytest.mark.parametrize("family", [f[0] for f in FAMILIES])
def test_two_ranks_match_one_process(runs, family):
    """Dropouts on: rank r drops the single process's rows."""
    d = runs[family]
    _losses_match(_records(d["two_on"] / "metrics.jsonl"),
                  _records(d["one"] / "metrics.jsonl"), 2e-5)
    meta = json.loads((d["two_on"] / "checkpoints" / "meta.json").read_text())
    assert [c["step"] for c in meta["checkpoints"]] == [8, 16]


@pytest.mark.parametrize("family", [f[0] for f in FAMILIES])
def test_two_ranks_match_jax_data_parallel(runs, family):
    d = runs[family]
    _losses_match(_records(d["two_off"] / "metrics.jsonl"),
                  _records(d["jax"] / "metrics.jsonl"), 1e-5)
    got = json.loads((d["two_off"] / "checkpoints" / "meta.json").read_text())
    want = json.loads((d["jax"] / "checkpoints" / "meta.json").read_text())
    assert got["best"]["step"] == want["best"]["step"]
    np.testing.assert_allclose(got["best"]["value"], want["best"]["value"],
                               rtol=1e-5)


def test_flash_row_offset_halves_equal_whole():
    """Two half batches with their first rows as offsets drop the whole
    batch's slots: the mask, and the plain forward and backward."""
    from news_image_caption_tpu_torch.ops import flash_attention as fa
    B, H, T, S, E, p = 4, 2, 5, 7, 16, 0.3
    seed = torch.tensor([77], dtype=torch.int32)
    whole = fa.dropout_keep(seed, B, H, T, S, p)
    halves = torch.cat([fa.dropout_keep(seed, 2, H, T, S, p, row0=r)
                        for r in (0, 2)])
    assert torch.equal(halves, whole)
    assert not torch.equal(fa.dropout_keep(seed, 2, H, T, S, p, row0=2),
                           whole[:2])
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(B, n, E).astype(np.float32))
               .requires_grad_(True) for n in (T, S, S))
    bias = torch.zeros(B, S)
    out = fa.flash_cross_attention(q, k, v, bias, seed, H, p)
    out.sum().backward()
    parts = []
    for r in (0, 2):
        qs, ks, vs = (t.detach()[r:r + 2].clone().requires_grad_(True)
                      for t in (q, k, v))
        o = fa.flash_cross_attention(qs, ks, vs, bias[r:r + 2], seed, H, p,
                                     row0=r)
        o.sum().backward()
        parts.append((o, qs.grad, ks.grad, vs.grad))
    for i, want in enumerate((out, q.grad, k.grad, v.grad)):
        got = torch.cat([part[i] for part in parts])
        assert torch.equal(got.detach(), want.detach()), i


def test_dropout_global_rows_halves_equal_whole():
    """Under `global_rows` each half draws the whole batch's masks, rows
    flattened batch-major included, and leaves the generator where the
    whole batch's draw leaves it; a tensor shared by every row is drawn
    whole."""
    from news_image_caption_tpu_torch.ops.dropout import dropout
    from news_image_caption_tpu_torch.parallel.collectives import \
        global_rows
    x = torch.arange(1.0, 4 * 3 * 5 + 1).view(4, 3, 5)
    flat = x.reshape(12, 5)
    taps = torch.ones(2, 3)

    def draws(parts):
        g = torch.Generator().manual_seed(3)
        return ([dropout(p, 0.5, g) for p in parts[0]],
                [dropout(p, 0.5, g) for p in parts[1]],
                dropout(taps, 0.5, g, batched=False), torch.rand(2,
                                                                 generator=g))

    want = draws(([x], [flat]))
    for first in (0, 2):
        with global_rows(first, 2, 4):
            got = draws(([x[first:first + 2]], [flat[first * 3:
                                                     (first + 2) * 3]]))
        assert torch.equal(got[0][0], want[0][0][first:first + 2])
        assert torch.equal(got[1][0], want[1][0][first * 3:(first + 2) * 3])
        assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
