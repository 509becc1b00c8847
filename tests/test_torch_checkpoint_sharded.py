"""The port's sharded checkpoint store (`training/checkpoint_sharded.py`)
and the commands over it, against the JAX reference's store, on the CPU.

- The same saves (keep 2, best by loss) into the port's store and the
  reference's (orbax) give the same `meta.json`, the same retained
  steps, and best pinned through retention; a fresh store reads the meta
  back; two asynchronous saves drain in order and a lost newest
  checkpoint falls back to the one before.
- Two gloo ranks (`tests/torch_parallel_workers.py::sharded_store`) save
  one state, each writing its share (`__0_0.distcp`, `__1_0.distcp`),
  which this process loads on one rank; and they load a store saved here
  on one rank: bit for bit both ways.
- `train` with `checkpoint_format: sharded` for one epoch, then `-r` for
  two, logs the second epoch's losses and ends with the params of an
  uninterrupted run; `evaluate -m best` from that store (detected, and
  named by `checkpoint_format`) writes files byte-equal to `evaluate` of
  the same params through a `.pt` store; a directory the reference's
  store wrote (orbax) raises naming `state_from_jax`.
"""

import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import torch_parallel_workers as workers  # noqa: E402
from news_image_caption_tpu.training import \
    checkpoint_sharded as jax_sharded  # noqa: E402
from news_image_caption_tpu_torch import cli  # noqa: E402
from news_image_caption_tpu_torch.training.checkpoint import \
    CheckpointStore  # noqa: E402
from news_image_caption_tpu_torch.training.checkpoint_sharded import \
    ShardedCheckpointStore  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
TINY = str(REPO / "configs" / "tiny_test.yaml")
SAVES = [(1, 5.0), (2, 1.0), (3, 4.0), (4, 3.0)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(val: float):
    return {"w": torch.full((8, 4), val), "b": torch.arange(8.0) * val,
            "step": 3}


def _jax_state(val: float):
    return {"w": jnp.full((8, 4), val), "b": jnp.arange(8.0) * val,
            "step": jnp.asarray(3, jnp.int32)}


def test_meta_matches_jax_store(tmp_path):
    port = ShardedCheckpointStore(str(tmp_path / "port"), keep=2)
    ref = jax_sharded.ShardedCheckpointStore(str(tmp_path / "ref"), keep=2)
    for i, (step, loss) in enumerate(SAVES):
        blocking = i % 2 == 1
        port.save(_state(float(step)), step, {"loss": loss},
                  blocking=blocking)
        ref.save(_jax_state(float(step)), step, {"loss": loss},
                 blocking=blocking)
    port.wait()
    ref.close()
    got = json.loads((tmp_path / "port" / "meta.json").read_text())
    want = json.loads((tmp_path / "ref" / "meta.json").read_text())
    assert got == want
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "ref")) == ["ckpt_2", "ckpt_3", "ckpt_4",
                                          "meta.json"]


def test_best_pinned_through_retention(tmp_path):
    store = ShardedCheckpointStore(str(tmp_path), keep=2)
    for step, loss in SAVES:
        store.save(_state(float(step)), step, {"loss": loss})
    assert store.latest_step() == 4
    assert not (tmp_path / "ckpt_1").exists()
    assert (tmp_path / "ckpt_2").exists()
    assert store.best_value() == 1.0
    best = store.load(_state(0.0), "best")
    np.testing.assert_array_equal(best["w"].numpy(), 2.0)
    assert best["step"] == 3
    again = ShardedCheckpointStore(str(tmp_path), keep=2)
    assert again.best_value() == 1.0 and again.latest_step() == 4
    np.testing.assert_array_equal(again.read("best", "b").numpy(),
                                  np.arange(8.0) * 2)


def test_async_save_and_fallback(tmp_path):
    store = ShardedCheckpointStore(str(tmp_path), keep=4)
    store.save(_state(1.0), 1, blocking=False)
    store.save(_state(2.0), 2, blocking=False)
    assert store.latest_step() == 2
    shutil.rmtree(tmp_path / "ckpt_2")
    got, step = store.load_with_fallback(_state(0.0))
    assert step == 1
    np.testing.assert_array_equal(got["w"].numpy(), 1.0)


@pytest.fixture(scope="module")
def resharded(tmp_path_factory):
    """A state saved on two ranks, and a store saved here on one that the
    two ranks load."""
    root = tmp_path_factory.mktemp("reshard")
    rng = np.random.RandomState(0)
    params = {f"layer{i}.w": rng.randn(16, 8).astype(np.float32)
              for i in range(6)}
    params["emb"] = rng.randn(40, 8).astype(np.float32)
    one = {"step": 7, "params": {k: torch.from_numpy(v * 2.0)
                                 for k, v in params.items()}}
    ShardedCheckpointStore(str(root / "one")).save(one, 7, {"loss": 0.5})
    results = workers.spawn(2, "sharded_store", {
        "params": params, "step": 11, "save_dir": str(root / "two"),
        "load_dir": str(root / "one")}, root / "spawn")
    return root, params, one, results


def test_saved_on_two_ranks_loads_on_one(resharded):
    root, params, _, results = resharded
    for res in results:
        assert {"__0_0.distcp", "__1_0.distcp", ".metadata"} <= set(
            res["files"])
    store = ShardedCheckpointStore(str(root / "two"))
    assert [c["step"] for c in store.meta["checkpoints"]] == [11, 12]
    assert store.meta["best"] == {"step": 11, "value": 1.0}
    tree = store.read("best")
    assert tree["step"] == 11
    for k, v in params.items():
        np.testing.assert_array_equal(tree["params"][k].numpy(), v)


def test_saved_on_one_loads_on_two(resharded):
    _, _, one, results = resharded
    for res in results:
        assert res["step"] == 7
        for k, v in one["params"].items():
            np.testing.assert_array_equal(res["params"][k], v.numpy())


@pytest.fixture(scope="module")
def commands(tmp_path_factory):
    """An uninterrupted train; a sharded one stopped after epoch 0 and
    recovered; the sharded best copied into a .pt store; evaluate -m
    best from both."""
    root = tmp_path_factory.mktemp("commands")

    def run(*argv, out, **trainer):
        over = {"trainer": {"log_every": 4, "serialization_dir": str(out),
                            **trainer}}
        assert cli.main([argv[0], TINY, "--platform", "cpu", "-o",
                         json.dumps(over), *argv[1:]]) == 0

    run("train", out=root / "plain")
    run("train", out=root / "sharded", num_epochs=1,
        checkpoint_format="sharded")
    run("train", "-r", out=root / "sharded", checkpoint_format="sharded")
    store = ShardedCheckpointStore(str(root / "sharded" / "checkpoints"))
    best = store.meta["best"]
    pt = CheckpointStore(str(root / "pt" / "checkpoints"))
    pt.save(store.read("best"), best["step"],
            next(c["metrics"] for c in store.meta["checkpoints"]
                 if c["step"] == best["step"]))
    run("evaluate", "-m", "best", out=root / "sharded")
    run("evaluate", "-m", "best", "-s", "_named", out=root / "sharded",
        checkpoint_format="sharded")
    run("evaluate", "-m", "best", out=root / "pt")
    return root


def test_recover_from_sharded_store(commands):
    records = [json.loads(line) for line in
               (commands / "sharded" / "metrics.jsonl").read_text()
               .splitlines()]
    plain = [json.loads(line) for line in
             (commands / "plain" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [r["step"] for r in plain]
    for g, w in zip(records, plain):
        assert g["loss"] == w["loss"], (g, w)
    store = ShardedCheckpointStore(str(commands / "sharded" / "checkpoints"))
    assert [c["step"] for c in store.meta["checkpoints"]] == [8, 16]
    want = torch.load(commands / "plain" / "checkpoints" / "ckpt_16.pt",
                      weights_only=True)["params"]
    got = store.read(16, "params")
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("suffix", ["", "_named"])
@pytest.mark.parametrize("name", ["generations{}.jsonl",
                                  "evaluate-metrics{}.json"])
def test_evaluate_best_from_sharded_equals_pt_store(commands, name, suffix):
    got = (commands / "sharded" / name.format(suffix)).read_bytes()
    assert got == (commands / "pt" / name.format("")).read_bytes()


def test_orbax_directory_raises_naming_state_from_jax(tmp_path):
    ref = jax_sharded.ShardedCheckpointStore(
        str(tmp_path / "checkpoints"), keep=2)
    ref.save(_jax_state(1.0), 1, {"loss": 1.0})
    ref.close()
    over = {"trainer": {"serialization_dir": str(tmp_path)}}
    with pytest.raises(ValueError, match="state_from_jax"):
        cli.main(["evaluate", TINY, "--platform", "cpu", "-o",
                  json.dumps(over), "-m", "best"])
