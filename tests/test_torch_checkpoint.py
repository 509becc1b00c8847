"""The port's checkpoint store, the train state's round trip through it,
and `DeviceLoader`, on the CPU.

The store mirrors the reference's tests (`tests/test_training.py`):
best and keep-N retention, an async save whose host snapshot is a real
copy, a blocking save ordered after pending async ones, an async write
error surfacing at `wait`, `load_averaged` against numpy's mean, and
`load_with_fallback` over a corrupted newest file. The files load with
`torch.load(..., weights_only=True)`.

Save -> load -> step equals an unbroken run bit for bit for `fp32`,
`bf16`, `bf16_o2` and `accumulate_gradients(..., 2)` on the tiny model
(random init, the YAML's dropouts), and a checkpoint of one layout does
not load into a state of another.

`state_from_jax`: JAX's O2 step (fp32 compute, dropout 0) runs 3 steps,
its state is carried across, and the port's next 2 steps equal JAX's
steps 4 and 5: losses, master params and moments within 1e-5.
"""

import json
import os
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from news_image_caption_tpu import config as jax_config  # noqa: E402
from news_image_caption_tpu.training import \
    train_step as jax_train_step  # noqa: E402
from news_image_caption_tpu_torch import cli  # noqa: E402
from news_image_caption_tpu_torch.config import (  # noqa: E402
    build_dataset, build_model, build_optimizer, load_config)
from news_image_caption_tpu_torch.data.loader import DeviceLoader  # noqa: E402
from news_image_caption_tpu_torch.data.synthetic import LOSS_KEYS  # noqa: E402
from news_image_caption_tpu_torch.models.from_jax import (  # noqa: E402
    params_from_jax, state_from_jax, torch_key)
from news_image_caption_tpu_torch.training.checkpoint import (  # noqa: E402
    CheckpointStore, check_layout, restore)
from news_image_caption_tpu_torch.training.optim import \
    accumulate_gradients  # noqa: E402
from news_image_caption_tpu_torch.training.train_step import (  # noqa: E402
    create_o2_train_state, make_train_step)

REPO = Path(__file__).resolve().parent.parent
TINY = str(REPO / "configs" / "tiny_test.yaml")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny models: one intra-op thread, so that the suite's parallel
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _w(value, n=4):
    return {"w": torch.full((n,), float(value)), "step": 0}


def test_save_load_best_and_retention(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=2, best_metric="loss")
    store.save({"w": torch.arange(4.0), "step": 1}, 1, {"loss": 5.0})
    store.save({"w": torch.ones(4) * 2, "step": 2}, 2, {"loss": 3.0})
    store.save({"w": torch.ones(4) * 3, "step": 3}, 3, {"loss": 4.0})
    assert store.latest_step() == 3
    assert sorted(os.listdir(tmp_path)) == [
        "best.pt", "ckpt_2.pt", "ckpt_3.pt", "meta.json"]
    meta = json.loads((tmp_path / "meta.json").read_text())
    assert meta == {"checkpoints": [{"step": 2, "metrics": {"loss": 3.0}},
                                    {"step": 3, "metrics": {"loss": 4.0}}],
                    "best": {"step": 2, "value": 3.0}}
    target = _w(0)
    best = store.load(target, "best")
    assert best["w"] is target["w"] and best["step"] == 2
    assert torch.equal(target["w"], torch.full((4,), 2.0))
    assert torch.equal(store.load(_w(0), "latest")["w"],
                       torch.full((4,), 3.0))
    assert torch.equal(store.load(_w(0), 2)["w"], torch.full((4,), 2.0))
    assert torch.load(tmp_path / "ckpt_3.pt", weights_only=True)["step"] == 3
    with pytest.raises(ValueError, match="state/w"):
        store.load(_w(0, n=5), "latest")


def test_async_save_snapshots_a_real_copy(tmp_path):
    """The worker is held until after the caller overwrites its tensor
    in place; the written values are the ones at `save`."""
    store = CheckpointStore(str(tmp_path), keep=3, best_metric="loss")
    release = threading.Event()
    orig_commit = store._commit

    def gated_commit(*args):
        release.wait(timeout=10)
        orig_commit(*args)

    store._commit = gated_commit
    w = torch.arange(4.0)
    store.save({"w": w, "step": 0}, 1, {"loss": 5.0}, blocking=False)
    w += 100.0
    release.set()
    store.save(_w(2), 2, {"loss": 3.0}, blocking=False)
    store.save(_w(3), 3, {"loss": 4.0}, blocking=False)
    assert store.latest_step() == 3          # drains pending writes
    assert torch.equal(store.load(_w(0), 1)["w"], torch.arange(4.0))
    assert torch.equal(store.load(_w(0), "best")["w"], torch.full((4,), 2.))
    assert [t["step"] for t in store.timings] == [1, 2, 3]
    assert all(t["write_s"] >= 0 and t["snapshot_s"] >= 0
               for t in store.timings)
    again = CheckpointStore(str(tmp_path), keep=3, best_metric="loss")
    assert again.latest_step() == 3 and again.best_value() == 3.0


def test_blocking_save_orders_after_pending_async(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=4)
    release = threading.Event()
    orig_commit = store._commit

    def gated_commit(host_state, path, step, metrics, record=None):
        if metrics and metrics.get("tag") == "async":
            release.wait(timeout=10)
        orig_commit(host_state, path, step, metrics, record)

    store._commit = gated_commit
    store.save({"w": torch.zeros(2)}, 7, {"tag": "async"}, blocking=False)
    timer = threading.Timer(0.2, release.set)
    timer.start()
    store.save({"w": torch.ones(2)}, 7, {"tag": "blocking"})
    timer.join(timeout=10)
    assert not timer.is_alive()
    assert [c["metrics"]["tag"] for c in store.meta["checkpoints"]
            if c["step"] == 7] == ["blocking"]
    assert torch.equal(store.load({"w": torch.zeros(2)}, 7)["w"],
                       torch.ones(2))


def test_async_write_error_surfaces_at_wait(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=2)
    store.save({"w": torch.zeros(2)}, 1, blocking=False)
    store.wait()
    os.makedirs(tmp_path / "ckpt_2.pt.tmp")    # occupies the write path
    store.save({"w": torch.zeros(2)}, 2, blocking=False)
    with pytest.raises(OSError):
        store.wait()


def test_load_averaged_is_numpys_mean(tmp_path):
    """Floating tensors averaged in fp64 and cast back, ints from the
    newest checkpoint; bf16 too."""
    store = CheckpointStore(str(tmp_path), keep=5)
    rng = np.random.RandomState(0)
    values = {s: rng.randn(5).astype(np.float32) for s in (1, 2, 3)}
    for s, v in values.items():
        store.save({"w": torch.from_numpy(v), "b": torch.from_numpy(v).bfloat16(),
                    "step": s}, s)
    target = {"w": torch.zeros(5), "b": torch.zeros(5, dtype=torch.bfloat16),
              "step": 0}
    for kw, steps in (({"last_n": 2}, [2, 3]), ({}, [1, 2, 3]),
                      ({"steps": [1, 3]}, [1, 3])):
        got = store.load_averaged(target, **kw)
        want = np.mean([values[s].astype(np.float64) for s in steps], 0)
        np.testing.assert_array_equal(got["w"].numpy(),
                                      want.astype(np.float32))
        bmean = np.mean([torch.from_numpy(values[s]).bfloat16().double()
                         .numpy() for s in steps], 0)
        assert torch.equal(got["b"], torch.from_numpy(bmean).bfloat16())
        assert got["step"] == max(steps)


def test_read_averaged_of_one_key(tmp_path):
    """read_averaged(key=) averages that entry alone, equal to the same
    entry of load_averaged's tree; read gives a step's tree as saved."""
    store = CheckpointStore(str(tmp_path), keep=5)
    for s in (1, 2, 3):
        store.save({"params": {"w": torch.full((3,), float(s))},
                    "opt": {"m": torch.full((3,), 10.0 * s)}, "step": s}, s)
    got = store.read_averaged(last_n=2, key="params")
    assert set(got) == {"w"}
    assert torch.equal(got["w"], torch.full((3,), 2.5))
    full = store.read_averaged(last_n=2)
    assert torch.equal(full["params"]["w"], got["w"])
    assert torch.equal(full["opt"]["m"], torch.full((3,), 25.0))
    assert store.read(1)["step"] == 1
    assert torch.equal(store.read("latest")["params"]["w"],
                       torch.full((3,), 3.0))


def test_restore_checks_the_whole_layout_before_copying():
    target = {"a": torch.zeros(2), "b": torch.zeros(2)}
    tree = {"a": torch.ones(2), "b": torch.ones(2, dtype=torch.bfloat16)}
    with pytest.raises(ValueError, match="state/b: checkpoint holds "
                                         "torch.bfloat16"):
        restore(target, tree)
    assert torch.equal(target["a"], torch.zeros(2))
    with pytest.raises(ValueError, match="keys"):
        check_layout(target, {"a": torch.ones(2)})


def test_load_with_fallback_skips_a_corrupted_newest(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=5)
    for s in (1, 2, 3):
        store.save(_w(s), s)
    (tmp_path / "ckpt_3.pt").write_bytes(b"not a checkpoint")
    got, step = store.load_with_fallback(_w(0))
    assert step == 2 and torch.equal(got["w"], torch.full((4,), 2.0))
    for s in (1, 2):
        os.remove(tmp_path / f"ckpt_{s}.pt")
    with pytest.raises(FileNotFoundError, match="no readable checkpoint"):
        store.load_with_fallback(_w(0))


# -- the train state through the store ----------------------------------

PRECISIONS = ["fp32", "bf16", "bf16_o2", "accumulate_2"]


def _run(precision: str):
    """(state, step, batches) of the tiny model, seeded init, the YAML's
    dropouts on."""
    cfg = load_config(TINY)
    tx = build_optimizer(cfg)
    if precision == "accumulate_2":
        tx, precision = accumulate_gradients(tx, 2), "fp32"
    fp32 = build_model(cfg, "cpu", torch.float32,
                       torch.Generator().manual_seed(0))
    model, state = cli.train_state(cfg, fp32, tx, precision,
                                   torch.device("cpu"))
    dtype = torch.float32 if precision == "fp32" else torch.bfloat16
    step = make_train_step(model.loss_fn, tx, compute_dtype=dtype)
    batches = [{k: torch.from_numpy(b[k]) for k in LOSS_KEYS}
               for b in build_dataset(cfg, "train").batches(4, seed=0)]
    return state, step, batches


@pytest.mark.parametrize("precision", PRECISIONS)
def test_save_load_step_equals_an_unbroken_run(tmp_path, precision):
    state, step, batches = _run(precision)
    for b in batches[:3]:
        state, _ = step(state, b, 7)
    store = CheckpointStore(str(tmp_path))
    store.save(state, state.step, blocking=False)
    unbroken = []
    for b in batches[3:6]:
        state, m = step(state, b, 7)
        unbroken.append(m["loss"])
    store.wait()
    resumed, step2, _ = _run(precision)
    store.load(resumed, "latest")
    assert resumed.step == 3
    for b, want in zip(batches[3:6], unbroken):
        resumed, m = step2(resumed, b, 7)
        assert torch.equal(m["loss"], want)
    a, b = state.state_dict(), resumed.state_dict()

    def same(x, y, path):
        if isinstance(x, dict):
            assert set(x) == set(y), path
            for k in x:
                same(x[k], y[k], f"{path}/{k}")
        elif isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), path
        else:
            assert x == y, path

    same(a, b, "state")
    if state.compute is not None:
        for k, p in resumed.compute.items():
            assert torch.equal(p, state.compute[k]), k


def test_checkpoint_holds_the_references_layout(tmp_path):
    layouts = {}
    for precision in PRECISIONS:
        state, _, _ = _run(precision)
        store = CheckpointStore(str(tmp_path / precision))
        store.save(state, 0)
        tree = torch.load(tmp_path / precision / "ckpt_0.pt",
                          weights_only=True)
        layouts[precision] = (sorted(tree), sorted(tree["opt_state"]),
                              {p.dtype for p in tree["params"].values()})
    assert layouts["fp32"] == layouts["bf16"] == (
        ["opt_state", "params", "step"], ["count", "mu", "nu"],
        {torch.float32})
    assert layouts["bf16_o2"] == (["opt_state", "params", "step"],
                                  ["inner", "master"], {torch.bfloat16})
    assert layouts["accumulate_2"][1] == [
        "acc_grads", "gradient_step", "inner_opt_state", "mini_step"]
    for precision, ckpt, match in (
            ("bf16_o2", "fp32", "params/.* holds torch.float32"),
            ("fp32", "bf16_o2", "params/.* holds torch.bfloat16"),
            ("accumulate_2", "fp32", "not an accumulation state"),
            ("fp32", "accumulate_2", "not a BertAdam state")):
        state, _, _ = _run(precision)
        with pytest.raises(ValueError, match=match):
            CheckpointStore(str(tmp_path / ckpt)).load(state, 0)


def test_state_from_jax_continues_jax_steps():
    no_dropout = json.dumps({"model": {"decoder": dict(
        dropout=0.0, weight_dropout=0.0, relu_dropout=0.0,
        input_dropout=0.0, attention_dropout=0.0)}})
    jcfg = jax_config.load_config(TINY, no_dropout)
    jmodel = jax_config.build_model(jcfg)
    batches = [b for _, b in zip(range(5), jax_config.build_dataset(
        jcfg, "train").batches(4, seed=0))]
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), batches[0])
    jtx = jax_config.build_optimizer(jcfg)
    jstate = jax_train_step.create_o2_train_state(params, jtx,
                                                  compute_dtype=jnp.float32)
    jstep = jax_train_step.make_train_step(jmodel.loss_fn, jtx, donate=False,
                                           compute_dtype=jnp.float32,
                                           o2_master=True)
    losses = []
    for i, b in enumerate(batches):
        if i == 3:
            carried = jax.tree.map(np.asarray,
                                   serialization.to_state_dict(jstate))
        jstate, m = jstep(jstate, b, jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))

    cfg = load_config(TINY, no_dropout)
    model = build_model(cfg, "cpu", torch.float32)
    tx = build_optimizer(cfg)
    state = create_o2_train_state(model.decoder, tx)
    state_from_jax(carried, state)
    assert state.step == 3 and state.opt_state["inner"].count == 3
    step = make_train_step(model.loss_fn, tx, compute_dtype=torch.float32)
    for b, want in zip(batches[3:], losses[3:]):
        state, m = step(state, {k: torch.from_numpy(b[k])
                                for k in LOSS_KEYS})
        np.testing.assert_allclose(m["loss"].item(), want, rtol=1e-5)
    assert state.step == int(jstate.step) == 5
    inner = jstate.opt_state["inner"][1]
    tree = state.state_dict()["opt_state"]
    for name, jtree, got in (
            ("master", jstate.opt_state["master"], tree["master"]),
            ("mu", inner.mu, tree["inner"]["mu"]),
            ("nu", inner.nu, tree["inner"]["nu"])):
        for k, w in flatten_dict(jtree["params"], sep="/").items():
            np.testing.assert_allclose(got[torch_key(k)].numpy(),
                                       np.asarray(w), rtol=1e-5, atol=1e-7,
                                       err_msg=f"{name} {k}")
    assert tree["inner"]["count"] == int(inner.count) == 5
    assert set(tree["master"]) == set(params_from_jax(
        jax.tree.map(np.asarray, params), model.decoder))


# -- DeviceLoader --------------------------------------------------------

def _host_batches(n):
    for i in range(n):
        yield {"x": np.full((2, 3), i, np.float32),
               "m": np.arange(2) > i}


def test_device_loader_copies_every_batch_in_order():
    got = list(DeviceLoader(_host_batches(5), "cpu"))
    assert len(got) == 5
    for i, b in enumerate(got):
        assert torch.equal(b["x"], torch.full((2, 3), float(i)))
        assert b["m"].dtype == torch.bool


def test_device_loader_hands_the_error_over():
    def broken():
        yield from _host_batches(2)
        raise KeyError("bad record")

    seen = []
    with pytest.raises(KeyError, match="bad record"):
        for b in DeviceLoader(broken(), "cpu"):
            seen.append(b)
    assert len(seen) == 2


def test_device_loader_stops_its_worker_when_abandoned():
    before = set(threading.enumerate())
    it = iter(DeviceLoader(_host_batches(100), "cpu"))
    next(it)
    workers = set(threading.enumerate()) - before
    assert len(workers) == 1
    it.close()
    for t in workers:
        t.join(timeout=5)
        assert not t.is_alive()
