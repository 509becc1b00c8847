"""The port's `train` command, trainer and precisions against the
reference, on the CPU.

Both commands run on `configs/tiny_test.yaml` (32 train records in
batches of 4, 2 epochs: 16 steps, val loss every epoch) with every
dropout 0 and `log_every` 4. The reference's `cli.main(["train", ...])`
initializes with PRNGKey(0); the port's `cli.main` runs with its
`training_model` (the random init) swapped for that init carried across
by `params_from_jax`. A module fixture runs the reference's train and
its `evaluate -m best` and `-m avg:2` once, so JAX compiles once:

- the port's `metrics.jsonl` has the reference's records (losses within
  1e-5 relative; `input_wait` is a host time and only its key is held),
  its `meta.json` the same steps, best step and values within 1e-5, its
  last checkpoint's fp32 params within rtol 1e-5 / atol 1e-7 of the
  reference's (read with flax);
- the reference's checkpoints carried into port checkpoints by
  `state_from_jax`: `evaluate -m best` and `-m avg:2` write files
  byte-equal to the reference's; the step-8 state carried across and
  trained on through epoch 1 ends within 1e-5 of the reference's step 16;
- SIGTERM mid-epoch and `recover`, the out-of-memory skip and the
  restore after a failed optimizer update reproduce the reference's step
  counts;
- `bf16` against the reference's `bf16` step over 5 steps (losses within
  rtol 0.02 / atol 0.02, the tolerance of the bf16 flash tests), the
  port's `bf16` and `bf16_o2` trajectories bit-equal to each other, and
  `accumulate_gradients(tx, 2)` against optax's `MultiSteps` over 4
  micro-batches (params within rtol 1e-5 / atol 1e-7 after each);
- the `train` command runs every config the port builds (those of
  `transformer_flattened` and of its variants), narrowed, and `evaluate`
  loads what it wrote.
"""

import json
import os
import signal
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from news_image_caption_tpu import cli as jax_cli  # noqa: E402
from news_image_caption_tpu import config as jax_config  # noqa: E402
from news_image_caption_tpu.training import optim as jax_optim  # noqa: E402
from news_image_caption_tpu.training import \
    train_step as jax_train_step  # noqa: E402
from news_image_caption_tpu_torch import cli  # noqa: E402
from news_image_caption_tpu_torch.config import (  # noqa: E402
    build_dataset, build_model, build_optimizer, load_config, merge_overrides)
from news_image_caption_tpu_torch.data.loader import DeviceLoader  # noqa: E402
from news_image_caption_tpu_torch.data.synthetic import LOSS_KEYS  # noqa: E402
from news_image_caption_tpu_torch.models.from_jax import (  # noqa: E402
    params_from_jax, state_from_jax, torch_key)
from news_image_caption_tpu_torch.training.checkpoint import \
    CheckpointStore  # noqa: E402
from news_image_caption_tpu_torch.training.optim import (  # noqa: E402
    accumulate_gradients, make_bert_adam)
from news_image_caption_tpu_torch.training.train_step import (  # noqa: E402
    create_o2_train_state, create_train_state, make_train_step)
from news_image_caption_tpu_torch.training.trainer import (  # noqa: E402
    Trainer, TrainerConfig)

REPO = Path(__file__).resolve().parent.parent
TINY = str(REPO / "configs" / "tiny_test.yaml")
NO_DROPOUT = {"model": {"decoder": dict(
    dropout=0.0, weight_dropout=0.0, relu_dropout=0.0, input_dropout=0.0,
    attention_dropout=0.0)}}
OVERRIDES = merge_overrides(NO_DROPOUT, {"trainer": {"log_every": 4}})


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny models: one intra-op thread, so that the suite's parallel
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _overrides(out: Path) -> str:
    return json.dumps(merge_overrides(
        OVERRIDES, {"trainer": {"serialization_dir": str(out)}}))


def _jax_init(cfg_json: str):
    cfg = jax_config.load_config(TINY, cfg_json)
    model = jax_config.build_model(cfg)
    sample = next(jax_config.build_dataset(cfg, "train").batches(4))
    return model.init(jax.random.PRNGKey(0), sample)


def _carried(params, overrides: str, dtype=torch.float32):
    """The port's model holding JAX params, built from the tiny config."""
    model = build_model(load_config(TINY, overrides), "cpu", dtype)
    model.decoder.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, params), model.decoder))
    return model


def _read_jax(path: Path):
    return serialization.msgpack_restore(path.read_bytes())


def _records(path: Path):
    return [json.loads(line) for line in path.read_text().splitlines()]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's train, evaluate -m best and -m avg:2, run once."""
    out = tmp_path_factory.mktemp("reference")
    overrides = _overrides(out)
    assert jax_cli.main(["train", TINY, "--platform", "cpu", "-o",
                         overrides]) == 0
    for which, suffix in (("best", "_best"), ("avg:2", "_avg")):
        assert jax_cli.main(["evaluate", TINY, "--platform", "cpu", "-o",
                             overrides, "-m", which, "-s", suffix]) == 0
    return out


@pytest.fixture(scope="module")
def port_run(reference, tmp_path_factory):
    """The port's train command from the reference's init."""
    out = tmp_path_factory.mktemp("port")
    overrides = _overrides(out)
    params = _jax_init(overrides)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "training_model",
                   lambda cfg, device, seed: _carried(params, overrides))
        assert cli.main(["train", TINY, "--platform", "cpu", "-o",
                         overrides]) == 0
    return out


def test_train_metrics_match_reference(reference, port_run):
    want = _records(reference / "metrics.jsonl")
    got = _records(port_run / "metrics.jsonl")
    assert [r["split"] for r in got] == ["train", "train", "val"] * 2
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k, v in w.items():
            if k == "loss":
                np.testing.assert_allclose(g[k], v, rtol=1e-5)
            elif k != "input_wait":
                assert g[k] == v, k
        if w["split"] == "train":
            assert 0.0 <= g["input_wait"] <= 1.0


def test_meta_matches_reference(reference, port_run):
    want = json.loads((reference / "checkpoints" / "meta.json").read_text())
    got = json.loads((port_run / "checkpoints" / "meta.json").read_text())
    assert [c["step"] for c in got["checkpoints"]] == [8, 16] == \
        [c["step"] for c in want["checkpoints"]]
    assert got["best"]["step"] == want["best"]["step"] == 16
    np.testing.assert_allclose(got["best"]["value"], want["best"]["value"],
                               rtol=1e-5)
    for g, w in zip(got["checkpoints"], want["checkpoints"]):
        assert set(g["metrics"]) == set(w["metrics"]) == {
            "epoch", "loss", "n_batches"}
        assert g["metrics"]["epoch"] == w["metrics"]["epoch"]
        np.testing.assert_allclose(g["metrics"]["loss"],
                                   w["metrics"]["loss"], rtol=1e-5)
    assert sorted(os.listdir(port_run / "checkpoints")) == [
        "best.pt", "ckpt_16.pt", "ckpt_8.pt", "meta.json"]


def test_final_params_match_reference(reference, port_run):
    want = _read_jax(reference / "checkpoints" / "ckpt_16.msgpack")
    got = torch.load(port_run / "checkpoints" / "ckpt_16.pt",
                     weights_only=True)
    assert got["step"] == int(want["step"]) == 16
    assert got["opt_state"]["count"] == 16
    flat = {torch_key(k): v for k, v in
            flatten_dict(want["params"]["params"], sep="/").items()}
    assert set(flat) == set(got["params"])
    for k, w in flat.items():
        assert got["params"][k].dtype == torch.float32
        np.testing.assert_allclose(got["params"][k].numpy(), w, rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_tensorboard_scalars_match_reference(reference, port_run):
    """The same (step, tag) events; values within 1e-5 but the host
    times (tokens/s, input wait)."""
    from news_image_caption_tpu_torch.utils.tensorboard import read_events

    def events(out):
        (path,) = (out / "log").iterdir()
        return read_events(str(path))

    want, got = events(reference), events(port_run)
    assert [(e.step, e.tag) for e in got] == [(e.step, e.tag) for e in want]
    assert {e.tag for e in got} == {
        "train/loss", "train/tokens_per_sec", "train/input_wait",
        "train/skipped_batches", "validation/loss", "validation/n_batches"}
    for g, w in zip(got, want):
        if g.tag not in ("train/tokens_per_sec", "train/input_wait"):
            np.testing.assert_allclose(g.value, w.value, rtol=1e-5,
                                       err_msg=g.tag)


def _tiny_state(overrides: str = json.dumps(NO_DROPOUT)):
    cfg = load_config(TINY, overrides)
    model = build_model(cfg, "cpu", torch.float32)
    tx = build_optimizer(cfg)
    return cfg, model, tx, create_train_state(model.decoder, tx)


@pytest.fixture(scope="module")
def carried_store(reference, tmp_path_factory):
    """The reference's two checkpoints carried into a port store with
    the reference's metrics."""
    out = tmp_path_factory.mktemp("carried")
    meta = json.loads((reference / "checkpoints" / "meta.json").read_text())
    store = CheckpointStore(str(out / "checkpoints"), keep=3)
    for entry in meta["checkpoints"]:
        _, _, _, state = _tiny_state()
        state_from_jax(_read_jax(reference / "checkpoints"
                                 / f"ckpt_{entry['step']}.msgpack"), state)
        assert state.step == entry["step"]
        store.save(state, entry["step"], entry["metrics"])
    return out


@pytest.mark.parametrize("which,suffix", [("best", "_best"),
                                          ("avg:2", "_avg")])
def test_evaluate_checkpoint_files_are_byte_equal(reference, carried_store,
                                                  which, suffix, capsys):
    assert cli.main(["evaluate", TINY, "--platform", "cpu", "-o",
                     _overrides(carried_store), "-m", which, "-s",
                     suffix]) == 0
    assert "random init" not in capsys.readouterr().err
    for name in (f"generations{suffix}.jsonl",
                 f"evaluate-metrics{suffix}.json"):
        assert (carried_store / name).read_bytes() == \
            (reference / name).read_bytes(), name


def test_state_from_jax_continues_the_trajectory(reference):
    """The reference's step-8 state carried across, then epoch 1's eight
    batches through the port's step: the reference's step 16."""
    cfg, model, tx, state = _tiny_state()
    state_from_jax(_read_jax(reference / "checkpoints" / "ckpt_8.msgpack"),
                   state)
    assert state.step == 8 and state.opt_state.count == 8
    step = make_train_step(model.loss_fn, tx, compute_dtype=torch.float32)
    loader = DeviceLoader(({k: b[k] for k in LOSS_KEYS} for b in
                           build_dataset(cfg, "train").batches(4, seed=1)),
                          "cpu")
    for batch in loader:
        state, m = step(state, batch)
        assert m["skipped"] == 0
    want = _read_jax(reference / "checkpoints" / "ckpt_16.msgpack")
    assert state.step == 16 and state.opt_state.count == 16
    tree = state.state_dict()
    for part, jtree in (("params", want["params"]),
                        ("mu", want["opt_state"]["1"]["mu"]),
                        ("nu", want["opt_state"]["1"]["nu"])):
        got = tree["params"] if part == "params" else \
            tree["opt_state"][part]
        for k, w in flatten_dict(jtree["params"], sep="/").items():
            np.testing.assert_allclose(got[torch_key(k)].detach().numpy(), w,
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"{part} {k}")


def test_state_from_jax_carries_the_o2_layout():
    cfg = jax_config.load_config(TINY)
    params = _jax_init(None)
    jtx = jax_config.build_optimizer(cfg)
    jstate = jax_train_step.create_o2_train_state(params, jtx)
    tree = serialization.to_state_dict(jstate)
    pcfg = load_config(TINY)
    master = build_model(pcfg, "cpu", torch.float32)
    compute = build_model(pcfg, "cpu", torch.bfloat16)
    state = create_o2_train_state(compute.decoder, build_optimizer(pcfg),
                                  master=master.decoder)
    state_from_jax(jax.tree.map(np.asarray, tree), state)
    master = {torch_key(k): np.asarray(v) for k, v in
              flatten_dict(params["params"], sep="/").items()}
    stored = {torch_key(k): np.asarray(v, np.float32) for k, v in
              flatten_dict(jstate.params["params"], sep="/").items()}
    assert set(master) == set(state.params) and state.step == 0
    for k, w in master.items():
        np.testing.assert_array_equal(state.opt_state["master"][k].numpy(), w)
        assert state.params[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            state.params[k].detach().float().numpy(), stored[k])
    inner = state.opt_state["inner"]
    assert inner.count == 0 and all(not m.any() for m in inner.mu + inner.nu)


# -- trainer: preemption, recover, out of memory ------------------------

def _tiny_trainer(tmp_path, **kw):
    cfg, model, tx, state = _tiny_state()
    ds = build_dataset(cfg, "train")
    conf = TrainerConfig(serialization_dir=str(tmp_path), log_every=2, **kw)
    return ds, model, tx, state, Trainer(model.loss_fn, tx, conf), conf


def _loader(ds, epoch):
    return DeviceLoader(({k: b[k] for k in LOSS_KEYS}
                         for b in ds.batches(4, seed=epoch)), "cpu")


def test_preemption_checkpoints_and_recover_resumes(tmp_path):
    """SIGTERM mid-epoch: a checkpoint tagged preempted at the step
    reached (11), a clean return; recover reruns epochs 1 and 2 from it
    (step 27), as the reference's trainer does."""
    ds, model, tx, state, trainer, conf = _tiny_trainer(tmp_path,
                                                         num_epochs=3)
    before = signal.getsignal(signal.SIGTERM)

    def batches(epoch):
        for i, b in enumerate(_loader(ds, epoch)):
            if epoch == 1 and i == 3:
                os.kill(os.getpid(), signal.SIGTERM)
            yield b

    state = trainer.train(state, batches)
    assert state.step == 8 + 3
    meta = json.loads((tmp_path / "checkpoints" / "meta.json").read_text())
    last = max(meta["checkpoints"], key=lambda c: c["step"])
    assert last["step"] == 11
    assert last["metrics"] == {"epoch": 1, "preempted": True}
    assert signal.getsignal(signal.SIGTERM) is before

    _, model2, tx2, state2 = _tiny_state()
    trainer2 = Trainer(model2.loss_fn, tx2, conf)
    state2 = trainer2.train(state2, lambda e: _loader(ds, e), recover=True)
    assert state2.step == 11 + 2 * 8
    assert state2.opt_state.count == 27


def test_oom_batches_are_skipped(tmp_path):
    ds, model, tx, state, trainer, _ = _tiny_trainer(tmp_path, num_epochs=1)
    real_step = trainer.train_step
    calls = {"n": 0}

    def flaky_step(state, b, seed):
        calls["n"] += 1
        if calls["n"] in (2, 5):
            raise torch.OutOfMemoryError("CUDA out of memory. boom")
        return real_step(state, b, seed)

    trainer.train_step = flaky_step
    state = trainer.train(state, lambda e: _loader(ds, e))
    # 8 batches offered, 2 rejected: 6 steps.
    assert state.step == 6 and not state.in_update


def test_oom_gives_up_after_consecutive_failures(tmp_path):
    ds, model, tx, state, trainer, _ = _tiny_trainer(
        tmp_path, num_epochs=1, max_consecutive_oom=2)

    def always_oom(state, b, seed):
        raise torch.OutOfMemoryError("CUDA out of memory. boom")

    trainer.train_step = always_oom
    with pytest.raises(torch.OutOfMemoryError):
        trainer.train(state, lambda e: _loader(ds, e))


@pytest.mark.parametrize("with_checkpoint", [True, False])
def test_oom_in_the_update_restores_the_latest_checkpoint(tmp_path,
                                                          with_checkpoint):
    """An OOM inside the optimizer's in-place update tears the state:
    the trainer restores the newest checkpoint (step 8) and goes on with
    the epoch's other batches; with no checkpoint it raises."""
    ds, model, tx, state, trainer, _ = _tiny_trainer(tmp_path, num_epochs=2)
    real_apply = tx.apply
    fail_at = [11 if with_checkpoint else 3]     # once

    def apply(grads, opt_state, params):
        if opt_state.count + 1 == fail_at[0]:
            fail_at[0] = None
            torch._foreach_mul_(params, 0.0)       # half-written update
            raise torch.OutOfMemoryError("CUDA out of memory. boom")
        real_apply(grads, opt_state, params)

    tx.apply = apply
    if not with_checkpoint:
        with pytest.raises(RuntimeError, match="no checkpoint"):
            trainer.train(state, lambda e: _loader(ds, e))
        return
    state = trainer.train(state, lambda e: _loader(ds, e))
    # Epoch 1: steps 9, 10, then the failed 11th restores step 8, then
    # the epoch's last five batches.
    assert state.step == 8 + 5 and state.opt_state.count == 13
    assert not state.in_update
    assert all(bool(torch.isfinite(p).all()) and p.abs().sum() > 0
               for p in state.params.values())


def test_patience_stops_early(tmp_path):
    """With the rate at 0 the val loss never improves: patience 1 stops
    after the second epoch of five, as the reference's loop does."""
    ds, model, tx, state, trainer, _ = _tiny_trainer(
        tmp_path, num_epochs=5, patience=1)
    tx.lr_schedule = lambda n: 0.0
    val = build_dataset(load_config(TINY), "val")
    state = trainer.train(state, lambda e: _loader(ds, e),
                          lambda e: DeviceLoader(
                              ({k: b[k] for k in LOSS_KEYS}
                               for b in val.batches(4, shuffle=False)), "cpu"))
    assert state.step == 16
    vals = [r for r in trainer.history if r["split"] == "val"]
    assert len(vals) == 2 and vals[0]["loss"] == vals[1]["loss"]


def test_train_command_recovers(tmp_path):
    """`train -r` with one more epoch resumes at step 16 (epoch 2) and
    runs epoch 2 only."""
    def run(extra, epochs):
        overrides = json.dumps({"trainer": {"num_epochs": epochs}})
        assert cli.main(["train", TINY, "--platform", "cpu", "-s",
                         str(tmp_path), "-o", overrides] + extra) == 0

    run([], 2)
    run(["-r"], 3)
    meta = json.loads((tmp_path / "checkpoints" / "meta.json").read_text())
    assert [c["step"] for c in meta["checkpoints"]] == [8, 16, 24]
    assert meta["checkpoints"][-1]["metrics"]["epoch"] == 3
    epochs = [r["epoch"] for r in _records(tmp_path / "metrics.jsonl")
              if r["split"] == "val"]
    assert epochs == [0, 1, 2]


def test_build_optimizer_reads_the_references_keys():
    cfg = load_config(str(REPO / "configs/goodnews_transformer_roberta.yaml"))
    tx = build_optimizer(cfg)
    assert (tx.b1, tx.b2, tx.eps, tx.weight_decay, tx.max_grad_norm) == (
        0.9, 0.98, 1e-6, 1e-5, 0.1)
    jsched = jax.jit(jax_optim.warmup_linear_schedule(1e-4, 437600, 0.05))
    for n in (0, 1, 21880, 21881, 437600):
        assert tx.lr_schedule(n) == float(jsched(jnp.int32(n)))
    bad = merge_overrides(cfg, {"trainer": {"optimizer": {"learning_rate":
                                                          1.0}}})
    with pytest.raises(ValueError, match="learning_rate"):
        build_optimizer(bad)
    gen1 = build_optimizer({"trainer": {"optimizer": {
        "type": "gen1_adam", "lr": 5e-4, "decay_every": 30000,
        "decay_rate": 0.8, "grad_clip": 2.0}}})
    assert (gen1.b1, gen1.b2, gen1.eps, gen1.clip_value) == (
        0.8, 0.999, 1e-8, 2.0)
    gsched = jax.jit(jax_optim.step_decay_schedule(5e-4, 0, 30000, 0.8))
    for n in (0, 29999, 30000, 90001):
        assert gen1.lr_schedule(n) == float(gsched(jnp.int32(n)))
    noam = {"trainer": {"optimizer": {"type": "noam", "model_size": 512,
                                      "warmup": 300}}}
    tx = build_optimizer(noam)
    nsched = jax.jit(jax_optim.noam_schedule(512, 1.0, 300))
    for n in (0, 1, 2, 299, 300, 5000):
        np.testing.assert_allclose(tx.lr_schedule(n),
                                   float(nsched(jnp.int32(n))), rtol=1e-6)
    with pytest.raises(ValueError, match="lr"):
        build_optimizer(merge_overrides(noam, {"trainer": {"optimizer": {
            "lr": 1.0}}}))


def test_train_without_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--platform cpu"):
        cli.main(["train", TINY, "-s", str(tmp_path)])
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("path", ["configs/goodnews_transformer_roberta.yaml",
                                  "configs/nytimes/transformer_roberta.yaml"])
def test_fp32_with_flash_routes_every_flash_attention_generic(path):
    """fp32 meets a model with use_flash_train: every flash attention of
    the built model (on meta) routes to the generic flash kernels, which
    take fp32, so the card trains it through them; the same model in
    bf16 routes to the fast kernels."""
    from news_image_caption_tpu_torch.ops.flash_attention import route_flash
    on = {"use_flash_train": True}
    model = load_config(str(REPO / path))["model"]
    overrides = {"model": {"decoder": on} if "decoder" in model else on,
                 "trainer": {"mixed_precision": "fp32"}}
    cfg = load_config(str(REPO / path), json.dumps(overrides))
    flash = [m for m in build_model(cfg, "meta",
                                    torch.float32).param_module.modules()
             if getattr(m, "use_flash", False)]
    assert flash
    assert all(route_flash(torch.float32, m.head_dim) == "generic"
               for m in flash)
    assert all(route_flash(torch.bfloat16, m.head_dim) == "fast"
               for m in flash)


def test_fp32_flash_train_command_matches_plain_attention(tmp_path,
                                                          monkeypatch):
    """train configs/tiny_test.yaml --platform cpu at mixed_precision
    fp32 with use_flash_train (the flash path's plain version on the CPU)
    gives, at p = 0, the records of the same command without flash:
    losses within 1e-5 relative."""
    from news_image_caption_tpu_torch.ops import attention
    calls = []
    real = attention.flash_cross_attention
    monkeypatch.setattr(attention, "flash_cross_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    records = {}
    for flash in (False, True):
        out = tmp_path / f"flash_{flash}"
        overrides = merge_overrides(OVERRIDES, {
            "model": {"decoder": {"use_flash_train": flash}},
            "trainer": {"mixed_precision": "fp32",
                        "serialization_dir": str(out)}})
        before = len(calls)
        assert cli.main(["train", TINY, "--platform", "cpu", "-o",
                         json.dumps(overrides)]) == 0
        assert (len(calls) > before) == flash
        records[flash] = _records(out / "metrics.jsonl")
    want, got = records[False], records[True]
    assert [(r["split"], r["step"]) for r in got] == [
        (r["split"], r["step"]) for r in want]
    np.testing.assert_allclose([r["loss"] for r in got],
                               [r["loss"] for r in want], rtol=1e-5, atol=0)


# -- precisions and accumulation against the reference ------------------

BF16_MODEL = {"model": {"decoder": {"dtype": "bfloat16"}}}


def test_bf16_matches_reference_bf16_step():
    """5 steps of the reference's bf16 step (fp32 params cast to bf16,
    the decoder computing in bf16) against the port's bf16 state (fp32
    params, bf16 compute copy): losses within rtol 0.02 / atol 0.02."""
    overrides = json.dumps(merge_overrides(NO_DROPOUT, BF16_MODEL))
    jcfg = jax_config.load_config(TINY, overrides)
    jmodel = jax_config.build_model(jcfg)
    ds = jax_config.build_dataset(jcfg, "train")
    batches = [b for _, b in zip(range(5), ds.batches(4, seed=0))]
    params = jmodel.init(jax.random.PRNGKey(0), batches[0])
    jtx = jax_config.build_optimizer(jcfg)
    jstate = jax_train_step.create_train_state(params, jtx)
    jstep = jax_train_step.make_train_step(jmodel.loss_fn, jtx, donate=False,
                                           compute_dtype=jnp.bfloat16)
    cfg = load_config(TINY, overrides)
    fp32 = _carried(params, overrides)
    compute = build_model(cfg, "cpu", torch.bfloat16)
    tx = build_optimizer(cfg)
    state = create_train_state(fp32.decoder, tx, compute=compute.decoder)
    step = make_train_step(compute.loss_fn, tx, compute_dtype=torch.bfloat16)
    want, got = [], []
    for b in batches:
        jstate, jm = jstep(jstate, b, jax.random.PRNGKey(0))
        state, m = step(state, {k: torch.from_numpy(b[k])
                                for k in LOSS_KEYS})
        want.append(float(jm["loss"]))
        got.append(m["loss"].item())
        assert m["skipped"] == 0
    np.testing.assert_allclose(got, want, rtol=0.02, atol=0.02)
    assert all(p.dtype == torch.float32 for p in state.params.values())
    for k, p in state.params.items():
        assert torch.equal(state.compute[k], p.detach().bfloat16()), k
    assert state.opt_state.count == 5


def test_bf16_and_bf16_o2_trajectories_are_equal():
    """The forward sees the same bf16 weights and the optimizer the same
    fp32 values in both layouts: 8 steps bit for bit."""
    cfg = load_config(TINY, json.dumps(NO_DROPOUT))
    ds = build_dataset(cfg, "train")
    init = build_model(cfg, "cpu", torch.float32,
                       torch.Generator().manual_seed(0))
    runs = {}
    for precision in ("bf16", "bf16_o2"):
        fp32 = build_model(cfg, "cpu", torch.float32)
        fp32.decoder.load_state_dict(init.decoder.state_dict())
        model, state = cli.train_state(cfg, fp32, build_optimizer(cfg),
                                       precision, torch.device("cpu"))
        step = make_train_step(model.loss_fn, build_optimizer(cfg),
                               compute_dtype=torch.bfloat16)
        losses = []
        for b in _loader(ds, 0):
            state, m = step(state, b)
            losses.append(m["loss"].item())
        runs[precision] = (losses, state)
    (la, a), (lb, b) = runs["bf16"], runs["bf16_o2"]
    assert la == lb and all(np.isfinite(la))
    assert all(p.dtype == torch.bfloat16 for p in b.params.values())
    for k, p in a.params.items():
        assert torch.equal(p.detach(), b.opt_state["master"][k]), k
        assert torch.equal(a.compute[k], b.params[k].detach()), k


def test_accumulation_matches_reference_multisteps():
    """accumulate_gradients(tx, 2) over 4 micro-batches of 2 against
    optax's MultiSteps: params within rtol 1e-5 / atol 1e-7 after each,
    unchanged after the first of a window, and one inner update a
    window; the window's mean gradient equals the full batch's step."""
    overrides = json.dumps(NO_DROPOUT)
    jcfg = jax_config.load_config(TINY, overrides)
    jmodel = jax_config.build_model(jcfg)
    ds = jax_config.build_dataset(jcfg, "train")
    full = [b for _, b in zip(range(2), ds.batches(4, shuffle=False))]
    micro = [jax.tree.map(lambda x, h=h: x[2 * h:2 * h + 2], b)
             for b in full for h in (0, 1)]
    params = jmodel.init(jax.random.PRNGKey(0), full[0])
    jtx = jax_optim.accumulate_gradients(
        jax_optim.make_bert_adam(lr=1e-3, t_total=1000, warmup=0.01), 2)
    jstate = jax_train_step.create_train_state(params, jtx)
    jstep = jax_train_step.make_train_step(jmodel.loss_fn, jtx, donate=False)
    model = _carried(params, overrides)
    tx = accumulate_gradients(make_bert_adam(lr=1e-3, t_total=1000,
                                             warmup=0.01), 2)
    state = create_train_state(model.decoder, tx)
    step = make_train_step(model.loss_fn, tx, compute_dtype=torch.float32)
    start = {k: p.detach().clone() for k, p in state.params.items()}
    for i, b in enumerate(micro):
        jstate, _ = jstep(jstate, b, jax.random.PRNGKey(0))
        state, _ = step(state, {k: torch.from_numpy(b[k])
                                for k in LOSS_KEYS})
        opt = state.opt_state
        assert (opt.mini_step, opt.gradient_step,
                opt.inner_opt_state.count) == ((i + 1) % 2, (i + 1) // 2,
                                               (i + 1) // 2)
        assert opt.mini_step == int(jstate.opt_state.mini_step)
        want = flatten_dict(jstate.params["params"], sep="/")
        for k, w in want.items():
            np.testing.assert_allclose(
                state.params[torch_key(k)].detach().numpy(), np.asarray(w),
                rtol=1e-5, atol=1e-7, err_msg=k)
        if i == 0:
            assert all(torch.equal(p.detach(), start[k])
                       for k, p in state.params.items())
    # One window of two halves against one step on the whole batch
    # (BertAdam's first update hardly depends on the gradient's scale).
    runs = []
    for every, batches in ((1, full[:1]), (2, micro[:2])):
        model = _carried(params, overrides)
        tx = accumulate_gradients(make_bert_adam(lr=1e-3, t_total=1000,
                                                 warmup=0.01), every)
        state = create_train_state(model.decoder, tx)
        step = make_train_step(model.loss_fn, tx, compute_dtype=torch.float32)
        for b in batches:
            state, _ = step(state, {k: torch.from_numpy(b[k])
                                    for k in LOSS_KEYS})
        runs.append(state.params)
    for k, p in runs[0].items():
        np.testing.assert_allclose(runs[1][k].detach().numpy(),
                                   p.detach().numpy(), rtol=2e-5, atol=1e-7,
                                   err_msg=k)


# -- the train command over the configs the port builds -----------------

FLATTENED = ["configs/goodnews_transformer_roberta.yaml",
             "configs/nytimes/location_aware.yaml",
             "configs/nytimes/transformer_roberta.yaml",
             "configs/tiny_test.yaml",
             "configs/goodnews/transformer_faces.yaml",
             "configs/nytimes/transformer_faces.yaml",
             "configs/goodnews/transformer_objects.yaml",
             "configs/nytimes/transformer_objects.yaml",
             "configs/nytimes/transformer_faces_objects.yaml",
             "configs/goodnews/transformer_glove.yaml",
             "configs/nytimes/transformer_glove.yaml",
             "configs/goodnews/no_image.yaml",
             "configs/nytimes/no_image.yaml"]
NARROW = dict(vocab_size=64, cutoff=[16, 32, 64], embed_dim=16, ffn_dim=32,
              num_heads=4, image_dim=16, article_dim=12, max_positions=64)
NARROW_EXTRA = {"transformer_faces": dict(face_dim=8),
                "transformer_faces_objects": dict(face_dim=8, obj_dim=6)}
NARROW_DATA = dict(vocab_size=64, caption_len=12, article_len=16,
                   n_patches=4, image_dim=16, article_dim=12, face_dim=8,
                   obj_dim=6, train={"size": 8}, val={"size": 4},
                   test={"size": 4})


@pytest.mark.parametrize("path", FLATTENED)
def test_train_command_runs_every_config_narrowed(path, tmp_path, capsys):
    cfg = load_config(str(REPO / path))
    narrow = ({"decoder": NARROW} if "decoder" in cfg["model"] else
              dict(NARROW, **NARROW_EXTRA.get(cfg["model"]["type"], {})))
    overrides = json.dumps({
        "model": narrow, "dataset": NARROW_DATA, "iterator": {"batch_size": 4},
        "generation": {"max_len": 4},
        "trainer": {"num_epochs": 1, "log_every": 1,
                    "serialization_dir": str(tmp_path)}})
    assert cli.main(["train", str(REPO / path), "--platform", "cpu", "-o",
                     overrides]) == 0
    recs = _records(tmp_path / "metrics.jsonl")
    assert [r["split"] for r in recs] == ["train", "train", "val"]
    assert all(np.isfinite(r["loss"]) for r in recs)
    precision = cfg["trainer"].get("mixed_precision") or "fp32"
    ckpt = torch.load(tmp_path / "checkpoints" / "ckpt_2.pt",
                      weights_only=True)
    want = torch.bfloat16 if precision == "bf16_o2" else torch.float32
    assert all(p.dtype == want for p in ckpt["params"].values())
    assert ("master" in ckpt["opt_state"]) == (precision == "bf16_o2")
    assert cli.main(["evaluate", str(REPO / path), "--platform", "cpu",
                     "-o", overrides, "-m", "latest"]) == 0
    assert "random init" not in capsys.readouterr().err
    assert len(_records(tmp_path / "generations.jsonl")) == 4
