"""The port's profiling hooks, step loaders, bf16 first moments and
registries against the reference's, on the CPU.

- `FixedStepsLoader` and `TokenBucketBatcher` (`data/loader.py`, plain
  Python copies): the same batches as the reference's from the same
  factories and instances, the same batches materialized on resume, the
  same errors.
- `StepTimer` and `MetricsLogger` (`utils/profiling.py`): the same keys
  and records.
- The trainer's profiler window (`training/trainer.py`) through the
  `train` command on `configs/tiny_test.yaml` (8 steps an epoch): a
  trace file a window in `<serialization_dir>/profile`, as many
  `train_step.forward` spans as `profile_steps`, the start at or past
  `profile_start` after `--recover`, a window cut short by the run's
  end closed and written.
- `BertAdam(moment_dtype=torch.bfloat16)` against the reference's
  `bert_adam(moment_dtype=jnp.bfloat16)` on the same gradients: the
  stored bf16 first moments bit for bit, the parameters within 1e-6;
  the bf16 moments through a checkpoint.
- `utils/registry.py`: the same behaviour as the reference's `Registry`,
  and a model type registered in a test builds from a YAML in both
  packages (the entry removed afterwards).
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from news_image_caption_tpu import config as jax_config  # noqa: E402
from news_image_caption_tpu.data import loader as jax_loader  # noqa: E402
from news_image_caption_tpu.models.captioner import \
    TransformerFlattened as JaxTransformerFlattened  # noqa: E402
from news_image_caption_tpu.training import optim as jax_optim  # noqa: E402
from news_image_caption_tpu.utils import profiling as jax_profiling  # noqa
from news_image_caption_tpu.utils import registry as jax_registry  # noqa
from news_image_caption_tpu_torch import Registry, cli, config  # noqa: E402
from news_image_caption_tpu_torch.data import loader  # noqa: E402
from news_image_caption_tpu_torch.models.captioner import \
    TransformerFlattened  # noqa: E402
from news_image_caption_tpu_torch.models.from_jax import \
    params_from_jax  # noqa: E402
from news_image_caption_tpu_torch.training.checkpoint import \
    CheckpointStore  # noqa: E402
from news_image_caption_tpu_torch.training.optim import \
    make_bert_adam  # noqa: E402
from news_image_caption_tpu_torch.utils import profiling, registry  # noqa

REPO = Path(__file__).resolve().parent.parent
TINY = str(REPO / "configs" / "tiny_test.yaml")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, so that the suite's parallel
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- FixedStepsLoader ------------------------------------------------------

def _factory(sizes, with_start: bool, made: list):
    """make_batches(seed[, start]) over seeds of sizes[seed % len]
    batches (seed, i); `made` records every batch materialized."""
    def batches(seed, start=0):
        for i in range(start, sizes[seed % len(sizes)]):
            made.append((seed, i))
            yield (seed, i)

    if with_start:
        return batches
    return lambda seed: batches(seed)


@pytest.mark.parametrize("sizes,steps,per_seed", [
    ((5,), 3, 5), ((5,), 3, None), ((4, 0, 3), 4, None), ((7,), 7, 7),
])
@pytest.mark.parametrize("with_start", [True, False])
def test_fixed_steps_loader_matches_reference(sizes, steps, per_seed,
                                              with_start):
    """Epochs 0..5 from scratch, each epoch alone as a resumed run would
    draw it, through the start= fast path where the factory takes an
    explicit `start` and the count a seed is known, else the
    materializing skip."""
    out = {}
    for name, mod in (("ref", jax_loader), ("port", loader)):
        made: list = []
        lf = mod.FixedStepsLoader(_factory(sizes, with_start, made), steps,
                                  batches_per_seed=per_seed)
        epochs = [list(lf.epoch(e)) for e in range(6)]
        out[name] = (epochs, made)
        assert all(len(e) == steps for e in epochs)
    assert out["port"] == out["ref"]
    if with_start and per_seed:
        # Resuming at epoch E materializes epoch E's batches only.
        epochs, made = out["port"]
        assert len(made) == 6 * steps


@pytest.mark.parametrize("with_start", [True, False])
def test_fixed_steps_loader_empty_factory_raises(with_start):
    for mod in (jax_loader, loader):
        lf = mod.FixedStepsLoader(_factory((0,), with_start, []), 2)
        with pytest.raises(ValueError, match="no batches"):
            list(lf.epoch(0))


def test_fixed_steps_loader_ignores_a_kwargs_factory():
    """A factory that swallows **kwargs is not trusted with start=: the
    skip materializes instead, in both packages."""
    for mod in (jax_loader, loader):
        made: list = []

        def factory(seed, **kwargs):
            return _factory((5,), False, made)(seed)

        lf = mod.FixedStepsLoader(factory, 3, batches_per_seed=5)
        assert list(lf.epoch(1)) == [(0, 3), (0, 4), (1, 0)]
        assert made[:3] == [(0, 0), (0, 1), (0, 2)]


# -- TokenBucketBatcher ----------------------------------------------------

def _instances(n: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    return [{"id": i, "len": int(n_)} for i, n_ in
            enumerate(rng.randint(1, 513, size=n))]


@pytest.mark.parametrize("batch_size,max_tokens,window", [
    (16, 16384, 6000), (16, 2048, 64), (8, None, 50), (32, 4096, 1),
])
def test_token_bucket_batcher_matches_reference(batch_size, max_tokens,
                                                window):
    insts = _instances(200)
    got = [{k: (b, bl) for k, (b, bl) in enumerate(
        mod.TokenBucketBatcher(lambda x: x["len"], batch_size=batch_size,
                               max_tokens=max_tokens,
                               window=window).batches(iter(insts)))}
        for mod in (jax_loader, loader)]
    assert got[1] == got[0]
    batches = list(got[1].values())
    assert sorted(x["id"] for b, _ in batches for x in b) == list(range(200))
    for b, bucket in batches:
        assert len(b) <= batch_size
        assert max(x["len"] for x in b) <= bucket
        assert max_tokens is None or len(b) == 1 or \
            len(b) * bucket <= max_tokens


def test_token_bucket_batcher_oversize_raises():
    for mod in (jax_loader, loader):
        tb = mod.TokenBucketBatcher(lambda x: x["len"])
        assert tb.bucket_for(512) == 512 and tb.bucket_for(33) == 64
        with pytest.raises(ValueError, match="exceeds the largest bucket"):
            tb.bucket_for(513)
        with pytest.raises(ValueError, match="exceeds the largest bucket"):
            list(tb.batches([{"len": 10}, {"len": 600}]))


# -- StepTimer and MetricsLogger -------------------------------------------

def test_step_timer_keys_match_reference(monkeypatch):
    """Ticks at fixed clock readings give the reference's EMA readings;
    the port's reads a tensor on the host before the clock."""
    import time as time_mod
    clock = iter([10.0, 10.5, 11.5, 11.75] * 2)
    monkeypatch.setattr(time_mod, "perf_counter", lambda: next(clock))
    out = []
    for mod, watched in ((jax_profiling, np.float32(1.0)),
                         (profiling, torch.ones(2))):
        timer = mod.StepTimer(ema=0.5)
        out.append([timer.tick(watched, tokens=t) for t in (0, 100, 0, 50)])
    assert out[1] == out[0]
    assert out[0][0] == {} and set(out[0][1]) == {"step_time_s",
                                                  "tokens_per_sec"}
    assert out[0][3]["tokens_per_sec"] == 0.5 * 200.0 + 0.5 * 200.0


def test_metrics_logger_records_match_reference(tmp_path):
    recs = []
    for name, mod in (("ref", jax_profiling), ("port", profiling)):
        path = tmp_path / f"{name}.jsonl"
        log = mod.MetricsLogger(str(path), flush_every=2)
        log.log(1, loss=np.float32(2.5), note="a")
        assert path.read_text() == ""         # not flushed yet
        log.log(2, loss=torch.tensor(1.25) if name == "port" else 1.25)
        log.log(3, n=4)
        log.close()
        recs.append([json.loads(line) for line in
                     path.read_text().splitlines()])
    for r in recs:
        for rec in r:
            assert isinstance(rec.pop("time"), float)
    assert recs[1] == recs[0] == [{"step": 1, "loss": 2.5, "note": "a"},
                                  {"step": 2, "loss": 1.25},
                                  {"step": 3, "n": 4.0}]


# -- the profiler window ---------------------------------------------------

def _train(tmp_path, trainer, recover=False):
    overrides = {"trainer": {"serialization_dir": str(tmp_path),
                             **trainer}}
    argv = ["train", TINY, "--platform", "cpu", "-o", json.dumps(overrides)]
    assert cli.main(argv + (["-r"] if recover else [])) == 0


def _windows(tmp_path):
    """{trace file: train_step.forward spans} of the profile directory."""
    return {p.name: sum(e.get("name") == "train_step.forward" for e in
                        json.loads(p.read_text())["traceEvents"])
            for p in (tmp_path / "profile").glob("*.pt.trace.json")}


def test_profiler_window_and_recover(tmp_path, caplog):
    """Epoch 0 (steps 0..7) traces steps 2, 3, 4; recovered at step 8,
    past profile_start, the run traces its first 3 steps, 8..10."""
    caplog.set_level("INFO", logger="trainer")
    window = {"profile_start": 2, "profile_steps": 3}
    _train(tmp_path, {"num_epochs": 1, **window})
    first = _windows(tmp_path)
    assert list(first.values()) == [3]
    _train(tmp_path, {"num_epochs": 2, **window}, recover=True)
    both = _windows(tmp_path)
    assert len(both) == 2 and list(both.values()) == [3, 3]
    starts = re.findall(r"profiling steps (\d+)\.\.(\d+)", caplog.text)
    assert starts == [("2", "5"), ("8", "11")]
    assert caplog.text.count("profile trace written") == 2


def test_profiler_window_closed_at_the_end(tmp_path, caplog):
    """A window that outlasts the run is closed, and written, on exit."""
    caplog.set_level("INFO", logger="trainer")
    _train(tmp_path, {"num_epochs": 1, "profile_start": 6,
                      "profile_steps": 10})
    assert list(_windows(tmp_path).values()) == [2]
    assert "profile trace written" not in caplog.text


def test_profiler_off_writes_nothing(tmp_path):
    _train(tmp_path, {"num_epochs": 1})
    assert not (tmp_path / "profile").exists()


# -- bf16 first moments ----------------------------------------------------

def test_bf16_first_moments_match_reference(tmp_path):
    """Four updates (lr(0) = 0, then the warmup-linear rate) from the same
    gradients: mu stored in bf16 bit for bit JAX's, nu fp32 within 1e-6,
    the parameters within 1e-6; mu rounds once on store and the update
    reads the rounded mu. Then the state through a checkpoint."""
    rng = np.random.RandomState(0)
    shapes = [(33, 17), (17,), (5, 4, 3)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[(rng.randn(*s) * 10.0 ** rng.uniform(-4, 0)).astype(
        np.float32) for s in shapes] for _ in range(4)]
    kw = dict(lr=1e-2, t_total=20, warmup=0.1)

    tx = jax_optim.make_bert_adam(moment_dtype=jnp.bfloat16, **kw)
    jparams = [jnp.asarray(p) for p in params]
    jstate = tx.init(jparams)
    update = jax.jit(tx.update)
    for g in grads:
        upd, jstate = update([jnp.asarray(x) for x in g], jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)

    opt = make_bert_adam(moment_dtype=torch.bfloat16, **kw)
    master = [torch.from_numpy(p.copy()) for p in params]
    state = opt.init(master)
    assert all(m.dtype == torch.bfloat16 for m in state.mu)
    assert all(v.dtype == torch.float32 for v in state.nu)
    for g in grads:
        opt.apply([torch.from_numpy(x.copy()) for x in g], state, master)
    adam = jstate[1]
    assert state.count == int(adam.count) == 4
    for m, jm in zip(state.mu, adam.mu):
        assert jm.dtype == jnp.bfloat16
        np.testing.assert_array_equal(m.view(torch.int16).numpy(),
                                      np.asarray(jm).view(np.int16))
    for v, jv, p, jp in zip(state.nu, adam.nu, master, jparams):
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-6,
                                   atol=1e-12)
        np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-6,
                                   atol=1e-6)
    assert any(not np.array_equal(p.numpy(), q)
               for p, q in zip(master, params))

    # Through a checkpoint: the bf16 moments come back bf16, bit for bit;
    # an fp32-moment state refuses them.
    names = ["a", "b", "c"]
    store = CheckpointStore(str(tmp_path / "ckpt"))
    store.save({"opt": state.state_dict(names)}, 4, {"loss": 1.0},
               blocking=True)
    tree = store.read("latest")["opt"]
    fresh = opt.init([torch.zeros(s) for s in shapes])
    fresh.load_state_dict(tree, names)
    assert fresh.count == 4
    for a, b in zip(fresh.mu + fresh.nu, state.mu + state.nu):
        assert a.dtype == b.dtype and torch.equal(a, b)
    fp32 = make_bert_adam(**kw).init([torch.zeros(s) for s in shapes])
    with pytest.raises(ValueError, match="bfloat16"):
        fp32.load_state_dict(tree, names)


# -- the registries --------------------------------------------------------

def test_registry_matches_reference():
    out = []
    for mod in (jax_registry, registry):
        reg = mod.Registry(f"probe_{mod.__name__}")
        assert mod.Registry.get_registry(reg.name) is reg
        reg.register("b")(lambda x=1: ("b", x))
        reg.register("a")(dict)
        with pytest.raises(KeyError, match="already registered"):
            reg.register("a")(list)
        reg.register("a", overwrite=True)(list)
        with pytest.raises(KeyError, match="Available: \\['a', 'b'\\]"):
            reg.get("c")
        out.append((reg.keys(), "a" in reg, "c" in reg, reg.build("b", 2),
                    reg.get("a") is list))
    assert out[1] == out[0] == (["a", "b"], True, False, ("b", 2), True)
    assert Registry is registry.Registry
    import news_image_caption_tpu.data.readers  # noqa: F401 (jsonl_news)
    assert {r: sorted(getattr(registry, r).keys()) for r in
            ("MODELS", "DECODERS", "DATASETS")} == {
        r: sorted(getattr(jax_registry, r).keys()) for r in
        ("MODELS", "DECODERS", "DATASETS")}


def test_registered_type_builds_from_yaml(tmp_path):
    """`my_captioner`, registered in both packages (the port's builder
    takes device, dtype and generator), builds from a YAML whose model
    type names it, around the decoder its `decoder:` block names; the
    port's model takes the shapes of JAX's init strictly. The entries are
    removed."""
    seen = {}

    def port_builder(decoder, device, dtype, generator):
        seen.update(device=device, dtype=dtype)
        return TransformerFlattened(decoder=decoder)

    jax_registry.MODELS.register("my_captioner")(
        lambda decoder: JaxTransformerFlattened(decoder=decoder))
    registry.MODELS.register("my_captioner")(port_builder)
    try:
        text = Path(TINY).read_text().replace(
            "type: transformer_flattened", "type: my_captioner")
        path = tmp_path / "my.yaml"
        path.write_text(text)
        jcfg = jax_config.load_config(str(path))
        jmodel = jax_config.build_model(jcfg)
        ds = jax_config.build_dataset(jcfg, "test")
        shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                                {k: jnp.asarray(v) for k, v in next(
                                    ds.batches(2, shuffle=False)).items()})
        model = config.build_model(config.load_config(str(path)), "cpu")
        assert isinstance(model, TransformerFlattened)
        assert seen == {"device": torch.device("cpu"),
                        "dtype": torch.float32}
        model.decoder.load_state_dict(params_from_jax(
            jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes),
            model.decoder))
    finally:
        del jax_registry.MODELS._entries["my_captioner"]
        del registry.MODELS._entries["my_captioner"]
    with pytest.raises(KeyError, match="my_captioner"):
        config.build_model(config.load_config(str(path)), "meta")
