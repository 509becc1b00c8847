"""The port's `evaluate` command against the reference's, on the CPU.

Both commands run on `configs/tiny_test.yaml`, split `test` (8 records,
batches of 4, max_len 8, fp32). The reference's `cli.main(["evaluate",
...])` finds no checkpoint and initializes with PRNGKey(0) on its first
batch; the test rebuilds that init with `model.init`, carries it into
the port with `params_from_jax` and runs the port's `cli.main` with the
same arguments, its `evaluation_model` (the random init) replaced by
the carried model. The files must agree: generations.jsonl
and evaluate-metrics.json byte for byte, with and without `--no-enrich`,
and every `--dump-attention` array within 1e-5 (tokens equal). Three
reference runs in all, in a module fixture: the first enriched with the
attention dump, the second bare with a suffix and a `max_len` override,
the third bare with `generation.quantize_kv` (the int8 K/V route, its
kernel's plain twin counted on the port's side).
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from news_image_caption_tpu import cli as jax_cli  # noqa: E402
from news_image_caption_tpu import config as jax_config  # noqa: E402
from news_image_caption_tpu_torch import cli  # noqa: E402
from news_image_caption_tpu_torch.config import (  # noqa: E402
    build_model, load_config, merge_overrides)
from news_image_caption_tpu_torch.models.from_jax import \
    params_from_jax  # noqa: E402

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


RUNS = {
    # name: (extra overrides, extra arguments)
    "enriched": ({}, ["--dump-attention", "{dir}/attn"]),
    "bare": ({"generation": {"max_len": 6}}, ["--no-enrich", "-s", "_bare"]),
    "quantized": ({"generation": {"quantize_kv": True}},
                  ["--no-enrich", "-s", "_q8"]),
}


def _argv(run: str, out: Path):
    """(the -o overrides, the command line) of a run into `out`."""
    overrides, extra = RUNS[run]
    overrides = json.dumps(dict(overrides,
                                trainer={"serialization_dir": str(out)}))
    return overrides, (["evaluate", TINY, "--platform", "cpu", "-o",
                        overrides] + [a.format(dir=out) for a in extra])


def _reference_model(overrides: str):
    """The reference command's model and init, as its evaluate makes
    them: PRNGKey(0) on the split's first batch."""
    cfg = jax_config.load_config(TINY, overrides)
    model = jax_config.build_model(cfg)
    ds = jax_config.build_dataset(cfg, "test")
    sample = next(ds.batches(cfg["iterator"]["batch_size"], shuffle=False))
    return model.init(jax.random.PRNGKey(0), sample)


def _port_model(params, overrides: str):
    model = build_model(load_config(TINY, overrides), "cpu")
    model.decoder.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, params), model.decoder))
    model.decoder.eval()
    return model


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{run: (reference dir, port dir)}, both commands run once a run;
    under "int8_calls", the calls of the int8 attention's plain twin in
    each port run."""
    from news_image_caption_tpu_torch.ops import decode_attention

    root = tmp_path_factory.mktemp("evaluate")
    out = {"int8_calls": {}}
    with pytest.MonkeyPatch.context() as mp:
        twin = decode_attention.decode_cross_attention_int8_plain

        def counting(*args):
            out["int8_calls"][run] = out["int8_calls"].get(run, 0) + 1
            return twin(*args)
        mp.setattr(decode_attention, "decode_cross_attention_int8_plain",
                   counting)
        for run in RUNS:
            ref, port = root / f"{run}_ref", root / f"{run}_port"
            ref_overrides, ref_argv = _argv(run, ref)
            port_overrides, port_argv = _argv(run, port)
            assert jax_cli.main(ref_argv) == 0
            model = _port_model(_reference_model(ref_overrides),
                                port_overrides)
            mp.setattr(cli, "evaluation_model",
                       lambda cfg, device, model=model: model)
            assert cli.main(port_argv) == 0
            out[run] = (ref, port)
    return out


@pytest.mark.parametrize("run,suffix", [("enriched", ""), ("bare", "_bare"),
                                        ("quantized", "_q8")])
@pytest.mark.parametrize("name", ["generations{}.jsonl",
                                  "evaluate-metrics{}.json"])
def test_files_are_byte_equal(runs, run, suffix, name):
    ref, port = runs[run]
    want = (ref / name.format(suffix)).read_bytes()
    assert (port / name.format(suffix)).read_bytes() == want
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref))


def test_attention_dumps_match(runs):
    ref, port = (d / "attn" for d in runs["enriched"])
    files = sorted(os.listdir(ref))
    assert files == ["attn_00000.npz", "attn_00001.npz"]
    assert sorted(os.listdir(port)) == files
    for name in files:
        with np.load(ref / name) as want, np.load(port / name) as got:
            assert sorted(got.files) == sorted(want.files)
            assert {"tokens", "layer0_image", "layer1_article"} <= set(
                got.files)
            np.testing.assert_array_equal(got["tokens"], want["tokens"])
            for key in want.files:
                assert got[key].shape == want[key].shape, key
                np.testing.assert_allclose(got[key], want[key], rtol=0,
                                           atol=1e-5, err_msg=key)


def test_suffix_and_overrides_are_honoured(runs):
    _, enriched = runs["enriched"]
    _, bare = runs["bare"]
    assert sorted(os.listdir(bare)) == ["evaluate-metrics_bare.json",
                                        "generations_bare.jsonl"]
    recs = [json.loads(line) for line in
            (bare / "generations_bare.jsonl").read_text().splitlines()]
    assert len(recs) == 8
    assert all(set(r) == {"generation", "caption", "copied_texts"}
               for r in recs)
    assert max(len(r["generation"].split()) for r in recs) <= 6
    long = [json.loads(line) for line in
            (enriched / "generations.jsonl").read_text().splitlines()]
    assert max(len(r["generation"].split()) for r in long) > 6
    assert "caption_names" in long[0] and "gen_readability" in long[0]


def test_random_init_command_runs(tmp_path, capsys):
    """Without a model the command warns and draws its weights from a
    generator seeded with 0: two runs write the same files."""
    texts = []
    for run in ("a", "b"):
        out = tmp_path / run
        argv = ["evaluate", TINY, "--platform", "cpu", "-o",
                json.dumps({"trainer": {"serialization_dir": str(out)}})]
        assert cli.main(argv) == 0
        captured = capsys.readouterr()
        assert "using random init" in captured.err
        metrics = json.loads(captured.out.strip().splitlines()[-1])
        assert metrics["n_samples"] == 8
        assert json.loads((out / "evaluate-metrics.json").read_text()) == \
            metrics
        texts.append((out / "generations.jsonl").read_bytes())
    assert texts[0] == texts[1]


def test_quantize_kv_takes_the_int8_route(runs):
    """`generation.quantize_kv: true` decodes through the int8 K/V route
    (its files are the reference's, `test_files_are_byte_equal`), and
    only then; evaluate reads no `quantize_head`, as the reference's
    command reads none."""
    calls = runs["int8_calls"]
    # 2 layers x 2 contexts, a step of each of the 2 batches at least.
    assert calls.get("quantized", 0) >= 8
    assert "enriched" not in calls and "bare" not in calls
    gcfg = cli.generation_config({"generation": {"quantize_kv": True,
                                                 "quantize_head": True}})
    assert gcfg.quantize_kv and not gcfg.quantize_head


@pytest.mark.parametrize("command,overrides,argv,item", [
    ("train", {"trainer": {"checkpoint_format": "sharded"}}, [], "11"),
    ("evaluate", {"model": {"decoder": {"normalize_before": True}}}, [], "8"),
    ("evaluate", {"model": {"type": "gen3_pipeline",
                            "roberta": {"ring": {"data": 1, "context": 2}}}},
     [], "11"),
    ("train", {"trainer": {"profile_steps": 3}}, [], "5b"),
    ("train", {"trainer": {"mesh": {"data": -1, "model": 1}}}, [], "11"),
    ("train", {"trainer": {"distributed": True}}, [], "11"),
])
def test_options_not_ported_raise(tmp_path, command, overrides, argv, item):
    """Each option raises naming the ROADMAP item that ports it; those of
    items 5b, 8b and 11, since ported, run (a pre-norm decoder's evaluate
    writes its generations; the profiler window: `train --platform
    cpu` writes a trace of its window into `<serialization_dir>/profile`,
    tests/test_torch_profiling_loaders.py holds the window itself; the
    sharded store, the mesh and the bootstrap train in one process, and a
    ring over two context ranks raises as the reference's mesh does on
    one device; tests/test_torch_parallel.py and its neighbours hold them
    on several ranks). No process group outlives a command."""
    import torch.distributed as dist
    overrides = dict(overrides, trainer=dict(
        overrides.get("trainer", {}), serialization_dir=str(tmp_path)))
    if item == "11":
        run = [command, TINY, "--platform", "cpu", "-o",
               json.dumps(overrides)] + argv
        if command == "evaluate":
            with pytest.raises(ValueError, match="does not cover 1 devices"):
                cli.main(run)
        else:
            assert cli.main(run) == 0
            assert (tmp_path / "metrics.jsonl").exists()
            sharded = "checkpoint_format" in overrides["trainer"]
            assert (tmp_path / "checkpoints" / "ckpt_16").is_dir() == sharded
        assert not dist.is_initialized()
        return
    if item == "8":
        # Ported by item 8b: a pre-norm decoder evaluates (random init).
        assert cli.main([command, TINY, "--platform", "cpu", "-o",
                         json.dumps(overrides)] + argv) == 0
        assert len((tmp_path / "generations.jsonl").read_text()
                   .splitlines()) == 8
        return
    if item == "5b":
        assert cli.main([command, TINY, "--platform", "cpu", "-o",
                         json.dumps(overrides)] + argv) == 0
        traces = list((tmp_path / "profile").glob("*.pt.trace.json"))
        assert len(traces) == 1
        events = json.loads(traces[0].read_text())["traceEvents"]
        assert sum(e.get("name") == "train_step.forward"
                   for e in events) == 3
        assert (tmp_path / "metrics.jsonl").exists()
        return
    with pytest.raises(NotImplementedError,
                       match=rf"ROADMAP Queue 1 item {item}\)"):
        cli.main([command, TINY, "--platform", "cpu", "-o",
                  json.dumps(overrides)] + argv)
    assert not (tmp_path / "generations.jsonl").exists()
    assert not (tmp_path / "metrics.jsonl").exists()


@pytest.mark.parametrize("command,overrides", [
    ("evaluate", {"model": {"type": "tgnc"}}),
    ("train", {"model": {"type": "tgnc"}}),
])
def test_options_ported_with_the_last_families_run(tmp_path, command,
                                                   overrides):
    """TGNC over the tiny config's flattened decoder, once raising
    (ROADMAP Queue 1 item 10b), now trains and evaluates (the Gen-1
    optimizer builds: tests/test_torch_training_loop.py)."""
    overrides = dict(overrides, trainer=dict(
        overrides.get("trainer", {}), num_epochs=1,
        serialization_dir=str(tmp_path)))
    assert cli.main([command, TINY, "--platform", "cpu", "-o",
                     json.dumps(overrides)]) == 0
    if command == "evaluate":
        assert (tmp_path / "generations.jsonl").read_text().count("\n") == 8
    else:
        val = json.loads((tmp_path / "metrics.jsonl").read_text())
        assert val["split"] == "val" and np.isfinite(val["loss"])
        assert (tmp_path / "checkpoints" / "best.pt").exists()


def _tiny_on_shards(where: Path) -> str:
    """configs/tiny_test.yaml over NICS shards of its shapes (train 16
    records in two shards, test 8), written by the port's `write_shard`."""
    from news_image_caption_tpu_torch.data.native_loader import write_shard
    rng = np.random.default_rng(0)
    for split, sizes in (("train", (9, 7)), ("test", (8,))):
        for i, n in enumerate(sizes):
            caption = rng.integers(3, 64, size=(n, 12)).astype(np.int32)
            caption[:, 0], caption[:, -1] = 0, 2
            write_shard(str(where / f"{split}-{i}.nics"), {
                "caption_ids": caption,
                "image": rng.standard_normal((n, 4, 16)).astype(np.float32),
                "article": rng.standard_normal((n, 16, 12)).astype(
                    np.float16),
                "article_mask": (rng.random((n, 16)) > 0.8).astype(np.uint8),
                "image_mask": np.zeros((n, 4), np.uint8)})
    text = Path(TINY).read_text()
    head, tail = text.split("model:", 1)
    dataset = (f"dataset:\n  type: nics_shards\n"
               f"  train: {{pattern: {where}/train-*.nics}}\n"
               f"  val: {{pattern: {where}/test-*.nics}}\n"
               f"  test: {{pattern: {where}/test-*.nics}}\n")
    path = where / "tiny_shards.yaml"
    path.write_text(dataset + "model:" + tail)
    return str(path)


@pytest.mark.parametrize("command", ["train", "evaluate"])
def test_options_ported_with_the_data_commands_run(tmp_path, command):
    """`dataset: {type: nics_shards}`, once raising (ROADMAP Queue 1 item
    5b), trains and evaluates (against the reference's commands:
    tests/test_torch_shards.py); its float16 article reaches the model
    as bfloat16, its uint8 masks as bool."""
    cfg = _tiny_on_shards(tmp_path)
    overrides = json.dumps({"trainer": {"num_epochs": 1,
                                        "serialization_dir": str(tmp_path)}})
    assert cli.main([command, cfg, "--platform", "cpu", "-o", overrides]) == 0
    if command == "evaluate":
        assert (tmp_path / "generations.jsonl").read_text().count("\n") == 8
    else:
        val = json.loads((tmp_path / "metrics.jsonl").read_text()
                         .splitlines()[-1])
        assert val["split"] == "val" and np.isfinite(val["loss"])
        assert (tmp_path / "checkpoints" / "best.pt").exists()


def test_checkpoint_directory_raises(tmp_path):
    """-m without a checkpoints directory, and a checkpoint that is not
    there, raise: the port never evaluates random weights where a
    checkpoint was meant."""
    argv = ["evaluate", TINY, "--platform", "cpu", "-o",
            json.dumps({"trainer": {"serialization_dir": str(tmp_path)}})]
    with pytest.raises(FileNotFoundError, match="no checkpoints directory"):
        cli.main(argv + ["-m", "best"])
    (tmp_path / "checkpoints").mkdir()
    for which in ("best", "latest", "3", "avg:2"):
        with pytest.raises(FileNotFoundError):
            cli.main(argv + ["-m", which])
    assert not (tmp_path / "generations.jsonl").exists()


def test_checkpoint_directory_loads(tmp_path, capsys):
    """`train` then `evaluate` from its checkpoints: the default (best),
    a step and avg:2 decode the checkpoint's params, without the random
    init's warning."""
    overrides = json.dumps({"trainer": {"serialization_dir": str(tmp_path),
                                        "num_epochs": 2}})
    assert cli.main(["train", TINY, "--platform", "cpu", "-o",
                     overrides]) == 0
    meta = json.loads((tmp_path / "checkpoints" / "meta.json").read_text())
    assert [c["step"] for c in meta["checkpoints"]] == [8, 16]
    texts = {}
    for argv in ([], ["-m", "8"], ["-m", "avg:2"]):
        assert cli.main(["evaluate", TINY, "--platform", "cpu", "-o",
                         overrides, "-s", "_x"] + argv) == 0
        assert "random init" not in capsys.readouterr().err
        texts[tuple(argv)] = (tmp_path / "generations_x.jsonl").read_bytes()
    best = torch.load(tmp_path / "checkpoints" / "best.pt",
                      weights_only=True)
    model = cli.checkpoint_model(load_config(TINY, overrides),
                                 str(tmp_path / "checkpoints"), "best",
                                 torch.device("cpu"))
    for k, p in model.decoder.state_dict().items():
        assert torch.equal(p, best["params"][k]), k
    assert len(set(texts.values())) >= 2
    # An O2 config stores bf16 params: the fp32 checkpoint is refused.
    o2 = load_config(TINY, json.dumps(merge_overrides(
        json.loads(overrides), {"trainer": {"mixed_precision": "bf16_o2"}})))
    with pytest.raises(ValueError, match="torch.float32 .*expected "
                                         "torch.bfloat16"):
        cli.checkpoint_model(o2, str(tmp_path / "checkpoints"), "avg:2",
                             torch.device("cpu"))


def test_no_card_without_platform_cpu_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--platform cpu"):
        cli.main(["evaluate", TINY, "-o", json.dumps(
            {"trainer": {"serialization_dir": str(tmp_path)}})])
    assert not tmp_path.exists() or not any(tmp_path.iterdir())
