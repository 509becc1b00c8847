"""The port's `evaluate` command against the reference's, on the CPU.

Both commands run on `configs/tiny_test.yaml`, split `test` (8 records,
batches of 4, max_len 8, fp32). The reference's `cli.main(["evaluate",
...])` finds no checkpoint and initializes with PRNGKey(0) on its first
batch; the test rebuilds that init with `model.init`, carries it into
the port with `params_from_jax` and runs the port's `cli.main` with the
same arguments, its `evaluation_model` (the random init) replaced by
the carried model. The files must agree: generations.jsonl
and evaluate-metrics.json byte for byte, with and without `--no-enrich`,
and every `--dump-attention` array within 1e-5 (tokens equal). Two
reference runs in all, in a module fixture: the first enriched with the
attention dump, the second bare with a suffix and a `max_len` override.
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
from news_image_caption_tpu_torch.config import (build_model,  # noqa: E402
                                                 load_config)
from news_image_caption_tpu_torch.models.from_jax import \
    params_from_jax  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
TINY = str(REPO / "configs" / "tiny_test.yaml")
RUNS = {
    # name: (extra overrides, extra arguments)
    "enriched": ({}, ["--dump-attention", "{dir}/attn"]),
    "bare": ({"generation": {"max_len": 6}}, ["--no-enrich", "-s", "_bare"]),
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
    """{run: (reference dir, port dir)}, both commands run once a run."""
    root = tmp_path_factory.mktemp("evaluate")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
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


@pytest.mark.parametrize("run,suffix", [("enriched", ""), ("bare", "_bare")])
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


@pytest.mark.parametrize("overrides,argv,item", [
    ({"generation": {"speculative_k": 4}}, [], 6),
    ({"generation": {"sampling_topk": 3}}, [], 4),
    ({"generation": {"quantize_kv": True}}, [], 7),
    ({}, ["-m", "best"], 5),
    ({"dataset": {"type": "nics_shards"}}, [], 5),
    ({"model": {"decoder": {"normalize_before": True}}}, [], 8),
    ({"model": {"type": "transformer_pointer"}}, [], 10),
    ({"model": {"type": "gen3_pipeline"}}, [], 9),
])
def test_options_not_ported_raise(tmp_path, overrides, argv, item):
    overrides = dict(overrides, trainer={"serialization_dir": str(tmp_path)})
    with pytest.raises(NotImplementedError,
                       match=rf"ROADMAP Queue 1 item {item}\)"):
        cli.main(["evaluate", TINY, "--platform", "cpu", "-o",
                  json.dumps(overrides)] + argv)
    assert not (tmp_path / "generations.jsonl").exists()


def test_checkpoint_directory_raises(tmp_path):
    (tmp_path / "checkpoints").mkdir()
    with pytest.raises(NotImplementedError,
                       match=r"ROADMAP Queue 1 item 5\)"):
        cli.main(["evaluate", TINY, "--platform", "cpu", "-o",
                  json.dumps({"trainer": {"serialization_dir":
                                          str(tmp_path)}})])


def test_no_card_without_platform_cpu_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--platform cpu"):
        cli.main(["evaluate", TINY, "-o", json.dumps(
            {"trainer": {"serialization_dir": str(tmp_path)}})])
    assert not tmp_path.exists() or not any(tmp_path.iterdir())
