"""The port's `train` and `evaluate -m best` commands on the LSTM and
Gen-2 families, against the reference's, and `build_model` on the six
configs of the two families, on the CPU.

`configs/goodnews/baseline_glove_lstm.yaml` (bert_adam, fp32) and
`configs/goodnews/gen2_word.yaml` (noam, fp32), each narrowed by `-o`
(widths, vocab 64, 32 train records in batches of 4, 2 epochs: 16 steps,
every dropout 0, `log_every` 4; BertAdam at lr 1e-3 over t_total 100,
Noam's warmup 4), run through both packages' commands; the port's
command starts from the reference's PRNGKey(0) init carried across by
`params_from_jax`. Then each package's `evaluate -m best` decodes from
its own checkpoints: `metrics.jsonl` holds the reference's records
(losses within 1e-5), `meta.json` the same steps and best, the last
checkpoint's params within rtol 1e-5 / atol 1e-6, and
`generations.jsonl` and `evaluate-metrics.json` are byte-equal. Gen-2
evaluates again with `speculative_k: 3` (generate_speculative, the same
file); the LSTM has no speculative decode, so the key leaves its file as
it was.

Every config of the two families builds at full width on the meta device
with the parameter names and shapes of the reference's init (traced
with `jax.eval_shape`), and trains two steps narrowed in its own
precision (bf16 for three LSTM configs) before `evaluate -m latest`.
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from flax import serialization  # noqa: E402

from news_image_caption_tpu import cli as jax_cli  # noqa: E402
from news_image_caption_tpu import config as jax_config  # noqa: E402
from news_image_caption_tpu_torch import cli  # noqa: E402
from news_image_caption_tpu_torch import config  # noqa: E402
from news_image_caption_tpu_torch.models.decoder_lstm import \
    LSTMFlattenedModel  # noqa: E402
from news_image_caption_tpu_torch.models.from_jax import \
    params_from_jax  # noqa: E402
from news_image_caption_tpu_torch.models.gen2 import \
    Gen2Captioner  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
LSTM_CONFIGS = ["configs/goodnews/baseline_glove_lstm.yaml",
                "configs/goodnews/lstm_roberta.yaml",
                "configs/nytimes/lstm_glove.yaml",
                "configs/nytimes/lstm_roberta.yaml"]
GEN2_CONFIGS = ["configs/goodnews/gen2_roberta.yaml",
                "configs/goodnews/gen2_word.yaml"]
NARROW_DATA = dict(vocab_size=64, caption_len=12, article_len=16,
                   n_patches=4, image_dim=16, article_dim=12,
                   train={"size": 32, "seed": 0}, val={"size": 8, "seed": 1},
                   test={"size": 8, "seed": 2})
NARROW = {
    "lstm": {"model": dict(vocab_size=64, cutoff=[16, 32, 64], embed_dim=16,
                           hidden_size=16, image_dim=16, article_dim=12,
                           max_positions=64, dropout_rate=0.0),
             "trainer": {"optimizer": {"lr": 0.001, "warmup": 0.1,
                                       "t_total": 100}}},
    "gen2": {"model": dict(vocab_size=64, d_model=16, d_ff=32, num_heads=4,
                           num_layers=2, img_dim=16, sent_dim=12, max_len=64,
                           dropout_rate=0.0),
             "trainer": {"optimizer": {"warmup": 4}}},
}
COMMAND_CONFIGS = {"lstm": "configs/goodnews/baseline_glove_lstm.yaml",
                   "gen2": "configs/goodnews/gen2_word.yaml"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _family(path: str) -> str:
    return "gen2" if "gen2" in path else "lstm"


def _overrides(family: str, out: Path, **more) -> str:
    over = config.merge_overrides(NARROW[family], {
        "dataset": NARROW_DATA, "iterator": {"batch_size": 4},
        "generation": {"max_len": 8},
        "trainer": {"num_epochs": 2, "log_every": 4, "patience": None,
                    "serialization_dir": str(out)}})
    return json.dumps(config.merge_overrides(over, more))


def _records(path: Path):
    return [json.loads(line) for line in path.read_text().splitlines()]


@pytest.fixture(scope="module", params=["lstm", "gen2"])
def runs(request, tmp_path_factory):
    """(family, config, reference dir, port dir): each package's train,
    then evaluate -m best from its own checkpoints."""
    family = request.param
    path = str(REPO / COMMAND_CONFIGS[family])
    ref = tmp_path_factory.mktemp(f"reference_{family}")
    port = tmp_path_factory.mktemp(f"port_{family}")
    over = _overrides(family, ref)
    assert jax_cli.main(["train", path, "--platform", "cpu", "-o",
                         over]) == 0
    assert jax_cli.main(["evaluate", path, "--platform", "cpu", "-o", over,
                         "-m", "best"]) == 0
    over = _overrides(family, port)
    jcfg = jax_config.load_config(path, over)
    sample = next(jax_config.build_dataset(jcfg, "train").batches(4))
    variables = jax_config.build_model(jcfg).init(jax.random.PRNGKey(0),
                                                  sample)
    model = config.build_model(config.load_config(path, over), "cpu")
    model.param_module.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, variables), model.param_module))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "training_model", lambda cfg, device, seed: model)
        assert cli.main(["train", path, "--platform", "cpu", "-o",
                         over]) == 0
    assert cli.main(["evaluate", path, "--platform", "cpu", "-o", over,
                     "-m", "best"]) == 0
    return family, path, ref, port


def test_train_metrics_match_reference(runs):
    _, _, ref, port = runs
    want = _records(ref / "metrics.jsonl")
    got = _records(port / "metrics.jsonl")
    assert [r["split"] for r in got] == ["train", "train", "val"] * 2
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k, v in w.items():
            if k == "loss":
                np.testing.assert_allclose(g[k], v, rtol=1e-5)
            elif k != "input_wait":
                assert g[k] == v, k
    # The runs trained: the last train window's loss under the first.
    train = [r["loss"] for r in got if r["split"] == "train"]
    assert train[-1] < train[0]


def test_meta_matches_reference(runs):
    _, _, ref, port = runs
    want = json.loads((ref / "checkpoints" / "meta.json").read_text())
    got = json.loads((port / "checkpoints" / "meta.json").read_text())
    assert [c["step"] for c in got["checkpoints"]] == [8, 16] == \
        [c["step"] for c in want["checkpoints"]]
    assert got["best"]["step"] == want["best"]["step"]
    np.testing.assert_allclose(got["best"]["value"], want["best"]["value"],
                               rtol=1e-5)


def test_final_params_match_reference(runs):
    family, path, ref, port = runs
    want = serialization.msgpack_restore(
        (ref / "checkpoints" / "ckpt_16.msgpack").read_bytes())
    got = torch.load(port / "checkpoints" / "ckpt_16.pt", weights_only=True)
    model = config.build_model(config.load_config(
        path, _overrides(family, port)), "meta")
    flat = params_from_jax(want["params"], model.param_module)
    assert set(flat) == set(got["params"])
    # An attention's key bias adds q . b_k to every key's score alike,
    # which the softmax cancels: its gradient is rounding noise in both
    # packages, which Adam's update m / (sqrt(v) + eps) scales up to the
    # rate (Noam's eps is 1e-9). Those biases are held by what they do
    # (nothing: the loss without them below), the rest by their values.
    noise = [k for k in flat if k.endswith("k_lin.bias")]
    assert len(noise) == (6 if family == "gen2" else 0)
    for k, w in flat.items():
        if k not in noise:
            np.testing.assert_allclose(got["params"][k].numpy(), w.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    if noise:
        model = config.build_model(config.load_config(
            path, _overrides(family, port)), "cpu")
        model.param_module.load_state_dict(got["params"])
        cfg = config.load_config(path, _overrides(family, port))
        batch = next(config.build_dataset(cfg, "val").batches(4))
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        with torch.no_grad():
            loss, _ = model.loss_fn(batch)
            for k in noise:
                model.param_module.get_parameter(k).zero_()
            again, _ = model.loss_fn(batch)
        np.testing.assert_allclose(again.item(), loss.item(), rtol=1e-6)
    # The optimizer's state went to the checkpoint too: Adam's moments
    # and the count, one update a step.
    opt = got["opt_state"]
    assert opt["count"] == 16 and set(opt["mu"]) == set(flat)


@pytest.mark.parametrize("name", ["generations.jsonl",
                                  "evaluate-metrics.json"])
def test_evaluate_best_files_are_byte_equal(runs, name):
    _, _, ref, port = runs
    assert len(_records(port / "generations.jsonl")) == 8
    assert (port / name).read_bytes() == (ref / name).read_bytes()


def test_speculative_key_follows_the_reference(runs):
    """speculative_k: 3 reaches Gen-2's generate_speculative (the same
    greedy file); the LSTM, which has none, decodes greedily."""
    family, path, ref, port = runs
    over = _overrides(family, port, generation={"speculative_k": 3})
    assert cli.main(["evaluate", path, "--platform", "cpu", "-o", over,
                     "-m", "best", "-s", "_spec"]) == 0
    assert (port / "generations_spec.jsonl").read_bytes() == \
        (ref / "generations.jsonl").read_bytes()


def test_dump_attention_warns_and_skips(runs, tmp_path, capsys):
    family, path, _, port = runs
    over = _overrides(family, port)
    assert cli.main(["evaluate", path, "--platform", "cpu", "-o", over,
                     "-m", "best", "-s", "_dump", "--dump-attention",
                     str(tmp_path / "attn")]) == 0
    assert "no attention_maps; skipping dump" in capsys.readouterr().err
    assert not (tmp_path / "attn").exists()
    assert (port / "generations_dump.jsonl").read_bytes() == \
        (port / "generations.jsonl").read_bytes()


# -- the families' configs --------------------------------------------------

def _jax_shapes(cfg):
    model = jax_config.build_model(cfg)
    ds = jax_config.build_dataset(cfg, "test")
    ex = ds.collate([ds[0]])
    sample = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
              for k, v in ex.items()}
    return jax.eval_shape(model.init, jax.random.PRNGKey(0), sample)


@pytest.mark.parametrize("path", LSTM_CONFIGS + GEN2_CONFIGS)
def test_config_builds_the_references_parameters(path):
    cfg = config.load_config(str(REPO / path))
    model = config.build_model(cfg, "meta")
    tree = jax.tree.map(lambda s: np.lib.stride_tricks.as_strided(
        np.zeros(1, np.float32), s.shape, (0,) * len(s.shape)),
        _jax_shapes(cfg))
    params_from_jax(tree, model.param_module)   # strict: names and shapes
    assert all(p.dtype == torch.float32 and p.device.type == "meta"
               for p in model.param_module.parameters())
    if _family(path) == "lstm":
        assert isinstance(model, LSTMFlattenedModel)
        assert model.param_module is model
    else:
        assert isinstance(model, Gen2Captioner)
        jmodel = jax_config.build_model(cfg)
        assert model.module.pad_id == jmodel.module.pad_id == 1
        assert model.smoothing == jmodel.smoothing


@pytest.mark.parametrize("path", LSTM_CONFIGS + GEN2_CONFIGS)
def test_train_command_runs_every_config_narrowed(path, tmp_path, capsys):
    """Two steps of the config's own precision and optimizer, then
    `evaluate -m latest` from what it wrote."""
    family = _family(path)
    overrides = json.dumps(config.merge_overrides(NARROW[family], {
        "dataset": dict(NARROW_DATA, train={"size": 8}), "iterator": {
            "batch_size": 4}, "generation": {"max_len": 4},
        "trainer": {"num_epochs": 1, "log_every": 1,
                    "serialization_dir": str(tmp_path)}}))
    assert cli.main(["train", str(REPO / path), "--platform", "cpu", "-o",
                     overrides]) == 0
    recs = _records(tmp_path / "metrics.jsonl")
    assert [r["split"] for r in recs] == ["train", "train", "val"]
    assert all(np.isfinite(r["loss"]) for r in recs)
    ckpt = torch.load(tmp_path / "checkpoints" / "ckpt_2.pt",
                      weights_only=True)
    first = "cells_0.ih.kernel" if family == "lstm" else \
        "layers.0.self_attn.q_lin.kernel"
    assert ckpt["params"][first].dtype == torch.float32
    assert cli.main(["evaluate", str(REPO / path), "--platform", "cpu",
                     "-o", overrides, "-m", "latest"]) == 0
    assert "random init" not in capsys.readouterr().err
    assert len(_records(tmp_path / "generations.jsonl")) == 8
