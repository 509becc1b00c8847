"""The port's `train` and `evaluate -m best` commands on the online
pipeline, against the reference's, on the CPU.

`configs/goodnews/transformer_weighted_roberta.yaml` narrowed by `-o`
with the reference's own keys (`model.resnet`: ResNet-18 with 3 stages;
`model.roberta`: 2 layers 16 wide; `model.decoder`: 1 layer 16 wide,
every dropout 0; vocab 64, 16 train records in batches of 4, 2 epochs:
8 steps; fp32, BertAdam at lr 1e-3 over t_total 100), from the synthetic
set's raw uint8 images at 224. The port's command starts from the
reference's PRNGKey(0) init carried across by `params_from_jax`. Then
each package's `evaluate -m best` decodes from its own checkpoints:
`metrics.jsonl` holds the reference's records (losses within 1e-5),
`meta.json` the same steps and best, the last checkpoint's params within
rtol 1e-5 / atol 1e-6 (the frozen encoders bit-equal to the init), and
`generations.jsonl` and `evaluate-metrics.json` are byte-equal.
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
from news_image_caption_tpu_torch.models.from_jax import \
    params_from_jax  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CONFIG = str(REPO / "configs/goodnews/transformer_weighted_roberta.yaml")
ZERO_DROPOUT = dict(dropout=0.0, weight_dropout=0.0, relu_dropout=0.0,
                    input_dropout=0.0, attention_dropout=0.0)
NARROW = {
    "dataset": dict(vocab_size=64, caption_len=12, article_len=16,
                    train={"size": 16, "seed": 0}, val={"size": 8, "seed": 1},
                    test={"size": 8, "seed": 2}),
    "model": {
        "resnet": {"depth": 18, "num_stages": 3},
        "roberta": dict(vocab_size=64, hidden=16, num_layers=2, heads=2,
                        intermediate=32, max_positions=24),
        "decoder": dict(vocab_size=64, embed_dim=16, ffn_dim=32, num_heads=4,
                        num_layers=1, kernel_sizes=[3], cutoff=[16, 32, 64],
                        image_dim=256, article_dim=16, max_positions=64,
                        **ZERO_DROPOUT)},
    "iterator": {"batch_size": 4},
    "generation": {"max_len": 8},
    "trainer": {"num_epochs": 2, "log_every": 2, "patience": None,
                "mixed_precision": "fp32",
                "optimizer": {"lr": 0.001, "warmup": 0.1, "t_total": 100}},
}
FROZEN = ("resnet.", "roberta.")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _overrides(out: Path) -> str:
    return json.dumps(config.merge_overrides(
        NARROW, {"trainer": {"serialization_dir": str(out)}}))


def _records(path: Path):
    return [json.loads(line) for line in path.read_text().splitlines()]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference dir, port dir, the carried init): each package's train,
    then evaluate -m best from its own checkpoints."""
    ref = tmp_path_factory.mktemp("reference")
    port = tmp_path_factory.mktemp("port")
    over = _overrides(ref)
    assert jax_cli.main(["train", CONFIG, "--platform", "cpu", "-o",
                         over]) == 0
    assert jax_cli.main(["evaluate", CONFIG, "--platform", "cpu", "-o", over,
                         "-m", "best"]) == 0
    over = _overrides(port)
    jcfg = jax_config.load_config(CONFIG, over)
    sample = next(jax_config.build_dataset(jcfg, "train").batches(4))
    variables = jax.jit(jax_config.build_model(jcfg).init)(
        jax.random.PRNGKey(0), sample)
    model = config.build_model(config.load_config(CONFIG, over), "cpu")
    init = params_from_jax(jax.tree.map(np.asarray, variables), model)
    model.load_state_dict(init)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "training_model", lambda cfg, device, seed: model)
        assert cli.main(["train", CONFIG, "--platform", "cpu", "-o",
                         over]) == 0
    assert cli.main(["evaluate", CONFIG, "--platform", "cpu", "-o", over,
                     "-m", "best"]) == 0
    return ref, port, init


def test_train_metrics_match_reference(runs):
    ref, port, _ = runs
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
    train = [r["loss"] for r in got if r["split"] == "train"]
    assert train[-1] < train[0]


def test_meta_matches_reference(runs):
    ref, port, _ = runs
    want = json.loads((ref / "checkpoints" / "meta.json").read_text())
    got = json.loads((port / "checkpoints" / "meta.json").read_text())
    assert [c["step"] for c in got["checkpoints"]] == [4, 8] == \
        [c["step"] for c in want["checkpoints"]]
    assert got["best"]["step"] == want["best"]["step"]
    np.testing.assert_allclose(got["best"]["value"], want["best"]["value"],
                               rtol=1e-5)


def test_final_params_match_reference(runs):
    """Every parameter of the last checkpoint (the frozen encoders
    included, as the reference's checkpoint holds them) against the
    reference's; the encoders bit-equal to the init and without
    moments."""
    ref, port, init = runs
    want = serialization.msgpack_restore(
        (ref / "checkpoints" / "ckpt_8.msgpack").read_bytes())
    got = torch.load(port / "checkpoints" / "ckpt_8.pt", weights_only=True)
    model = config.build_model(config.load_config(CONFIG, _overrides(port)),
                               "meta")
    flat = params_from_jax(want["params"], model)
    assert set(flat) == set(got["params"]) == set(init)
    for k, w in flat.items():
        np.testing.assert_allclose(got["params"][k].numpy(), w.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
        if k.startswith(FROZEN):
            assert torch.equal(got["params"][k], init[k]), k
    assert not torch.equal(got["params"]["weighted_sum.bert_weight"],
                           init["weighted_sum.bert_weight"])
    opt = got["opt_state"]
    assert opt["count"] == 8
    assert set(opt["mu"]) == {k for k in flat if not k.startswith(FROZEN)}


@pytest.mark.parametrize("name", ["generations.jsonl",
                                  "evaluate-metrics.json"])
def test_evaluate_best_files_are_byte_equal(runs, name):
    ref, port, _ = runs
    assert len(_records(port / "generations.jsonl")) == 8
    assert (port / name).read_bytes() == (ref / name).read_bytes()


def test_speculative_key_decodes_greedily(runs):
    """The pipeline has no generate_speculative (nor has the
    reference's), so `speculative_k` leaves the greedy file as it was."""
    ref, port, _ = runs
    over = json.dumps(config.merge_overrides(json.loads(_overrides(port)), {
        "generation": {"speculative_k": 3}}))
    assert cli.main(["evaluate", CONFIG, "--platform", "cpu", "-o", over,
                     "-m", "best", "-s", "_spec"]) == 0
    assert (port / "generations_spec.jsonl").read_bytes() == \
        (ref / "generations.jsonl").read_bytes()
