"""The port's `train` and `evaluate -m best` commands on the faces and
objects captioner (`configs/nytimes/transformer_faces_objects.yaml`,
Transform-and-Tell's full model), against the reference's, on the CPU.

The config is narrowed by overrides (V=64, D=16, H=4, FFN=32, faces 8 and
objects 6 wide, 4 faces and 4 objects an item; 16 train records in
batches of 4, 2 epochs: 8 steps, every dropout 0, max_len 8). The
reference's `cli.main(["train", ...])` initializes with PRNGKey(0); the
port's runs with its random init swapped for that init carried across
by `params_from_jax`. Then each package's `evaluate -m best` decodes
from its own checkpoints. `metrics.jsonl` and the last checkpoint's
params must agree within 1e-5, and `generations.jsonl` and
`evaluate-metrics.json` must be byte-equal.
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from flax import serialization  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from news_image_caption_tpu import cli as jax_cli  # noqa: E402
from news_image_caption_tpu import config as jax_config  # noqa: E402
from news_image_caption_tpu_torch import cli  # noqa: E402
from news_image_caption_tpu_torch.config import (build_model,  # noqa: E402
                                                 load_config)
from news_image_caption_tpu_torch.models.from_jax import (  # noqa: E402
    params_from_jax, torch_key)

REPO = Path(__file__).resolve().parent.parent
CONFIG = str(REPO / "configs" / "nytimes" / "transformer_faces_objects.yaml")
NARROW = {
    "model": dict(vocab_size=64, cutoff=[16, 32, 64], embed_dim=16,
                  ffn_dim=32, num_heads=4, image_dim=16, article_dim=12,
                  face_dim=8, obj_dim=6, max_positions=64, dropout=0.0,
                  weight_dropout=0.0, relu_dropout=0.0, input_dropout=0.0,
                  attention_dropout=0.0),
    "dataset": dict(vocab_size=64, caption_len=12, article_len=16,
                    n_patches=4, image_dim=16, article_dim=12, face_dim=8,
                    obj_dim=6, train={"size": 16}, val={"size": 8},
                    test={"size": 8}),
    "iterator": {"batch_size": 4},
    "generation": {"max_len": 8},
    "trainer": {"num_epochs": 2, "log_every": 2},
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _overrides(out: Path) -> str:
    over = json.loads(json.dumps(NARROW))
    over["trainer"]["serialization_dir"] = str(out)
    return json.dumps(over)


def _records(path: Path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def _carried(overrides: str):
    """The port's model holding the reference's PRNGKey(0) init, which
    the reference's train command draws on its first train batch."""
    jcfg = jax_config.load_config(CONFIG, overrides)
    sample = next(jax_config.build_dataset(jcfg, "train").batches(4))
    params = jax_config.build_model(jcfg).init(jax.random.PRNGKey(0), sample)
    model = build_model(load_config(CONFIG, overrides), "cpu", torch.float32)
    model.decoder.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, params), model.decoder))
    return model


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference dir, port dir): each package's train, then evaluate
    -m best from its own checkpoints."""
    ref = tmp_path_factory.mktemp("reference")
    port = tmp_path_factory.mktemp("port")
    over = _overrides(ref)
    assert jax_cli.main(["train", CONFIG, "--platform", "cpu", "-o",
                         over]) == 0
    assert jax_cli.main(["evaluate", CONFIG, "--platform", "cpu", "-o", over,
                         "-m", "best"]) == 0
    over = _overrides(port)
    model = _carried(over)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "training_model", lambda cfg, device, seed: model)
        assert cli.main(["train", CONFIG, "--platform", "cpu", "-o",
                         over]) == 0
    assert cli.main(["evaluate", CONFIG, "--platform", "cpu", "-o", over,
                     "-m", "best"]) == 0
    return ref, port


def test_train_metrics_match_reference(runs):
    ref, port = runs
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


def test_final_params_match_reference(runs):
    ref, port = runs
    want = serialization.msgpack_restore(
        (ref / "checkpoints" / "ckpt_8.msgpack").read_bytes())
    got = torch.load(port / "checkpoints" / "ckpt_8.pt", weights_only=True)
    flat = {torch_key(k): v for k, v in
            flatten_dict(want["params"]["params"], sep="/").items()}
    assert set(flat) == set(got["params"])
    assert any(k.startswith("layers.0.obj_attn.") for k in flat)
    for k, w in flat.items():
        np.testing.assert_allclose(got["params"][k].numpy(), w, rtol=1e-5,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("name", ["generations.jsonl",
                                  "evaluate-metrics.json"])
def test_evaluate_best_files_are_byte_equal(runs, name):
    ref, port = runs
    assert len(_records(port / "generations.jsonl")) == 8
    assert (port / name).read_bytes() == (ref / name).read_bytes()
