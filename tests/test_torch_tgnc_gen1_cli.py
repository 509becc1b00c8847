"""The port's `train` and `evaluate -m best` commands on TGNC and Gen-1,
against the reference's, and `build_model` on their two configs, on the
CPU.

`configs/goodnews/joganic_tgnc.yaml` (bert_adam, BCE template loss) and
`configs/goodnews/gen1_show_attend_tell.yaml` (gen1_adam), each
narrowed by `-o` (widths, vocab 64, 32 train records in batches of 4, 2
epochs: 16 steps, fp32, every dropout 0, `log_every` 1; BertAdam at lr
1e-3 over t_total 100, gen1_adam's decay every 4 steps), run through
both packages' commands; the port's command starts from the reference's
PRNGKey(0) init carried across by `params_from_jax`. The reference
fixes TGNC's classifier dropout and its layers' conv, input and
attention dropouts at 0.1 and draws them from JAX's bits, so the runs
set them to 0 in both packages. Then each package's `evaluate -m best`
decodes from its own checkpoints: `metrics.jsonl` holds the reference's
records (losses within 1e-5; TGNC's first train step is the caption
loss plus the BCE of the batch's `template_label`, which the command
moves to the model, not the caption loss alone), `meta.json` the same
steps and best, the last checkpoint's params within rtol 1e-5 / atol
1e-6, and `generations.jsonl` and `evaluate-metrics.json` are
byte-equal. TGNC evaluates again with `speculative_k: 3` (the same
file); Gen-1 has no speculative decode, so the key leaves its file as
it was.

Both configs build at full width on the meta device with the parameter
names and shapes of the reference's init (traced with
`jax.eval_shape`), and TGNC trains two steps in its own precision (bf16)
before `evaluate -m latest`.
"""

import functools
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from flax import serialization  # noqa: E402

from news_image_caption_tpu import cli as jax_cli  # noqa: E402
from news_image_caption_tpu import config as jax_config  # noqa: E402
from news_image_caption_tpu.models import tgnc as jax_tgnc  # noqa: E402
from news_image_caption_tpu_torch import cli  # noqa: E402
from news_image_caption_tpu_torch import config  # noqa: E402
from news_image_caption_tpu_torch.data.synthetic import to_device  # noqa
from news_image_caption_tpu_torch.models.from_jax import \
    params_from_jax  # noqa: E402
from news_image_caption_tpu_torch.models.gen1 import Gen1Model  # noqa: E402
from news_image_caption_tpu_torch.models.tgnc import TGNC  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CONFIGS = {"tgnc": "configs/goodnews/joganic_tgnc.yaml",
           "gen1": "configs/goodnews/gen1_show_attend_tell.yaml"}
NARROW_DATA = dict(vocab_size=64, caption_len=12, article_len=16,
                   n_patches=4, image_dim=16, article_dim=12,
                   train={"size": 32, "seed": 0}, val={"size": 8, "seed": 1},
                   test={"size": 8, "seed": 2})
NARROW = {
    "tgnc": {"model": dict(vocab_size=64, cutoff=[16, 32, 64], embed_dim=16,
                           ffn_dim=32, num_heads=4, num_layers=2,
                           kernel_sizes=[3, 7], head_kernel=7, image_dim=16,
                           article_dim=12, max_positions=64, dropout=0.0),
             "trainer": {"optimizer": {"lr": 0.001, "warmup": 0.1,
                                       "t_total": 100}}},
    "gen1": {"model": dict(vocab_size=64, input_encoding_size=16,
                           rnn_size=16, att_hid_size=16, fc_feat_size=16,
                           att_feat_size=16, seq_length=8, drop_prob=0.0),
             "trainer": {"optimizer": {"lr": 0.001, "decay_every": 4}}},
}
DROPOUTS = ("dropout", "weight_dropout", "input_dropout", "relu_dropout")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _overrides(family: str, out: Path, **more) -> str:
    over = config.merge_overrides(NARROW[family], {
        "dataset": NARROW_DATA, "iterator": {"batch_size": 4},
        "generation": {"max_len": 8},
        "trainer": {"num_epochs": 2, "log_every": 1, "patience": None,
                    "mixed_precision": "fp32",
                    "serialization_dir": str(out)}})
    return json.dumps(config.merge_overrides(over, more))


def _records(path: Path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def _no_dropout(model):
    """Every dropout of the port's model at 0 (TGNC's classifier and its
    layers' fixed ones included)."""
    for m in model.param_module.modules():
        for name in DROPOUTS:
            if isinstance(getattr(m, name, None), float):
                setattr(m, name, 0.0)
    return model


def _reference_init(path: str, over: str):
    jcfg = jax_config.load_config(path, over)
    sample = next(jax_config.build_dataset(jcfg, "train").batches(4))
    return jax.tree.map(np.asarray, jax_config.build_model(jcfg).init(
        jax.random.PRNGKey(0), sample))


@pytest.fixture(scope="module", params=["tgnc", "gen1"])
def runs(request, tmp_path_factory):
    """(family, config, reference dir, port dir, initial port model):
    each package's train, then evaluate -m best from its own
    checkpoints."""
    family = request.param
    path = str(REPO / CONFIGS[family])
    ref = tmp_path_factory.mktemp(f"reference_{family}")
    port = tmp_path_factory.mktemp(f"port_{family}")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_tgnc, "ClassificationHead", functools.partial(
            jax_tgnc.ClassificationHead, dropout_rate=0.0))
        mp.setattr(jax_tgnc, "DynamicConvDecoderLayer", functools.partial(
            jax_tgnc.DynamicConvDecoderLayer, weight_dropout=0.0,
            input_dropout=0.0, attention_dropout=0.0))
        over = _overrides(family, ref)
        assert jax_cli.main(["train", path, "--platform", "cpu", "-o",
                             over]) == 0
        assert jax_cli.main(["evaluate", path, "--platform", "cpu", "-o",
                             over, "-m", "best"]) == 0
    over = _overrides(family, port)
    variables = _reference_init(path, over)

    def carried():
        model = config.build_model(config.load_config(path, over), "cpu")
        model.param_module.load_state_dict(params_from_jax(
            variables, model.param_module))
        return _no_dropout(model)

    model = carried()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "training_model", lambda cfg, device, seed: model)
        assert cli.main(["train", path, "--platform", "cpu", "-o",
                         over]) == 0
    assert cli.main(["evaluate", path, "--platform", "cpu", "-o", over,
                     "-m", "best"]) == 0
    return family, path, ref, port, carried()


def test_train_metrics_match_reference(runs):
    _, _, ref, port, _ = runs
    want = _records(ref / "metrics.jsonl")
    got = _records(port / "metrics.jsonl")
    assert [r["split"] for r in got] == (["train"] * 8 + ["val"]) * 2
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k, v in w.items():
            if k == "loss":
                np.testing.assert_allclose(g[k], v, rtol=1e-5)
            elif k != "input_wait":
                assert g[k] == v, k
    # The runs trained: the second validation's loss under the first.
    val = [r["loss"] for r in got if r["split"] == "val"]
    assert val[1] < val[0]


@pytest.mark.parametrize("runs", ["tgnc"], indirect=True)
def test_first_step_loss_carries_the_template_loss(runs):
    """The first train record is the first batch's loss: caption plus
    BCE, as the reference's; the same batch without `template_label`
    gives the caption loss alone."""
    family, path, ref, port, model = runs
    first = _records(port / "metrics.jsonl")[0]["loss"]
    np.testing.assert_allclose(first, _records(ref / "metrics.jsonl")[0]
                               ["loss"], rtol=1e-5)
    cfg = config.load_config(path, _overrides(family, port))
    raw = next(config.build_dataset(cfg, "train").batches(4, seed=0))
    batch = next(cli._loss_batches([raw], model))
    assert "template_label" in batch
    batch = to_device(batch, "cpu")
    with torch.no_grad():
        loss, aux = model.loss_fn(batch)
        del batch["template_label"]
        bare, _ = model.loss_fn(batch)
    np.testing.assert_allclose(loss.item(), first, rtol=1e-5)
    np.testing.assert_allclose(bare.item(), aux["caption_loss"].item(),
                               rtol=1e-6)
    assert abs(first - bare.item()) > 1e-2


def test_meta_matches_reference(runs):
    _, _, ref, port, _ = runs
    want = json.loads((ref / "checkpoints" / "meta.json").read_text())
    got = json.loads((port / "checkpoints" / "meta.json").read_text())
    assert [c["step"] for c in got["checkpoints"]] == [8, 16] == \
        [c["step"] for c in want["checkpoints"]]
    assert got["best"]["step"] == want["best"]["step"]
    np.testing.assert_allclose(got["best"]["value"], want["best"]["value"],
                               rtol=1e-5)


def test_final_params_match_reference(runs):
    family, path, ref, port, _ = runs
    want = serialization.msgpack_restore(
        (ref / "checkpoints" / "ckpt_16.msgpack").read_bytes())
    got = torch.load(port / "checkpoints" / "ckpt_16.pt", weights_only=True)
    model = config.build_model(config.load_config(
        path, _overrides(family, port)), "meta")
    flat = params_from_jax(want["params"], model.param_module)
    assert set(flat) == set(got["params"])
    # The attention's score bias adds one constant to every patch's and
    # sentence's score, which the softmax cancels: its gradient is
    # rounding noise in both packages, which Adam scales up to the rate.
    # It is held by what it does (nothing: the loss without it below),
    # the rest by their values.
    noise = [k for k in flat if k.endswith("alpha_net.bias")]
    assert len(noise) == (1 if family == "gen1" else 0)
    for k, w in flat.items():
        if k not in noise:
            np.testing.assert_allclose(got["params"][k].numpy(), w.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    if noise:
        cfg = config.load_config(path, _overrides(family, port))
        model = config.build_model(cfg, "cpu")
        model.param_module.load_state_dict(got["params"])
        batch = to_device(next(config.build_dataset(cfg, "val").batches(4)),
                          "cpu")
        with torch.no_grad():
            loss, _ = model.loss_fn(batch)
            for k in noise:
                model.param_module.get_parameter(k).zero_()
            again, _ = model.loss_fn(batch)
        np.testing.assert_allclose(again.item(), loss.item(), rtol=1e-6)
    opt = got["opt_state"]
    assert opt["count"] == 16 and set(opt["mu"]) == set(flat)


@pytest.mark.parametrize("name", ["generations.jsonl",
                                  "evaluate-metrics.json"])
def test_evaluate_best_files_are_byte_equal(runs, name):
    _, _, ref, port, _ = runs
    assert len(_records(port / "generations.jsonl")) == 8
    assert (port / name).read_bytes() == (ref / name).read_bytes()


def test_speculative_key_follows_the_reference(runs):
    """speculative_k: 3 reaches TGNC's generate_speculative (the same
    greedy file); Gen-1, which has none, decodes greedily."""
    family, path, ref, port, _ = runs
    over = _overrides(family, port, generation={"speculative_k": 3})
    assert cli.main(["evaluate", path, "--platform", "cpu", "-o", over,
                     "-m", "best", "-s", "_spec"]) == 0
    assert (port / "generations_spec.jsonl").read_bytes() == \
        (ref / "generations.jsonl").read_bytes()


# -- the two configs ---------------------------------------------------------

def _jax_shapes(cfg):
    model = jax_config.build_model(cfg)
    ds = jax_config.build_dataset(cfg, "test")
    ex = ds.collate([ds[0]])
    sample = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
              for k, v in ex.items()}
    return jax.eval_shape(model.init, jax.random.PRNGKey(0), sample)


@pytest.mark.parametrize("family", ["tgnc", "gen1"])
def test_config_builds_the_references_parameters(family):
    cfg = config.load_config(str(REPO / CONFIGS[family]))
    model = config.build_model(cfg, "meta")
    tree = jax.tree.map(lambda s: np.lib.stride_tricks.as_strided(
        np.zeros(1, np.float32), s.shape, (0,) * len(s.shape)),
        _jax_shapes(cfg))
    params_from_jax(tree, model.param_module)   # strict: names and shapes
    assert all(p.dtype == torch.float32 and p.device.type == "meta"
               for p in model.param_module.parameters())
    jmodel = jax_config.build_model(cfg)
    if family == "tgnc":
        assert isinstance(model, TGNC)
        assert model.use_template_decoder and jmodel.use_template_decoder
        assert model.template_loss_weight == jmodel.template_loss_weight
        dec = model.tg_decoder
        assert [layer.kernel_size for layer in dec.all_layers()] == \
            [3, 7, 15, 31] + [31] * 5
    else:
        assert isinstance(model, Gen1Model)
        mod = model.param_module
        assert (mod.model_type, mod.core.method, mod.vocab_size) == \
            ("show_attend_tell", "fc", 9487)


def test_tgnc_trains_in_its_own_precision(tmp_path, capsys):
    """Two bf16 steps of the YAML's own precision and optimizer, then
    `evaluate -m latest` from what it wrote."""
    overrides = json.dumps(config.merge_overrides(NARROW["tgnc"], {
        "dataset": dict(NARROW_DATA, train={"size": 8}), "iterator": {
            "batch_size": 4}, "generation": {"max_len": 4},
        "trainer": {"num_epochs": 1, "log_every": 1,
                    "serialization_dir": str(tmp_path)}}))
    path = str(REPO / CONFIGS["tgnc"])
    assert cli.main(["train", path, "--platform", "cpu", "-o",
                     overrides]) == 0
    recs = _records(tmp_path / "metrics.jsonl")
    assert [r["split"] for r in recs] == ["train", "train", "val"]
    assert all(np.isfinite(r["loss"]) for r in recs)
    ckpt = torch.load(tmp_path / "checkpoints" / "ckpt_2.pt",
                      weights_only=True)
    assert ckpt["params"]["classifier.dense.kernel"].dtype == torch.float32
    assert cli.main(["evaluate", path, "--platform", "cpu", "-o", overrides,
                     "-m", "latest"]) == 0
    assert "random init" not in capsys.readouterr().err
    assert len(_records(tmp_path / "generations.jsonl")) == 8
