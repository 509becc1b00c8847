"""The port's `train` and `evaluate -m best` commands on the pointer
family, against the reference's, and `build_model` on the family's
sixteen configs, on the CPU.

`configs/tiny_pointer.yaml` (32 train records in batches of 4, 2 epochs:
16 steps, loss weights (0, 1, 1)) runs with every dropout 0 and
`log_every` 4 through both packages' commands. The reference fixes its
copy head's dropout at 0.1 and draws it from JAX's bits, so the run
sets it to 0 in both packages; the port's command starts from the
reference's PRNGKey(0) init carried across by `params_from_jax`. Then
each package's `evaluate -m best` decodes from its own checkpoints:
`metrics.jsonl` holds the reference's records (losses within 1e-5) and,
in the port's train records, the window's gen / entity / copy losses
mixed by the loss weights into the loss; `meta.json` the same steps and
best; the last checkpoint's params (decoder and heads) within rtol
1e-5 / atol 1e-6;
`generations.jsonl` (with `copied_texts`) and `evaluate-metrics.json`
byte-equal.

Every pointer-family config, and each of the online pipeline's two,
builds at full width on the meta device with the parameter names and
shapes of the reference's init (traced with `jax.eval_shape`), and so
do TGNC's and Gen-1's; the flagship's checkpoint keys stay the
decoder's own.
"""

import functools
import glob
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from flax import serialization  # noqa: E402

from news_image_caption_tpu import cli as jax_cli  # noqa: E402
from news_image_caption_tpu import config as jax_config  # noqa: E402
from news_image_caption_tpu.models import pointer as jax_pointer  # noqa: E402
from news_image_caption_tpu_torch import cli  # noqa: E402
from news_image_caption_tpu_torch import config  # noqa: E402
from news_image_caption_tpu_torch.models.from_jax import (  # noqa: E402
    params_from_jax, torch_key)
from news_image_caption_tpu_torch.models.pointer import \
    TransformerPointer  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
TINY = str(REPO / "configs" / "tiny_pointer.yaml")
OVERRIDES = {"model": dict(dropout=0.0, weight_dropout=0.0, input_dropout=0.0,
                           attention_dropout=0.0),
             "trainer": {"log_every": 4}}
POINTER_CONFIGS = [
    "configs/goodnews/context_pointer.yaml", "configs/goodnews/copy_fix.yaml",
    "configs/goodnews/copy_loss.yaml", "configs/goodnews/entity_faces.yaml",
    "configs/goodnews/entity_pointer.yaml",
    "configs/goodnews/entity_weightedbert.yaml",
    "configs/goodnews/faces_pointer.yaml",
    "configs/goodnews/objects_pointer.yaml",
    "configs/goodnews/only_pointer.yaml",
    "configs/goodnews/pretrained_entity_pointer.yaml",
    "configs/goodnews/transformer_copying.yaml",
    "configs/goodnews/transformer_pointer.yaml",
    "configs/nytimes/copy_fix.yaml", "configs/nytimes/copy_loss.yaml",
    "configs/nytimes/transformer_copying.yaml", "configs/tiny_pointer.yaml"]
# The online pipeline's configs (tests/test_torch_pipeline_cli.py runs
# the commands).
PIPELINE_CONFIGS = [
    "configs/goodnews/transformer_weighted_roberta.yaml",
    "configs/nytimes/transformer_weighted_roberta.yaml"]
# TGNC's and Gen-1's configs (tests/test_torch_tgnc_gen1_cli.py runs the
# commands; the LSTM and Gen-2 configs', tests/test_torch_lstm_gen2_cli.py).
OTHER_CONFIGS = [
    "configs/goodnews/gen1_show_attend_tell.yaml",
    "configs/goodnews/joganic_tgnc.yaml"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _overrides(out: Path) -> str:
    return json.dumps(config.merge_overrides(
        OVERRIDES, {"trainer": {"serialization_dir": str(out)}}))


def _records(path: Path):
    return [json.loads(line) for line in path.read_text().splitlines()]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference dir, port dir): each package's train, then evaluate -m
    best from its own checkpoints."""
    ref = tmp_path_factory.mktemp("reference")
    port = tmp_path_factory.mktemp("port")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_pointer, "CopyAttentionScores", functools.partial(
            jax_pointer.CopyAttentionScores, dropout_rate=0.0))
        over = _overrides(ref)
        assert jax_cli.main(["train", TINY, "--platform", "cpu", "-o",
                             over]) == 0
        assert jax_cli.main(["evaluate", TINY, "--platform", "cpu", "-o",
                             over, "-m", "best"]) == 0
        over = _overrides(port)
        jcfg = jax_config.load_config(TINY, over)
        sample = next(jax_config.build_dataset(jcfg, "train").batches(4))
        variables = jax_config.build_model(jcfg).init(jax.random.PRNGKey(0),
                                                      sample)
    model = config.build_model(config.load_config(TINY, over), "cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, variables),
                                          model))
    model.copy_attn.dropout = 0.0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "training_model", lambda cfg, device, seed: model)
        assert cli.main(["train", TINY, "--platform", "cpu", "-o",
                         over]) == 0
    assert cli.main(["evaluate", TINY, "--platform", "cpu", "-o", over,
                     "-m", "best"]) == 0
    return ref, port


def test_train_metrics_match_reference(runs):
    ref, port = runs
    want = _records(ref / "metrics.jsonl")
    got = _records(port / "metrics.jsonl")
    assert [r["split"] for r in got] == ["train", "train", "val"] * 2
    assert len(got) == len(want)
    parts = ("gen_loss", "entity_loss", "copy_loss")
    for g, w in zip(got, want):
        assert [k for k in g if k not in parts] == list(w)
        for k, v in w.items():
            if k == "loss":
                np.testing.assert_allclose(g[k], v, rtol=1e-5)
            elif k != "input_wait":
                assert g[k] == v, k
        if g["split"] == "train":
            assert list(g)[3:6] == list(parts)
            assert all(np.isfinite(g[k]) and g[k] > 0 for k in parts)
            # (0, 1, 1): the loss is the entity and copy losses.
            np.testing.assert_allclose(g["loss"],
                                       g["entity_loss"] + g["copy_loss"],
                                       rtol=1e-5)


def test_meta_matches_reference(runs):
    ref, port = runs
    want = json.loads((ref / "checkpoints" / "meta.json").read_text())
    got = json.loads((port / "checkpoints" / "meta.json").read_text())
    assert [c["step"] for c in got["checkpoints"]] == [8, 16] == \
        [c["step"] for c in want["checkpoints"]]
    assert got["best"]["step"] == want["best"]["step"]
    np.testing.assert_allclose(got["best"]["value"], want["best"]["value"],
                               rtol=1e-5)


def test_final_params_match_reference(runs):
    ref, port = runs
    want = serialization.msgpack_restore(
        (ref / "checkpoints" / "ckpt_16.msgpack").read_bytes())
    got = torch.load(port / "checkpoints" / "ckpt_16.pt", weights_only=True)
    model = config.build_model(config.load_config(TINY), "meta")
    flat = params_from_jax(want["params"], model)
    assert set(flat) == set(got["params"])
    assert {k.split(".")[0] for k in flat} == {
        "decoder", "entity_attn", "entity_fc", "copy_attn"}
    # atol 1e-6: at loss weights (0, 1, 1) the word tables' gradients
    # come through the input embedding alone, some near Adam's eps 1e-6,
    # where m / (sqrt(v) + eps) moves with their last bits.
    for k, w in flat.items():
        np.testing.assert_allclose(got["params"][k].numpy(), w.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", ["generations.jsonl",
                                  "evaluate-metrics.json"])
def test_evaluate_best_files_are_byte_equal(runs, name):
    ref, port = runs
    records = _records(port / "generations.jsonl")
    assert len(records) == 8
    assert all("copied_texts" in r for r in records)
    assert any(r["copied_texts"] for r in records)
    assert (port / name).read_bytes() == (ref / name).read_bytes()


def test_dump_attention_warns_and_skips(runs, tmp_path, capsys):
    _, port = runs
    over = _overrides(port)
    assert cli.main(["evaluate", TINY, "--platform", "cpu", "-o", over,
                     "-m", "best", "-s", "_dump", "--dump-attention",
                     str(tmp_path / "attn")]) == 0
    assert "no attention_maps; skipping dump" in capsys.readouterr().err
    assert not (tmp_path / "attn").exists()
    assert (port / "generations_dump.jsonl").read_bytes() == \
        (port / "generations.jsonl").read_bytes()


# -- the family's configs ---------------------------------------------------

def test_config_lists_cover_the_repository():
    every = sorted(str(Path(p).relative_to(REPO)) for p in glob.glob(
        str(REPO / "configs" / "**" / "*.yaml"), recursive=True))
    types = {p: config.load_config(str(REPO / p))["model"]["type"]
             for p in every}
    family = {p for p, t in types.items()
              if t in config.POINTERS or t == "transformer_entity"}
    assert family == set(POINTER_CONFIGS)
    assert len(family) == 16
    assert set(PIPELINE_CONFIGS) == {p for p, t in types.items()
                                     if t == "gen3_pipeline"}
    assert set(OTHER_CONFIGS) == {p for p, t in types.items()
                                  if t in ("tgnc", "gen1")}
    # `config.py` builds every model type of the repository's configs.
    assert all(t in config.CAPTIONERS or t in config.POINTERS
               or t in config.FAMILIES or t in ("gen3_pipeline", "tgnc")
               for t in types.values())


def _jax_shapes(cfg):
    model = jax_config.build_model(cfg)
    ds = jax_config.build_dataset(cfg, "test")
    ex = ds.collate([ds[0]])
    sample = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
              for k, v in ex.items()}
    return jax.eval_shape(model.init, jax.random.PRNGKey(0), sample)


@pytest.mark.parametrize("path", POINTER_CONFIGS + PIPELINE_CONFIGS
                         + OTHER_CONFIGS)
def test_config_builds_the_references_parameters(path):
    cfg = config.load_config(str(REPO / path))
    model = config.build_model(cfg, "meta")
    tree = jax.tree.map(lambda s: np.lib.stride_tricks.as_strided(
        np.zeros(1, np.float32), s.shape, (0,) * len(s.shape)),
        _jax_shapes(cfg))
    params_from_jax(tree, model.param_module)   # strict: names and shapes
    assert all(p.dtype == torch.float32 and p.device.type == "meta"
               for p in model.param_module.parameters())
    jmodel = jax_config.build_model(cfg)
    if isinstance(model, TransformerPointer):
        assert model.loss_weights == tuple(jmodel.loss_weights)
        assert model.use_entity_head == jmodel.use_entity_head
        dec = model.decoder
        assert dec.layers[0].context_names == [
            name for name in ("image", "article", "faces", "obj", "entity")
            if hasattr(dec.layers[0], f"{name}_attn")]


def test_flagship_checkpoint_keys_stay_the_decoders(tmp_path):
    """The flagship's `param_module` is its decoder: a checkpoint's
    params are the flax tree's names with no prefix, as before the
    pointer family."""
    tiny = str(REPO / "configs" / "tiny_test.yaml")
    model = config.build_model(config.load_config(tiny), "meta")
    assert model.param_module is model.decoder
    jax_names = {torch_key(k) for k in
                 _flat(_jax_shapes(jax_config.load_config(tiny)))}
    assert set(dict(model.param_module.named_parameters())) == jax_names
    assert not any(k.startswith("decoder.") for k in jax_names)
    over = json.dumps({"trainer": {"num_epochs": 1}})
    assert cli.main(["train", tiny, "--platform", "cpu", "-s", str(tmp_path),
                     "-o", over]) == 0
    ckpt = torch.load(tmp_path / "checkpoints" / "best.pt",
                      weights_only=True)
    assert set(ckpt["params"]) == jax_names


def _flat(tree, prefix=""):
    tree = tree["params"] if set(tree) == {"params"} else tree
    out = []
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out += _flat(v, path) if isinstance(v, dict) else [path]
    return out


@pytest.mark.parametrize("path,weights,head", [
    ("configs/goodnews/transformer_pointer.yaml", (0.0, 1.0, 1.0), True),
    ("configs/nytimes/copy_fix.yaml", (1.0, 1.0, 1.0), True),
    ("configs/nytimes/transformer_copying.yaml", (1.0, 0.0, 0.0), True),
    ("configs/goodnews/only_pointer.yaml", (0.0, 1.0, 1.0), False)])
def test_pointer_switches_follow_the_config(path, weights, head):
    model = config.build_model(config.load_config(str(REPO / path)), "meta")
    assert model.loss_weights == weights and model.use_entity_head == head


def test_entity_pointer_is_narrowed_through_decoder_kwargs():
    """Top-level widths of transformer_entity_pointer reach the pointer,
    which drops them: the reference's decoder stays at its defaults
    unless narrowed through decoder_kwargs."""
    path = str(REPO / "configs/goodnews/entity_pointer.yaml")
    narrow = dict(vocab_size=64, cutoff=[16, 32, 64], embed_dim=16,
                  ffn_dim=32, num_heads=4, num_layers=2, kernel_sizes=[3, 5],
                  image_dim=16, article_dim=12)
    over = {"model": {"decoder_kwargs": narrow, "article_dim": 12,
                      "num_heads": 4, "entity_dim": 8, "vocab_size": 7},
            "dataset": dict(vocab_size=64, article_len=16, n_patches=4,
                            image_dim=16, article_dim=12, entity_dim=8)}
    cfg = config.load_config(path, json.dumps(over))
    model = config.build_model(cfg, "meta")
    assert model.vocab_size == 64 and model.decoder.embed_dim == 16
    assert model.decoder.layers[0].context_names == ["image", "article",
                                                     "entity"]
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                        _jax_shapes(cfg))
    params_from_jax(tree, model)


NARROW = dict(vocab_size=64, cutoff=[16, 32, 64], embed_dim=16, ffn_dim=32,
              num_heads=4, image_dim=16, article_dim=12, max_positions=64)
NARROW_EXTRA = {"transformer_faces_pointer": dict(face_dim=8),
                "transformer_objects_pointer": dict(obj_dim=6),
                "transformer_entity": dict(entity_dim=8),
                "transformer_entity_pointer": dict(
                    entity_dim=8, decoder_kwargs=dict(
                        NARROW, num_layers=2, kernel_sizes=[3, 5]))}
NARROW_DATA = dict(vocab_size=64, caption_len=12, article_len=16,
                   n_patches=4, image_dim=16, article_dim=12, face_dim=8,
                   obj_dim=6, entity_dim=8, train={"size": 8},
                   val={"size": 4}, test={"size": 4})


@pytest.mark.parametrize("path", POINTER_CONFIGS)
def test_train_command_runs_every_config_narrowed(path, tmp_path, capsys):
    """Two steps of the config's own precision, then `evaluate -m
    latest` (greedy, the pointer's copied texts) from what it wrote."""
    cfg = config.load_config(str(REPO / path))
    narrow = dict(NARROW, **NARROW_EXTRA.get(cfg["model"]["type"], {}))
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
    pointer = cfg["model"]["type"] != "transformer_entity"
    assert ("copy_loss" in recs[0]) == pointer
    ckpt = torch.load(tmp_path / "checkpoints" / "ckpt_2.pt",
                      weights_only=True)
    assert any(k.startswith("entity_attn.") for k in ckpt["params"]) \
        == pointer
    assert cli.main(["evaluate", str(REPO / path), "--platform", "cpu",
                     "-o", overrides, "-m", "latest"]) == 0
    assert "random init" not in capsys.readouterr().err
    records = _records(tmp_path / "generations.jsonl")
    assert len(records) == 4 and all("copied_texts" in r for r in records)
