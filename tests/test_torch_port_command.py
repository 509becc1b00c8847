"""The port's checkpoint migration against the reference's, on the CPU:
`models/port_tell.py`, `models/port_checkpoint.py`,
`models/from_jax.py::flax_view` / `encoder_state` and the `port` command.

Reference-keyed torch models (`tests/torch_tell_{decoder,pointer,tgnc}.py`,
seeded) give the `best.th` state dicts, as the reference's
`tests/test_port_checkpoint.py` and `test_port_tell.py` build them.

- `port_checkpoint`'s trees equal the reference's, leaf for leaf, for the
  flattened, pointer, only-pointer and TGNC families and a flattened
  checkpoint that bundles fairseq RoBERTa and torchvision ResNet
  encoders, `bert_weight` and the dead `bert_weight_2`; strict porting
  raises on the same unknown keys;
- `flax_view` of the port's model is the reference's init tree (paths and
  shapes, from `jax.eval_shape`) for the flattened, pointer, TGNC (with
  and without the template decoder) and weighted-pipeline configs, and
  `params_from_jax` reads it back bit for bit;
- `assemble_for_init` and `merge_into_init` give the reference's trees,
  warnings, dropped leaves and errors;
- the `port` command then `evaluate -m best` writes files byte-equal to
  the reference's commands' for the flattened and pointer families; for
  TGNC and the weighted pipeline (encoders not bundled: both packages
  keep their own random init for them) the ported checkpoint's params
  equal the reference's; the bundled encoders' files hold the
  reference's values.
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import yaml  # noqa: E402
from flax import serialization  # noqa: E402

from news_image_caption_tpu import cli as jax_cli  # noqa: E402
from news_image_caption_tpu import config as jax_config  # noqa: E402
from news_image_caption_tpu.models import \
    port_checkpoint as jax_port  # noqa: E402
from news_image_caption_tpu.models import \
    port_tell as jax_port_tell  # noqa: E402
from news_image_caption_tpu_torch import cli  # noqa: E402
from news_image_caption_tpu_torch.config import (build_model,  # noqa: E402
                                                 load_config)
from news_image_caption_tpu_torch.models import port_checkpoint  # noqa: E402
from news_image_caption_tpu_torch.models import port_tell  # noqa: E402
from news_image_caption_tpu_torch.models.from_jax import (  # noqa: E402
    _flatten, encoder_state, flax_view, params_from_jax)
from news_image_caption_tpu_torch.models.roberta import \
    RobertaEncoder  # noqa: E402

from torch_tell_decoder import TellDecoder  # noqa: E402
from torch_tell_pointer import TellPointer  # noqa: E402
from torch_tell_tgnc import TellTGNC  # noqa: E402

V, D, FFN, H = 120, 32, 64, 4
CUTOFF = (40, 80, V)
KERNELS = (3, 5)
IMG_DIM, ART_DIM = 48, 32
DECODER = dict(vocab_size=V, ffn_dim=FFN, kernel_sizes=KERNELS, cutoff=CUTOFF,
               image_dim=IMG_DIM, article_dim=ART_DIM, max_positions=64)
PORT_ARGS = dict(num_layers=len(KERNELS), embed_dim=D, n_bands=len(CUTOFF))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _decoder_sd(seed=0, image_dim=IMG_DIM):
    torch.manual_seed(seed)
    tdec = TellDecoder(embed_dim=D, num_heads=H,
                       **dict(DECODER, image_dim=image_dim)).eval()
    return {f"decoder.{k}": v for k, v in tdec.state_dict().items()}


def _pointer_sd(seed=0):
    torch.manual_seed(seed)
    return TellPointer(embed_dim=D, num_heads=H, **DECODER).eval().state_dict()


def _tgnc_sd(seed=1, n_templates=3):
    torch.manual_seed(seed)
    return TellTGNC(embed_dim=D, n_templates=n_templates, head_kernel=7,
                    num_heads=H, **DECODER).eval().state_dict()


def _bundled_encoders(rng):
    """fairseq RoBERTa (24 layers at width 8) and torchvision ResNet-152
    keys, the ResNet's leaves tiny (the porter maps keys, not shapes)."""
    E, FF = 8, 16
    pre = "roberta.model.decoder.sentence_encoder."
    sd = {pre + "embed_tokens.weight": rng.randn(20, E),
          pre + "embed_positions.weight": rng.randn(12, E),
          pre + "emb_layer_norm.weight": rng.randn(E),
          pre + "emb_layer_norm.bias": rng.randn(E)}
    for i in range(24):
        b = f"{pre}layers.{i}."
        sd.update({b + "self_attn.in_proj_weight": rng.randn(3 * E, E),
                   b + "self_attn.in_proj_bias": rng.randn(3 * E),
                   b + "self_attn.out_proj.weight": rng.randn(E, E),
                   b + "self_attn.out_proj.bias": rng.randn(E),
                   b + "self_attn_layer_norm.weight": rng.randn(E),
                   b + "self_attn_layer_norm.bias": rng.randn(E),
                   b + "fc1.weight": rng.randn(FF, E), b + "fc1.bias":
                   rng.randn(FF), b + "fc2.weight": rng.randn(E, FF),
                   b + "fc2.bias": rng.randn(E),
                   b + "final_layer_norm.weight": rng.randn(E),
                   b + "final_layer_norm.bias": rng.randn(E)})

    def bn(prefix):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            sd[f"resnet.{prefix}.{leaf}"] = rng.randn(2)
        sd[f"resnet.{prefix}.num_batches_tracked"] = np.zeros((), np.int64)

    sd["resnet.conv1.weight"] = rng.randn(2, 3, 1, 1)
    bn("bn1")
    for stage, blocks in enumerate((3, 8, 36, 3)):
        for b in range(blocks):
            t = f"layer{stage + 1}.{b}"
            for ci in (1, 2, 3):
                sd[f"resnet.{t}.conv{ci}.weight"] = rng.randn(2, 2, 1, 1)
                bn(f"{t}.bn{ci}")
            if b == 0:
                sd[f"resnet.{t}.downsample.0.weight"] = rng.randn(2, 2, 1, 1)
                bn(f"{t}.downsample.1")
    sd["resnet.fc.weight"] = rng.randn(3, 2)
    return {k: torch.from_numpy(np.asarray(v, np.float32)
                                if v.dtype == np.float64 else v)
            for k, v in sd.items()}


def _bundle_sd():
    sd = _decoder_sd()
    sd.update(_bundled_encoders(np.random.RandomState(3)))
    sd["bert_weight"] = torch.randn(25, generator=torch.Generator()
                                    .manual_seed(4))
    sd["bert_weight_2"] = torch.zeros(25)
    return sd


def _same(a, b, path=""):
    """Equal trees: the same keys, leaves equal bit for bit."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), \
            (path, set(a) ^ set(b))
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, str) or a is None:
        assert a == b, path
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.shape == y.shape and x.dtype == y.dtype, path
        np.testing.assert_array_equal(x, y, err_msg=path)


@pytest.mark.parametrize("family", ["flattened", "pointer", "only_pointer",
                                    "tgnc", "bundle"])
def test_port_trees_equal_the_references(family):
    sd = {"flattened": _decoder_sd, "pointer": _pointer_sd,
          "only_pointer": lambda: {k: v for k, v in _pointer_sd().items()
                                   if not k.startswith("entity")},
          "tgnc": _tgnc_sd, "bundle": _bundle_sd}[family]()
    want = jax_port.port_checkpoint(sd, **PORT_ARGS)
    got = port_checkpoint.port_checkpoint(sd, **PORT_ARGS)
    assert got["model"] == want["model"]
    _same(got, want)
    if family == "bundle":
        assert set(got) == {"model", "variables", "unused", "extras",
                            "roberta", "resnet"}
        assert any("bert_weight_2" in u for u in got["unused"])
    # DataParallel's 'module.' prefix is dropped.
    _same(port_checkpoint.port_checkpoint(
        {f"module.{k}": v for k, v in sd.items()}, **PORT_ARGS), want)


@pytest.mark.parametrize("family", ["flattened", "pointer", "tgnc"])
def test_strict_porting_raises_as_the_reference(family):
    sd = {"flattened": _decoder_sd, "pointer": _pointer_sd,
          "tgnc": _tgnc_sd}[family]()
    sd["decoder.layers.0.mystery.weight"] = torch.zeros(2)
    with pytest.raises(ValueError) as want:
        jax_port.port_checkpoint(sd, **PORT_ARGS)
    with pytest.raises(ValueError) as got:
        port_checkpoint.port_checkpoint(sd, **PORT_ARGS)
    assert str(got.value) == str(want.value)
    _same(port_checkpoint.port_checkpoint(sd, strict=False, **PORT_ARGS),
          jax_port.port_checkpoint(sd, strict=False, **PORT_ARGS))


def test_port_tell_decoder_checks_shapes_against_the_view():
    sd = _decoder_sd()
    model = build_model({"model": {"type": "transformer_flattened",
                                   "decoder": dict(DECODER, embed_dim=D,
                                                   num_heads=H,
                                                   num_layers=2)}}, "cpu")
    template = flax_view(model.param_module)
    want = jax_port_tell.port_tell_decoder(sd, **PORT_ARGS, template=template)
    got = port_tell.port_tell_decoder(sd, **PORT_ARGS, template=template)
    _same(got, want)
    bad = jax.tree.map(lambda a: a, template)
    bad["params"]["layers_0"]["fc1"]["kernel"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="shape mismatch at /layers_0/fc1"):
        port_tell.port_tell_decoder(sd, **PORT_ARGS, template=bad)


def _config(kind: str) -> dict:
    """Small configs of the families, synthetic test split of 4."""
    dataset = {"type": "synthetic_news", "vocab_size": V, "caption_len": 12,
               "article_len": 9, "n_patches": 5, "image_dim": IMG_DIM,
               "article_dim": ART_DIM, "test": {"size": 4, "seed": 2}}
    decoder = dict(DECODER, embed_dim=D, num_heads=H, num_layers=len(KERNELS),
                   kernel_sizes=list(KERNELS), cutoff=list(CUTOFF))
    cfg = {"dataset": dataset, "iterator": {"batch_size": 2},
           "generation": {"max_len": 6, "sampling_topk": 1}}
    if kind == "flattened":
        cfg["model"] = {"type": "transformer_flattened",
                        "decoder": dict(decoder, type="dynamic_conv_decoder"
                                        "_flattened")}
        cfg["trainer"] = {"mixed_precision": "bf16_o2"}
    elif kind == "pointer":
        cfg["model"] = dict(decoder, type="transformer_pointer")
    elif kind == "tgnc":
        cfg["model"] = dict(decoder, type="tgnc", use_template_decoder=True,
                            n_templates=3, head_kernel=7)
    elif kind == "tgnc_flattened":
        cfg["model"] = dict(decoder, type="tgnc")
    else:
        dataset.update(image_dim=256, raw_image_size=64)
        cfg["model"] = {
            "type": "gen3_pipeline", "weigh_bert": True,
            "resnet": {"depth": 18, "num_stages": 3},
            "roberta": {"vocab_size": V, "hidden": ART_DIM, "num_layers": 1,
                        "heads": H, "intermediate": 64},
            "decoder": dict(decoder, type="dynamic_conv_decoder_flattened",
                            image_dim=256)}
    return cfg


@pytest.mark.parametrize("kind", ["flattened", "pointer", "tgnc",
                                  "tgnc_flattened", "pipeline"])
def test_flax_view_is_the_reference_init_tree(kind):
    cfg = _config(kind)
    jmodel = jax_config.build_model(cfg)
    sample = next(jax_config.build_dataset(cfg, "test").batches(2))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), sample)
    model = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(0))
    view = flax_view(model.param_module)
    want = {k: tuple(v.shape) for k, v in _flatten(
        jax.tree.map(lambda s: s, shapes)).items()}
    got = {k: v.shape for k, v in _flatten(view).items()}
    assert got == want
    assert all(v.dtype == np.float32 for v in _flatten(view).values())
    back = params_from_jax(view, model.param_module)
    for k, t in model.param_module.state_dict().items():
        assert torch.equal(back[k], t.float()), k


def test_assemble_and_merge_match_the_reference():
    # Flattened: the {"captioner": ...} wrapper unwrapped, extras warned.
    sd = _decoder_sd()
    sd["bert_weight"] = torch.ones(25)
    model = build_model(_config("flattened"), "cpu")
    init = flax_view(model.param_module)
    for s in (sd, _decoder_sd()):
        want = jax_port.assemble_for_init(
            jax_port.port_checkpoint(s, **PORT_ARGS), init)
        got = port_checkpoint.assemble_for_init(
            port_checkpoint.port_checkpoint(s, **PORT_ARGS), init)
        _same(got, want)
        _same(port_checkpoint.merge_into_init(init, got[0]),
              jax.tree.map(np.asarray,
                           jax_port.merge_into_init(init, want[0])))
        assert ("bert_weight" in s) == any("not consumed by this config" in w
                                           for w in got[1])
    # Pointer: the copy head's dead out_proj is dropped.
    model = build_model(_config("pointer"), "cpu")
    init = flax_view(model.param_module)
    ported = port_checkpoint.port_checkpoint(_pointer_sd(), **PORT_ARGS)
    cand, warnings = port_checkpoint.assemble_for_init(ported, init)
    merged, dropped = port_checkpoint.merge_into_init(init, cand)
    want_merged, want_dropped = jax_port.merge_into_init(init, cand)
    assert dropped == want_dropped and dropped
    _same(merged, jax.tree.map(np.asarray, want_merged))
    # Pipeline: encoders kept from the init (warned), bert_weight routed.
    model = build_model(_config("pipeline"), "cpu")
    init = flax_view(model.param_module)
    sd = _decoder_sd(image_dim=256)
    sd["bert_weight"] = torch.randn(2)
    ported = port_checkpoint.port_checkpoint(sd, **PORT_ARGS)
    got = port_checkpoint.assemble_for_init(ported, init)
    _same(got, jax_port.assemble_for_init(ported, init))
    assert [w.split(";")[0] for w in got[1]] == [
        "warning: checkpoint bundles no resnet weights",
        "warning: checkpoint bundles no roberta weights"]
    # Errors: a missing leaf, a misshapen one.
    cand = jax.tree.map(lambda a: a, got[0])
    del cand["captioner"]["params"]["layers_0"]["fc1"]
    for fn in (port_checkpoint.merge_into_init, jax_port.merge_into_init):
        with pytest.raises(KeyError, match="missing /captioner/params/"
                                           "layers_0/fc1"):
            fn(init, cand)
    cand = jax.tree.map(lambda a: a, got[0])
    cand["weighted_sum"]["params"]["bert_weight"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="shape mismatch at /weighted_sum"):
        port_checkpoint.merge_into_init(init, cand)


def _write(cfg: dict, where: Path) -> str:
    where.mkdir(parents=True, exist_ok=True)
    path = where / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg, default_flow_style=None))
    return str(path)


def _port_both(tmp_path, kind, sd, capsys):
    """Each package's port command on `sd` for config `kind`; returns
    the two serialization directories and the port's stderr."""
    best_th = tmp_path / "best.th"
    torch.save(sd, best_th)
    out, err = {}, ""
    for name, run, extra in (("ref", jax_cli.main, []),
                             ("port", cli.main, [])):
        ser = tmp_path / name / "serialization"
        cfg = dict(_config(kind))
        cfg["trainer"] = dict(cfg.get("trainer", {}),
                              serialization_dir=str(ser))
        path = _write(cfg, tmp_path / name)
        capsys.readouterr()
        assert run(["port", path, str(best_th)] + extra) == 0
        captured = capsys.readouterr()
        assert "detected family: " in captured.out
        if name == "port":
            err = captured.err
        out[name] = (path, ser)
    return out, err


@pytest.mark.parametrize("kind", ["flattened", "pointer"])
def test_port_then_evaluate_matches_the_reference(tmp_path, capsys, kind):
    sd = _decoder_sd() if kind == "flattened" else _pointer_sd()
    runs, err = _port_both(tmp_path, kind, sd, capsys)
    if kind == "pointer":
        assert "dropped 1 ported leaves" in err
    (ref_cfg, ref), (port_cfg, port) = runs["ref"], runs["port"]
    assert jax_cli.main(["evaluate", ref_cfg, "--split", "test"]) == 0
    assert cli.main(["evaluate", port_cfg, "--split", "test", "-m", "best",
                     "--platform", "cpu"]) == 0
    assert "random init" not in capsys.readouterr().err
    assert (port / "generations.jsonl").read_bytes() == \
        (ref / "generations.jsonl").read_bytes()
    assert len((port / "generations.jsonl").read_text().splitlines()) == 4
    assert (port / "evaluate-metrics.json").read_text() == \
        (ref / "evaluate-metrics.json").read_text()
    meta = json.loads((port / "checkpoints" / "meta.json").read_text())
    assert meta["best"] == {"step": 0, "value": 0.0}
    state = torch.load(port / "checkpoints" / "best.pt", weights_only=True)
    dtype = torch.bfloat16 if kind == "flattened" else torch.float32
    assert {p.dtype for p in state["params"].values()} == {dtype}
    if kind == "flattened":          # bf16_o2: the fp32 master beside
        assert set(state["opt_state"]) == {"master", "inner"}


def _ref_params(ser: Path, module):
    ckpt = serialization.msgpack_restore(
        (ser / "checkpoints" / "ckpt_0.msgpack").read_bytes())
    return params_from_jax(ckpt["params"], module)


@pytest.mark.parametrize("kind", ["tgnc", "pipeline"])
def test_ported_checkpoint_params_match_the_reference(tmp_path, capsys,
                                                      kind):
    if kind == "tgnc":
        sd = _tgnc_sd()
    else:
        sd = _decoder_sd(image_dim=256)
        sd["bert_weight"] = torch.randn(2, generator=torch.Generator()
                                        .manual_seed(5))
    runs, err = _port_both(tmp_path, kind, sd, capsys)
    cfg = load_config(runs["port"][0])
    model = build_model(cfg, "cpu")
    want = _ref_params(runs["ref"][1], model.param_module)
    got = torch.load(runs["port"][1] / "checkpoints" / "ckpt_0.pt",
                     weights_only=True)["params"]
    assert set(got) == set(want)
    init = cli.training_model(cfg, torch.device("cpu"), 0).param_module
    for k, v in got.items():
        if k.startswith(("resnet.", "roberta.")):
            # Not bundled: each package keeps its own random init.
            assert torch.equal(v, init.state_dict()[k]), k
        else:
            assert torch.equal(v, want[k]), k
    if kind == "pipeline":
        assert "bundles no resnet" in err and "bundles no roberta" in err
        assert "weighted_sum stays random" not in err


def test_bundled_encoders_are_written_with_the_references_values(tmp_path,
                                                                 capsys):
    runs, err = _port_both(tmp_path, "flattened", _bundle_sd(), capsys)
    assert "not consumed by this config" in err
    for enc in ("roberta", "resnet"):
        want = serialization.msgpack_restore(
            (runs["ref"][1] / "checkpoints" / f"{enc}_ported.msgpack")
            .read_bytes())
        got = torch.load(runs["port"][1] / "checkpoints" / f"{enc}_ported.pt",
                         weights_only=True)
        mapped = encoder_state(want, enc)
        assert set(got) == set(mapped)
        for k in got:
            assert torch.equal(got[k], mapped[k]), k
    # The RoBERTa file loads into an encoder of its widths.
    enc = RobertaEncoder(vocab_size=20, hidden=8, num_layers=24, heads=2,
                         intermediate=16, max_positions=12, device="cpu",
                         dtype=torch.float32)
    enc.load_state_dict(torch.load(
        runs["port"][1] / "checkpoints" / "roberta_ported.pt",
        weights_only=True))
    assert got["conv1.weight"].shape == (2, 3, 1, 1)   # OIHW, as it came
