"""The port's shards and the offline pass against the reference's, on the
CPU: `data/native_loader.py` with its C++ reader `native/shard_reader.cc`,
`data/dataset.py::NicsShardDataset`, `data/loader.py::host_tensor`,
`data/materialize.py` and the `preprocess` command.

- `write_shard` writes files and schemas byte-equal to the reference's;
- `NativeShardLoader` yields the reference loader's batches, bit for bit,
  for the same shards and seeds, structure-of-arrays and
  array-of-structures, with `drop_last` on and off, and a shuffled epoch
  is a permutation of the records;
- a float16 field reaches the tensor as bfloat16 with the bits of the
  reference's `ml_dtypes` cast (all 65536 float16 values: subnormals,
  infinities, NaNs of both signs), `*_mask` uint8 fields as bool;
- the reader is built by `g++` into `_build/`, named by a hash of its
  source, and its build raises without `g++` (no fallback);
- `materialize` with narrowed encoders carried from the reference's
  `FeatureEncoders` writes the reference's ids and masks exactly and its
  features within the tolerances `tests/test_torch_pipeline.py` holds
  the encoders to (ResNet rtol 1e-4 / atol 1e-4 x the largest value,
  RoBERTa 1e-5), over inline images, a PNG on disk (both resized by PIL)
  and a missing image (skipped);
- `preprocess` -> `train` -> `evaluate -m best` through `nics_shards` on
  a narrowed flagship config (fp32, no dropout): `metrics.jsonl` within
  1e-5 and `generations.jsonl` byte-equal to the reference's commands',
  the port's model carrying the reference's PRNGKey(0) init.
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ml_dtypes = pytest.importorskip("ml_dtypes")

import jax  # noqa: E402
import yaml  # noqa: E402

from news_image_caption_tpu import cli as jax_cli  # noqa: E402
from news_image_caption_tpu import config as jax_config  # noqa: E402
from news_image_caption_tpu.data import dataset as jax_dataset  # noqa: E402
from news_image_caption_tpu.data import \
    materialize as jax_mat  # noqa: E402
from news_image_caption_tpu.data import \
    native_loader as jax_native  # noqa: E402
from news_image_caption_tpu.data.readers import \
    NewsRecord as JaxNewsRecord  # noqa: E402
from news_image_caption_tpu.models import resnet as jax_resnet  # noqa: E402
from news_image_caption_tpu.models import \
    roberta as jax_roberta  # noqa: E402
from news_image_caption_tpu_torch import cli  # noqa: E402
from news_image_caption_tpu_torch.config import (build_model,  # noqa: E402
                                                 load_config)
from news_image_caption_tpu_torch.data import materialize  # noqa: E402
from news_image_caption_tpu_torch.data import native_loader  # noqa: E402
from news_image_caption_tpu_torch.data.dataset import \
    NicsShardDataset  # noqa: E402
from news_image_caption_tpu_torch.data.loader import (  # noqa: E402
    DeviceLoader, f16_bf16_bits, host_tensor)
from news_image_caption_tpu_torch.data.readers import \
    NewsRecord  # noqa: E402
from news_image_caption_tpu_torch.models.from_jax import \
    params_from_jax  # noqa: E402
from news_image_caption_tpu_torch.models.resnet import \
    ResNetTrunk  # noqa: E402
from news_image_caption_tpu_torch.models.roberta import \
    RobertaEncoder  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
ROBERTA = dict(vocab_size=512, hidden=16, num_layers=1, heads=4,
               intermediate=32, max_positions=64)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(n, seed=0, first=0):
    """n records; `label` numbers them from `first`."""
    rng = np.random.default_rng(seed)
    return {
        "caption_ids": rng.integers(0, 100, (n, 8)).astype(np.int32),
        "image": rng.standard_normal((n, 4, 6)).astype(np.float32),
        "article": rng.standard_normal((n, 5, 3)).astype(np.float16),
        "article_mask": rng.random((n, 5)) > 0.5,
        "raw": rng.integers(0, 256, (n, 3, 3, 3)).astype(np.uint8),
        "label": np.arange(first, first + n, dtype=np.int64),
        "scale": rng.random(n).astype(np.float64),
    }


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Three shards of 7, 5 and 9 records written by each package."""
    where = tmp_path_factory.mktemp("shards")
    out = {"ref": [], "port": []}
    for i, (n, first) in enumerate(((7, 0), (5, 7), (9, 12))):
        arrays = _arrays(n, seed=i, first=first)
        for name, write in (("ref", jax_native.write_shard),
                            ("port", native_loader.write_shard)):
            path = str(where / f"{name}-{i}.nics")
            write(path, arrays)
            out[name].append(path)
    return out


def test_write_shard_bytes_equal(shards):
    for ref, port in zip(shards["ref"], shards["port"]):
        assert Path(port).read_bytes() == Path(ref).read_bytes()
        assert Path(port + ".schema").read_bytes() == \
            Path(ref + ".schema").read_bytes()


@pytest.mark.parametrize("soa", [True, False], ids=["soa", "aos"])
@pytest.mark.parametrize("drop_last", [True, False],
                         ids=["drop_last", "keep_last"])
def test_loader_batches_equal_the_references(shards, soa, drop_last):
    want = jax_native.NativeShardLoader(shards["ref"], batch_size=4,
                                        drop_last=drop_last, soa=soa)
    got = native_loader.NativeShardLoader(shards["port"], batch_size=4,
                                          drop_last=drop_last, soa=soa,
                                          pool_size=2)
    assert len(got) == len(want) == 21
    labels = []
    for shuffle, seed in ((False, 0), (True, 0), (True, 5)):
        gb = [{k: v.copy() for k, v in b.items()}
              for b in got.epoch(shuffle=shuffle, seed=seed)]
        wb = list(want.epoch(shuffle=shuffle, seed=seed))
        assert len(gb) == len(wb) == (5 if drop_last else 6)
        for g, w in zip(gb, wb):
            assert list(g) == list(w)
            for k in w:
                assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
                assert g[k].tobytes() == w[k].tobytes(), k
        labels.append(np.concatenate([b["label"] for b in gb]))
    if not drop_last:
        # Every record once an epoch: a shuffled epoch is a permutation.
        for lab in labels:
            np.testing.assert_array_equal(np.sort(lab), np.arange(21))
        assert not np.array_equal(labels[1], labels[0])
    got.close()
    want.close()
    with pytest.raises(ValueError, match="closed"):
        len(got)


def test_f16_to_bf16_bits_equal_ml_dtypes():
    every = np.arange(65536, dtype=np.uint32).astype(np.uint16).view(
        np.float16)
    with np.errstate(invalid="ignore"):
        want = every.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(f16_bf16_bits(every), want)
    t = host_tensor(every.reshape(256, 256))
    assert t.dtype == torch.bfloat16 and t.shape == (256, 256)
    np.testing.assert_array_equal(
        t.view(torch.int16).numpy().view(np.uint16).ravel(), want)
    # Other dtypes pass as they are.
    for a in (np.arange(6, dtype=np.int32), np.ones(3, bool),
              np.zeros((2, 2), np.float32)):
        assert host_tensor(a).numpy().tobytes() == a.tobytes()


def test_nics_dataset_delivers_the_references_batches(shards):
    want = jax_dataset.NicsShardDataset(paths=shards["ref"])
    got = NicsShardDataset(paths=shards["port"])
    assert len(got) == len(want) == 21
    wb = list(want.batches(4, seed=3))
    gb = [{k: v.copy() for k, v in b.items()} for b in got.batches(4, seed=3)]
    on_device = list(DeviceLoader(iter(gb), "cpu"))
    assert len(gb) == len(wb) == 5
    for g, d, w in zip(gb, on_device, wb):
        assert g["article_mask"].dtype == bool
        assert g["article"].dtype == np.float16
        assert d["article"].dtype == torch.bfloat16
        for k in w:
            bits = d[k].view(torch.int16) if k == "article" else d[k]
            assert bits.numpy().tobytes() == w[k].tobytes(), k
    got.close()
    with pytest.raises(FileNotFoundError):
        NicsShardDataset(pattern=str(REPO / "no-such-*.nics"))


def test_reader_builds_from_its_source_with_gxx(tmp_path, monkeypatch):
    path = native_loader.build()
    assert path.parent == native_loader.BUILD_DIR
    assert path.name.startswith("libshard_reader_")
    assert native_loader.SOURCE.parent.name == "native"
    assert native_loader.SOURCE.parent.parent.name == \
        "news_image_caption_tpu_torch"
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "build")
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setattr(native_loader.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native_loader.build()
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="building the shard reader"):
        native_loader.build()
    assert not (tmp_path / "build").exists() or not list(
        (tmp_path / "build").glob("*.so"))


# -- materialize and the preprocess command ----------------------------------

def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _carried(col, variables, module):
    holder = torch.nn.ModuleDict({col: module})
    return {k[len(col) + 1:]: v for k, v in params_from_jax(
        {col: _np(variables["params"])}, holder).items()}


@pytest.fixture(scope="module")
def encoders():
    """Narrowed reference encoders (random, PRNGKey(0)) and the port's
    carrying their weights."""
    ref = jax_mat.FeatureEncoders(
        resnet=jax_resnet.ResNetTrunk(depth=18, num_stages=2),
        roberta=jax_roberta.RobertaEncoder(**ROBERTA), crop=32)
    kw = dict(device="cpu", dtype=torch.float32)
    resnet, roberta = ResNetTrunk(18, 2, **kw), RobertaEncoder(**ROBERTA, **kw)
    port = materialize.FeatureEncoders(
        resnet=resnet, resnet_state=_carried("resnet", ref._rv, resnet),
        roberta=roberta, roberta_state=_carried("roberta", ref._bv, roberta),
        crop=32)
    return ref, port


def _news(n: int):
    names = ["Barack Obama", "Angela Merkel", "New York", "José Müller"]
    return [{"caption": f"{names[i % 4]} visited city number {i} in "
                        f"{names[(i + 2) % 4]}.",
             "article": f"{names[(i + 1) % 4]} was seen in {names[i % 4]} on "
                        f"day {i}. It rained in {names[(i + 3) % 4]}."}
            for i in range(n)]


def test_materialize_matches_the_reference(tmp_path, encoders):
    """Inline images (one the size, one resized by PIL), a PNG on disk
    and a missing image, which both skip."""
    Image = pytest.importorskip("PIL.Image")
    ref_enc, port_enc = encoders
    rng = np.random.default_rng(7)
    png = tmp_path / "img.png"
    Image.fromarray(rng.integers(0, 256, (40, 30, 3), dtype=np.uint8)).save(
        png)
    news = _news(7)

    def records(cls):
        out = []
        for i, n in enumerate(news):
            image = path = None
            if i in (0, 3):
                image = np.random.default_rng(i).integers(
                    0, 256, (48 if i == 0 else 36, 48, 3), dtype=np.uint8)
            elif i == 2:
                path = str(png)
            elif i == 5:
                path = str(tmp_path / "missing.jpg")
            out.append(cls(caption=n["caption"], article=n["article"],
                           image=image, image_path=path))
        return out

    kw = dict(records_per_shard=4, caption_len=16, article_len=32,
              image_size=48, batch_size=3)
    want = jax_mat.materialize(None, str(tmp_path / "ref"),
                               encoders=ref_enc,
                               reader=records(JaxNewsRecord), **kw)
    got = materialize.materialize(None, str(tmp_path / "port"),
                                  encoders=port_enc,
                                  reader=records(NewsRecord), **kw)
    assert len(got) == len(want) == 2          # 6 records kept, 4 a shard
    for g, w in zip(got, want):
        assert Path(g).name.replace("port", "ref") == Path(w).name
        _compare_shard(g, w)


def _compare_shard(got: str, want: str):
    assert Path(got + ".schema").read_text() == \
        Path(want + ".schema").read_text()
    (gb,) = [{k: v.copy() for k, v in b.items()} for b in
             native_loader.NativeShardLoader(
                 [got], batch_size=64, drop_last=False).epoch(shuffle=False)]
    (wb,) = list(jax_native.NativeShardLoader(
        [want], batch_size=64, drop_last=False).epoch(shuffle=False))
    for k, v in wb.items():
        if k == "image":
            scale = float(np.abs(v).max())
            np.testing.assert_allclose(gb[k], v, rtol=1e-4,
                                       atol=1e-4 * scale)
        elif k == "article":
            np.testing.assert_allclose(gb[k], v, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(gb[k], v, err_msg=k)


NARROW_DECODER = dict(vocab_size=512, embed_dim=16, ffn_dim=32, num_heads=4,
                      num_layers=2, kernel_sizes=[3, 5],
                      cutoff=[128, 256, 512], image_dim=128, article_dim=16,
                      max_positions=64, dropout=0.0, weight_dropout=0.0,
                      relu_dropout=0.0, input_dropout=0.0,
                      attention_dropout=0.0, use_flash_train=False)


@pytest.fixture(scope="module")
def commands(tmp_path_factory, encoders):
    """Each package's preprocess (train 24 records, val 8), train (2
    epochs of 6 steps) and evaluate -m best on the val shards."""
    where = tmp_path_factory.mktemp("commands")
    ref_enc, port_enc = encoders
    cfg = load_config(str(REPO / "configs" / "goodnews_transformer_roberta"
                          ".yaml"))
    del cfg["dataset"]
    cfg["model"]["decoder"].update(NARROW_DECODER)
    cfg["iterator"]["batch_size"] = 4
    cfg["generation"]["max_len"] = 10
    cfg["trainer"].update(num_epochs=2, patience=None, log_every=3,
                          mixed_precision="fp32")
    cfg["trainer"]["optimizer"].update(lr=0.001, t_total=100)
    cfg_path = where / "narrow.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg, default_flow_style=None))
    news = _news(32)
    for split, rows in (("train", news[:24]), ("val", news[24:])):
        (where / f"{split}.jsonl").write_text(
            "".join(json.dumps(r) + "\n" for r in rows))
    out = {}
    for name, run, mat, enc in (("ref", jax_cli.main, jax_mat, ref_enc),
                                ("port", cli.main, materialize, port_enc)):
        root = where / name
        root.mkdir()
        flags = ["--records-per-shard", "8", "--caption-len", "16",
                 "--article-len", "32"]
        if name == "port":
            flags += ["--platform", "cpu"]
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(mat, "FeatureEncoders", lambda *a, **k: enc)
            for split in ("train", "val"):
                assert run(["preprocess", str(where / f"{split}.jsonl"),
                            str(root / split)] + flags) == 0
        overrides = json.dumps({
            "dataset": {"type": "nics_shards",
                        "train": {"pattern": str(root / "train-*.nics")},
                        "val": {"pattern": str(root / "val-*.nics")}},
            "trainer": {"serialization_dir": str(root / "ser")}})
        argv = [str(cfg_path), "-o", overrides]
        if name == "ref":
            assert run(["train"] + argv) == 0
            assert run(["evaluate"] + argv + ["-m", "best", "--split",
                                              "val"]) == 0
        else:
            jcfg = jax_config.load_config(str(cfg_path), overrides)
            jmodel = jax_config.build_model(jcfg)
            sample = next(jax_config.build_dataset(jcfg, "train").batches(4))
            params = _np(jmodel.init(jax.random.PRNGKey(0), sample))

            def carried(cfg, device, seed):
                model = build_model(cfg, device, torch.float32)
                model.decoder.load_state_dict(
                    params_from_jax(params, model.decoder))
                return model

            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(cli, "training_model", carried)
                assert run(["train"] + argv + ["--platform", "cpu"]) == 0
            assert run(["evaluate"] + argv + ["-m", "best", "--split",
                                              "val", "--platform",
                                              "cpu"]) == 0
        out[name] = root
    return out


def test_preprocess_writes_the_references_shards(commands):
    for split, n in (("train", 3), ("val", 1)):
        got = sorted(str(p) for p in commands["port"].glob(f"{split}-*.nics"))
        want = sorted(str(p) for p in commands["ref"].glob(f"{split}-*.nics"))
        assert len(got) == len(want) == n
        for g, w in zip(got, want):
            _compare_shard(g, w)


def test_train_and_evaluate_from_shards_match(commands):
    ref, port = commands["ref"] / "ser", commands["port"] / "ser"
    want = [json.loads(x) for x in
            (ref / "metrics.jsonl").read_text().splitlines()]
    got = [json.loads(x) for x in
           (port / "metrics.jsonl").read_text().splitlines()]
    assert [r["split"] for r in got] == ["train", "train", "val"] * 2
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k, v in w.items():
            if k == "loss":
                np.testing.assert_allclose(g[k], v, rtol=1e-5)
            elif k != "input_wait":
                assert g[k] == v, k
    assert (port / "generations.jsonl").read_bytes() == \
        (ref / "generations.jsonl").read_bytes()
    assert json.loads((port / "evaluate-metrics.json").read_text()) == \
        pytest.approx(json.loads((ref / "evaluate-metrics.json").read_text()),
                      rel=1e-6)
