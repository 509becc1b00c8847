"""Structure of the port: weight mapping at flagship width, imports,
the weight loaders and the kernel build's failure mode.

Nothing here allocates the flagship: the JAX tree comes from
`jax.eval_shape` and the port's decoder is built on the meta device.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from news_image_caption_tpu.models.captioner import \
    TransformerFlattened as JaxTransformerFlattened  # noqa: E402
from news_image_caption_tpu_torch.config import (  # noqa: E402
    FLAGSHIP, FLAGSHIP_ARTICLE_LEN, FLAGSHIP_IMAGE_LEN)
from news_image_caption_tpu_torch.models.decoder_flattened import \
    DynamicConvDecoder  # noqa: E402
from news_image_caption_tpu_torch.models.from_jax import (  # noqa: E402
    load_npz, params_from_jax, torch_key)
from news_image_caption_tpu_torch.ops import _build  # noqa: E402
from news_image_caption_tpu_torch.serving import worker  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(vocab_size=120, cutoff=(40, 80, 120), embed_dim=32, ffn_dim=64,
             num_heads=4, num_layers=2, kernel_sizes=(3, 5), image_dim=48,
             article_dim=32, max_positions=64)


def _batch(B, P, S, image_dim, article_dim, make):
    return {"caption_ids": make((B, 8), jnp.int32),
            "image": make((B, P, image_dim), jnp.float32),
            "image_mask": make((B, P), jnp.bool_),
            "article": make((B, S, article_dim), jnp.float32),
            "article_mask": make((B, S), jnp.bool_)}


def _zero_strided(shape, dtype):
    """A writable array of `shape` that allocates one element."""
    return np.lib.stride_tricks.as_strided(
        np.zeros(1, dtype), shape, (0,) * len(shape), writeable=True)


def test_flagship_params_map_onto_port_at_full_width():
    jmodel = JaxTransformerFlattened(**FLAGSHIP)
    shapes = jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0),
        _batch(1, FLAGSHIP_IMAGE_LEN, FLAGSHIP_ARTICLE_LEN,
               FLAGSHIP["image_dim"], FLAGSHIP["article_dim"],
               jax.ShapeDtypeStruct))
    tree = jax.tree.map(lambda s: _zero_strided(s.shape, np.float32), shapes)
    decoder = DynamicConvDecoder(device="meta", dtype=torch.bfloat16,
                                 **FLAGSHIP)
    sd = params_from_jax(tree, decoder)
    want = {k: tuple(v.shape) for k, v in decoder.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert n_jax == sum(p.numel() for p in decoder.parameters())
    assert len(sd) == len(jax.tree.leaves(shapes))


def test_params_from_jax_is_strict():
    decoder = DynamicConvDecoder(device="meta", dtype=torch.float32, **SMALL)
    jmodel = JaxTransformerFlattened(**SMALL)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            _batch(2, 5, 7, 48, 32, jax.ShapeDtypeStruct))
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    params_from_jax(tree, decoder)
    layer = tree["params"]["layers_0"]

    extra = jax.tree.map(lambda a: a, tree)
    extra["params"]["layers_0"]["mystery"] = {"kernel": np.zeros(3)}
    with pytest.raises(ValueError, match=r"unused \['layers.0.mystery.kernel'\]"):
        params_from_jax(extra, decoder)

    missing = jax.tree.map(lambda a: a, tree)
    del missing["params"]["layers_0"]["fc1"]["scale"]
    with pytest.raises(ValueError, match=r"missing \['layers.0.fc1.scale'\]"):
        params_from_jax(missing, decoder)

    bad = jax.tree.map(lambda a: a, tree)
    bad["params"]["layers_0"]["fc1"]["kernel"] = layer["fc1"]["kernel"].T
    with pytest.raises(ValueError, match="shape mismatch.*layers.0.fc1.kernel"):
        params_from_jax(bad, decoder)


@pytest.mark.parametrize("path,key", [
    ("layers_0/image_attn/k_proj/kernel", "layers.0.image_attn.k_proj.kernel"),
    ("layers_12/conv/weight_linear/kernel",
     "layers.12.conv.weight_linear.kernel"),
    ("adaptive_softmax/tail_proj_1", "adaptive_softmax.tail_proj_1"),
    ("embedder/adaptive/embed_0", "embedder.adaptive.embed_0"),
])
def test_torch_key(path, key):
    assert torch_key(path) == key


def test_load_npz_reads_bf16_stored_as_void(tmp_path):
    import ml_dtypes
    vals = np.array([1.0, -2.5, 3.140625], np.float32)
    path = tmp_path / "params.npz"
    np.savez(path, **{"a/b/kernel": vals.astype(ml_dtypes.bfloat16),
                      "a/bias": vals})
    assert np.load(path)["a/b/kernel"].dtype == np.dtype("V2")
    tree = load_npz(str(path))
    kernel = tree["a"]["b"]["kernel"]
    assert kernel.dtype == torch.bfloat16
    np.testing.assert_array_equal(kernel.float().numpy(), vals)
    assert tree["a"]["bias"].dtype == torch.float32


def test_builder_loads_params_path(tmp_path, monkeypatch):
    """A bf16 .npz in the reference server's layout loads bit-exactly
    into the builder's model."""
    import ml_dtypes
    from flax.traverse_util import flatten_dict
    jmodel = JaxTransformerFlattened(**SMALL)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  _batch(2, 5, 7, 48, 32,
                                         lambda s, d: jnp.zeros(s, d)))
    flat = {"/".join(k): np.asarray(v).astype(ml_dtypes.bfloat16)
            for k, v in flatten_dict(params).items()}
    path = tmp_path / "flagship.npz"
    np.savez(path, **flat)
    monkeypatch.setattr(worker, "FLAGSHIP", SMALL)
    predict = worker.flagship_model_builder("cpu", params_path=str(path))
    sd = predict.model.decoder.state_dict()
    for name, leaf in flat.items():
        key = torch_key(name.removeprefix("params/"))
        want = leaf.view(np.int16)
        got = sd[key].view(torch.int16).numpy()
        np.testing.assert_array_equal(got, want, err_msg=key)


def test_port_imports_no_jax():
    """Every module of the port imports, a small model builds and
    decodes, and the train command takes two steps and writes its
    checkpoint, also on a mesh into the sharded store, on the CPU,
    without jax, orbax, OpenCV, PIL or the reference package loaded (the
    detection modules resize images without them)."""
    code = """
import importlib, json, pkgutil, sys, tempfile
import torch
import news_image_caption_tpu_torch as pkg
names = {m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + ".")}
for name in sorted(names):
    importlib.import_module(name)
new = {"training.checkpoint", "training.preemption", "data.loader",
       "utils.logging", "utils.tensorboard", "cli", "config",
       "serving.base", "serving.client", "serving.http",
       "serving.messages", "serving.transport", "serving.worker",
       "models.facenet", "models.yolov3", "models.image_resize",
       "parallel", "parallel.mesh", "parallel.distributed",
       "parallel.collectives", "parallel.sequence", "parallel.ring",
       "parallel.pipe", "parallel.partition",
       "training.checkpoint_sharded"}
assert {pkg.__name__ + "." + n for n in new} <= names, names
from news_image_caption_tpu_torch.models.captioner import TransformerFlattened
from news_image_caption_tpu_torch.generation.generator import GenerationConfig
model = TransformerFlattened(device="cpu", dtype=torch.float32,
    generator=torch.Generator().manual_seed(0), **%r)
batch = {"image": torch.randn(2, 5, 48), "image_mask": None,
         "article": torch.randn(2, 7, 32), "article_mask": None}
tokens, _ = model.generate(batch, GenerationConfig(max_len=4))
assert tokens.shape == (2, 5), tokens.shape
from news_image_caption_tpu_torch import cli
from news_image_caption_tpu_torch.training.checkpoint_sharded import (
    ShardedCheckpointStore)
with tempfile.TemporaryDirectory() as out:
    over = json.dumps({"trainer": {"num_epochs": 1},
                       "dataset": {"train": {"size": 8}, "val": {"size": 4}}})
    assert cli.main(["train", "configs/tiny_test.yaml", "--platform", "cpu",
                     "-s", out, "-o", over]) == 0
    assert torch.load(out + "/checkpoints/ckpt_2.pt",
                      weights_only=True)["step"] == 2
with tempfile.TemporaryDirectory() as out:
    over = json.dumps({"trainer": {"num_epochs": 1, "mesh": {"data": 1},
                                   "checkpoint_format": "sharded"},
                       "dataset": {"train": {"size": 8}, "val": {"size": 4}}})
    assert cli.main(["train", "configs/tiny_test.yaml", "--platform", "cpu",
                     "-s", out, "-o", over]) == 0
    assert ShardedCheckpointStore(out + "/checkpoints").read(2)["step"] == 2
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "orbax", "zmq",
                                    "cv2", "PIL", "news_image_caption_tpu"))
assert not bad, bad
print("ok")
""" % (SMALL,)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")


GATED = ("regex", "ml_dtypes", "PIL", "h5py", "pymongo", "flax", "jax",
         "jaxlib", "news_image_caption_tpu")


def test_port_imports_no_gated_dependency():
    """The card's machine has none of regex, ml_dtypes, PIL, h5py,
    pymongo or flax: importing every module of the port loads none of
    them (nor jax), and the tokenizer, the readers, the shard reader and
    the offline pass run without them."""
    code = """
import importlib, json, pkgutil, sys, tempfile
import numpy as np
import torch
import news_image_caption_tpu_torch as pkg
names = {m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + ".")}
new = {"data.bpe", "data.vocabulary", "data.indexer", "data.preprocess",
       "data.readers", "data.native_loader", "data.materialize",
       "models.port_tell", "models.port_checkpoint"}
assert {pkg.__name__ + "." + n for n in new} <= names, names
for name in sorted(names):
    importlib.import_module(name)
from news_image_caption_tpu_torch.data import materialize as mat
from news_image_caption_tpu_torch.data.native_loader import NativeShardLoader
from news_image_caption_tpu_torch.models.resnet import ResNetTrunk
from news_image_caption_tpu_torch.models.roberta import RobertaEncoder
with tempfile.TemporaryDirectory() as out:
    with open(out + "/n.jsonl", "w") as f:
        for i in range(3):
            f.write(json.dumps({"caption": f"José's café {i}",
                                "article": f"Zürich 北京 {i}."}) + "\\n")
    kw = dict(device="cpu", dtype=torch.float32)
    enc = mat.FeatureEncoders(resnet=ResNetTrunk(18, 2, **kw),
                              roberta=RobertaEncoder(512, 16, 1, 4, 32, 64,
                                                     **kw), crop=32)
    paths = mat.materialize(out + "/n.jsonl", out + "/s", caption_len=8,
                            article_len=16, encoders=enc, image_size=32)
    (batch,) = NativeShardLoader(paths, 3).epoch(shuffle=False)
    assert batch["image"].shape == (3, 16, 128), batch["image"].shape
bad = sorted(m for m in sys.modules if m.split(".")[0] in %r)
assert not bad, bad
print("ok")
""" % (GATED,)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")


def test_shard_reader_source_lives_outside_csrc():
    """nvcc compiles csrc/*.cu; the shard reader is host code, built by
    g++ from native/."""
    from news_image_caption_tpu_torch.data import native_loader
    src = native_loader.SOURCE
    assert src.exists() and src.suffix == ".cc"
    assert src.parent == REPO / "news_image_caption_tpu_torch" / "native"
    assert not (_build.CSRC / src.name).exists()
    assert src not in _build.sources()
    assert native_loader.BUILD_DIR == _build.BUILD_DIR


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert {p.name for p in _build.sources()} == {
        "common.cuh", "band_topk.cu", "decode_attention.cu",
        "decode_blocks.cu", "decode_ffn.cu", "decode_generic.cu",
        "dynamic_conv.cu", "flash_attention.cu", "flash_generic.cu"}
