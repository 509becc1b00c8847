"""The port's `serving/worker.py::full_model_builder` against the JAX
reference's, on the CPU.

A raw 48 x 64 photo goes through MTCNN (the cascade's weights and face
biases of `tests/torch_detectors.py`, min_face 24, patched into both
packages' `MTCNN`), InceptionResnetV1 embeddings of the faces and
YOLOv3-SPP objects at 64 x 64 (numpy weights over the reference's trees,
carried into the port by `params_from_jax`), then the reference test's
tiny captioner (`tests/test_serving.py`: faces 512 and objects 1024
wide, JAX's PRNGKey(0) init, loaded by the port from `caption_params`).
Tokens must be equal, `n_faces`, `n_objects` and `obj_boxes` the
reference's (boxes within 1e-3 pixel), each `attn_l{i}_{context}` within
1e-5, at fp32. Then with faces and objects off (both packages), each
one off (the port's tokens equal its own `generate` on the batch built
by hand from the detectors' outputs), `warmup()`, and a model whose
objects are 2048 wide, which fails in both packages.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax.errors import ScopeParamShapeError  # noqa: E402

from news_image_caption_tpu.generation.generator import \
    GenerationConfig as JaxGenerationConfig  # noqa: E402
from news_image_caption_tpu.models import facenet as jf  # noqa: E402
from news_image_caption_tpu.models import yolov3 as jy  # noqa: E402
from news_image_caption_tpu.models.captioner import \
    TransformerFlattened as JaxTransformerFlattened  # noqa: E402
from news_image_caption_tpu.serving import worker as jax_worker  # noqa: E402
from news_image_caption_tpu_torch.generation.generator import \
    GenerationConfig  # noqa: E402
from news_image_caption_tpu_torch.models import facenet as pf  # noqa: E402
from news_image_caption_tpu_torch.models import yolov3 as py  # noqa: E402
from news_image_caption_tpu_torch.models.captioner import \
    TransformerFlattened  # noqa: E402
from news_image_caption_tpu_torch.models.from_jax import \
    params_from_jax  # noqa: E402
from news_image_caption_tpu_torch.models.variants import \
    nan_to_mask  # noqa: E402
from news_image_caption_tpu_torch.serving import worker  # noqa: E402
from torch_detectors import (MIN_FACE, cascade_variables,  # noqa: E402
                             photo, random_variables)

TINY = dict(vocab_size=64, cutoff=(16, 32, 64), embed_dim=32, ffn_dim=64,
            num_heads=4, num_layers=2, kernel_sizes=(3, 5), image_dim=16,
            article_dim=24, max_positions=64)
CONTEXTS = (("faces", 512), ("obj", 1024))
P, S, MAXF, MAXO, MAX_LEN, YOLO_SIZE = 4, 6, 4, 16, 6, 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _job():
    rng = np.random.default_rng(0)
    mask = np.zeros((1, S), bool)
    mask[0, -2:] = True
    return {"image_raw": photo(),
            "image": rng.standard_normal((1, P, 16)).astype(np.float32),
            "image_mask": np.zeros((1, P), bool),
            "article": rng.standard_normal((1, S, 24)).astype(np.float32),
            "article_mask": mask}


@pytest.fixture(scope="module")
def parts():
    """The captioner's params, the detectors' variables in both
    packages' forms, and the job."""
    jmodel = JaxTransformerFlattened(**TINY, extra_contexts=CONTEXTS)
    job = _job()
    init_batch = {"caption_ids": np.zeros((1, 8), np.int32),
                  **{k: v for k, v in job.items() if k != "image_raw"},
                  "faces": np.zeros((1, MAXF, 512), np.float32),
                  "faces_mask": np.zeros((1, MAXF), bool),
                  "obj": np.zeros((1, MAXO, 1024), np.float32),
                  "obj_mask": np.zeros((1, MAXO), bool)}
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), init_batch))
    cascade = cascade_variables()
    facenet = random_variables(jf.InceptionResnetV1(), (1, 160, 160, 3), 3)
    yolo = random_variables(jy.YoloV3SPP(), (1, YOLO_SIZE, YOLO_SIZE, 3), 6)
    port = {"cascade": [params_from_jax(v, net(device="meta")) for v, net
                        in zip(cascade, (pf.PNet, pf.RNet, pf.ONet))],
            "facenet": params_from_jax(
                facenet, pf.InceptionResnetV1(device="meta")),
            "yolo": params_from_jax(yolo, py.YoloV3SPP(device="meta"))}
    return dict(jmodel=jmodel, params=params, cascade=cascade,
                facenet=facenet, yolo=yolo, port=port, job=job)


def _reference(parts, monkeypatch, **kw):
    monkeypatch.setattr(jf, "MTCNN", functools.partial(
        jf.MTCNN, *parts["cascade"], min_face=MIN_FACE))
    return jax_worker.full_model_builder(
        caption_model=parts["jmodel"], caption_params=parts["params"],
        gen_config=JaxGenerationConfig(max_len=MAX_LEN),
        yolo_variables=parts["yolo"], facenet_variables=parts["facenet"],
        max_faces=MAXF, max_objects=MAXO, yolo_img_size=YOLO_SIZE, **kw)


def _port(parts, monkeypatch, **kw):
    monkeypatch.setattr(pf, "MTCNN", functools.partial(
        pf.MTCNN, *parts["port"]["cascade"], min_face=MIN_FACE))
    model = TransformerFlattened(device="cpu", dtype=torch.float32,
                                 generator=torch.Generator().manual_seed(1),
                                 **TINY, extra_contexts=CONTEXTS)
    return worker.full_model_builder(
        caption_model=model, caption_params=parts["params"],
        gen_config=GenerationConfig(max_len=MAX_LEN),
        yolo_variables=parts["port"]["yolo"],
        facenet_variables=parts["port"]["facenet"], max_faces=MAXF,
        max_objects=MAXO, yolo_img_size=YOLO_SIZE, device="cpu", **kw)


def _compare(got, want):
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["tokens"], np.asarray(want["tokens"]))
    for key in ("n_faces", "n_objects"):
        if key in want:
            assert int(got[key]) == int(want[key]), key
    if "obj_boxes" in want:
        assert got["obj_boxes"].shape == want["obj_boxes"].shape
        np.testing.assert_allclose(got["obj_boxes"], want["obj_boxes"],
                                   rtol=0, atol=1e-3)
    for key in want:
        if key.startswith("attn_"):
            np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                       rtol=0, atol=1e-5, err_msg=key)


def test_full_model_matches_reference(parts, monkeypatch):
    want = _reference(parts, monkeypatch)(parts["job"])
    predict = _port(parts, monkeypatch)
    got = predict(parts["job"])
    assert int(got["n_faces"]) >= 2 and int(got["n_objects"]) >= 1
    T = got["tokens"].shape[1] - 1
    for li in range(2):
        for name, n in (("image", P), ("article", S), ("faces", MAXF),
                        ("obj", MAXO)):
            attn = got[f"attn_l{li}_{name}"]
            assert attn.shape == (1, T, n + 2)
            np.testing.assert_allclose(attn.sum(-1), 1.0, atol=1e-5)
    _compare(got, want)
    predict.warmup()


def test_full_model_without_detectors_matches_reference(parts, monkeypatch):
    want = _reference(parts, monkeypatch, use_faces=False,
                      use_objects=False)(parts["job"])
    predict = _port(parts, monkeypatch, use_faces=False, use_objects=False)
    got = predict(parts["job"])
    assert "n_faces" not in got and "n_objects" not in got
    _compare(got, want)
    predict.warmup()


@pytest.mark.parametrize("faces,objects", [(True, False), (False, True)])
def test_full_model_one_detector_off(parts, monkeypatch, faces, objects):
    """The caption is the model's own `generate` on the batch built by
    hand from the detectors' outputs (NaN slots masked)."""
    predict = _port(parts, monkeypatch, use_faces=faces, use_objects=objects,
                    return_attns=False)
    job = parts["job"]
    got = predict(job)
    assert ("n_faces" in got) == faces and ("n_objects" in got) == objects
    assert not any(k.startswith("attn_") for k in got)
    feats = {"faces": np.full((MAXF, 512), np.nan, np.float32),
             "obj": np.full((MAXO, 1024), np.nan, np.float32)}
    img = job["image_raw"]
    if faces:
        boxes, _ = predict.mtcnn.detect(img)
        crops = predict.mtcnn.extract_faces(img, boxes[:MAXF])
        feats["faces"][:len(crops)] = pf.embed_faces(predict.embedder, crops)
        assert int(got["n_faces"]) == len(crops) >= 2
    if objects:
        _, obj = predict.objector(img)
        feats["obj"][:len(obj)] = obj[:MAXO]
        assert int(got["n_objects"]) == min(len(obj), MAXO)
    batch = {k: torch.from_numpy(v) for k, v in job.items()
             if k != "image_raw"}
    for name, f in feats.items():
        batch[name], batch[f"{name}_mask"] = nan_to_mask(
            torch.from_numpy(f)[None])
    model = TransformerFlattened(device="cpu", dtype=torch.float32,
                                 **TINY, extra_contexts=CONTEXTS)
    model.decoder.load_state_dict(params_from_jax(parts["params"],
                                                  model.decoder))
    model.decoder.eval()
    want, _ = model.generate(batch, GenerationConfig(max_len=MAX_LEN))
    np.testing.assert_array_equal(got["tokens"], want.numpy())
    predict.warmup()


def test_full_model_detection_only(parts, monkeypatch):
    """Without a captioner the result holds the detections alone."""
    monkeypatch.setattr(pf, "MTCNN", functools.partial(
        pf.MTCNN, *parts["port"]["cascade"], min_face=MIN_FACE))
    predict = worker.full_model_builder(
        yolo_variables=parts["port"]["yolo"],
        facenet_variables=parts["port"]["facenet"], max_faces=MAXF,
        yolo_img_size=YOLO_SIZE, device="cpu")
    got = predict(parts["job"])
    assert set(got) == {"n_faces", "n_objects", "obj_boxes"}
    predict.warmup()


def test_objects_2048_wide_fail_in_both(parts, monkeypatch):
    """The builder feeds the YOLO neck's 1024-wide features; a model
    whose objects are 2048 wide (the configs' `obj_dim`) fails in the
    reference when it decodes and in the port when it is built."""
    wide = (("faces", 512), ("obj", 2048))
    jmodel = JaxTransformerFlattened(**TINY, extra_contexts=wide)
    batch = {"caption_ids": np.zeros((1, 8), np.int32),
             **{k: v for k, v in parts["job"].items() if k != "image_raw"},
             "faces": np.zeros((1, MAXF, 512), np.float32),
             "faces_mask": np.zeros((1, MAXF), bool),
             "obj": np.zeros((1, MAXO, 2048), np.float32),
             "obj_mask": np.zeros((1, MAXO), bool)}
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                batch))
    params = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    predict = jax_worker.full_model_builder(
        caption_model=jmodel, caption_params=params, use_faces=False,
        use_objects=False, gen_config=JaxGenerationConfig(max_len=MAX_LEN))
    with pytest.raises(ScopeParamShapeError, match="obj_attn"):
        predict(parts["job"])
    model = TransformerFlattened(device="meta", dtype=torch.float32, **TINY,
                                 extra_contexts=wide)
    with pytest.raises(ValueError, match="1024-wide obj"):
        worker.full_model_builder(caption_model=model, use_faces=False,
                                  use_objects=False, device="cpu")
