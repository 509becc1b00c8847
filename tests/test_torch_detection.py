"""The port's detection modules against the JAX reference's, on the CPU.

`models/image_resize.py` against OpenCV itself (the reference's resizes
are `cv2.resize`), byte for byte: INTER_AREA's whole-factor and
fractional shrinks and its enlargements (the pyramid's 0.709 steps, the
cascade's crops to 24 / 48 / 160 from any box, crops one pixel wide),
INTER_LINEAR down and up (letterbox to 256 and 416, the exact halving
OpenCV sends to its area path), odd sizes, one to four channels.

`nms`, `letterbox`, `scale_coords`, `non_max_suppression` and
`decode_predictions` against the reference's on the same arrays; PNet,
RNet, ONet (odd and even sizes through the ceil-mode pools), the
InceptionResnetV1 embedder at 80 x 80 and YoloV3SPP at 64 x 64 against
JAX's from the same weights through `params_from_jax` (fp32: within
1e-5 times the larger of 1 and the output's largest magnitude).
The weights are drawn with numpy over `jax.eval_shape`'s tree
(`tests/torch_detectors.py`).

`MTCNN.detect` and `extract_faces` on a 48 x 64 photo with min_face 24
(three pyramid scales): the face-class biases of PNet's `conv4_1`,
RNet's `dense5_1` and ONet's `dense6_1` are raised in both packages
(0.35, 1.0, 1.5) so that each stage keeps some of its boxes but not all,
at probabilities below 1 (no ties for `argsort`); boxes, order and
counts match. `ObjectFeatureExtractor` at 64 x 64: boxes, order, counts
and the pooled 1024-wide features. YoloV3SPP has 63,052,381
parameters on the meta device; its darknet bytes round-trip, and the
port's `export_darknet_weights` of carried weights is the reference's
bytes; `port_facenet_pt` gives the reference's tree on a synthetic
facenet-pytorch state dict.
"""


import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from news_image_caption_tpu.models import facenet as jf  # noqa: E402
from news_image_caption_tpu.models import yolov3 as jy  # noqa: E402
from news_image_caption_tpu_torch.models import facenet as pf  # noqa: E402
from news_image_caption_tpu_torch.models import yolov3 as py  # noqa: E402
from news_image_caption_tpu_torch.models.from_jax import \
    params_from_jax  # noqa: E402
from news_image_caption_tpu_torch.models.image_resize import (  # noqa: E402
    resize_area, resize_linear)
from torch_detectors import (MIN_FACE, cascade_variables,  # noqa: E402
                             photo, random_variables)

YOLO_SIZE = 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small nets: one intra-op thread, so that the suite's parallel
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def carried(net, variables):
    net.load_state_dict(params_from_jax(variables, net))
    return net.eval().requires_grad_(False)


def nhwc(t: torch.Tensor) -> np.ndarray:
    a = t.detach().numpy()
    return a.transpose(0, 2, 3, 1) if a.ndim == 4 else a


def close(got, want, rtol_of_max: float = 1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    tol = rtol_of_max * max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


# ---------------------------------------------------------------- (a)

AREA_CASES = [
    ((480, 640, 3), (288, 384)),     # the pyramid's first step (0.6)
    ((480, 640, 3), (204, 272)),     # 0.6 * 0.709: fractional shrink
    ((48, 64, 3), (24, 32)),         # exact halving (min_face 24)
    ((48, 64, 3), (17, 22)),         # the second pyramid scale
    ((90, 60, 3), (30, 20)),         # whole factor 3
    ((96, 64, 3), (24, 32)),         # whole factors 4 and 2
    ((37, 51, 3), (24, 24)),         # an RNet crop, shrunk
    ((13, 9, 3), (24, 24)),          # an RNet crop, enlarged
    ((61, 45, 3), (48, 48)),         # an ONet crop, shrunk
    ((30, 41, 3), (48, 48)),         # an ONet crop, enlarged
    ((31, 47, 3), (160, 160)),       # an embedder crop, enlarged
    ((211, 173, 3), (160, 160)),     # an embedder crop, shrunk
    ((200, 90, 3), (160, 160)),      # shrunk on one axis, enlarged on one
    ((1, 37, 3), (24, 24)),          # a crop one pixel high
    ((29, 1, 3), (160, 160)),        # a crop one pixel wide
    ((1, 1, 3), (48, 48)),
    ((57, 83), (21, 31)),            # one channel, no channel axis
    ((57, 83, 4), (77, 101)),        # four channels
]
LINEAR_CASES = [
    ((480, 640, 3), (192, 256)),     # letterbox down to 256
    ((480, 640, 3), (312, 416)),     # letterbox down to 416
    ((120, 90, 3), (256, 192)),      # letterbox up to 256
    ((45, 60, 3), (312, 416)),       # letterbox up to 416
    ((40, 56, 3), (46, 64)),         # the extractor test's 64
    ((64, 96, 3), (32, 48)),         # exact halving: OpenCV's area path
    ((67, 43, 3), (29, 91)),         # odd sizes, down and up
    ((1, 9, 3), (4, 13)),
    ((33, 1, 3), (77, 5)),
    ((57, 83), (113, 61)),
    ((57, 83, 4), (77, 101)),
]


@pytest.mark.parametrize("src,dst", AREA_CASES)
def test_resize_area_equals_opencv(src, dst):
    img = np.random.default_rng(sum(src) + sum(dst)).integers(
        0, 256, src, dtype=np.uint8)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA)
    np.testing.assert_array_equal(resize_area(img, *dst), want)


@pytest.mark.parametrize("src,dst", LINEAR_CASES)
def test_resize_linear_equals_opencv(src, dst):
    img = np.random.default_rng(sum(src) * 7 + sum(dst)).integers(
        0, 256, src, dtype=np.uint8)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(resize_linear(img, *dst), want)


def test_resize_same_size_copies_and_rejects_floats():
    img = np.random.default_rng(0).integers(0, 256, (5, 7, 3), np.uint8)
    out = resize_area(img, 5, 7)
    np.testing.assert_array_equal(out, img)
    assert out is not img
    with pytest.raises(ValueError, match="uint8"):
        resize_linear(img.astype(np.float32), 3, 3)


# ---------------------------------------------------------------- (b)


def test_nms_matches_reference():
    rng = np.random.default_rng(1)
    xy = rng.uniform(0, 100, (60, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 40, (60, 2))], 1)
    scores = rng.uniform(0, 1, 60)
    scores[10:14] = scores[3]                 # ties keep numpy's order
    for method in ("union", "min"):
        for thr in (0.3, 0.5, 0.7):
            assert pf.nms(boxes, scores, thr, method) == jf.nms(
                boxes, scores, thr, method)
    assert pf.nms(np.zeros((0, 4)), np.zeros(0)) == []


@pytest.mark.parametrize("shape,size", [((480, 640, 3), 256),
                                        ((480, 640, 3), 416),
                                        ((120, 90, 3), 256),
                                        ((45, 60, 3), 416),
                                        ((100, 200, 3), 128)])
def test_letterbox_and_scale_coords_match_reference(shape, size):
    img = np.random.default_rng(size).integers(0, 256, shape, np.uint8)
    got, r, pad = py.letterbox(img, size)
    want, r_ref, pad_ref = jy.letterbox(img, size)
    np.testing.assert_array_equal(got, want)
    assert (r, pad) == (r_ref, pad_ref)
    boxes = np.random.default_rng(2).uniform(-20, size + 20, (7, 4)
                                             ).astype(np.float32)
    for orig in (None, shape[:2]):
        np.testing.assert_array_equal(
            py.scale_coords(boxes, r, pad, orig),
            jy.scale_coords(boxes, r, pad, orig))


def _predictions(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    pred = np.zeros((n, 85), np.float32)
    pred[:, :2] = rng.uniform(0, 300, (n, 2))
    pred[:, 2:4] = rng.uniform(1, 80, (n, 2))
    pred[:, 4] = rng.uniform(0, 1, n)
    pred[:, 5:] = rng.uniform(0, 1, (n, 80)) ** 4
    pred[:5, 2] = 1.5                         # under the 2-pixel floor
    return pred


def test_non_max_suppression_matches_reference():
    for seed, conf in ((0, 0.3), (1, 0.1), (2, 0.5), (3, 0.99)):
        pred = _predictions(400, seed)
        got = py.non_max_suppression(pred, conf)
        want = jy.non_max_suppression(pred, conf)
        np.testing.assert_array_equal(got, want)
    got = py.non_max_suppression(_predictions(300, 4), 0.05, max_det=7)
    np.testing.assert_array_equal(
        got, jy.non_max_suppression(_predictions(300, 4), 0.05, max_det=7))
    assert got.shape == (7, 6)


def test_decode_predictions_matches_reference():
    rng = np.random.default_rng(5)
    heads = [(3 * rng.standard_normal((2, s, s, 255))).astype(np.float32)
             for s in (8, 4, 2)]
    heads[0][0, 0, 0, 2] = 30.0               # past exp's clip
    want = np.asarray(jy.decode_predictions([jnp.asarray(h)
                                             for h in heads]))
    got = py.decode_predictions([torch.from_numpy(h).permute(0, 3, 1, 2)
                                 for h in heads]).numpy()
    assert got.shape == want.shape == (2, (64 + 16 + 4) * 3, 85)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6)


# ---------------------------------------------------------------- (c)


@pytest.fixture(scope="module")
def cascade():
    """The reference's MTCNN on numpy weights with the face biases
    raised, and the port's on the same weights."""
    vars_ = cascade_variables()
    ref = jf.MTCNN(*vars_, min_face=MIN_FACE)
    port = pf.MTCNN(*[params_from_jax(v, net) for v, net in zip(
        vars_, (pf.PNet(device="meta"), pf.RNet(device="meta"),
                pf.ONet(device="meta")))], min_face=MIN_FACE, device="cpu")
    return ref, port


@pytest.mark.parametrize("hw", [(12, 12), (17, 22), (24, 32), (25, 33)])
def test_pnet_matches_jax(cascade, hw):
    ref, port = cascade
    x = np.random.default_rng(hw[0]).uniform(-1, 1, (1, *hw, 3)
                                             ).astype(np.float32)
    want = ref._pnet_j(ref.pvars, jnp.asarray(x))
    with torch.no_grad():
        got = port.pnet(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        close(nhwc(g), w)


@pytest.mark.parametrize("name", ["rnet", "onet"])
def test_rnet_onet_match_jax(cascade, name):
    ref, port = cascade
    size = 24 if name == "rnet" else 48
    x = np.random.default_rng(size).uniform(-1, 1, (3, size, size, 3)
                                            ).astype(np.float32)
    want = getattr(ref, f"_{name}_j")(
        ref.rvars if name == "rnet" else ref.ovars, jnp.asarray(x))
    with torch.no_grad():
        got = getattr(port, name)(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        close(g.numpy(), w)


@pytest.mark.parametrize("n,k,s", [(10, 2, 2), (9, 2, 2), (22, 3, 2),
                                   (21, 3, 2), (8, 2, 2), (7, 3, 2)])
def test_ceil_max_pool_matches_reference(n, k, s):
    x = np.random.default_rng(n).standard_normal((1, n, n + 1, 4)
                                                 ).astype(np.float32)
    want = np.asarray(jf._ceil_max_pool(jnp.asarray(x), k, s))
    got = torch.nn.functional.max_pool2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), k, s, ceil_mode=True)
    np.testing.assert_array_equal(nhwc(got), want)


def test_inception_resnet_matches_jax():
    model = jf.InceptionResnetV1()
    v = random_variables(model, (1, 160, 160, 3), seed=3)
    x = np.random.default_rng(4).uniform(-1, 1, (2, 80, 80, 3)
                                         ).astype(np.float32)
    want = np.asarray(jax.jit(model.apply)(v, x))
    port = carried(pf.InceptionResnetV1(device="meta").to_empty(
        device="cpu"), v)
    got = pf.embed_faces(port, x)
    assert got.shape == (2, 512)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    close(got, want)


@pytest.fixture(scope="module")
def yolo():
    """The reference's ObjectFeatureExtractor at 64 on numpy weights,
    and the port's on the same weights."""
    v = random_variables(jy.YoloV3SPP(), (1, YOLO_SIZE, YOLO_SIZE, 3), 6)
    ref = jy.ObjectFeatureExtractor(variables=v, img_size=YOLO_SIZE)
    port = py.ObjectFeatureExtractor(
        params_from_jax(v, py.YoloV3SPP(device="meta")), YOLO_SIZE,
        device="cpu")
    return v, ref, port


def test_yolo_matches_jax(yolo):
    _, ref, port = yolo
    x = np.random.default_rng(7).uniform(0, 1, (1, YOLO_SIZE, YOLO_SIZE, 3)
                                         ).astype(np.float32)
    heads, neck = ref._fwd(ref.vars, jnp.asarray(x))
    with torch.no_grad():
        got_heads, got_neck = port.model(
            torch.from_numpy(x).permute(0, 3, 1, 2))
    assert [tuple(h.shape) for h in got_heads] == [
        (1, 255, 8, 8), (1, 255, 4, 4), (1, 255, 2, 2)]
    assert tuple(got_neck.shape) == (1, 1024, 2, 2)
    for g, w in zip(got_heads, heads):
        close(nhwc(g), w)
    close(nhwc(got_neck), neck)


# ---------------------------------------------------------------- (d)


def test_mtcnn_detect_and_extract_match_reference(cascade):
    ref, port = cascade
    img = photo()
    seen = {}
    run = port._run

    def counting(net, batch):
        out = run(net, batch)
        probs = out[0][0, 1].ravel() if out[0].ndim == 4 else out[0][:, 1]
        thr = {"PNet": 0.6, "RNet": 0.7, "ONet": 0.7}[type(net).__name__]
        seen.setdefault(type(net).__name__, []).append(
            (int((probs > thr).sum()), probs.size, float(probs.max())))
        return out

    port._run = counting
    try:
        boxes, probs = port.detect(img)
    finally:
        port._run = run
    want_boxes, want_probs = ref.detect(img)
    # Each stage kept some of its boxes but not all, below probability 1.
    for name in ("PNet", "RNet", "ONet"):
        kept = sum(k for k, _, _ in seen[name])
        total = sum(n for _, n, _ in seen[name])
        assert 0 < kept < total, (name, seen[name])
        assert max(p for _, _, p in seen[name]) < 1.0
    assert len(seen["PNet"]) == 3                   # three scales
    assert boxes.shape == want_boxes.shape and len(boxes) >= 2
    np.testing.assert_allclose(boxes, want_boxes, rtol=0, atol=1e-3)
    np.testing.assert_allclose(probs, want_probs, rtol=0, atol=1e-5)
    # Crops of the detected boxes and of boxes past the photo's edges.
    extra = np.array([[-5.0, -3.0, 10.0, 70.0], [60.5, 40.2, 90.0, 99.0],
                      [3.2, 4.9, 3.4, 5.1]])
    for b in (boxes, np.concatenate([boxes, extra]), np.zeros((0, 4))):
        got = port.extract_faces(img, b)
        want = ref.extract_faces(img, b)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_object_feature_extractor_matches_reference(yolo):
    _, ref, port = yolo
    img = np.random.default_rng(8).integers(0, 256, (40, 56, 3), np.uint8)
    boxes, feats = port(img)
    want_boxes, want_feats = ref(img)
    assert 0 < len(boxes) == len(want_boxes)
    assert feats.shape == want_feats.shape == (len(boxes), 1024)
    np.testing.assert_allclose(boxes, want_boxes, rtol=0, atol=1e-3)
    close(feats, want_feats)
    # A threshold no box reaches: nothing found, in both.
    empty, none = port(img, conf_thres=1.0)
    assert empty.shape == (0, 4) and none.shape == (0, 1024)
    assert len(ref(img, conf_thres=1.0)[0]) == 0


# ---------------------------------------------------------------- (e)


def test_yolo_parameter_count_on_meta():
    model = py.YoloV3SPP(device="meta")
    assert sum(p.numel() for p in model.parameters()) == 63_052_381
    assert len(py._conv_order()) == 76


def test_darknet_bytes_round_trip_and_match_reference(yolo):
    v, _, port = yolo
    blob = py.export_darknet_weights(port.model.state_dict())
    assert blob == jy.export_darknet_weights(v)
    assert (len(blob) - 20) // 4 == 63_052_381
    back = py.port_darknet_weights(blob, port.model)
    sd = port.model.state_dict()
    assert set(back) == set(sd)
    for k, t in sd.items():
        assert torch.equal(back[k], t), k
    for bad in (blob[:-40], blob + b"\x00" * 40):
        with pytest.raises(ValueError, match="mismatch"):
            py.port_darknet_weights(bad)
        with pytest.raises(ValueError, match="mismatch"):
            jy.port_darknet_weights(bad, v)


def test_port_facenet_pt_matches_reference():
    shapes = jax.eval_shape(lambda: jf.InceptionResnetV1().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 160, 160, 3))))["params"]
    sd = {}
    counter = [0.0]

    def fresh(shape):
        counter[0] += 1.0
        return np.full(shape, counter[0], np.float32)

    def add_conv(prefix, entry):
        k = entry["conv"]["kernel"].shape
        sd[f"{prefix}.conv.weight"] = fresh((k[3], k[2], k[0], k[1]))
        for t in ("weight", "bias", "running_mean", "running_var"):
            sd[f"{prefix}.bn.{t}"] = fresh(entry["bn"]["scale"].shape)
        sd[f"{prefix}.bn.num_batches_tracked"] = np.zeros((), np.int64)

    for name, entry in shapes.items():
        if name in ("last_linear", "last_bn"):
            continue
        tname = name
        for rep in ("repeat_1", "repeat_2", "repeat_3"):
            if name.startswith(rep + "_"):
                tname = rep + "." + name[len(rep) + 1:]
        if "conv" in entry and "bn" in entry:
            add_conv(tname, entry)
            continue
        for sub, sube in entry.items():
            if sub == "conv2d":
                k = sube["kernel"].shape
                sd[f"{tname}.conv2d.weight"] = fresh((k[3], k[2], k[0], k[1]))
                sd[f"{tname}.conv2d.bias"] = fresh(sube["bias"].shape)
            else:
                tsub = sub.replace("branch0_", "branch0.").replace(
                    "branch1_", "branch1.").replace("branch2_", "branch2.")
                add_conv(f"{tname}.{tsub}", sube)
    ll = shapes["last_linear"]["kernel"].shape
    sd["last_linear.weight"] = fresh((ll[1], ll[0]))
    for t in ("weight", "bias", "running_mean", "running_var"):
        sd[f"last_bn.{t}"] = fresh((512,))
    sd["logits.weight"] = fresh((8631, 512))      # the classifier, unused

    got = pf.port_facenet_pt(sd)
    want = params_from_jax(jax.tree.map(np.asarray, jf.port_facenet_pt(
        {k: v for k, v in sd.items() if not k.endswith("tracked")})),
        pf.InceptionResnetV1(device="meta"))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    model = pf.InceptionResnetV1(device="meta")
    model.load_state_dict(got, assign=True)


def test_params_from_jax_is_strict_on_detectors():
    v = random_variables(jf.RNet(), (1, 24, 24, 3), seed=0)
    net = pf.RNet(device="meta")
    state = params_from_jax(v, net)
    assert tuple(state["dense4.weight"].shape) == (128, 576)
    assert tuple(state["conv1.weight"].shape) == (28, 3, 3, 3)
    np.testing.assert_array_equal(state["conv1.weight"].numpy(),
                                  v["params"]["conv1"]["kernel"].transpose(
                                      3, 2, 0, 1))
    del v["params"]["prelu2"]
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(v, net)
