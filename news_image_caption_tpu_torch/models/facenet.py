"""FaceNet: the MTCNN face detector and the InceptionResnetV1 embedder.

Counterpart of `news_image_caption_tpu/models/facenet.py`: `ConvBN`,
`Block35` / `Block17` / `Block8`, `Mixed6a` / `Mixed7a`,
`InceptionResnetV1` (512-d L2-normalised embeddings of 160 x 160 crops
in [-1, 1]), the cascade nets `PNet` / `RNet` / `ONet`, `nms`, `MTCNN`
(`detect`, `extract_faces`) and `port_facenet_pt`.

The nets are NCHW PyTorch modules (convolutions in cuDNN on the card,
as the reference's are XLA's; no kernel of the port touches them),
weights OIHW, Dense weights [out, in], parameter names those of the
flax tree (`repeat_1_0.branch1_1.conv.weight`, `prelu1`), so
`models/from_jax.py::params_from_jax` carries the reference's variables
across. RNet and ONet flatten their last map in the reference's order
(H, W, C), so their dense kernels mean what they mean there. The
pyramid, the box regression, the crops and NMS stay host-side numpy, as
in the reference; the resizes are OpenCV's INTER_AREA, byte for byte
(`models/image_resize.py`).

Precision: the detectors run in float32 on the card with TF32 off for
their convolutions and products (`fp32_exact`), so the cascade's
thresholds and NMS see what the float32 CPU path sees; the flags are
restored when a detector returns, and nothing else of the port is
affected.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from news_image_caption_tpu_torch.models.image_resize import resize_area
from news_image_caption_tpu_torch.models.resnet import Conv, FrozenBatchNorm
from news_image_caption_tpu_torch.models.roberta import Dense
from news_image_caption_tpu_torch.ops.linear import initializes, new_param


@contextlib.contextmanager
def fp32_exact():
    """TF32 off for cuDNN convolutions and cuBLAS products inside the
    block; the previous settings come back on exit."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(
                enabled=torch.backends.cudnn.enabled,
                benchmark=torch.backends.cudnn.benchmark,
                deterministic=torch.backends.cudnn.deterministic,
                allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul


class ConvBN(nn.Module):
    """Bias-free conv, FrozenBatchNorm (eps 1e-3), ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel, stride: int = 1,
                 padding=0, **kw):
        super().__init__()
        self.conv = Conv(in_ch, out_ch, kernel, stride, padding, **kw)
        self.bn = FrozenBatchNorm(out_ch, eps=1e-3, device=kw["device"],
                                  dtype=kw["dtype"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


# ----------------------------------------------------------------------
# InceptionResnetV1 (512-d embeddings)
# ----------------------------------------------------------------------


class Block35(nn.Module):
    def __init__(self, scale: float = 0.17, **kw):
        super().__init__()
        self.scale = scale
        self.branch0 = ConvBN(256, 32, 1, **kw)
        self.branch1_0 = ConvBN(256, 32, 1, **kw)
        self.branch1_1 = ConvBN(32, 32, 3, padding=1, **kw)
        self.branch2_0 = ConvBN(256, 32, 1, **kw)
        self.branch2_1 = ConvBN(32, 32, 3, padding=1, **kw)
        self.branch2_2 = ConvBN(32, 32, 3, padding=1, **kw)
        self.conv2d = Conv(96, 256, 1, bias=True, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b0 = self.branch0(x)
        b1 = self.branch1_1(self.branch1_0(x))
        b2 = self.branch2_2(self.branch2_1(self.branch2_0(x)))
        up = self.conv2d(torch.cat([b0, b1, b2], 1))
        return F.relu(x + self.scale * up)


class Block17(nn.Module):
    def __init__(self, scale: float = 0.10, **kw):
        super().__init__()
        self.scale = scale
        self.branch0 = ConvBN(896, 128, 1, **kw)
        self.branch1_0 = ConvBN(896, 128, 1, **kw)
        self.branch1_1 = ConvBN(128, 128, (1, 7), padding=(0, 3), **kw)
        self.branch1_2 = ConvBN(128, 128, (7, 1), padding=(3, 0), **kw)
        self.conv2d = Conv(256, 896, 1, bias=True, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b0 = self.branch0(x)
        b1 = self.branch1_2(self.branch1_1(self.branch1_0(x)))
        up = self.conv2d(torch.cat([b0, b1], 1))
        return F.relu(x + self.scale * up)


class Block8(nn.Module):
    def __init__(self, scale: float = 0.20, no_relu: bool = False, **kw):
        super().__init__()
        self.scale, self.no_relu = scale, no_relu
        self.branch0 = ConvBN(1792, 192, 1, **kw)
        self.branch1_0 = ConvBN(1792, 192, 1, **kw)
        self.branch1_1 = ConvBN(192, 192, (1, 3), padding=(0, 1), **kw)
        self.branch1_2 = ConvBN(192, 192, (3, 1), padding=(1, 0), **kw)
        self.conv2d = Conv(384, 1792, 1, bias=True, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b0 = self.branch0(x)
        b1 = self.branch1_2(self.branch1_1(self.branch1_0(x)))
        x = x + self.scale * self.conv2d(torch.cat([b0, b1], 1))
        return x if self.no_relu else F.relu(x)


class Mixed6a(nn.Module):
    def __init__(self, **kw):
        super().__init__()
        self.branch0 = ConvBN(256, 384, 3, stride=2, **kw)
        self.branch1_0 = ConvBN(256, 192, 1, **kw)
        self.branch1_1 = ConvBN(192, 192, 3, padding=1, **kw)
        self.branch1_2 = ConvBN(192, 256, 3, stride=2, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b0 = self.branch0(x)
        b1 = self.branch1_2(self.branch1_1(self.branch1_0(x)))
        return torch.cat([b0, b1, F.max_pool2d(x, 3, 2)], 1)


class Mixed7a(nn.Module):
    def __init__(self, **kw):
        super().__init__()
        self.branch0_0 = ConvBN(896, 256, 1, **kw)
        self.branch0_1 = ConvBN(256, 384, 3, stride=2, **kw)
        self.branch1_0 = ConvBN(896, 256, 1, **kw)
        self.branch1_1 = ConvBN(256, 256, 3, stride=2, **kw)
        self.branch2_0 = ConvBN(896, 256, 1, **kw)
        self.branch2_1 = ConvBN(256, 256, 3, padding=1, **kw)
        self.branch2_2 = ConvBN(256, 256, 3, stride=2, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b0 = self.branch0_1(self.branch0_0(x))
        b1 = self.branch1_1(self.branch1_0(x))
        b2 = self.branch2_2(self.branch2_1(self.branch2_0(x)))
        return torch.cat([b0, b1, b2, F.max_pool2d(x, 3, 2)], 1)


class InceptionResnetV1(nn.Module):
    """512-d L2-normalised face embeddings (the vggface2 head):
    x [B, 3, 160, 160] float in [-1, 1] -> [B, 512]."""

    torch_layout = True     # params_from_jax: kernels OIHW / [out, in]

    def __init__(self, *, device="cuda", dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.conv2d_1a = ConvBN(3, 32, 3, stride=2, **kw)
        self.conv2d_2a = ConvBN(32, 32, 3, **kw)
        self.conv2d_2b = ConvBN(32, 64, 3, padding=1, **kw)
        self.conv2d_3b = ConvBN(64, 80, 1, **kw)
        self.conv2d_4a = ConvBN(80, 192, 3, **kw)
        self.conv2d_4b = ConvBN(192, 256, 3, stride=2, **kw)
        self.repeats = [f"repeat_1_{i}" for i in range(5)] + ["mixed_6a"] \
            + [f"repeat_2_{i}" for i in range(10)] + ["mixed_7a"] \
            + [f"repeat_3_{i}" for i in range(5)] + ["block8"]
        for name in self.repeats:
            if name.startswith("repeat_1"):
                block = Block35(**kw)
            elif name.startswith("repeat_2"):
                block = Block17(**kw)
            elif name.startswith("repeat_3"):
                block = Block8(**kw)
            elif name == "mixed_6a":
                block = Mixed6a(**kw)
            elif name == "mixed_7a":
                block = Mixed7a(**kw)
            else:
                block = Block8(no_relu=True, **kw)
            self.add_module(name, block)
        self.last_linear = Dense(1792, 512, bias=False, **kw)
        self.last_bn = FrozenBatchNorm(512, eps=1e-3, device=device,
                                       dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv2d_2b(self.conv2d_2a(self.conv2d_1a(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.conv2d_4b(self.conv2d_4a(self.conv2d_3b(x)))
        for name in self.repeats:
            x = getattr(self, name)(x)
        x = self.last_linear(x.mean(dim=(2, 3)))
        x = self.last_bn(x[:, :, None, None])[:, :, 0, 0]
        norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        return x / torch.clamp(norm, min=1e-12)


# ----------------------------------------------------------------------
# MTCNN cascade
# ----------------------------------------------------------------------


def _prelu(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    a = a[:, None, None] if x.ndim == 4 else a
    return torch.where(x >= 0, x, a * x)


def _slopes(module: nn.Module, widths, device, dtype) -> None:
    """The PReLU slopes as parameters named as flax's (`prelu1`, ...),
    one a channel, 0.25."""
    for i, c in enumerate(widths, 1):
        p = new_param((c,), device, dtype)
        if initializes(device):
            with torch.no_grad():
                p.fill_(0.25)
        setattr(module, f"prelu{i}", p)


def _flatten_hwc(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] flattened in the reference's (H, W, C) order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class PNet(nn.Module):
    """x [B, 3, H, W] -> (face probabilities [B, 2, H', W'], box
    regression [B, 4, H', W']); every conv VALID, so a 12 x 12 window
    gives one cell."""

    torch_layout = True

    def __init__(self, *, device="cuda", dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.conv1 = Conv(3, 10, 3, bias=True, **kw)
        self.conv2 = Conv(10, 16, 3, bias=True, **kw)
        self.conv3 = Conv(16, 32, 3, bias=True, **kw)
        self.conv4_1 = Conv(32, 2, 1, bias=True, **kw)
        self.conv4_2 = Conv(32, 4, 1, bias=True, **kw)
        _slopes(self, (10, 16, 32), device, dtype)

    def forward(self, x: torch.Tensor):
        x = _prelu(self.conv1(x), self.prelu1)
        x = F.max_pool2d(x, 2, 2, ceil_mode=True)
        x = _prelu(self.conv2(x), self.prelu2)
        x = _prelu(self.conv3(x), self.prelu3)
        return torch.softmax(self.conv4_1(x), dim=1), self.conv4_2(x)


class RNet(nn.Module):
    """x [B, 3, 24, 24] -> (probabilities [B, 2], regression [B, 4])."""

    torch_layout = True

    def __init__(self, *, device="cuda", dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.conv1 = Conv(3, 28, 3, bias=True, **kw)
        self.conv2 = Conv(28, 48, 3, bias=True, **kw)
        self.conv3 = Conv(48, 64, 2, bias=True, **kw)
        self.dense4 = Dense(576, 128, **kw)
        self.dense5_1 = Dense(128, 2, **kw)
        self.dense5_2 = Dense(128, 4, **kw)
        _slopes(self, (28, 48, 64, 128), device, dtype)

    def forward(self, x: torch.Tensor):
        x = _prelu(self.conv1(x), self.prelu1)
        x = F.max_pool2d(x, 3, 2, ceil_mode=True)
        x = _prelu(self.conv2(x), self.prelu2)
        x = F.max_pool2d(x, 3, 2, ceil_mode=True)
        x = _prelu(self.conv3(x), self.prelu3)
        x = _prelu(self.dense4(_flatten_hwc(x)), self.prelu4)
        return torch.softmax(self.dense5_1(x), dim=-1), self.dense5_2(x)


class ONet(nn.Module):
    """x [B, 3, 48, 48] -> (probabilities [B, 2], regression [B, 4],
    landmarks [B, 10])."""

    torch_layout = True

    def __init__(self, *, device="cuda", dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.conv1 = Conv(3, 32, 3, bias=True, **kw)
        self.conv2 = Conv(32, 64, 3, bias=True, **kw)
        self.conv3 = Conv(64, 64, 3, bias=True, **kw)
        self.conv4 = Conv(64, 128, 2, bias=True, **kw)
        self.dense5 = Dense(1152, 256, **kw)
        self.dense6_1 = Dense(256, 2, **kw)
        self.dense6_2 = Dense(256, 4, **kw)
        self.dense6_3 = Dense(256, 10, **kw)
        _slopes(self, (32, 64, 64, 128, 256), device, dtype)

    def forward(self, x: torch.Tensor):
        x = _prelu(self.conv1(x), self.prelu1)
        x = F.max_pool2d(x, 3, 2, ceil_mode=True)
        x = _prelu(self.conv2(x), self.prelu2)
        x = F.max_pool2d(x, 3, 2, ceil_mode=True)
        x = _prelu(self.conv3(x), self.prelu3)
        x = F.max_pool2d(x, 2, 2, ceil_mode=True)
        x = _prelu(self.conv4(x), self.prelu4)
        x = _prelu(self.dense5(_flatten_hwc(x)), self.prelu5)
        return (torch.softmax(self.dense6_1(x), dim=-1), self.dense6_2(x),
                self.dense6_3(x))


def nms(boxes: np.ndarray, scores: np.ndarray,
        threshold: float = 0.5, method: str = "union") -> List[int]:
    """Greedy NMS over xyxy boxes, highest score first (numpy's argsort,
    reversed, as the reference's); "min" divides by the smaller area."""
    if len(boxes) == 0:
        return []
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    area = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    order = scores.argsort()[::-1]
    keep = []
    while len(order):
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = (np.maximum(xx2 - xx1, 0)
                 * np.maximum(yy2 - yy1, 0))
        # Empty boxes give 0 / 0: NaN, never <= threshold, so suppressed
        # (the reference's numpy warns; the result is the same).
        with np.errstate(divide="ignore", invalid="ignore"):
            if method == "min":
                o = inter / np.minimum(area[i], area[order[1:]])
            else:
                o = inter / (area[i] + area[order[1:]] - inter)
        order = order[1:][o <= threshold]
    return keep


def build_net(cls, state: Optional[Mapping[str, Any]] = None, *, device,
              dtype=torch.float32,
              generator: Optional[torch.Generator] = None) -> nn.Module:
    """A frozen net in eval mode: `state` (a state dict, loaded
    strictly) on `device`, or random weights drawn from `generator`."""
    if state is None:
        net = cls(device=device, dtype=dtype, generator=generator)
    else:
        net = cls(device="meta", dtype=dtype)
        net.load_state_dict(state, assign=True)
        net.to(device=device, dtype=dtype)
    return net.eval().requires_grad_(False)


def to_nchw(x: np.ndarray, device, dtype) -> torch.Tensor:
    """Host NHWC float32 -> NCHW on the device."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(
        device=device, dtype=dtype).permute(0, 3, 1, 2)


def to_host(t: torch.Tensor) -> np.ndarray:
    """A device tensor as float32 numpy on the host."""
    return t.float().cpu().numpy()


class MTCNN:
    """The three-stage cascade: the nets on the device, the pyramid,
    crops, box regression and NMS on the host. ONet's landmarks are
    computed but not used (`extract_faces` crops axis-aligned, as the
    reference does). detect(image uint8 HWC) -> (boxes [N, 4],
    probabilities [N]).

    pnet / rnet / onet: the port's state dicts of the nets (the
    reference's `pnet_vars` / `rnet_vars` / `onet_vars` through
    `params_from_jax`); random weights from `generator` otherwise.
    `timings`, when a dict, gains each stage's host-clock seconds of
    the last `detect` (pyramid, refine, output)."""

    def __init__(self, pnet=None, rnet=None, onet=None,
                 thresholds=(0.6, 0.7, 0.7), min_face: int = 20,
                 factor: float = 0.709, *, device="cuda",
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.device, self.dtype = torch.device(device), dtype
        self.pnet = build_net(PNet, pnet, **kw)
        self.rnet = build_net(RNet, rnet, **kw)
        self.onet = build_net(ONet, onet, **kw)
        self.thresholds = thresholds
        self.min_face = min_face
        self.factor = factor
        self.timings: Optional[Dict[str, float]] = None

    @staticmethod
    def _norm(img: np.ndarray) -> np.ndarray:
        return (img.astype(np.float32) - 127.5) / 128.0

    @staticmethod
    def _resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
        return resize_area(img, h, w)

    @torch.inference_mode()
    def _run(self, net: nn.Module, batch: np.ndarray):
        with fp32_exact():
            return [to_host(t) for t in net(
                to_nchw(batch, self.device, self.dtype))]

    def _stamp(self, name: str, since: float) -> float:
        now = time.perf_counter()
        if self.timings is not None:
            self.timings[name] = now - since
        return now

    def detect(self, image: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        if self.timings is not None:
            self.timings.clear()
        t = time.perf_counter()
        H, W = image.shape[:2]
        scale0 = 12.0 / self.min_face
        scales = []
        m = min(H, W) * scale0
        s = scale0
        while m >= 12:
            scales.append(s)
            s *= self.factor
            m *= self.factor
        boxes_all = []
        for s in scales:
            h, w = int(H * s), int(W * s)
            if h < 12 or w < 12:
                continue
            inp = self._norm(self._resize(image, h, w))[None]
            probs, reg = self._run(self.pnet, inp)
            probs = probs[0, 1]                     # [H', W'] face class
            reg = reg[0].transpose(1, 2, 0)         # [H', W', 4]
            ys, xs = np.where(probs > self.thresholds[0])
            if len(ys) == 0:
                continue
            stride, cell = 2, 12
            bb = np.stack([
                (xs * stride) / s, (ys * stride) / s,
                (xs * stride + cell) / s, (ys * stride + cell) / s,
            ], axis=1)
            r = reg[ys, xs]
            wbox = bb[:, 2] - bb[:, 0]
            hbox = bb[:, 3] - bb[:, 1]
            bb = bb + np.stack([r[:, 0] * wbox, r[:, 1] * hbox,
                                r[:, 2] * wbox, r[:, 3] * hbox], 1)
            scores = probs[ys, xs]
            keep = nms(bb, scores, 0.5)
            boxes_all.append(
                np.concatenate([bb[keep], scores[keep, None]], 1))
        t = self._stamp("pyramid", t)
        if not boxes_all:
            return np.zeros((0, 4)), np.zeros((0,))
        boxes = np.concatenate(boxes_all)
        keep = nms(boxes[:, :4], boxes[:, 4], 0.7)
        boxes = boxes[keep]

        for stage, (net, size, thr) in enumerate([
                (self.rnet, 24, self.thresholds[1]),
                (self.onet, 48, self.thresholds[2])]):
            crops = []
            for b in boxes:
                x1, y1, x2, y2 = [int(max(v, 0)) for v in b[:4]]
                # Clamp the top-left corner too: a box regressed past the
                # right or bottom edge would otherwise crop nothing.
                x1, y1 = min(x1, W - 1), min(y1, H - 1)
                x2 = min(max(x2, x1 + 1), W)
                y2 = min(max(y2, y1 + 1), H)
                crops.append(self._norm(
                    self._resize(image[y1:y2, x1:x2], size, size)))
            if not crops:
                return np.zeros((0, 4)), np.zeros((0,))
            out = self._run(net, np.stack(crops))
            probs = out[0][:, 1]
            reg = out[1]
            mask = probs > thr
            boxes = boxes[mask]
            if boxes.shape[0] == 0:
                self._stamp(("refine", "output")[stage], t)
                return np.zeros((0, 4)), np.zeros((0,))
            reg = reg[mask]
            wb = boxes[:, 2] - boxes[:, 0]
            hb = boxes[:, 3] - boxes[:, 1]
            boxes[:, 0] += reg[:, 0] * wb
            boxes[:, 1] += reg[:, 1] * hb
            boxes[:, 2] += reg[:, 2] * wb
            boxes[:, 3] += reg[:, 3] * hb
            boxes[:, 4] = probs[mask]
            keep = nms(boxes[:, :4], boxes[:, 4], 0.7,
                       "min" if stage == 1 else "union")
            boxes = boxes[keep]
            t = self._stamp(("refine", "output")[stage], t)
        return boxes[:, :4], boxes[:, 4]

    def extract_faces(self, image: np.ndarray, boxes: np.ndarray,
                      size: int = 160) -> np.ndarray:
        """Crop and resize faces for the embedder: [N, size, size, 3]
        float32 in [-1, 1], NHWC on the host."""
        H, W = image.shape[:2]
        out = []
        for b in boxes:
            x1, y1, x2, y2 = [int(v) for v in b]
            x1 = min(max(x1, 0), W - 1)
            y1 = min(max(y1, 0), H - 1)
            x2 = min(max(x2, x1 + 1), W)
            y2 = min(max(y2, y1 + 1), H)
            out.append(self._norm(
                self._resize(image[y1:y2, x1:x2], size, size)))
        if not out:
            return np.zeros((0, size, size, 3), np.float32)
        return np.stack(out)


def embed_faces(embedder: InceptionResnetV1,
                crops: np.ndarray) -> np.ndarray:
    """Host NHWC crops [N, 160, 160, 3] -> [N, 512] float32 embeddings,
    the embedder run on its device in float32 without TF32."""
    p = next(embedder.parameters())
    with torch.inference_mode(), fp32_exact():
        return to_host(embedder(to_nchw(crops, p.device, p.dtype)))


def port_facenet_pt(state_dict: Mapping[str, Any]
                    ) -> Dict[str, torch.Tensor]:
    """A facenet-pytorch InceptionResnetV1 state dict -> the port's
    `InceptionResnetV1` state dict (PyTorch's layout in both): the
    blocks' `repeat_1.{i}` -> `repeat_1_{i}`, a branch's `branch1.0` ->
    `branch1_0`, BatchNorm's weight / bias / running_mean / running_var
    -> scale / bias / mean / var; keys the embedder does not have
    (`logits`, `num_batches_tracked`) are left out."""
    sd = {k: torch.as_tensor(np.asarray(v)) for k, v in state_dict.items()}
    out: Dict[str, torch.Tensor] = {}

    def conv(src: str, dst: str) -> None:
        out[f"{dst}.conv.weight"] = sd[f"{src}.conv.weight"]
        bn(f"{src}.bn", f"{dst}.bn")

    def bn(src: str, dst: str) -> None:
        for leaf, tv in (("scale", "weight"), ("bias", "bias"),
                         ("mean", "running_mean"), ("var", "running_var")):
            out[f"{dst}.{leaf}"] = sd[f"{src}.{tv}"]

    for name in ("conv2d_1a", "conv2d_2a", "conv2d_2b", "conv2d_3b",
                 "conv2d_4a", "conv2d_4b"):
        conv(name, name)

    def block(src: str, dst: str, branches) -> None:
        for b in branches:
            conv(f"{src}.{b}", f"{dst}.{b.replace('.', '_')}")
        out[f"{dst}.conv2d.weight"] = sd[f"{src}.conv2d.weight"]
        out[f"{dst}.conv2d.bias"] = sd[f"{src}.conv2d.bias"]

    b35 = ("branch0", "branch1.0", "branch1.1", "branch2.0", "branch2.1",
           "branch2.2")
    b17 = ("branch0", "branch1.0", "branch1.1", "branch1.2")
    for i in range(5):
        block(f"repeat_1.{i}", f"repeat_1_{i}", b35)
    for i in range(10):
        block(f"repeat_2.{i}", f"repeat_2_{i}", b17)
    for i in range(5):
        block(f"repeat_3.{i}", f"repeat_3_{i}", b17)
    block("block8", "block8", b17)
    for b in ("branch0", "branch1.0", "branch1.1", "branch1.2"):
        conv(f"mixed_6a.{b}", f"mixed_6a.{b.replace('.', '_')}")
    for b in ("branch0.0", "branch0.1", "branch1.0", "branch1.1",
              "branch2.0", "branch2.1", "branch2.2"):
        conv(f"mixed_7a.{b}", f"mixed_7a.{b.replace('.', '_')}")
    out["last_linear.weight"] = sd["last_linear.weight"]
    bn("last_bn", "last_bn")
    return out
