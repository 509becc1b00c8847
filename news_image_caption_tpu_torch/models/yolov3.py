"""YOLOv3-SPP: the object detector and its host-side utilities.

Counterpart of `news_image_caption_tpu/models/yolov3.py`: `ANCHORS`,
`STRIDES`, `ConvBNLeaky`, `Residual`, `Darknet53`, `SPP`, `YoloV3SPP`,
`decode_predictions`, `letterbox`, `scale_coords`,
`non_max_suppression`, the darknet `.weights` reader and writer
(`port_darknet_weights`, `export_darknet_weights`) and
`ObjectFeatureExtractor`.

The network is NCHW PyTorch (cuDNN convolutions on the card, run in
float32 without TF32, see `models/facenet.py::fp32_exact`), weights
OIHW, parameter names those of the flax tree
(`backbone.res3_0.conv1.conv.weight`, `det5.bias`). It returns the
three heads [B, 255, S/8, S/8], [B, 255, S/16, S/16], [B, 255, S/32,
S/32] and the SPP neck [B, 1024, S/32, S/32] that the object features
pool. The letterbox resize is OpenCV's INTER_LINEAR, byte for byte
(`models/image_resize.py`); NMS and the pooling stay on the host, as in
the reference.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from news_image_caption_tpu_torch.models.facenet import (build_net,
                                                         fp32_exact, nms,
                                                         to_host, to_nchw)
from news_image_caption_tpu_torch.models.image_resize import resize_linear
from news_image_caption_tpu_torch.models.resnet import Conv, FrozenBatchNorm

# yolov3-spp anchors (cfg order): 3 per scale, small -> large stride.
ANCHORS = (
    ((10, 13), (16, 30), (33, 23)),        # stride 8
    ((30, 61), (62, 45), (59, 119)),       # stride 16
    ((116, 90), (156, 198), (373, 326)),   # stride 32
)
STRIDES = (8, 16, 32)
NUM_CLASSES = 80


class ConvBNLeaky(nn.Module):
    """Bias-free conv (padding kernel // 2), FrozenBatchNorm (eps 1e-5),
    leaky ReLU 0.1."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, **kw):
        super().__init__()
        self.conv = Conv(in_ch, out_ch, kernel, stride, kernel // 2, **kw)
        self.bn = FrozenBatchNorm(out_ch, eps=1e-5, device=kw["device"],
                                  dtype=kw["dtype"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(self.bn(self.conv(x)), 0.1)


class Residual(nn.Module):
    def __init__(self, features: int, **kw):
        super().__init__()
        self.conv1 = ConvBNLeaky(features, features // 2, 1, **kw)
        self.conv2 = ConvBNLeaky(features // 2, features, 3, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(self.conv1(x))


class Darknet53(nn.Module):
    """Backbone returning the three feature maps (256, 512, 1024 ch)."""

    def __init__(self, **kw):
        super().__init__()
        self.stem = ConvBNLeaky(3, 32, 3, **kw)
        self.stages = []
        width = 32
        for stage, n in enumerate((1, 2, 8, 8, 4), 1):
            self.add_module(f"down{stage}",
                            ConvBNLeaky(width, 2 * width, 3, 2, **kw))
            width *= 2
            names = [f"res{stage}_{i}" for i in range(n)]
            for name in names:
                self.add_module(name, Residual(width, **kw))
            self.stages.append([f"down{stage}"] + names)

    def forward(self, x: torch.Tensor):
        x = self.stem(x)
        maps = []
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            maps.append(x)
        return maps[2], maps[3], maps[4]


def spp(x: torch.Tensor) -> torch.Tensor:
    """Spatial pyramid pooling: x and its max pools 5, 9, 13 (stride 1,
    padded with -inf), concatenated on channels."""
    return torch.cat([x] + [F.max_pool2d(x, k, 1, k // 2)
                            for k in (5, 9, 13)], 1)


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


class YoloV3SPP(nn.Module):
    """Backbone, SPP neck and three heads: x [B, 3, S, S] (S % 32 == 0)
    -> ((p3, p4, p5) raw heads, neck [B, 1024, S/32, S/32])."""

    torch_layout = True     # params_from_jax: kernels OIHW

    def __init__(self, num_classes: int = NUM_CLASSES, *, device="cuda",
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        no = 3 * (5 + num_classes)
        self.num_classes = num_classes
        self.backbone = Darknet53(**kw)
        for i, (cin, cout, k) in enumerate((
                (1024, 512, 1), (512, 1024, 3), (1024, 512, 1),
                (2048, 512, 1), (512, 1024, 3), (1024, 512, 1),
                (512, 1024, 3))):
            self.add_module(f"h5_{i}", ConvBNLeaky(cin, cout, k, **kw))
        self.det5 = Conv(1024, no, 1, bias=True, **kw)
        self.up4_conv = ConvBNLeaky(512, 256, 1, **kw)
        self.up3_conv = ConvBNLeaky(256, 128, 1, **kw)
        for head, width, cin in (("h4", 256, 768), ("h3", 128, 384)):
            for i in range(6):
                narrow = i % 2 == 0
                self.add_module(f"{head}_{i}", ConvBNLeaky(
                    cin if i == 0 else (2 * width if narrow else width),
                    width if narrow else 2 * width, 1 if narrow else 3,
                    **kw))
        self.det4 = Conv(512, no, 1, bias=True, **kw)
        self.det3 = Conv(256, no, 1, bias=True, **kw)

    def _chain(self, prefix: str, ids, x: torch.Tensor) -> torch.Tensor:
        for i in ids:
            x = getattr(self, f"{prefix}_{i}")(x)
        return x

    def forward(self, x: torch.Tensor):
        c3, c4, c5 = self.backbone(x)
        y = spp(self._chain("h5", range(3), c5))
        neck = self._chain("h5", (3, 4), y)
        y = self.h5_5(neck)
        p5 = self.det5(self.h5_6(y))
        z = torch.cat([_upsample2(self.up4_conv(y)), c4], 1)
        z = self._chain("h4", range(5), z)
        p4 = self.det4(self.h4_5(z))
        w = torch.cat([_upsample2(self.up3_conv(z)), c3], 1)
        w = self._chain("h3", range(5), w)
        p3 = self.det3(self.h3_5(w))
        return (p3, p4, p5), neck


def decode_predictions(heads: Sequence[torch.Tensor],
                       num_classes: int = NUM_CLASSES) -> torch.Tensor:
    """Raw NCHW heads -> [B, N, 5 + C]: xywh in pixels, objectness,
    class probabilities; N runs over (row, column, anchor) of each head
    in turn, as the reference's NHWC order."""
    outs = []
    for head, anchors, stride in zip(heads, ANCHORS, STRIDES):
        B, _, H, W = head.shape
        na = len(anchors)
        p = head.reshape(B, na, 5 + num_classes, H, W).permute(0, 3, 4, 1, 2)
        gy = torch.arange(H, device=head.device)[None, :, None, None]
        gx = torch.arange(W, device=head.device)[None, None, :, None]
        xy = torch.sigmoid(p[..., :2])
        x = (xy[..., 0] + gx) * stride
        y = (xy[..., 1] + gy) * stride
        anc = torch.tensor(anchors, dtype=torch.float32, device=head.device)
        wh = torch.exp(torch.clamp(p[..., 2:4], -10, 10)) * anc
        obj = torch.sigmoid(p[..., 4])
        cls = torch.sigmoid(p[..., 5:])
        out = torch.cat([x[..., None], y[..., None], wh, obj[..., None],
                         cls], dim=-1)
        outs.append(out.reshape(B, H * W * na, 5 + num_classes))
    return torch.cat(outs, dim=1)


def letterbox(img: np.ndarray, new_shape: int = 416,
              color: int = 114) -> Tuple[np.ndarray, float, Tuple[int, int]]:
    """Aspect-preserving resize (OpenCV's INTER_LINEAR) and pad to a
    square: (image, scale ratio, (pad_x, pad_y))."""
    h, w = img.shape[:2]
    r = min(new_shape / h, new_shape / w)
    nh, nw = int(round(h * r)), int(round(w * r))
    pad_w, pad_h = new_shape - nw, new_shape - nh
    left, top = pad_w // 2, pad_h // 2
    resized = resize_linear(img, nh, nw)
    out = np.full((new_shape, new_shape, img.shape[2]), color, img.dtype)
    out[top:top + nh, left:left + nw] = resized
    return out, r, (left, top)


def scale_coords(boxes: np.ndarray, ratio: float, pad: Tuple[int, int],
                 orig_shape: Optional[Tuple[int, int]] = None
                 ) -> np.ndarray:
    """Letterboxed xyxy boxes back to the original image's coordinates,
    clipped to its bounds (H, W) where `orig_shape` is given."""
    out = boxes.copy()
    out[:, [0, 2]] = (out[:, [0, 2]] - pad[0]) / ratio
    out[:, [1, 3]] = (out[:, [1, 3]] - pad[1]) / ratio
    if orig_shape is not None:
        h, w = orig_shape
        out[:, [0, 2]] = out[:, [0, 2]].clip(0, w)
        out[:, [1, 3]] = out[:, [1, 3]].clip(0, h)
    return out


def non_max_suppression(pred: np.ndarray, conf_thres: float = 0.3,
                        iou_thres: float = 0.5,
                        max_det: int = 100) -> np.ndarray:
    """pred [N, 5 + C] (xywh, obj, cls) -> [M, 6] (xyxy, conf, cls):
    conf = obj * the best class's probability, boxes 2 to 4096 pixels
    wide and high, NMS within a class (each class's boxes offset by
    4096 pixels)."""
    obj = pred[:, 4]
    cls_probs = pred[:, 5:]
    cls_id = cls_probs.argmax(-1)
    conf = obj * cls_probs.max(-1)
    mask = conf > conf_thres
    if not mask.any():
        return np.zeros((0, 6), np.float32)
    p = pred[mask]
    conf = conf[mask]
    cls_id = cls_id[mask]
    xy, wh = p[:, :2], p[:, 2:4]
    ok = ((wh > 2).all(axis=1)) & ((wh < 4096).all(axis=1))
    if not ok.any():
        return np.zeros((0, 6), np.float32)
    xy, wh = xy[ok], wh[ok]
    conf, cls_id = conf[ok], cls_id[ok]
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], axis=1)
    offset = cls_id[:, None] * 4096.0
    keep = nms(boxes + offset, conf, iou_thres)
    keep = keep[:max_det]
    return np.concatenate([boxes[keep], conf[keep, None],
                           cls_id[keep, None].astype(np.float32)], 1)


def _conv_order():
    """(module path, has BatchNorm) of every conv in darknet's
    yolov3-spp.cfg order; detection convs carry a bias and no BN."""
    order = [("backbone.stem", True), ("backbone.down1", True),
             ("backbone.res1_0.conv1", True), ("backbone.res1_0.conv2", True),
             ("backbone.down2", True)]
    for i in range(2):
        order += [(f"backbone.res2_{i}.conv1", True),
                  (f"backbone.res2_{i}.conv2", True)]
    for stage, n in ((3, 8), (4, 8), (5, 4)):
        order.append((f"backbone.down{stage}", True))
        for i in range(n):
            order += [(f"backbone.res{stage}_{i}.conv1", True),
                      (f"backbone.res{stage}_{i}.conv2", True)]
    order += [(f"h5_{i}", True) for i in range(7)]
    order += [("det5", False), ("up4_conv", True)]
    order += [(f"h4_{i}", True) for i in range(6)]
    order += [("det4", False), ("up3_conv", True)]
    order += [(f"h3_{i}", True) for i in range(6)]
    order += [("det3", False)]
    return order


def _shapes(template) -> Dict[str, Tuple[int, ...]]:
    if template is None:
        template = YoloV3SPP(device="meta")
    if isinstance(template, nn.Module):
        template = template.state_dict()
    return {k: tuple(v.shape) for k, v in template.items()}


def port_darknet_weights(weights, template=None) -> Dict[str, torch.Tensor]:
    """A darknet `.weights` file (a path or its bytes) -> `YoloV3SPP`'s
    state dict. The layout: a header of 3 int32 (version) and 1 int64
    (images seen), then, conv by conv in cfg order, [bn bias, bn scale,
    bn mean, bn var] (or the conv's bias where it has no BN) and the
    kernel [out, in, kh, kw], float32. `template`: a YoloV3SPP (or its
    state dict) whose shapes drive the parse; default the 80-class
    model. Raises ValueError ("mismatch") unless the file holds exactly
    the architecture's floats."""
    if isinstance(weights, (str, os.PathLike)):
        with open(weights, "rb") as f:
            raw = f.read()
    else:
        raw = weights
    data = np.frombuffer(raw[20:], dtype=np.float32)
    shapes = _shapes(template)
    out: Dict[str, torch.Tensor] = {}
    ptr = 0

    def take(key: str) -> None:
        nonlocal ptr
        shape = shapes[key]
        n = int(np.prod(shape))
        if ptr + n > data.size:
            raise ValueError(
                f"darknet weights exhausted: need {ptr + n} floats, "
                f"file has {data.size} — architecture mismatch")
        out[key] = torch.from_numpy(data[ptr:ptr + n].reshape(shape).copy())
        ptr += n

    for path, has_bn in _conv_order():
        if has_bn:
            for leaf in ("bias", "scale", "mean", "var"):
                take(f"{path}.bn.{leaf}")
            take(f"{path}.conv.weight")
        else:
            take(f"{path}.bias")
            take(f"{path}.weight")
    if ptr != data.size:
        raise ValueError(
            f"darknet weights not fully consumed: used {ptr} of "
            f"{data.size} floats — architecture mismatch")
    return out


def export_darknet_weights(state_dict: Mapping[str, Any]) -> bytes:
    """The inverse of `port_darknet_weights`: a YoloV3SPP state dict as
    darknet `.weights` bytes (header version 0.2.5, 0 images seen)."""
    chunks = [np.asarray([0, 2, 5], np.int32).tobytes(),
              np.asarray([0], np.int64).tobytes()]

    def put(key: str) -> None:
        t = torch.as_tensor(state_dict[key]).detach().float().cpu()
        chunks.append(np.ascontiguousarray(t.numpy()).tobytes())

    for path, has_bn in _conv_order():
        if has_bn:
            for leaf in ("bias", "scale", "mean", "var"):
                put(f"{path}.bn.{leaf}")
            put(f"{path}.conv.weight")
        else:
            put(f"{path}.bias")
            put(f"{path}.weight")
    return b"".join(chunks)


def pool_boxes(neck: np.ndarray, dets: np.ndarray,
               img_size: int) -> np.ndarray:
    """Each detection's mean of the neck [h, w, C] over the cells its
    letterboxed box covers (at least one) -> [n, C]."""
    feats = []
    cell = img_size / neck.shape[0]
    for d in dets:
        x1, y1, x2, y2 = d[:4] / cell
        x1, y1 = int(max(x1, 0)), int(max(y1, 0))
        x2 = int(min(max(x2, x1 + 1), neck.shape[1]))
        y2 = int(min(max(y2, y1 + 1), neck.shape[0]))
        feats.append(neck[y1:y2, x1:x2].mean(axis=(0, 1)))
    return (np.stack(feats) if feats
            else np.zeros((0, neck.shape[-1]), np.float32))


class ObjectFeatureExtractor:
    """Detect objects and pool the SPP neck over each box: image uint8
    HWC -> (boxes [n, 4] in the image's coordinates, features [n,
    1024]). variables: YoloV3SPP's state dict (`port_darknet_weights`,
    or the reference's through `params_from_jax`); random weights from
    `generator` otherwise. `timings`, when a dict, gains the last call's
    host-clock seconds: letterbox, forward (to the decoded predictions
    and the neck on the host) and NMS with the pooling."""

    def __init__(self, variables: Optional[Mapping[str, Any]] = None,
                 img_size: int = 416, *, device="cuda",
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        self.model = build_net(YoloV3SPP, variables, device=device,
                               dtype=dtype, generator=generator)
        self.img_size = img_size
        self.device, self.dtype = torch.device(device), dtype
        self.timings: Optional[Dict[str, float]] = None

    @torch.inference_mode()
    def forward(self, boxed: np.ndarray):
        """A letterboxed uint8 image -> (decoded predictions [N, 85],
        neck [S/32, S/32, 1024]) on the host, float32."""
        inp = boxed.astype(np.float32)[None] / 255.0
        with fp32_exact():
            heads, neck = self.model(to_nchw(inp, self.device, self.dtype))
            pred = decode_predictions([h.float() for h in heads])
        return to_host(pred)[0], to_host(neck)[0].transpose(1, 2, 0)

    def __call__(self, image: np.ndarray, conf_thres: float = 0.3
                 ) -> Tuple[np.ndarray, np.ndarray]:
        t0 = time.perf_counter()
        boxed, ratio, pad = letterbox(image, self.img_size)
        t1 = time.perf_counter()
        pred, neck = self.forward(boxed)
        t2 = time.perf_counter()
        dets = non_max_suppression(pred, conf_thres)
        feats = pool_boxes(neck, dets, self.img_size)
        boxes = (scale_coords(dets[:, :4], ratio, pad,
                              orig_shape=image.shape[:2])
                 if len(dets) else np.zeros((0, 4), np.float32))
        if self.timings is not None:
            self.timings.update(letterbox=t1 - t0, forward=t2 - t1,
                                nms_pool=time.perf_counter() - t2)
        return boxes, feats
