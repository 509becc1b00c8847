"""The frozen ResNet trunk (headless, frozen BatchNorm) and the image
preprocessing of the online pipeline.

Counterpart of `news_image_caption_tpu/models/resnet.py` (`DEPTHS`,
`IMAGENET_MEAN` / `IMAGENET_STD`, `FrozenBatchNorm`, `Bottleneck`,
`BasicBlock`, `ResNetTrunk`, `preprocess_image`, `port_torch_resnet`).
BatchNorm is a constant affine map of its running statistics, its four
leaves (`scale`, `bias`, `mean`, `var`) never trained.

The trunk takes and returns NHWC, as the reference's flax trunk does; in
between it runs PyTorch convolutions (the reference runs them in XLA; no
Pallas kernel touches them) on the NCHW view of the NHWC tensor, which is
PyTorch's channels-last layout, so no copy is made. Conv weights are
stored OIHW, as `F.conv2d` takes them; `models/from_jax.py` transposes the
reference's HWIO kernels, and `state_from_torchvision` maps a
torchvision-layout state dict. Padding matches flax's: explicit for the 3x3
and 7x7 convolutions, none for the 1x1 (flax's SAME pads a 1x1 kernel by
nothing at any stride), -inf for the max pool.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from news_image_caption_tpu_torch.ops.linear import initializes, new_param

DEPTHS = {
    18: (2, 2, 2, 2),
    34: (3, 4, 6, 3),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
CROP = 224


class Conv(nn.Module):
    """Convolution, weight OIHW, fan-in normal init; bias-free unless
    `bias` (then zero). kernel and padding: an int or an (h, w) pair,
    the padding symmetric."""

    def __init__(self, in_ch: int, out_ch: int, kernel, stride: int = 1,
                 padding=0, bias: bool = False, *, device, dtype,
                 generator=None):
        super().__init__()
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        self.stride, self.padding = stride, padding
        self.weight = new_param((out_ch, in_ch, kh, kw), device, dtype)
        self.bias = new_param((out_ch,), device, dtype) if bias else None
        if initializes(device):
            with torch.no_grad():
                self.weight.normal_(0.0, (in_ch * kh * kw) ** -0.5,
                                    generator=generator)
                if bias:
                    self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding)


class FrozenBatchNorm(nn.Module):
    """y = x * inv + (bias - mean * inv), inv = rsqrt(var + eps) * scale,
    over the channels of NCHW x."""

    def __init__(self, features: int, eps: float = 1e-5, *, device, dtype):
        super().__init__()
        self.eps = eps
        for name, value in (("scale", 1.0), ("bias", 0.0), ("mean", 0.0),
                            ("var", 1.0)):
            setattr(self, name, new_param((features,), device, dtype))
            if initializes(device):
                with torch.no_grad():
                    getattr(self, name).fill_(value)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.var + self.eps) * self.scale
        shift = self.bias - self.mean * inv
        return x * inv[:, None, None] + shift[:, None, None]


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 downsample: bool = False, **kw):
        super().__init__()
        bn = dict(device=kw["device"], dtype=kw["dtype"])
        out = planes * self.expansion
        self.conv1 = Conv(in_planes, planes, 1, **kw)
        self.bn1 = FrozenBatchNorm(planes, **bn)
        self.conv2 = Conv(planes, planes, 3, stride, 1, **kw)
        self.bn2 = FrozenBatchNorm(planes, **bn)
        self.conv3 = Conv(planes, out, 1, **kw)
        self.bn3 = FrozenBatchNorm(out, **bn)
        if downsample:
            self.downsample_conv = Conv(in_planes, out, 1, stride, **kw)
            self.downsample_bn = FrozenBatchNorm(out, **bn)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.downsample:
            x = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + x)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 downsample: bool = False, **kw):
        super().__init__()
        bn = dict(device=kw["device"], dtype=kw["dtype"])
        self.conv1 = Conv(in_planes, planes, 3, stride, 1, **kw)
        self.bn1 = FrozenBatchNorm(planes, **bn)
        self.conv2 = Conv(planes, planes, 3, 1, 1, **kw)
        self.bn2 = FrozenBatchNorm(planes, **bn)
        if downsample:
            self.downsample_conv = Conv(in_planes, planes, 1, stride, **kw)
            self.downsample_bn = FrozenBatchNorm(planes, **bn)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.downsample:
            x = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + x)


class ResNetTrunk(nn.Module):
    """Headless ResNet: `num_stages=3` ends at layer3, 4 at layer4.
    Blocks are named as flax names them, `layer{stage}_{block}`."""

    def __init__(self, depth: int = 152, num_stages: int = 4, *, device,
                 dtype, generator: Optional[torch.Generator] = None):
        super().__init__()
        if depth not in DEPTHS:
            raise ValueError(f"resnet depth {depth}: one of {sorted(DEPTHS)}")
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.depth, self.num_stages = depth, num_stages
        block_cls = Bottleneck if depth >= 50 else BasicBlock
        self.conv1 = Conv(3, 64, 7, 2, 3, **kw)
        self.bn1 = FrozenBatchNorm(64, device=device, dtype=dtype)
        self.blocks = []
        in_planes = 64
        for stage in range(num_stages):
            planes = 64 * 2 ** stage
            stride = 1 if stage == 0 else 2
            for b in range(DEPTHS[depth][stage]):
                down = b == 0 and (stride != 1 or
                                   in_planes != planes * block_cls.expansion)
                name = f"layer{stage + 1}_{b}"
                self.add_module(name, block_cls(
                    in_planes, planes, stride if b == 0 else 1, down, **kw))
                self.blocks.append(name)
                in_planes = planes * block_cls.expansion
        self.out_channels = in_planes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC float [B, H, W, 3] -> NHWC features."""
        y = x.permute(0, 3, 1, 2)               # channels-last NCHW view
        y = F.relu(self.bn1(self.conv1(y)))
        y = F.max_pool2d(y, 3, 2, 1)
        for name in self.blocks:
            y = getattr(self, name)(y)
        return y.permute(0, 2, 3, 1)

    def patches(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC [B, H, W, 3] -> [B, H' * W', C] patch features, row-major
        over (H', W')."""
        y = self(x)
        B, H, W, C = y.shape
        return y.reshape(B, H * W, C)


def preprocess_image(img_uint8: torch.Tensor, crop: int = CROP,
                     random_crop: bool = False,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """uint8 HWC or NHWC in [0, 255] -> normalized float NHWC [B, crop,
    crop, C] on the image's device: /255, ImageNet mean and std, then a
    center crop (or, with `random_crop` and a generator, a crop drawn
    from it). A side under `crop` is first resized bilinearly to `crop`
    (half-pixel centres, as `jax.image.resize`)."""
    x = img_uint8.float() / 255.0
    mean = torch.from_numpy(IMAGENET_MEAN).to(x.device)
    std = torch.from_numpy(IMAGENET_STD).to(x.device)
    x = (x - mean) / std
    if x.ndim == 3:
        x = x[None]
    B, H, W, C = x.shape
    if H == crop and W == crop:
        return x
    if H < crop or W < crop:
        x = F.interpolate(x.permute(0, 3, 1, 2),
                          size=(max(H, crop), max(W, crop)),
                          mode="bilinear", align_corners=False
                          ).permute(0, 2, 3, 1)
        B, H, W, C = x.shape
        if H == crop and W == crop:
            return x
    if random_crop and generator is not None:
        draw = dict(generator=generator, device=generator.device)
        top = int(torch.randint(0, H - crop + 1, (), **draw))
        left = int(torch.randint(0, W - crop + 1, (), **draw))
    else:
        top, left = (H - crop) // 2, (W - crop) // 2
    return x[:, top:top + crop, left:left + crop]


def state_from_torchvision(state_dict: Mapping[str, Any], depth: int = 152,
                           num_stages: int = 4) -> Dict[str, torch.Tensor]:
    """A torchvision-layout ResNet state dict as `ResNetTrunk`'s: conv
    weights as they are (OIHW in both), BatchNorm's weight, bias,
    running_mean and running_var as scale, bias, mean and var. The `fc`
    head, `num_batches_tracked` and the stages past `num_stages` are
    left out."""
    sd = {k: torch.as_tensor(v) for k, v in state_dict.items()}

    def bn(dst, src):
        for leaf, tv in (("scale", "weight"), ("bias", "bias"),
                         ("mean", "running_mean"), ("var", "running_var")):
            out[f"{dst}.{leaf}"] = sd[f"{src}.{tv}"]

    out = {"conv1.weight": sd["conv1.weight"]}
    bn("bn1", "bn1")
    n_convs = 3 if depth >= 50 else 2
    for stage in range(num_stages):
        for b in range(DEPTHS[depth][stage]):
            src, dst = f"layer{stage + 1}.{b}", f"layer{stage + 1}_{b}"
            for ci in range(1, n_convs + 1):
                out[f"{dst}.conv{ci}.weight"] = sd[f"{src}.conv{ci}.weight"]
                bn(f"{dst}.bn{ci}", f"{src}.bn{ci}")
            if f"{src}.downsample.0.weight" in sd:
                out[f"{dst}.downsample_conv.weight"] = \
                    sd[f"{src}.downsample.0.weight"]
                bn(f"{dst}.downsample_bn", f"{src}.downsample.1")
    return out
