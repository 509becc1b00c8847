"""Linear layers, LayerNorm and the weight-norm fold.

Counterpart of `news_image_caption_tpu/ops/linear.py`. Kernels are
stored as the JAX package stores them, (in, out), so weights carry
across unchanged (`models/from_jax.py`); flax names (`kernel`, `scale`,
`bias`) are kept as parameter names for the same reason.
"""

from __future__ import annotations

import math

import torch
from torch import nn
import torch.nn.functional as F


def fold_weight_norm(v: torch.Tensor, g: torch.Tensor,
                     dtype: torch.dtype | None = None) -> torch.Tensor:
    """w = v * g / max(||v||_col, 1e-12), the norm over axis 0 of the
    (in, out) kernel; computed in fp32, then cast to `dtype`."""
    v32 = v.float()
    norm = torch.sqrt(torch.sum(v32 * v32, dim=0, keepdim=True))
    w = v32 * (g.float()[None, :] / torch.clamp(norm, min=1e-12))
    return w.to(dtype or v.dtype)


def positionwise(fn, x: torch.Tensor) -> torch.Tensor:
    """fn over each position of x [B, k, ...], one contiguous [B, ...]
    slice at a time, stacked back along dim 1: a decode chunk's k
    positions computed at a single step's shapes, so that its products
    sum as the step's do (a library product may pick another algorithm,
    and so another order of its sums, at another row count)."""
    return torch.stack([fn(x[:, j].contiguous()) for j in range(x.shape[1])],
                       dim=1)


def new_param(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


def initializes(device) -> bool:
    return torch.device(device).type != "meta"


class XavierLinear(nn.Module):
    """y = x @ kernel + bias, xavier-uniform init."""

    def __init__(self, in_features: int, features: int, *, device, dtype,
                 generator: torch.Generator | None = None,
                 use_bias: bool = True):
        super().__init__()
        self.kernel = new_param((in_features, features), device, dtype)
        self.bias = new_param((features,), device, dtype) if use_bias else None
        if initializes(device):
            bound = math.sqrt(6.0 / (in_features + features))
            with torch.no_grad():
                self.kernel.uniform_(-bound, bound, generator=generator)
                if self.bias is not None:
                    self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel.to(x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


class Dense(nn.Module):
    """flax `nn.Dense`: y = x @ kernel + bias. The kernel is drawn
    normal with variance 1 / in_features, cut at two deviations (flax's
    lecun-normal), or uniform in ±uniform_scale; the bias is zero."""

    def __init__(self, in_features: int, features: int, *, device, dtype,
                 generator: torch.Generator | None = None,
                 use_bias: bool = True,
                 uniform_scale: float | None = None):
        super().__init__()
        self.kernel = new_param((in_features, features), device, dtype)
        self.bias = new_param((features,), device, dtype) if use_bias else None
        if initializes(device):
            with torch.no_grad():
                if uniform_scale is None:
                    std = math.sqrt(1.0 / in_features)
                    self.kernel.normal_(0.0, std, generator=generator)
                    self.kernel.clamp_(-2.0 * std, 2.0 * std)
                else:
                    self.kernel.uniform_(-uniform_scale, uniform_scale,
                                         generator=generator)
                if self.bias is not None:
                    self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel.to(x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


class GehringLinear(nn.Module):
    """Linear with weight normalization w = scale * kernel / ||kernel||
    (norm per output feature), fan-in normal init with scale = ||kernel||.

    The per-output scale is applied in the epilogue,
    (x @ kernel) * s, as the reference does; decode folds it into the
    kernel once per model load (`folded`). weight_norm=False is a plain
    `kernel` and `bias` with the same init.
    """

    def __init__(self, in_features: int, features: int, *, device, dtype,
                 generator: torch.Generator | None = None,
                 weight_norm: bool = True):
        super().__init__()
        self.kernel = new_param((in_features, features), device, dtype)
        self.scale = (new_param((features,), device, dtype) if weight_norm
                      else None)
        self.bias = new_param((features,), device, dtype)
        if initializes(device):
            with torch.no_grad():
                self.kernel.normal_(0.0, math.sqrt(1.0 / in_features),
                                    generator=generator)
                if weight_norm:
                    self.scale.copy_(self.kernel.float().norm(dim=0))
                self.bias.zero_()

    def _norm_scale(self) -> torch.Tensor:
        v = self.kernel.float()
        norm = torch.sqrt(torch.sum(v * v, dim=0))
        return self.scale.float() / torch.clamp(norm, min=1e-12)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel.to(x.dtype)
        if self.scale is not None:
            y = y * self._norm_scale().to(x.dtype)
        return y + self.bias.to(x.dtype)

    def folded(self, dtype: torch.dtype):
        """(kernel with the weight norm folded in, bias), in `dtype`."""
        kernel = (self.kernel.to(dtype) if self.scale is None
                  else fold_weight_norm(self.kernel, self.scale, dtype))
        return kernel, self.bias.to(dtype)


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm`: eps 1e-6, statistics and affine in fp32,
    the result cast back to the input dtype."""

    def __init__(self, features: int, *, device, dtype, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = new_param((features,), device, dtype)
        self.bias = new_param((features,), device, dtype)
        if initializes(device):
            with torch.no_grad():
                self.scale.fill_(1.0)
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), x.shape[-1:], self.scale.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)
