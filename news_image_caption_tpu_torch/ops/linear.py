"""Linear layers and LayerNorm.

Counterpart of `news_image_caption_tpu/ops/linear.py`. Kernels are
stored as the JAX package stores them, (in, out), so weights carry
across unchanged (`models/from_jax.py`); flax names (`kernel`, `scale`,
`bias`) are kept as parameter names for the same reason.

A module's `dtype` is the dtype its parameters are stored in (the
reference's `param_dtype`); its products run in the dtype of the input
(the reference's compute `dtype`), the parameters cast to it. Where a
`GehringLinear`'s parameters are stored narrower than its input (bf16
parameters of an fp32 model), its weight-norm scale is rounded at the
parameters' dtype as the reference computes it: the column sums of
squares in fp32 rounded once, the square root rounded, the quotient
rounded.

Split forms (tensor parallelism, `parallel/partition.py`): a linear
whose kernel the partition rules split is `split` "column" (the output
dim: each rank holds its columns of the kernel, the bias and a weight
norm's scale) or "row" (the input dim: each rank holds its rows, the
bias and scale whole). `local(x)` is the form a split-aware module
chains: a column linear takes the replicated x through `copy_in` and
returns its columns of y, a row linear takes the rank's columns of its
input and returns the whole y, the ranks' partial products summed by
`reduce_out` before the scale and the bias, which are added once. A
weight norm folds over the input dim, so a row linear's norm ||v||
is the square root of the sum over the model ranks of each rank's sum
of squares, in the forward, its backward and the decode fold
(`folded`) alike. `forward(x)` stays whole in and whole out for a module
that chains no split forms: a column linear gathers its output, a row
linear takes its rank's columns of a whole input. Unsplit, or at a
model axis of one, both are the plain forward.
"""

from __future__ import annotations

import math

import torch
from torch import nn
import torch.nn.functional as F

from news_image_caption_tpu_torch.parallel.collectives import (copy_in,
                                                               gather_out,
                                                               reduce_out)
from news_image_caption_tpu_torch.parallel.partition import shard_of


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


class SplitLinear(nn.Module):
    """The split forms of a linear y = x @ kernel (+ bias); `_product`
    is the product with the partial sums' reduction in place."""

    split = None        # "column", "row" or None (`shard_params`)

    def _product(self, x: torch.Tensor, reduce=None) -> torch.Tensor:
        y = x @ self.kernel.to(x.dtype)
        if reduce is not None:
            y = reduce(y)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """The split-aware form: a column linear's columns of y from a
        replicated x, a row linear's whole y from its rank's columns of
        x (see the module note); the plain forward unsplit."""
        if self.split is None:
            return self._product(x)
        shard = shard_of(self)
        if self.split == "column":
            return self._product(copy_in(x, shard))
        return self._product(x, lambda y: reduce_out(y, shard))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shard = None if self.split is None else shard_of(self)
        if shard is None or shard.size == 1:
            return self.local(x)
        if self.split == "column":
            return gather_out(self.local(x), shard, -1)
        n = self.kernel.shape[0]
        return self.local(copy_in(x, shard)[..., shard.part(n)])


class XavierLinear(SplitLinear):
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


class Dense(SplitLinear):
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


class GehringLinear(SplitLinear):
    """Linear with weight normalization w = scale * kernel / ||kernel||
    (norm per output feature), fan-in normal init with scale = ||kernel||.

    The per-output scale is applied in the epilogue,
    (x @ kernel) * s, as the reference does; decode folds it into the
    kernel once per model load (`folded`). weight_norm=False is a plain
    `kernel` and `bias` with the same init. `dropout` scales the init's
    deviation to sqrt((1 - dropout) / in_features), as the reference's
    `gehring_normal(dropout)`.
    """

    def __init__(self, in_features: int, features: int, *, device, dtype,
                 generator: torch.Generator | None = None,
                 weight_norm: bool = True, use_bias: bool = True,
                 dropout: float = 0.0):
        super().__init__()
        self.kernel = new_param((in_features, features), device, dtype)
        self.scale = (new_param((features,), device, dtype) if weight_norm
                      else None)
        self.bias = new_param((features,), device, dtype) if use_bias else None
        if initializes(device):
            with torch.no_grad():
                self.kernel.normal_(0.0,
                                    math.sqrt((1.0 - dropout) / in_features),
                                    generator=generator)
                if weight_norm:
                    self.scale.copy_(self.kernel.float().norm(dim=0))
                if use_bias:
                    self.bias.zero_()

    def _norm_scale(self, dtype: torch.dtype) -> torch.Tensor:
        """g / max(||v||_col, 1e-12) in fp32, for an input of `dtype`:
        rounded at the parameters' dtype where that is narrower."""
        v = self.kernel.float()
        sumsq = torch.sum(v * v, dim=0)
        if self.split == "row":
            sumsq = reduce_out(sumsq, shard_of(self))
        pdtype = self.kernel.dtype
        if torch.finfo(pdtype).bits >= torch.finfo(dtype).bits:
            return self.scale.float() / torch.clamp(torch.sqrt(sumsq),
                                                    min=1e-12)
        norm = torch.sqrt(sumsq.to(pdtype).float()).to(pdtype).float()
        return (self.scale.float() / torch.clamp(norm, min=1e-12)
                ).to(pdtype).float()

    def _product(self, x: torch.Tensor, reduce=None) -> torch.Tensor:
        y = x @ self.kernel.to(x.dtype)
        if reduce is not None:
            y = reduce(y)
        if self.scale is not None:
            y = y * self._norm_scale(x.dtype).to(x.dtype)
        return y if self.bias is None else y + self.bias.to(x.dtype)

    def folded(self, dtype: torch.dtype):
        """(kernel with the weight norm folded in, bias or None), in
        `dtype`: split, this rank's slice of the whole fold."""
        kernel = (self.kernel.to(dtype) if self.scale is None
                  else (self.kernel.float()
                        * self._norm_scale(dtype)[None, :]).to(dtype))
        return kernel, None if self.bias is None else self.bias.to(dtype)


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
