"""Causal dynamic depthwise convolution over a whole sequence, forward
only.

Kernel: `csrc/dynamic_conv.cu` (`nic_dynamic_conv_fwd`), replacing the
TPU kernel `news_image_caption_tpu/ops/pallas_kernels.py::
dynamic_conv_pallas`. Its floor is one read of x and the taps and one
write of the output; one block per (batch item, time tile, channel
chunk) stages its x rows and the K - 1 rows before them in shared
memory, and the tap loop, not the bytes, sets its time (see the
source).

Numerics are the TPU kernel's (pallas_kernels.py:59-67): every product
and the running sum in fp32, taps in order k = 0 .. K-1, one rounding
to x's dtype. That is not the shift route of `ops/conv.py`, which
accumulates in x's dtype and so rounds K times in bf16. The kernel
keeps its products and sums apart (no fused multiply-add), so it equals
the plain version bit for bit.

The reference kernel has no gradient; `dynamic_conv_autograd` carries
that over: its backward raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from news_image_caption_tpu_torch.ops import _build

MAX_TAPS = 31
_ARGTYPES = [_build.P] * 3 + [_build.I] * 6 + [_build.P]
_ELEM_BYTES = {torch.bfloat16: 2, torch.float32: 4}


def dynamic_conv_plain(x: torch.Tensor, w: torch.Tensor,
                       num_heads: int) -> torch.Tensor:
    """out[b,t,c] = sum_k w[b,t,c//R,k] * x[b,t-K+1+k,c] in plain
    PyTorch, zeros before t = 0. x [B, T, C]; w [B, T, H, K] in x's
    dtype; R = C / H. Sums in fp32 in tap order, rounded once."""
    B, T, C = x.shape
    K = w.shape[-1]
    H = num_heads
    xp = F.pad(x.float().view(B, T, H, C // H), (0, 0, 0, 0, K - 1, 0))
    wf = w.float()
    acc = torch.zeros(B, T, H, C // H, device=x.device, dtype=torch.float32)
    for k in range(K):
        acc = acc + wf[..., k:k + 1] * xp[:, k:k + T]
    return acc.to(x.dtype).view(B, T, C)


def dynamic_conv(x: torch.Tensor, w: torch.Tensor,
                 num_heads: int) -> torch.Tensor:
    """See `dynamic_conv_plain`. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises."""
    if x.device.type == "cpu":
        return dynamic_conv_plain(x, w, num_heads)
    _build.require(x.device.type == "cuda",
                   f"dynamic_conv: no kernel for device {x.device}")
    B, T, C = x.shape
    H = num_heads
    K = w.shape[-1]
    _build.require(x.dtype in _ELEM_BYTES and w.dtype == x.dtype,
                   "dynamic_conv kernel takes x and w both bf16 or both fp32")
    _build.require(tuple(w.shape) == (B, T, H, K),
                   f"dynamic_conv: w {tuple(w.shape)}, expected [B, T, H, K]"
                   f" with B, T = {B}, {T} and H = {H}")
    _build.require(x.is_contiguous() and w.is_contiguous()
                   and w.device == x.device,
                   "dynamic_conv: inputs must be contiguous, on one device")
    _build.require(T >= 1 and 1 <= K <= MAX_TAPS and C % H == 0
                   and C % 2 == 0,
                   f"dynamic_conv: need T >= 1, 1 <= K <= {MAX_TAPS}, C even"
                   " and C % H == 0")
    out = torch.empty_like(x)
    fn = _build.function("nic_dynamic_conv_fwd", _ARGTYPES)
    _build.check(fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), B, T, C, H,
                    K, _ELEM_BYTES[x.dtype], _build.stream_of(x)),
                 "dynamic_conv")
    dynamic_conv.launches += 1
    return out


dynamic_conv.launches = 0


class _DynamicConv(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, num_heads):
        return dynamic_conv(x, w, num_heads)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "dynamic_conv has no gradient: the reference kernel"
            " (pallas_kernels.py::dynamic_conv_pallas) has none; train"
            " through DynamicConv's shift or band route")


def dynamic_conv_autograd(x: torch.Tensor, w: torch.Tensor,
                          num_heads: int) -> torch.Tensor:
    """`dynamic_conv` under autograd: the output keeps a graph, whose
    backward raises NotImplementedError, on the CPU as on the card."""
    return _DynamicConv.apply(x, w, num_heads)
