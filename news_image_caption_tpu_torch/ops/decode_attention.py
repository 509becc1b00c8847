"""Few-query cross-attention over per-item context K/V, for decode.

Kernel: `csrc/decode_attention.cu`, replacing the TPU kernel
`news_image_caption_tpu/ops/pallas_kernels.py::decode_cross_attention`.
It is bound by reading the context K and V once per step (33.7 MB per
layer for the article at batch 16): one block per (head, item) reads
its K/V slices once and keeps the scores in shared memory.

The port follows the TPU kernel's numerics, fp32 scores and softmax
with probabilities rounded to the value dtype; the reference's XLA
decode path (`ops/attention.py::attend_flat_beam` over `DecodeKV`)
instead materializes the scores in the compute dtype.
"""

from __future__ import annotations

import torch

from news_image_caption_tpu_torch.ops import _build

MAX_Q = 16
_ARGTYPES = [_build.P] * 5 + [_build.I] * 5 + [_build.P]


def decode_cross_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, bias: torch.Tensor,
                                 num_heads: int) -> torch.Tensor:
    """softmax(q_h k_hᵀ + bias) v_h per head, in plain PyTorch.

    q [B, Q, E] (already scaled by head_dim**-0.5); k, v [B, S, E];
    bias [B, S] fp32 (0 attendable, -1e9 masked). Scores and softmax in
    fp32; probabilities rounded to v's dtype; output in q's dtype.
    """
    B, Q, E = q.shape
    S = k.shape[1]
    dh = E // num_heads
    qh = q.float().view(B, Q, num_heads, dh)
    kh = k.float().view(B, S, num_heads, dh)
    vh = v.float().view(B, S, num_heads, dh)
    s = torch.einsum("bqhd,bshd->bhqs", qh, kh) + bias.float()[:, None, None, :]
    p = torch.softmax(s, dim=-1).to(v.dtype).float()
    out = torch.einsum("bhqs,bshd->bqhd", p, vh)
    return out.to(q.dtype).reshape(B, Q, E)


def decode_cross_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, bias: torch.Tensor,
                           num_heads: int) -> torch.Tensor:
    """Returns [B, Q, E]; see `decode_cross_attention_plain`. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    if q.device.type == "cpu":
        return decode_cross_attention_plain(q, k, v, bias, num_heads)
    _build.require(q.device.type == "cuda",
                   f"decode_cross_attention: no kernel for device {q.device}")
    return _launch(q, k, v, bias, num_heads)


def _launch(q, k, v, bias, num_heads):
    B, Q, E = q.shape
    S = k.shape[1]
    _build.require(all(t.dtype == torch.bfloat16 for t in (q, k, v))
                   and bias.dtype == torch.float32,
                   "decode_cross_attention kernel takes bf16 q/k/v and an"
                   " fp32 bias")
    _build.require(k.shape == (B, S, E) and v.shape == (B, S, E)
                   and bias.shape == (B, S),
                   "decode_cross_attention: k, v must be [B, S, E] and bias"
                   " [B, S]")
    _build.require(all(t.is_contiguous() and t.device == q.device
                       for t in (q, k, v, bias)),
                   "decode_cross_attention: inputs must be contiguous, on"
                   " one device")
    _build.require(1 <= Q <= MAX_Q and E % num_heads == 0,
                   f"decode_cross_attention: need 1 <= Q <= {MAX_Q} and"
                   " E % num_heads == 0")
    fn = _build.function("nic_decode_attention", _ARGTYPES)
    out = torch.empty_like(q)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    bias.data_ptr(), out.data_ptr(), B, Q, S, E, num_heads,
                    _build.stream_of(q)),
                 "decode_cross_attention")
    decode_cross_attention.launches += 1
    return out


decode_cross_attention.launches = 0
