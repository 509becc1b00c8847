"""Fused decode-step blocks of the dynamic-conv decoder layer.

Kernels: `csrc/decode_blocks.cu`, replacing the TPU kernels
`news_image_caption_tpu/ops/pallas_decode.py::decode_conv_block` and
`::decode_ffn_block`. At decode batch sizes both are bound by one read
of their weights per step (6.5 MB for the conv block, 16 MB for the
FFN, bf16, per flagship layer); the TPU's sequential carry over the
grid becomes split-K row products over independent tiles plus
elementwise epilogues (see the source).

The plain versions keep the reference kernels' bf16 rounding points
(pallas_decode.py:47-101 and :111-129): every product accumulates in
fp32 and is rounded to the working dtype where the reference rounds.
In fp32 the roundings are no-ops.
"""

from __future__ import annotations

import torch

from news_image_caption_tpu_torch.ops import _build

MAX_TAPS = 32
_CONV_ARGTYPES = [_build.P] * 11 + [_build.I] * 7 + [_build.P]
_FFN_ARGTYPES = [_build.P] * 8 + [_build.I] * 5 + [_build.P]
# Output tile and K step of the kernels' row products (RowTile).
_TILE_ROWS, _TILE_COLS, _TILE_K = 16, 64, 32


def _rounder(dtype):
    return lambda t: t.to(dtype).float()


def decode_conv_block_plain(x, cache, t: int, w1, b1, wl, w2, b2,
                            num_heads: int):
    """One conv-block decode step, in plain PyTorch.

    x [N, C]; cache [K-1, N, C] ring-major (slot s mod (K-1) holds the
    GLU row of step s, zeros before the sequence start); w1 [C, 2C],
    b1 [2C] and w2 [C, C], b2 [C] with weight norm folded; wl [C, H*K]
    the tap predictor, head-major (column h*K + k). Returns (y [N, C],
    the conv output + linear2 + residual before the LayerNorm; h [N, C],
    the GLU row the caller writes into slot t mod (K-1)).
    """
    N, C = x.shape
    H = num_heads
    K = wl.shape[1] // H
    Km1 = K - 1
    r = _rounder(x.dtype)
    xf = x.float()
    pre = r(r(xf @ w1.float()) + b1.float())
    a, g = pre[:, :C], pre[:, C:]
    h = r(a * r(torch.sigmoid(g)))
    taps = r(h @ wl.float()).view(N, H, K)
    p = r(torch.softmax(taps, dim=-1))
    slots = (t + torch.arange(Km1, device=x.device)) % Km1
    hist = cache.float()[slots].view(Km1, N, H, C // H)
    acc = torch.einsum("nhk,knhr->nhr", p[:, :, :Km1], hist).reshape(N, C)
    cur = r(p[:, :, Km1:].expand(N, H, C // H).reshape(N, C) * h)
    hconv = r(r(acc) + cur)
    y = r(r(r(hconv @ w2.float()) + b2.float()) + xf)
    return y.to(x.dtype), h.to(x.dtype)


def decode_ffn_block_plain(x, w1, b1, w2, b2):
    """relu(x w1 + b1) w2 + b2 + x for single-token rows, in plain
    PyTorch. x [N, C]; w1 [C, F], b1 [F]; w2 [F, C], b2 [C] with weight
    norm folded. The final LayerNorm stays with the caller."""
    r = _rounder(x.dtype)
    xf = x.float()
    h = torch.relu(r(r(xf @ w1.float()) + b1.float()))
    y = r(r(r(h @ w2.float()) + b2.float()) + xf)
    return y.to(x.dtype)


def decode_conv_block(x, cache, t: int, w1, b1, wl, w2, b2,
                      num_heads: int):
    """See `decode_conv_block_plain`. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    if x.device.type == "cpu":
        return decode_conv_block_plain(x, cache, t, w1, b1, wl, w2, b2,
                                       num_heads)
    _build.require(x.device.type == "cuda",
                   f"decode_conv_block: no kernel for device {x.device}")
    return _launch_conv(x, cache, int(t), w1, b1, wl, w2, b2, num_heads)


def decode_ffn_block(x, w1, b1, w2, b2):
    """See `decode_ffn_block_plain`. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    if x.device.type == "cpu":
        return decode_ffn_block_plain(x, w1, b1, w2, b2)
    _build.require(x.device.type == "cuda",
                   f"decode_ffn_block: no kernel for device {x.device}")
    return _launch_ffn(x, w1, b1, w2, b2)


def _splits(device, N: int, cols: int, K: int) -> int:
    """K chunks of a row product: about two blocks per SM of the card,
    at most one BK slice per chunk."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = -(-cols // _TILE_COLS) * -(-N // _TILE_ROWS)
    return max(1, min(-(-K // _TILE_K), -(-2 * sms // tiles)))


def _check_inputs(name, tensors, shapes):
    x = tensors[0]
    _build.require(all(t.dtype == torch.bfloat16 for t in tensors),
                   f"{name} kernel takes bf16 inputs")
    _build.require(all(tuple(t.shape) == s for t, s in zip(tensors, shapes)),
                   f"{name}: shapes {[tuple(t.shape) for t in tensors]},"
                   f" expected {shapes}")
    _build.require(all(t.is_contiguous() and t.device == x.device
                       for t in tensors),
                   f"{name}: inputs must be contiguous, on one device")


def _launch_conv(x, cache, t, w1, b1, wl, w2, b2, num_heads):
    N, C = x.shape
    H = num_heads
    K = wl.shape[1] // H
    _build.require(2 <= K <= MAX_TAPS and C % H == 0 and t >= 0,
                   f"decode_conv_block: need 2 <= K <= {MAX_TAPS},"
                   " C % H == 0 and t >= 0")
    _check_inputs("decode_conv_block", (x, cache, w1, b1, wl, w2, b2),
                  [(N, C), (K - 1, N, C), (C, 2 * C), (2 * C,), (C, H * K),
                   (C, C), (C,)])
    fn = _build.function("nic_decode_conv_block", _CONV_ARGTYPES)
    s1, s2 = _splits(x.device, N, 2 * C, C), _splits(x.device, N, C, C)
    h = torch.empty_like(x)
    hconv = torch.empty_like(x)
    y = torch.empty_like(x)
    part = torch.empty(max(s1 * 2 * C, s2 * C) * N, device=x.device,
                       dtype=torch.float32)
    _build.check(fn(x.data_ptr(), cache.data_ptr(), w1.data_ptr(),
                    b1.data_ptr(), wl.data_ptr(), w2.data_ptr(),
                    b2.data_ptr(), h.data_ptr(), hconv.data_ptr(),
                    y.data_ptr(), part.data_ptr(), N, C, H, K, t, s1, s2,
                    _build.stream_of(x)),
                 "decode_conv_block")
    decode_conv_block.launches += 1
    return y, h


def _launch_ffn(x, w1, b1, w2, b2):
    N, C = x.shape
    F = w1.shape[1]
    _check_inputs("decode_ffn_block", (x, w1, b1, w2, b2),
                  [(N, C), (C, F), (F,), (F, C), (C,)])
    fn = _build.function("nic_decode_ffn_block", _FFN_ARGTYPES)
    s1, s2 = _splits(x.device, N, F, C), _splits(x.device, N, C, F)
    h = torch.empty(N, F, device=x.device, dtype=x.dtype)
    y = torch.empty_like(x)
    part = torch.empty(max(s1 * F, s2 * C) * N, device=x.device,
                       dtype=torch.float32)
    _build.check(fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                    w2.data_ptr(), b2.data_ptr(), h.data_ptr(), y.data_ptr(),
                    part.data_ptr(), N, C, F, s1, s2, _build.stream_of(x)),
                 "decode_ffn_block")
    decode_ffn_block.launches += 1
    return y


decode_conv_block.launches = 0
decode_ffn_block.launches = 0
