"""Fused decode-step blocks of the dynamic-conv decoder layer.

Kernels: `csrc/decode_blocks.cu` and `csrc/decode_ffn.cu`, replacing
the TPU kernels `news_image_caption_tpu/ops/pallas_decode.py::
decode_conv_block` and `::decode_ffn_block`. At decode batch sizes both
are bound by one read of their weights per step (6.5 MB for the conv
block, 16.8 MB for the FFN, bf16, per flagship layer). The conv block
is split-K row products over independent tiles plus elementwise
epilogues. The FFN block is one launch (for up to 16 rows) designed for
the H100: every block owns 32 columns of w1 and a piece of w2, requests
all of them at once and multiplies on the tensor cores; groups of 8
blocks share their strips of h, and the groups' partial outputs are
added in a fixed order (see the source); `ffn_plan` is its host-side
plan.

The plain versions keep the reference kernels' bf16 rounding points
(pallas_decode.py:47-101 and :111-129): every product accumulates in
fp32 and is rounded to the working dtype where the reference rounds.
In fp32 the roundings are no-ops.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from news_image_caption_tpu_torch.ops import _build

MAX_TAPS = 32
_CONV_ARGTYPES = [_build.P] * 11 + [_build.I] * 7 + [_build.P]
_FFN_ARGTYPES = [_build.P] * 9 + [_build.I] * 6 + [_build.P]
# Output tile and K step of the conv block's row products (RowTile).
_TILE_ROWS, _TILE_COLS, _TILE_K = 16, 64, 32
# The FFN kernel: columns of w1 a block, rows of x a launch, the largest
# group of blocks that share h.
FFN_STRIP, FFN_ROWS, MAX_GROUP = 32, 16, 8
# Counters of the FFN kernel's barriers between blocks, one tensor a
# device: a count of launches and two sets of `slots` counters, zeroed
# here once and then kept by the kernel. Calls on one device share them,
# so they must follow one another (one stream).
_ffn_counters: dict = {}


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


class FfnPlan(NamedTuple):
    """How `decode_ffn_block`'s kernel cuts its work: block g of
    `blocks` owns columns [g * strip, (g + 1) * strip) of w1; `group`
    consecutive blocks share their strips of h, and rank r of a group
    multiplies the group's h with rows [group index * group * strip, +
    group * strip) of w2 restricted to columns [r * slice, (r + 1) *
    slice) of the output. All blocks are on the card at once; rows go
    through 16 a launch."""

    strip: int
    blocks: int
    launches: int
    group: int
    groups: int
    slice: int
    smem_bytes: int


def ffn_smem_bytes(C: int, group: int) -> int:
    """Dynamic shared memory of a block (csrc/decode_ffn.cu::
    ffn_smem_bytes): the w1 strip, the piece of w2 (rows padded by 8
    elements), x, the warps' fc1 partials, the group's h, the barrier
    of w2's copies."""
    return (C * FFN_STRIP * 2 + group * FFN_STRIP * (C // group + 8) * 2
            + FFN_ROWS * (C + 8) * 2 + 8 * FFN_ROWS * FFN_STRIP * 4
            + FFN_ROWS * (group * FFN_STRIP + 8) * 2 + 16)


def ffn_plan(N: int, C: int, F: int, sms: int) -> FfnPlan:
    """The kernel's plan for x [N, C] and an FFN width F on a card of
    `sms` multiprocessors, or ValueError for a shape it does not take."""
    _build.require(N >= 1 and C >= 64 and C % 64 == 0
                   and F >= FFN_STRIP and F % FFN_STRIP == 0,
                   f"decode_ffn_block: need N >= 1, C % 64 == 0 and"
                   f" F % {FFN_STRIP} == 0, got N={N}, C={C}, F={F}")
    blocks = F // FFN_STRIP
    # The largest group whose slice of the output is whole 16-column
    # steps of the kernel's second product.
    group = next(g for g in (8, 4, 2, 1)
                 if g <= MAX_GROUP and blocks % g == 0 and (C // g) % 16 == 0)
    smem = ffn_smem_bytes(C, group)
    _build.require(smem <= _build.MAX_SMEM_BYTES,
                   f"decode_ffn_block: C={C} needs {smem} bytes of shared"
                   f" memory a block, the card has {_build.MAX_SMEM_BYTES}")
    # Its blocks wait for one another, so all must be on the card: a
    # multiprocessor holds as many as fit in its 228 KB of shared memory
    # (1 KB of it a block is the system's).
    resident = sms * min(8, (228 * 1024) // (smem + 1024))
    _build.require(blocks <= resident,
                   f"decode_ffn_block: F={F} needs {blocks} blocks on the"
                   f" card at once, it holds {resident}")
    return FfnPlan(FFN_STRIP, blocks, -(-N // FFN_ROWS), group,
                   blocks // group, C // group, smem)


def _launch_ffn(x, w1, b1, w2, b2):
    N, C = x.shape
    F = w1.shape[1]
    _check_inputs("decode_ffn_block", (x, w1, b1, w2, b2),
                  [(N, C), (C, F), (F,), (F, C), (C,)])
    _build.require(all(t.data_ptr() % 16 == 0 for t in (x, w1, w2, b2)),
                   "decode_ffn_block: x, w1, w2 and b2 must be 16-byte"
                   " aligned")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = ffn_plan(N, C, F, sms)
    fn = _build.function("nic_decode_ffn_block", _FFN_ARGTYPES)
    counters = _ffn_counters.get(x.device)
    if counters is None or counters.numel() < 1 + 2 * (plan.groups
                                                       + plan.group):
        counters = torch.zeros(1 + 2 * max(plan.groups + plan.group, 64),
                               device=x.device, dtype=torch.int32)
        _ffn_counters[x.device] = counters
    slots = (counters.numel() - 1) // 2
    y = torch.empty_like(x)
    hbuf = torch.empty(FFN_ROWS, F, device=x.device, dtype=x.dtype)
    ws = torch.empty(plan.groups * FFN_ROWS * C, device=x.device,
                     dtype=torch.float32)
    for r0 in range(0, N, FFN_ROWS):
        rows = min(FFN_ROWS, N - r0)
        _build.check(fn(x[r0:].data_ptr(), w1.data_ptr(), b1.data_ptr(),
                        w2.data_ptr(), b2.data_ptr(), y[r0:].data_ptr(),
                        hbuf.data_ptr(), ws.data_ptr(), counters.data_ptr(),
                        slots, rows, C, F, plan.group, plan.smem_bytes,
                        _build.stream_of(x)),
                     "decode_ffn_block")
        decode_ffn_block.launches += 1
    return y


decode_conv_block.launches = 0
decode_ffn_block.launches = 0
