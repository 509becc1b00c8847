"""Causal dynamic depthwise convolution over a whole sequence, forward
only.

Kernel: `csrc/dynamic_conv.cu` (`nic_dynamic_conv_fwd`), replacing the
TPU kernel `news_image_caption_tpu/ops/pallas_kernels.py::
dynamic_conv_pallas`. Its floor is one read of x and the taps and one
write of the output (10.3-12.4 us at the flagship's B=16, T=512, C=1024,
H=16, K = 3-31 in bf16). One block of four warps per (batch item,
segment of one or two tiles of 4 M rows, chunk of 64 channels) issues every
copy of its segment at once, one `cp.async` group a tile: the x window,
and each row's taps as the 4-byte words of w that hold them; a lane
owns a channel pair and M rows of each tile. At K = 3, 7, 15, 31 K and
M = 16 are template parameters: a tile's taps are converted to fp32
float4 rows in shared memory, and a lane keeps its M + K - 1 x values in
registers; every other K, and an odd R, take a generic instantiation.
`dynamic_conv_plan` is that launch plan, chosen here and checked by the
kernel; `admits` which shapes and types the kernel takes, the launch's
one check of them. The launch also needs contiguous inputs, x aligned to
a channel pair and w to 4 bytes; x moves as 16-byte lines only where it
is 16-byte aligned.
At the flagship it takes 0.022-0.041 ms a width, 47-31% of the floor
(PERF.md §6).

Numerics are the TPU kernel's (pallas_kernels.py:59-67): every product
and the running sum in fp32, taps in order k = 0 .. K-1, one rounding
to x's dtype. That is not the shift route of `ops/conv.py`, which
accumulates in x's dtype and so rounds K times in bf16. The kernel
fuses each tap's product and sum (one fmaf), where the plain version
rounds them apart: the two agree within `dynamic_conv_tolerance`, d =
(2K + 1) 2^-24 sum_k |w x| plus one unit in the last place of x's dtype.
In bf16 a product of two inputs is exact in fp32, so there the kernel
equals the plain version bit for bit.

The reference kernel has no gradient; `dynamic_conv_autograd` carries
that over: its backward raises.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from news_image_caption_tpu_torch.ops import _build

MAX_TAPS = 31
CHUNK = 64                    # channels a block: a warp's 32 lanes, a pair each
WARPS = 4                     # row groups a block, one warp each
FIXED_TAPS = (3, 7, 15, 31)   # K as a template parameter (the flagship's layers)
FIXED_ROWS = 16               # rows a thread in those instantiations
SEGMENT = 2                   # the most tiles a block walks
SMEM_BUDGET = 48 * 1024       # a block's shared memory, no opt-in
_ARGTYPES = [_build.P] * 3 + [_build.I] * 16 + [_build.P]
_ELEM_BYTES = {torch.bfloat16: 2, torch.float32: 4}


class DynamicConvPlan(NamedTuple):
    """How the kernel cuts a call: grid (segments of T, channel chunks,
    B) of blocks of `WARPS` warps; a block walks `tiles` tiles of
    `tile_rows` rows over `channels` channels, a thread one channel pair
    and `rows_per_thread` consecutive rows of each; the block stages its
    segment's taps as they lie in w, `raw_slots` 4-byte words a row, and
    (K templated) a tile's taps as [tile_rows][head_slots][tap_slots]
    fp32; x rows move as 16-byte `lines` (C * element size a multiple
    of 16 and x 16-byte aligned) or as pairs; `instance` is K where K is
    a template parameter, else 0."""

    tile_rows: int
    rows_per_thread: int
    tiles: int
    channels: int
    head_slots: int
    tap_slots: int
    raw_slots: int
    lines: bool
    smem_bytes: int
    grid: Tuple[int, int, int]
    instance: int


def admits(dtype, B: int, T: int, C: int, H: int, K: int) -> Tuple[bool, str]:
    """Whether the kernel takes x [B, T, C] and taps [B, T, H, K] of
    `dtype`, and if not, why."""
    if dtype not in _ELEM_BYTES:
        return False, "dynamic_conv kernel takes x and w both bf16 or both fp32"
    if not (T >= 1 and 1 <= K <= MAX_TAPS and H >= 1 and C % H == 0
            and C % 2 == 0):
        return False, (f"dynamic_conv: need T >= 1, 1 <= K <= {MAX_TAPS}, C"
                       " even and C % H == 0")
    if not 1 <= B <= 65535:
        return False, f"dynamic_conv: need 1 <= B <= 65535, got B={B}"
    return True, ""


def _pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def heads_touched(C: int, R: int) -> int:
    """The most heads one chunk of `CHUNK` channels touches."""
    return max((min(c0 + CHUNK, C) - 1) // R - c0 // R + 1
               for c0 in range(0, C, CHUNK))


def dynamic_conv_smem_bytes(tile_rows: int, tiles: int, K: int,
                            head_slots: int, tap_slots: int, raw_slots: int,
                            elem_bytes: int, fp32_taps: bool) -> int:
    """A block's shared memory (csrc/dynamic_conv.cu::dc_smem_bytes): the
    segment's x window [tiles * tile_rows + K - 1][CHUNK], its taps as
    they lie in w, then (`fp32_taps`) one tile's fp32 taps."""
    seg = tiles * tile_rows
    return ((seg + K - 1) * CHUNK * elem_bytes + seg * raw_slots * 4
            + (tile_rows * head_slots * tap_slots * 4 if fp32_taps else 0))


def dynamic_conv_plan(B: int, T: int, C: int, H: int, K: int, dtype,
                      sms: int = 132, x_aligned: bool = True
                      ) -> DynamicConvPlan:
    """The kernel's plan for x [B, T, C], taps [B, T, H, K] of `dtype`
    on a card of `sms` multiprocessors, x 16-byte aligned or not
    (`x_aligned`), or ValueError for a shape it does not take. K in
    `FIXED_TAPS` with R even takes its own instantiation, 16 rows a
    thread, where that fits the budget; everything else the generic
    one, with the most rows a thread (16, 8, .. 1) that fits. A block
    walks `SEGMENT` tiles (the second tile's copies in flight under the
    first tile's sums) where T needs them, they fit and the grid keeps
    at least `sms` blocks, else one. Four tiles measured 4% faster at
    K=3 and 7% slower at K=7 than two (PERF.md §6)."""
    ok, why = admits(dtype, B, T, C, H, K)
    _build.require(ok, why)
    es = _ELEM_BYTES[dtype]
    touched = heads_touched(C, C // H)
    heads, taps = _pow2(touched), max(4, _pow2(K))
    raw = _pow2(-(-(touched * K + 1) * es // 4))
    fixed = K in FIXED_TAPS and (C // H) % 2 == 0
    chunks = -(-C // CHUNK)

    def fits(rows, n, templated):
        return dynamic_conv_smem_bytes(WARPS * rows, n, K, heads, taps, raw,
                                       es, templated) <= SMEM_BUDGET

    # The generic kernel at one row a thread and one tile always fits: 4
    # rows of the words of 64 heads of 31 taps (16 KB) and a window of 34
    # rows.
    rows, templated = next(
        (r, t) for t, sizes in ((True, (FIXED_ROWS,) if fixed else ()),
                                (False, (16, 8, 4, 2, 1)))
        for r in sizes if fits(r, 1, t))
    tile = WARPS * rows
    tiles = (SEGMENT if T > tile and fits(rows, SEGMENT, templated)
             and -(-T // (SEGMENT * tile)) * chunks * B >= sms else 1)
    return DynamicConvPlan(
        tile, rows, tiles, CHUNK, heads, taps, raw,
        (C * es) % 16 == 0 and x_aligned,
        dynamic_conv_smem_bytes(tile, tiles, K, heads, taps, raw, es,
                                templated),
        (-(-T // (tiles * tile)), chunks, B),
        K if templated else 0)


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


def dynamic_conv_tolerance(x: torch.Tensor, w: torch.Tensor,
                           num_heads: int) -> torch.Tensor:
    """How far the kernel's output may lie from `dynamic_conv_plain`'s,
    elementwise: the kernel fuses each tap's product and sum, so its
    fp32 sum differs by at most d = (2K + 1) 2^-24 sum_k |w x|, and the
    two roundings to x's dtype by at most one unit in the last place of
    the larger sum, under 2^-m (|plain| (1 + 2^-m) + d) for m mantissa
    bits."""
    K = w.shape[-1]
    want = dynamic_conv_plain(x, w, num_heads).float().abs()
    mass = dynamic_conv_plain(x.float().abs(), w.float().abs(), num_heads)
    d = (2 * K + 1) * 2.0 ** -24 * mass
    rel = torch.finfo(x.dtype).eps          # 2^-m
    return d + rel * (want * (1 + rel) + d)


def dynamic_conv(x: torch.Tensor, w: torch.Tensor,
                 num_heads: int) -> torch.Tensor:
    """See `dynamic_conv_plain`. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises."""
    if x.device.type == "cpu":
        return dynamic_conv_plain(x, w, num_heads)
    _build.require(x.device.type == "cuda",
                   f"dynamic_conv: no kernel for device {x.device}")
    return _launch(x, w, num_heads)


def _launch(x, w, H):
    B, T, C = x.shape
    K = w.shape[-1]
    _build.require(w.dtype == x.dtype,
                   "dynamic_conv kernel takes x and w both bf16 or both fp32")
    ok, why = admits(x.dtype, B, T, C, H, K)
    _build.require(ok, why)
    _build.require(tuple(w.shape) == (B, T, H, K),
                   f"dynamic_conv: w {tuple(w.shape)}, expected [B, T, H, K]"
                   f" with B, T = {B}, {T} and H = {H}")
    es = _ELEM_BYTES[x.dtype]
    _build.require(x.is_contiguous() and w.is_contiguous()
                   and w.device == x.device and x.data_ptr() % (2 * es) == 0
                   and w.data_ptr() % 4 == 0,
                   "dynamic_conv: inputs must be contiguous, on one device,"
                   " x aligned to a channel pair and w to 4 bytes")
    plan = dynamic_conv_plan(B, T, C, H, K, x.dtype, _build.sms_of(x.device),
                             x.data_ptr() % 16 == 0)
    out = torch.empty_like(x)
    fn = _build.function("nic_dynamic_conv_fwd", _ARGTYPES)
    _build.check(fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), B, T, C, H,
                    K, es, plan.tile_rows,
                    plan.rows_per_thread, plan.tiles, plan.channels,
                    plan.head_slots, plan.tap_slots, plan.raw_slots,
                    int(plan.lines), plan.smem_bytes, plan.instance,
                    _build.stream_of(x)),
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
