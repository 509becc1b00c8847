"""Fused decode-step blocks of the dynamic-conv decoder layer.

Kernels: `csrc/decode_blocks.cu` and `csrc/decode_ffn.cu`, replacing
the TPU kernels `news_image_caption_tpu/ops/pallas_decode.py::
decode_conv_block` and `::decode_ffn_block`. At decode batch sizes both
are bound by one read of their weights per step (6.5 MB for the conv
block, 16.8 MB for the FFN, bf16, per flagship layer). Both are one
cooperative launch (the conv block for up to 128 rows, which every stage
walks in tiles of 16; the FFN for up to 16) designed for the H100: every
block requests all its weights at entry and multiplies on the tensor
cores. The conv block's C / 16 blocks own 16 channels each through
linear1, the GLU, the ring combine and linear2, compute their head's tap
weights, and wait for one another twice (h, then the conv output, pass
through device memory); where the card holds them, several such sets of
blocks share the row tiles; `conv_block_plan` is its host-side plan and
`pack_taps` the layout its tap predictor wants. The FFN's blocks own 32
columns of w1 and a piece of w2; groups of 8 blocks share their strips
of h, and the groups' partial outputs are added in a fixed order (see
the sources); `ffn_plan` is its plan. `admits_conv` and `admits_ffn`
say what the kernels take.

Under tensor parallelism a rank holds F / m columns of the FFN's w1 and
the same rows of w2, so its second product is a partial sum:
`decode_ffn_block(..., reduce=)` runs the kernel's partial mode, which
stops after adding its groups' fp32 partials and writes that sum
(`decode_ffn_block_partial`), hands it to `reduce` (the psum over the
model ranks) and applies b2 and the residual at the whole kernel's
rounding points (`ffn_epilogue`); at one rank that is the whole kernel
bit for bit.

The generic variants (`csrc/decode_generic.cu`, `decode_conv_block_generic`
and `decode_ffn_block_generic`) take bf16 or fp32 at any C and F, K from
1 to 32 and any head size, with FFMA and fp32 sums. Their products are
one kernel each (`generic_product_plan`): a block owns a strip of output
columns over all the call's rows (row tiles only past 80), the weights
read once; where the strips leave the card short of blocks the depth is
split, and the last split of a strip to arrive adds the splits in order
(one counter a strip, `GENERIC_COUNTERS` a device, zeroed once and kept
by the kernel). The conv block is linear1 with the GLU, the tap logits
h wl, their softmax with the ring combine (at K = 1 the ring is never
read) and linear2. `route_conv` and `route_ffn` are the one
predicate each wrapper chooses by: "fast" where `admits_conv` /
`admits_ffn` hold, else "generic" where `admits_conv_generic` /
`admits_ffn_generic` hold, else ValueError with both reasons. The
FFN's partial mode takes the same route; its generic launches count on
`decode_ffn_block_generic`.

The plain versions keep the reference kernels' bf16 rounding points
(pallas_decode.py:47-101 and :111-129): every product accumulates in
fp32 and is rounded to the working dtype where the reference rounds.
In fp32 the roundings are no-ops.
"""

from __future__ import annotations

from fractions import Fraction
from typing import NamedTuple, Optional, Tuple

import torch

from news_image_caption_tpu_torch.ops import _build

MAX_TAPS = 32
_CONV_ARGTYPES = [_build.P] * 12 + [_build.I] * 9 + [_build.P]
_FFN_ARGTYPES = [_build.P] * 9 + [_build.I] * 6 + [_build.P, _build.P]
_CONV_GENERIC_ARGTYPES = [_build.I] + [_build.P] * 14 + [_build.I] * 11 \
    + [_build.P]
_FFN_GENERIC_ARGTYPES = [_build.I] + [_build.P] * 10 + [_build.I] * 7 \
    + [_build.P]
# The generic kernels' products (csrc/decode_generic.cu::product_kernel):
# the columns of a tile, the tiles (rows, columns, slots of the ring) by
# code, the depth a chunk, the blocks the card runs at once, the least
# depth a split, the strips below which a product takes 16-row tiles,
# and the counters of the splits' arrivals a device.
GENERIC_COLS = 64
GENERIC_TILES = ((16, GENERIC_COLS, 8), (32, GENERIC_COLS, 6),
                 (80, GENERIC_COLS, 6))
GENERIC_DEPTH = 32
GENERIC_BLOCKS, GENERIC_MIN_SPLIT = _build.H100_SMS, 128
GENERIC_NARROW, GENERIC_COUNTERS = 16, 256
_generic_counters: dict = {}
# The conv block kernel: channels a block, rows of x a tile (the tensor
# cores' 16-row operand), rows a launch.
CONV_STRIP, CONV_ROWS, CONV_MAX_ROWS = 16, 16, 128
# The FFN kernel: columns of w1 a block, rows of x a launch, the largest
# group of blocks that share h.
FFN_STRIP, FFN_ROWS, MAX_GROUP = 32, 16, 8
# Counters of the kernels' barriers between blocks, one tensor a kernel
# and device: a count of launches and two sets of `slots` counters,
# zeroed here once and then kept by the kernel. Calls on one device share
# them, so they must follow one another (one stream). The conv block's
# scratch (its conv output, [128, C]) is kept per (device, C) beside them.
_ffn_counters: dict = {}
_conv_counters: dict = {}
_conv_scratch: dict = {}
# Shared memory of a multiprocessor (228 KB), of which the card keeps
# 1 KB a block: how many blocks of a cooperative launch fit on the card.
_SM_SMEM_BYTES, _BLOCK_RESERVED_BYTES = 228 * 1024, 1024


def _resident_blocks(smem: int, sms: int) -> int:
    return sms * min(8, _SM_SMEM_BYTES // (smem + _BLOCK_RESERVED_BYTES))


def _rounder(dtype):
    return lambda t: t.to(dtype).float()


def ring_slots(t, Km1: int, N: int, device) -> torch.Tensor:
    """[K-1, N] ring slot of each tap and row, oldest first: slot (p + k)
    mod (K-1) for tap k of a row at position p, the one step index t (an
    int) or each row's own (an [N] tensor)."""
    k = torch.arange(Km1, device=device)
    if isinstance(t, torch.Tensor):
        return (t.long().to(device)[None, :] + k[:, None]) % Km1
    return ((t + k) % Km1)[:, None].expand(Km1, N)


def decode_conv_block_plain(x, cache, t, w1, b1, wl, w2, b2,
                            num_heads: int):
    """One conv-block decode step, in plain PyTorch.

    x [N, C]; cache [K-1, N, C] ring-major (slot s mod (K-1) holds the
    GLU row of step s, zeros before the sequence start); t the step
    index of every row (an int), or each row's position (an int32 [N]
    tensor); w1 [C, 2C], b1 [2C] and w2 [C, C], b2 [C] with weight norm
    folded; wl [C, H*K] the tap predictor, head-major (column h*K + k).
    Returns (y [N, C], the conv output + linear2 + residual before the
    LayerNorm; h [N, C], the GLU row the caller writes into the row's
    slot t mod (K-1)).
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
    if Km1 > 0:
        rows = torch.arange(N, device=x.device)[None, :]
        slots = ring_slots(t, Km1, N, x.device)
        hist = cache.float()[slots, rows].view(Km1, N, H, C // H)
        acc = torch.einsum("nhk,knhr->nhr", p[:, :, :Km1],
                           hist).reshape(N, C)
    else:
        acc = torch.zeros_like(h)
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


def decode_ffn_block_partial_plain(x, w1, b1, w2):
    """The fp32 sum relu(x w1 + b1) w2 before b2, the residual and the
    last roundings: the partial mode's output, in plain PyTorch."""
    r = _rounder(x.dtype)
    h = torch.relu(r(r(x.float() @ w1.float()) + b1.float()))
    return h @ w2.float()


def ffn_epilogue(s: torch.Tensor, b2: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """y from the fp32 sum s of the FFN's second product, at the whole
    kernel's rounding points: rbf(rbf(rbf(s) + b2) + x)."""
    r = _rounder(x.dtype)
    return r(r(r(s) + b2.float()) + x.float()).to(x.dtype)


def pack_taps(wl: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The tap predictor wl [C, H*K] (head-major) as the kernel reads
    it: [H, kp, C] with the K taps of a head padded with zeros to kp = 8,
    16 or 32, so a head's taps are contiguous, 16-byte aligned rows.
    Computed once a model load."""
    C = wl.shape[0]
    K = wl.shape[1] // num_heads
    kp = _padded_taps(K)
    out = torch.zeros(num_heads, kp, C, device=wl.device, dtype=wl.dtype)
    out[:, :K] = wl.view(C, num_heads, K).permute(1, 2, 0)
    return out


def _padded_taps(K: int) -> int:
    return 8 if K <= 8 else 16 if K <= 16 else 32


def decode_conv_block(x, cache, t, w1, b1, wl, w2, b2,
                      num_heads: int, taps: Optional[torch.Tensor] = None):
    """See `decode_conv_block_plain`. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises. `taps` is
    `pack_taps(wl, num_heads)` where the caller has it (the model packs
    it once a load); without it the kernel path packs wl every call. On
    the card, positions `t` given as a tensor stay there: the kernel
    reads them (int32 [N], contiguous)."""
    if x.device.type == "cpu":
        return decode_conv_block_plain(x, cache, t, w1, b1, wl, w2, b2,
                                       num_heads)
    _build.require(x.device.type == "cuda",
                   f"decode_conv_block: no kernel for device {x.device}")
    if not isinstance(t, torch.Tensor):
        t = int(t)
    N, C = x.shape
    if route_conv(x.dtype, N, C, num_heads, wl.shape[1] // num_heads,
                  _build.sms_of(x.device)) == "fast":
        return _launch_conv(x, cache, t, w1, b1, wl, w2, b2, num_heads, taps)
    return _launch_conv_generic(x, cache, t, w1, b1, wl, w2, b2, num_heads,
                                taps)


def decode_conv_block_generic(x, cache, t, w1, b1, wl, w2, b2,
                              num_heads: int,
                              taps: Optional[torch.Tensor] = None):
    """`decode_conv_block` through the generic kernel alone. A CPU
    tensor takes the plain version; a CUDA tensor launches the generic
    kernel or raises."""
    if x.device.type == "cpu":
        return decode_conv_block_plain(x, cache, t, w1, b1, wl, w2, b2,
                                       num_heads)
    _build.require(x.device.type == "cuda",
                   f"decode_conv_block: no kernel for device {x.device}")
    if not isinstance(t, torch.Tensor):
        t = int(t)
    return _launch_conv_generic(x, cache, t, w1, b1, wl, w2, b2, num_heads,
                                taps)


def decode_ffn_block_generic(x, w1, b1, w2, b2):
    """`decode_ffn_block` through the generic kernel alone; b2 None for
    the partial mode's fp32 sums (`decode_ffn_block_partial_plain`). A
    CPU tensor takes the plain version; a CUDA tensor launches the
    generic kernel or raises."""
    if x.device.type == "cpu":
        return (decode_ffn_block_partial_plain(x, w1, b1, w2) if b2 is None
                else decode_ffn_block_plain(x, w1, b1, w2, b2))
    _build.require(x.device.type == "cuda",
                   f"decode_ffn_block: no kernel for device {x.device}")
    return _launch_ffn_generic(x, w1, b1, w2, b2)


def decode_ffn_block(x, w1, b1, w2, b2, reduce=None):
    """See `decode_ffn_block_plain`. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises. reduce: for a
    model rank's columns of w1 and rows of w2, the sum over the ranks of
    the fp32 partials (`decode_ffn_block_partial`), after which b2 and x
    are added here (`ffn_epilogue`)."""
    if reduce is not None:
        return ffn_epilogue(reduce(decode_ffn_block_partial(x, w1, b1, w2)),
                            b2, x)
    if x.device.type == "cpu":
        return decode_ffn_block_plain(x, w1, b1, w2, b2)
    _build.require(x.device.type == "cuda",
                   f"decode_ffn_block: no kernel for device {x.device}")
    return _launch_ffn_routed(x, w1, b1, w2, b2)


def decode_ffn_block_partial(x, w1, b1, w2):
    """See `decode_ffn_block_partial_plain`: fp32 [N, C]. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel in its
    partial mode (counted in this wrapper's `launches`) or raises."""
    if x.device.type == "cpu":
        return decode_ffn_block_partial_plain(x, w1, b1, w2)
    _build.require(x.device.type == "cuda",
                   f"decode_ffn_block: no kernel for device {x.device}")
    return _launch_ffn_routed(x, w1, b1, w2, None)


def _launch_ffn_routed(x, w1, b1, w2, b2):
    N, C = x.shape
    if route_ffn(x.dtype, N, C, w1.shape[1],
                 _build.sms_of(x.device)) == "fast":
        return _launch_ffn(x, w1, b1, w2, b2)
    return _launch_ffn_generic(x, w1, b1, w2, b2)


def _check_inputs(name, tensors, shapes):
    x = tensors[0]
    _build.require(all(t.dtype == x.dtype for t in tensors),
                   f"{name}: inputs of one dtype, got"
                   f" {[t.dtype for t in tensors]}")
    _build.require(all(tuple(t.shape) == s for t, s in zip(tensors, shapes)),
                   f"{name}: shapes {[tuple(t.shape) for t in tensors]},"
                   f" expected {shapes}")
    _build.require(all(t.is_contiguous() and t.device == x.device
                       for t in tensors),
                   f"{name}: inputs must be contiguous, on one device")


class ConvBlockPlan(NamedTuple):
    """How `decode_conv_block`'s kernel cuts its work: block s of
    `blocks` owns channels [s * strip, (s + 1) * strip) of linear1 (its
    `a` and `g` columns), of the ring combine and of linear2, all in one
    head, whose `taps` (K padded to 8, 16 or 32) it computes with the
    other `blocks_per_head - 1` blocks of that head. A launch takes up to
    128 rows in `row_tiles` tiles of 16, which every stage walks over the
    weights in shared memory; `groups` such sets of blocks, as many as the
    card holds at once, share the tiles (group g takes tiles g, g +
    groups, ...). More rows go through `launches` launches."""

    strip: int
    blocks: int
    launches: int
    row_tiles: int
    groups: int
    taps: int
    blocks_per_head: int
    smem_bytes: int


def conv_block_smem_bytes(C: int, taps: int) -> int:
    """Dynamic shared memory of a block (csrc/decode_blocks.cu::
    conv_block_smem_bytes): the w1 strip (a and g columns), the w2
    strip, the activations (rows padded by 8 elements), the head's taps,
    the warps' parts of a product, the block's ring rows, the tap
    weights, the barrier of the taps' copies."""
    return (C * 2 * CONV_STRIP * 2 + C * CONV_STRIP * 2
            + CONV_ROWS * (C + 8) * 2 + taps * (C + 8) * 2
            + 8 * CONV_ROWS * 8 * 4 + taps * CONV_ROWS * CONV_STRIP * 2
            + CONV_ROWS * MAX_TAPS * 4 + 16)


def admits_conv(dtype, N: int, C: int, H: int, K: int,
                sms: int = _build.H100_SMS) -> Tuple[bool, str]:
    """Whether `decode_conv_block`'s kernel takes x [N, C] of `dtype`
    with H heads and K taps on a card of `sms` multiprocessors, and if
    not, why."""
    if dtype != torch.bfloat16:
        return False, "decode_conv_block kernel takes bf16 inputs"
    if not (N >= 1 and 2 <= K <= MAX_TAPS and H >= 1 and C >= CONV_STRIP
            and C % CONV_STRIP == 0 and C % H == 0
            and (C // H) % CONV_STRIP == 0):
        return False, (f"decode_conv_block: need N >= 1, 2 <= K <= {MAX_TAPS},"
                       f" C % {CONV_STRIP} == 0 and a head size C / H that is"
                       f" a multiple of {CONV_STRIP}, got N={N}, C={C}, H={H},"
                       f" K={K}")
    smem = conv_block_smem_bytes(C, _padded_taps(K))
    if smem > _build.MAX_SMEM_BYTES:
        return False, (f"decode_conv_block: C={C} needs {smem} bytes of shared"
                       f" memory a block, the card has {_build.MAX_SMEM_BYTES}")
    resident = _resident_blocks(smem, sms)
    if C // CONV_STRIP > resident:
        return False, (f"decode_conv_block: C={C} needs {C // CONV_STRIP}"
                       f" blocks on the card at once, it holds {resident}")
    return True, ""


def admits_conv_generic(dtype, N: int, C: int, H: int,
                        K: int) -> Tuple[bool, str]:
    """Whether the generic conv block kernel takes x [N, C] of `dtype`
    with H heads and K taps, and if not, why."""
    if dtype not in _build.GENERIC_DTYPES:
        return False, "decode_conv_block generic kernel takes bf16 or fp32"
    if not (N >= 1 and 1 <= K <= MAX_TAPS and H >= 1 and C >= 1
            and C % H == 0):
        return False, (f"decode_conv_block generic: need N >= 1, 1 <= K <="
                       f" {MAX_TAPS} and C % H == 0, got N={N}, C={C}, H={H},"
                       f" K={K}")
    return True, ""


def route_conv(dtype, N: int, C: int, H: int, K: int,
               sms: int = _build.H100_SMS) -> str:
    """"fast" (`decode_conv_block`'s kernel) where `admits_conv` holds,
    else "generic" where `admits_conv_generic` holds; ValueError with
    both reasons otherwise."""
    ok, why = admits_conv(dtype, N, C, H, K, sms)
    if ok:
        return "fast"
    ok, why_generic = admits_conv_generic(dtype, N, C, H, K)
    _build.require(ok, f"{why}; {why_generic}")
    return "generic"


def admits_ffn_generic(dtype, N: int, C: int, F: int) -> Tuple[bool, str]:
    """Whether the generic FFN kernel takes x [N, C] of `dtype` and an FFN
    width F, and if not, why."""
    if dtype not in _build.GENERIC_DTYPES:
        return False, "decode_ffn_block generic kernel takes bf16 or fp32"
    if not (N >= 1 and C >= 1 and F >= 1):
        return False, (f"decode_ffn_block generic: need N, C, F >= 1, got"
                       f" N={N}, C={C}, F={F}")
    return True, ""


def route_ffn(dtype, N: int, C: int, F: int,
              sms: int = _build.H100_SMS) -> str:
    """"fast" (`decode_ffn_block`'s kernel) where `admits_ffn` holds,
    else "generic" where `admits_ffn_generic` holds; ValueError with
    both reasons otherwise."""
    ok, why = admits_ffn(dtype, N, C, F, sms)
    if ok:
        return "fast"
    ok, why_generic = admits_ffn_generic(dtype, N, C, F)
    _build.require(ok, f"{why}; {why_generic}")
    return "generic"


class ProductPlan(NamedTuple):
    """How a generic product cuts its work: block (s, r, z) of the grid
    (strips, row_tiles, splits) owns output columns [s * strip_cols, (s +
    1) * strip_cols) of rows [r * rows, (r + 1) * rows) over the depth
    [z * ksplit, (z + 1) * ksplit), in a tile of `tile` (a code of
    GENERIC_TILES: `rows` x `cols`; the GLU's tile holds a strip's a and
    g columns, `cols` / 2 each). Where the depth is split, `part_floats`
    of fp32 scratch hold the splits' tiles and `counters` counters their
    arrivals."""

    tile: int
    rows: int
    cols: int
    strip_cols: int
    strips: int
    row_tiles: int
    ksplit: int
    splits: int
    part_floats: int
    counters: int
    smem_bytes: int


def generic_tile_smem_bytes(rows: int, cols: int, stages: int) -> int:
    """Dynamic shared memory of a product block (csrc/decode_generic.cu::
    ProdTile::SMEM): the ring's `stages` slots of an A chunk [rows][32 +
    4] and a B chunk [32][cols], fp32."""
    return 4 * stages * (rows * (GENERIC_DEPTH + 4) + GENERIC_DEPTH * cols)


def generic_product_plan(M: int, depth: int, width: int,
                         glu: bool = False) -> ProductPlan:
    """The plan of a generic product of M rows, `depth` and `width`
    output columns (fc1, fc2, the tap logits, linear2; with `glu`
    linear1, whose tile holds a strip's a and g columns). Rows a tile:
    16, 32 or 80 (row tiles past 80; 16 where the product has fewer
    than GENERIC_NARROW strips), 64 columns; where the tiles are fewer
    than GENERIC_BLOCKS (the blocks the card runs at once), the depth
    split into whole chunks of at least GENERIC_MIN_SPLIT where that
    spreads the work over the multiprocessors more evenly."""
    _build.require(M >= 1 and depth >= 1 and width >= 1,
                   f"generic product: need M, depth, width >= 1, got M={M},"
                   f" depth={depth}, width={width}")
    strip_cols = GENERIC_COLS // 2 if glu else GENERIC_COLS
    strips = -(-width // strip_cols)
    # A narrow product (the tap logits) takes 16-row tiles, for blocks.
    tile = 0 if M <= 16 or strips < GENERIC_NARROW else 1 if M <= 32 else 2
    rows, cols, stages = GENERIC_TILES[tile]
    row_tiles = -(-M // rows)
    base = strips * row_tiles
    # Where the tiles leave the card short of blocks, the fewest splits
    # that give the busiest multiprocessor the least work: waves of
    # GENERIC_BLOCKS blocks, ceil(base s / GENERIC_BLOCKS) blocks of 1 / s
    # of a strip's depth on it.
    most = max(1, -(-depth // GENERIC_MIN_SPLIT)) if base < GENERIC_BLOCKS \
        else 1
    splits = min(range(1, most + 1),
                 key=lambda s: (Fraction(-(-base * s // GENERIC_BLOCKS), s),
                                s))
    ksplit = -(-(-(-depth // splits)) // GENERIC_DEPTH) * GENERIC_DEPTH
    splits = -(-depth // ksplit)
    split = splits > 1
    return ProductPlan(tile, rows, cols, strip_cols, strips, row_tiles,
                       ksplit, splits,
                       splits * row_tiles * strips * rows * cols if split
                       else 0, row_tiles * strips if split else 0,
                       generic_tile_smem_bytes(rows, cols, stages))


def _generic_scratch(x, plans):
    """fp32 scratch for the splits' tiles of the plans (the largest any
    of them needs) and the device's arrival counters (None where no plan
    splits its depth)."""
    floats = max(p.part_floats for p in plans)
    if not floats:
        return None, None
    _build.require(max(p.counters for p in plans) <= GENERIC_COUNTERS,
                   f"generic product: more than {GENERIC_COUNTERS} split"
                   " strips")
    counters = _generic_counters.get(x.device)
    if counters is None:
        counters = _generic_counters[x.device] = torch.zeros(
            GENERIC_COUNTERS, device=x.device, dtype=torch.int32)
    return torch.empty(floats, device=x.device,
                       dtype=torch.float32), counters


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_conv_generic(x, cache, t, w1, b1, wl, w2, b2, num_heads, taps):
    """The generic kernel over x's rows. It reads the tap predictor wl
    itself; `taps` (the fast kernel's packing) is not used."""
    N, C = x.shape
    H = num_heads
    K = wl.shape[1] // H
    ok, why = admits_conv_generic(x.dtype, N, C, H, K)
    _build.require(ok, why)
    pos, t = _step_or_positions(t, x)
    _check_inputs("decode_conv_block", (x, cache, w1, b1, wl, w2, b2),
                  [(N, C), (K - 1, N, C), (C, 2 * C), (2 * C,), (C, H * K),
                   (C, C), (C,)])
    fn = _build.function("nic_decode_conv_block_generic",
                         _CONV_GENERIC_ARGTYPES)
    plans = (generic_product_plan(N, C, C, glu=True),
             generic_product_plan(N, C, H * K), generic_product_plan(N, C, C))
    h = torch.empty_like(x)
    y = torch.empty_like(x)
    hconv = torch.empty_like(x)
    logits = torch.empty(N, H * K, device=x.device, dtype=torch.float32)
    part, counters = _generic_scratch(x, plans)
    _build.check(fn(_build.GENERIC_DTYPES[x.dtype], x.data_ptr(),
                    cache.data_ptr() if K > 1 else None, _ptr(pos),
                    w1.data_ptr(), b1.data_ptr(), wl.data_ptr(),
                    w2.data_ptr(), b2.data_ptr(), h.data_ptr(),
                    logits.data_ptr(), hconv.data_ptr(), _ptr(part),
                    _ptr(counters), y.data_ptr(), N, C, H, K, t,
                    *(v for p in plans for v in (p.tile, p.ksplit)),
                    _build.stream_of(x)), "decode_conv_block generic")
    decode_conv_block_generic.launches += 1
    return y, h


def _launch_ffn_generic(x, w1, b1, w2, b2):
    """The generic kernel over x's rows; b2 None for the partial mode's
    fp32 sums."""
    N, C = x.shape
    F = w1.shape[1]
    ok, why = admits_ffn_generic(x.dtype, N, C, F)
    _build.require(ok, why)
    partial = b2 is None
    _check_inputs("decode_ffn_block", (x, w1, b1, w2) + (() if partial
                                                         else (b2,)),
                  [(N, C), (C, F), (F,), (F, C), (C,)])
    fn = _build.function("nic_decode_ffn_block_generic",
                         _FFN_GENERIC_ARGTYPES)
    plans = (generic_product_plan(N, C, F), generic_product_plan(N, F, C))
    h = torch.empty(N, F, device=x.device, dtype=x.dtype)
    y = torch.empty(N, C, device=x.device,
                    dtype=torch.float32 if partial else x.dtype)
    part, counters = _generic_scratch(x, plans)
    _build.check(fn(_build.GENERIC_DTYPES[x.dtype], x.data_ptr(),
                    w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                    _ptr(b2), h.data_ptr(), _ptr(part), _ptr(counters),
                    None if partial else y.data_ptr(),
                    y.data_ptr() if partial else None, N, C, F,
                    *(v for p in plans for v in (p.tile, p.ksplit)),
                    _build.stream_of(x)), "decode_ffn_block generic")
    decode_ffn_block_generic.launches += 1
    return y


def conv_block_plan(N: int, C: int, H: int, K: int, sms: int
                    ) -> ConvBlockPlan:
    """The kernel's plan for x [N, C], H heads and K taps on a card of
    `sms` multiprocessors, or ValueError for a shape it does not take."""
    ok, why = admits_conv(torch.bfloat16, N, C, H, K, sms)
    _build.require(ok, why)
    taps = _padded_taps(K)
    smem = conv_block_smem_bytes(C, taps)
    blocks = C // CONV_STRIP
    row_tiles = -(-min(N, CONV_MAX_ROWS) // CONV_ROWS)
    return ConvBlockPlan(CONV_STRIP, blocks, -(-N // CONV_MAX_ROWS),
                         row_tiles,
                         min(row_tiles, _resident_blocks(smem, sms) // blocks),
                         taps, C // H // CONV_STRIP, smem)


def _step_or_positions(t, x):
    """(positions, t) as both conv block kernels take them: (None, t) for
    one step index t >= 0 of every row, (pos, 0) for an int32 [N] tensor
    of each row's position, contiguous on x's device."""
    if not isinstance(t, torch.Tensor):
        _build.require(t >= 0, "decode_conv_block: need t >= 0")
        return None, t
    N = x.shape[0]
    _build.require(t.dtype == torch.int32 and tuple(t.shape) == (N,)
                   and t.is_contiguous() and t.device == x.device,
                   f"decode_conv_block: positions int32 [{N}] on"
                   f" {x.device}, contiguous, got {t.dtype}"
                   f" {tuple(t.shape)} on {t.device}")
    return t, 0


def _launch_conv(x, cache, t, w1, b1, wl, w2, b2, num_heads, taps):
    N, C = x.shape
    H = num_heads
    K = wl.shape[1] // H
    sms = _build.sms_of(x.device)
    ok, why = admits_conv(x.dtype, N, C, H, K, sms)
    _build.require(ok, why)
    pos, t = _step_or_positions(t, x)
    plan = conv_block_plan(N, C, H, K, sms)
    if taps is None:
        taps = pack_taps(wl, H)
    _check_inputs("decode_conv_block", (x, cache, w1, b1, wl, w2, b2, taps),
                  [(N, C), (K - 1, N, C), (C, 2 * C), (2 * C,), (C, H * K),
                   (C, C), (C,), (H, plan.taps, C)])
    _build.require(all(a.data_ptr() % 16 == 0
                       for a in (x, cache, w1, w2, taps)),
                   "decode_conv_block: x, cache, w1, w2 and taps must be"
                   " 16-byte aligned")
    fn = _build.function("nic_decode_conv_block", _CONV_ARGTYPES)
    counters = _conv_counters.get(x.device)
    if counters is None:
        counters = _conv_counters[x.device] = torch.zeros(
            5, device=x.device, dtype=torch.int32)
    hconv = _conv_scratch.get((x.device, C))
    if hconv is None:
        hconv = _conv_scratch[(x.device, C)] = torch.empty(
            CONV_MAX_ROWS, C, device=x.device, dtype=x.dtype)
    h = torch.empty_like(x)
    y = torch.empty_like(x)
    for r0 in range(0, N, CONV_MAX_ROWS):
        rows = min(CONV_MAX_ROWS, N - r0)
        groups = min(plan.groups, -(-rows // CONV_ROWS))
        _build.check(fn(x[r0:].data_ptr(), cache[:, r0:].data_ptr(),
                        w1.data_ptr(), b1.data_ptr(), taps.data_ptr(),
                        w2.data_ptr(), b2.data_ptr(), h[r0:].data_ptr(),
                        hconv.data_ptr(), y[r0:].data_ptr(),
                        counters.data_ptr(),
                        None if pos is None else pos[r0:].data_ptr(),
                        rows, N, C, H, K, plan.taps, t,
                        groups, plan.smem_bytes, _build.stream_of(x)),
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


def _ffn_group(C: int, F: int) -> int:
    """The largest group whose slice of the output is whole 16-column
    steps of the kernel's second product."""
    blocks = F // FFN_STRIP
    return next(g for g in (8, 4, 2, 1)
                if g <= MAX_GROUP and blocks % g == 0 and (C // g) % 16 == 0)


def admits_ffn(dtype, N: int, C: int, F: int,
               sms: int = _build.H100_SMS) -> Tuple[bool, str]:
    """Whether `decode_ffn_block`'s kernel takes x [N, C] of `dtype` and
    an FFN width F on a card of `sms` multiprocessors, and if not, why."""
    if dtype != torch.bfloat16:
        return False, "decode_ffn_block kernel takes bf16 inputs"
    if not (N >= 1 and C >= 64 and C % 64 == 0 and F >= FFN_STRIP
            and F % FFN_STRIP == 0):
        return False, (f"decode_ffn_block: need N >= 1, C % 64 == 0 and"
                       f" F % {FFN_STRIP} == 0, got N={N}, C={C}, F={F}")
    smem = ffn_smem_bytes(C, _ffn_group(C, F))
    if smem > _build.MAX_SMEM_BYTES:
        return False, (f"decode_ffn_block: C={C} needs {smem} bytes of shared"
                       f" memory a block, the card has {_build.MAX_SMEM_BYTES}")
    # Its blocks wait for one another, so all must be on the card.
    resident = _resident_blocks(smem, sms)
    if F // FFN_STRIP > resident:
        return False, (f"decode_ffn_block: F={F} needs {F // FFN_STRIP} blocks"
                       f" on the card at once, it holds {resident}")
    return True, ""


def ffn_plan(N: int, C: int, F: int, sms: int) -> FfnPlan:
    """The kernel's plan for x [N, C] and an FFN width F on a card of
    `sms` multiprocessors, or ValueError for a shape it does not take."""
    ok, why = admits_ffn(torch.bfloat16, N, C, F, sms)
    _build.require(ok, why)
    blocks = F // FFN_STRIP
    group = _ffn_group(C, F)
    return FfnPlan(FFN_STRIP, blocks, -(-N // FFN_ROWS), group,
                   blocks // group, C // group, ffn_smem_bytes(C, group))


def _launch_ffn(x, w1, b1, w2, b2):
    """The kernel over x's rows; b2 None for the partial mode's fp32
    sums."""
    N, C = x.shape
    F = w1.shape[1]
    partial = b2 is None
    if partial:
        b2 = torch.zeros(C, device=x.device, dtype=x.dtype)
    sms = _build.sms_of(x.device)
    ok, why = admits_ffn(x.dtype, N, C, F, sms)
    _build.require(ok, why)
    _check_inputs("decode_ffn_block", (x, w1, b1, w2, b2),
                  [(N, C), (C, F), (F,), (F, C), (C,)])
    _build.require(all(t.data_ptr() % 16 == 0 for t in (x, w1, w2, b2)),
                   "decode_ffn_block: x, w1, w2 and b2 must be 16-byte"
                   " aligned")
    plan = ffn_plan(N, C, F, sms)
    fn = _build.function("nic_decode_ffn_block", _FFN_ARGTYPES)
    counters = _ffn_counters.get(x.device)
    if counters is None or counters.numel() < 1 + 2 * (plan.groups
                                                       + plan.group):
        counters = torch.zeros(1 + 2 * max(plan.groups + plan.group, 64),
                               device=x.device, dtype=torch.int32)
        _ffn_counters[x.device] = counters
    slots = (counters.numel() - 1) // 2
    y = torch.empty(N, C, device=x.device,
                    dtype=torch.float32 if partial else x.dtype)
    hbuf = torch.empty(FFN_ROWS, F, device=x.device, dtype=x.dtype)
    ws = torch.empty(plan.groups * FFN_ROWS * C, device=x.device,
                     dtype=torch.float32)
    for r0 in range(0, N, FFN_ROWS):
        rows = min(FFN_ROWS, N - r0)
        _build.check(fn(x[r0:].data_ptr(), w1.data_ptr(), b1.data_ptr(),
                        w2.data_ptr(), b2.data_ptr(),
                        None if partial else y[r0:].data_ptr(),
                        hbuf.data_ptr(), ws.data_ptr(), counters.data_ptr(),
                        slots, rows, C, F, plan.group, plan.smem_bytes,
                        y[r0:].data_ptr() if partial else None,
                        _build.stream_of(x)),
                     "decode_ffn_block")
        if partial:
            decode_ffn_block_partial.launches += 1
        else:
            decode_ffn_block.launches += 1
    return y


decode_conv_block.launches = 0
decode_ffn_block.launches = 0
decode_ffn_block_partial.launches = 0
decode_conv_block_generic.launches = 0
decode_ffn_block_generic.launches = 0
