"""Full-sequence cross-attention with in-kernel dropout, for training.

Kernels: `csrc/flash_attention.cu` (`nic_flash_fwd`, `nic_flash_bwd`),
replacing the TPU kernels `news_image_caption_tpu/ops/pallas_flash.py::
_flash_fwd` and `::_flash_bwd`. `flash_cross_attention` is their
`torch.autograd.Function`: the forward saves the per-row logsumexp, the
backward recomputes the probabilities from it and regenerates the same
dropout mask, so no [B, H, T, S] tensor is stored between the passes.

By the count of bytes and operations, bytes bound both on the card (K
and V of the article are 33.7 MB a call at the flagship); what they
spend their time on is the work a thread does for every (t, s) slot
(an exponential, the dropout hash, the rounding). The kernels are
designed for the H100: a block of four warps owns 64 query rows of one
(head, item) and walks the keys twice in tiles of 64 that arrive
through a ring of `cp.async` copies; every product runs on the tensor
cores (`mma.sync`), scores and probabilities stay in registers, and
only the two transposed products of the backward pass a bf16 tile
through shared memory (see the source). They take any T and any S:
T > 64 becomes several blocks, whose parts of dk and dv a second kernel
adds in a fixed order. `flash_plan` is the host-side plan.

The generic variants (`csrc/flash_generic.cu`: `nic_flash_fwd_generic`,
`nic_flash_bwd_generic`) take what the fast kernels do not: fp32 and
head sizes 1 to 256 (bf16 outside 16-128), any T and S, with FFMA and
fp32 sums (no tensor cores, so fp32 never goes through TF32), the same
rounding points and the same dropout hash (`csrc/common.cuh`), so at a
shape both take the two drop the same slots. The generic forward holds
a block's score rows over all S keys in shared memory and forms them
once (64, 32 or 16 rows, the most that fit by S: `generic_fwd_plan`),
as the TPU kernel holds its block's score row; past that limit it walks
the keys twice, as the backward does. `route_flash(dtype,
head_dim)` is the one predicate that chooses: "fast" where `admits`
holds, else "generic" where `admits_generic` holds, else ValueError with
both reasons; `generic_flash_plan` is their host-side plan, and
`flash_attention_fwd_generic` / `_bwd_generic` hold a CUDA call to them
(their `.launches` count the generic launches).

Dropout bits come from a stateless hash of (seed, b, head, t, s) (see
the source's note), which `dropout_keep` computes with the same integer
steps in torch, so kernel and plain version drop the same slots. Every
function takes `row0`, the batch's first row in a data-parallel run's
global batch (`ops/dropout.py::row_offset`; 0 otherwise): b counts from
it, so two ranks' halves drop the slots of one process's whole batch.
Likewise `h0` and `heads_total`, a tensor-parallel rank's first head and
the whole attention's head count (defaults 0 and num_heads): the hash
keys a head by its global index, so a rank of heads [h0, h0 + H) drops
exactly the single process's slots of those heads, as the reference's
kernel keys its masks by global head. The TPU's own bits cannot be
reproduced; the plain versions therefore also
take an explicit `keep` mask (the CPU tests feed JAX's).

Numerics of the plain versions follow the TPU kernel: fp32 scores,
softmax and dropout, probabilities rounded to the value dtype before
the value product, ds rounded to it before the dq / dk products.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from news_image_caption_tpu_torch.ops import _build

_TAIL_ARGTYPES = [_build.I] * 5 + [ctypes.c_uint, ctypes.c_float, _build.I,
                                   _build.I, _build.I, _build.I, _build.I,
                                   _build.P]
_FWD_ARGTYPES = [_build.P] * 7 + _TAIL_ARGTYPES
_BWD_ARGTYPES = [_build.P] * 11 + _TAIL_ARGTYPES
_GENERIC_TAIL = [_build.I] * 5 + [ctypes.c_uint, ctypes.c_float, _build.I,
                                  _build.I, _build.I, _build.I, _build.P]
_FWD_ARGTYPES_GENERIC = [_build.I] + [_build.P] * 7 + _GENERIC_TAIL
_BWD_ARGTYPES_GENERIC = [_build.I] + [_build.P] * 11 + _GENERIC_TAIL
ROWS = 64                   # query rows a block (16 a warp)
KEYS = 64                   # keys a tile
MAX_STAGES = 3              # slots of the K / V ring
HEAD_DIMS = (16, 32, 64, 128)
SM_SMEM_BYTES = 233472      # shared memory of a multiprocessor (228 KB),
BLOCK_RESERVED_BYTES = 1024   # of which the card keeps this much a block
MAX_GRID_YZ = 65535         # blocks along B and along the T tiles
GENERIC_MAX_HEAD = 256      # the generic kernels' largest head size
# The generic kernels' tiles by head size (csrc/flash_generic.cu::
# plan_of): (largest head size of the class, query rows, keys a chunk).
GENERIC_TILES = ((16, 64, 64), (32, 64, 64), (64, 64, 64), (128, 64, 32),
                 (256, 32, 32))
# The generic forward's held score rows (csrc/flash_generic.cu::
# fwd_plan): rows a block, most first; floats after each row of q, K and
# V in shared memory.
HELD_ROWS = (64, 32, 16)
HELD_PAD = 4
_MASK32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 a in [0, 2^32): c is split into 16-bit
    halves so that no product leaves int64."""
    lo = a * (c & 0xFFFF)
    hi = (a * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def dropout_threshold(p: float) -> int:
    """A slot is kept where its 32 bits are >= this (0: keep all)."""
    return min(int(p * 2 ** 32), 2 ** 32 - 1)


def dropout_keep(seed: torch.Tensor, B: int, H: int, T: int, S: int,
                 p: float, row0: int = 0, h0: int = 0,
                 heads_total: Optional[int] = None) -> torch.Tensor:
    """The kernels' keep mask, bool [B, H, T, S], on seed's device, for
    rows row0 .. row0 + B - 1 of the global batch and heads h0 .. h0 +
    H - 1 of `heads_total` (default H).

    key = seed * 2654435761 + ((b + row0) * heads_total + h0 + h)
    (mod 2^32); row = fmix32(key ^ fmix32(t + 0x9e3779b9)); bits =
    fmix32(row + s).
    """
    dev = seed.device
    Ht = H if heads_total is None else heads_total
    bh = (torch.arange(row0, row0 + B, device=dev,
                       dtype=torch.int64).view(B, 1, 1, 1) * Ht + h0
          + torch.arange(H, device=dev, dtype=torch.int64).view(1, H, 1, 1))
    key = (_mul32(seed.reshape(()).long() & _MASK32, 2654435761) + bh) & _MASK32
    t = torch.arange(T, device=dev, dtype=torch.int64).view(1, 1, T, 1)
    row = _fmix32(key ^ _fmix32((t + 0x9E3779B9) & _MASK32))
    s = torch.arange(S, device=dev, dtype=torch.int64)
    return _fmix32((row + s) & _MASK32) >= dropout_threshold(p)


def _scale_mask(seed, B, H, T, S, p, keep, row0, h0=0, heads_total=None):
    """keep / (1 - p) as fp32 [B, H, T, S], or None without dropout."""
    if p == 0.0:
        _build.require(keep is None, "flash attention: keep given with p = 0")
        return None
    if keep is None:
        keep = dropout_keep(seed, B, H, T, S, p, row0, h0, heads_total)
    return keep.to(torch.float32) * (1.0 / (1.0 - p))


def _heads(x: torch.Tensor, H: int) -> torch.Tensor:
    B, L, E = x.shape
    return x.float().view(B, L, H, E // H)


class FlashPass(NamedTuple):
    """How one of the two kernels holds K and V: `stages` slots of one
    64-key tile each (K, V and the key bias); `resident` where every
    tile has its own slot, so both walks read the tiles in place, else
    a ring that the second walk fills again."""

    stages: int
    resident: bool
    smem_bytes: int
    blocks_per_sm: int      # as far as shared memory decides


class FlashPlan(NamedTuple):
    """How the flash kernels cut a call: grid (num_heads, B, t_tiles),
    block (h, b, i) owning query rows [i * rows, min(T, (i + 1) * rows))
    and walking key tiles j = 0 .. key_tiles - 1 of keys
    [j * keys, min(S, (j + 1) * keys)), twice."""

    rows: int
    keys: int
    t_tiles: int
    key_tiles: int
    blocks: int
    fwd: FlashPass
    bwd: FlashPass
    parts_floats: int       # fp32 scratch of the backward where t_tiles > 1


def admits(dtype, head_dim: int) -> Tuple[bool, str]:
    """Whether the fast flash kernels take q/k/v of `dtype` with this
    head size, and if not, why. (They take any T and S.)"""
    if dtype != torch.bfloat16:
        return False, ("flash attention kernels take bf16 q/k/v, an fp32"
                       " bias and an int32 seed of one element")
    if head_dim not in HEAD_DIMS:
        return False, (f"flash attention: the kernels take a head size E /"
                       f" num_heads in {HEAD_DIMS}, got {head_dim}")
    return True, ""


def admits_generic(dtype, head_dim: int) -> Tuple[bool, str]:
    """Whether the generic flash kernels take q/k/v of `dtype` with this
    head size, and if not, why. (They take any T and S.)"""
    if dtype not in _build.GENERIC_DTYPES:
        return False, ("flash attention generic kernels take bf16 or fp32"
                       " q/k/v")
    if not 1 <= head_dim <= GENERIC_MAX_HEAD:
        return False, (f"flash attention generic: need a head size in"
                       f" 1..{GENERIC_MAX_HEAD}, got {head_dim}")
    return True, ""


def route_flash(dtype, head_dim: int) -> str:
    """"fast" (the flash kernels) where `admits` holds, else "generic"
    where `admits_generic` holds; ValueError with both reasons
    otherwise."""
    ok, why = admits(dtype, head_dim)
    if ok:
        return "fast"
    ok, why_generic = admits_generic(dtype, head_dim)
    _build.require(ok, f"{why}; {why_generic}")
    return "generic"


def flash_smem_bytes(backward: bool, stages: int, head_dim: int) -> int:
    """Dynamic shared memory of a block (csrc/flash_attention.cu::
    flash_smem_bytes): the q tile, in the backward the g tile, the
    transposed products' [64][64] bf16 tile and the staging tile of dk
    and dv, then the slots."""
    tile = ROWS * head_dim * 2
    return ((3 * tile + ROWS * KEYS * 2 if backward else tile)
            + stages * (2 * KEYS * head_dim * 2 + KEYS * 4))


def _flash_pass(backward: bool, key_tiles: int, head_dim: int,
                want: int) -> FlashPass:
    def per_sm(stages):
        smem = flash_smem_bytes(backward, stages, head_dim)
        return SM_SMEM_BYTES // (smem + BLOCK_RESERVED_BYTES)

    stages = min(key_tiles, MAX_STAGES)
    while stages > min(2, key_tiles) and per_sm(stages) < want:
        stages -= 1
    smem = flash_smem_bytes(backward, stages, head_dim)
    _build.require(smem <= _build.MAX_SMEM_BYTES,
                   f"flash attention: a block's {smem} bytes of shared"
                   f" memory exceed the card's {_build.MAX_SMEM_BYTES}")
    return FlashPass(stages, stages == key_tiles, smem, per_sm(stages))


def flash_plan(B: int, T: int, S: int, num_heads: int, head_dim: int,
               sms: int) -> FlashPlan:
    """The kernels' plan for B items of T queries over S keys on a card
    of `sms` multiprocessors: up to MAX_STAGES slots, fewer where that
    lets two blocks share a multiprocessor and the call has more blocks
    than the card has multiprocessors (so that the flagship's 256 blocks
    are all on the card at once). ValueError for what the kernels do not
    take."""
    _build.require(B >= 1 and T >= 1 and S >= 1 and num_heads >= 1
                   and sms >= 1,
                   f"flash attention: need B, T, S >= 1, got B={B}, T={T},"
                   f" S={S}")
    _build.require(*admits(torch.bfloat16, head_dim))
    t_tiles, key_tiles = -(-T // ROWS), -(-S // KEYS)
    _build.require(B <= MAX_GRID_YZ and t_tiles <= MAX_GRID_YZ,
                   f"flash attention: B and T / {ROWS} may be at most"
                   f" {MAX_GRID_YZ}")
    blocks = num_heads * B * t_tiles
    want = min(2, -(-blocks // sms))
    return FlashPlan(
        ROWS, KEYS, t_tiles, key_tiles, blocks,
        _flash_pass(False, key_tiles, head_dim, want),
        _flash_pass(True, key_tiles, head_dim, want),
        2 * t_tiles * B * S * num_heads * head_dim if t_tiles > 1 else 0)


class GenericFlashPlan(NamedTuple):
    """How the generic kernels cut a call, grid (num_heads, B, tiles).

    The backward's block (h, b, i) owns query rows [i * rows, min(T,
    (i + 1) * rows)) and walks the keys twice in chunks of `keys`; the
    tile shape follows the head size (GENERIC_TILES), so that q and g,
    a chunk of K and V and its probabilities fit shared memory as fp32.
    The forward's block owns `fwd_rows` query rows and holds their
    scores over all S keys (`fwd_stages` ring slots of `held_keys` keys,
    `generic_fwd_plan`), or, past the held rows' limit (`fwd_stages`
    0), walks the keys twice in the backward's tiles."""

    rows: int
    keys: int
    t_tiles: int
    blocks: int
    fwd_smem_bytes: int
    bwd_smem_bytes: int
    parts_floats: int       # fp32 scratch of the backward where t_tiles > 1
    fwd_rows: int
    fwd_stages: int         # 0: the forward walks the keys twice
    fwd_t_tiles: int
    fwd_blocks: int


def generic_flash_smem_bytes(backward: bool, head_dim: int) -> int:
    """Dynamic shared memory of a two-walk block (csrc/flash_generic.cu::
    Tiles::smem_floats): q (and g) [W][rows + 1], K and V [W][keys + 1],
    the chunk's probabilities [rows][keys + 1] and the key bias [keys],
    fp32, W the class's head size."""
    width, rows, keys = next(t for t in GENERIC_TILES if head_dim <= t[0])
    return 4 * ((2 if backward else 1) * width * (rows + 1)
                + 2 * width * (keys + 1) + rows * (keys + 1) + keys)


def held_rows_ok(width: int, rows: int) -> bool:
    """Whether the held-row forward has a block of `rows` rows at this
    head width (csrc/flash_generic.cu::held_rows_ok)."""
    return (rows == 64 and width <= 128) or rows in (32, 16)


def held_keys(width: int) -> int:
    """Keys a chunk of the held-row forward's ring (csrc/flash_generic.cu
    ::held_keys)."""
    return 64 if width == 256 else 128


def held_smem_bytes(width: int, rows: int, S: int, stages: int) -> int:
    """Dynamic shared memory of a held-row forward block (csrc/
    flash_generic.cu::held_smem_floats): q [rows][W + 4], the ring
    [stages][held_keys][W + 4], the key bias [S4] and the score rows
    [rows][S4 + 4], fp32, S4 = S rounded up to 4."""
    pitch, s4 = width + HELD_PAD, -(-S // 4) * 4
    return 4 * (rows * pitch + stages * held_keys(width) * pitch + s4
                + rows * (s4 + 4))


def generic_fwd_plan(head_dim: int, S: int) -> Tuple[int, int, int]:
    """(rows a block, ring slots, shared memory bytes) of the generic
    forward over S keys (csrc/flash_generic.cu::fwd_plan): the most rows
    of HELD_ROWS, with 3 slots before 2 (2 where S takes one chunk of K
    and one of V), whose held block fits the card; else the two walks'
    (rows, 0, bytes)."""
    width = next(t[0] for t in GENERIC_TILES if head_dim <= t[0])
    most = min(3, 2 * -(-S // held_keys(width)))
    for rows in HELD_ROWS:
        if not held_rows_ok(width, rows):
            continue
        for stages in range(most, 1, -1):
            smem = held_smem_bytes(width, rows, S, stages)
            if smem <= _build.MAX_SMEM_BYTES:
                return rows, stages, smem
    rows = next(t[1] for t in GENERIC_TILES if head_dim <= t[0])
    return rows, 0, generic_flash_smem_bytes(False, head_dim)


def generic_flash_plan(B: int, T: int, S: int, num_heads: int,
                       head_dim: int) -> GenericFlashPlan:
    """The generic kernels' plan for B items of T queries over S keys, or
    ValueError for what they do not take."""
    _build.require(B >= 1 and T >= 1 and S >= 1 and num_heads >= 1,
                   f"flash attention: need B, T, S >= 1, got B={B}, T={T},"
                   f" S={S}")
    _build.require(*admits_generic(torch.float32, head_dim))
    _, rows, keys = next(t for t in GENERIC_TILES if head_dim <= t[0])
    fwd_rows, fwd_stages, fwd_smem = generic_fwd_plan(head_dim, S)
    t_tiles, fwd_t_tiles = -(-T // rows), -(-T // fwd_rows)
    _build.require(B <= MAX_GRID_YZ and max(t_tiles, fwd_t_tiles)
                   <= MAX_GRID_YZ,
                   f"flash attention: B and T / {min(rows, fwd_rows)} may be"
                   f" at most {MAX_GRID_YZ}")
    return GenericFlashPlan(
        rows, keys, t_tiles, num_heads * B * t_tiles, fwd_smem,
        generic_flash_smem_bytes(True, head_dim),
        2 * t_tiles * B * S * num_heads * head_dim if t_tiles > 1 else 0,
        fwd_rows, fwd_stages, fwd_t_tiles, num_heads * B * fwd_t_tiles)


def flash_attention_fwd_plain(q, k, v, bias, seed, num_heads: int,
                              dropout_p: float = 0.0,
                              keep: Optional[torch.Tensor] = None,
                              row0: int = 0, h0: int = 0,
                              heads_total: Optional[int] = None):
    """(out [B, T, E] in q's dtype, lse [B, H, T] fp32) in plain
    PyTorch, differentiable in q, k and v.

    q [B, T, E] pre-scaled by head_dim**-0.5; k, v [B, S, E]; bias
    [B, S] fp32 (0 attendable, -1e9 padded); seed int32 [1]; keep an
    optional bool [B, H, T, S] mask in place of the generated one; row0
    the batch's first global row; h0 the first of the num_heads heads
    among heads_total (a tensor-parallel rank's; default 0 of
    num_heads).
    """
    B, T, E = q.shape
    S, H = k.shape[1], num_heads
    s = torch.einsum("bthd,bshd->bhts", _heads(q, H), _heads(k, H))
    s = s + bias.float()[:, None, None, :]
    mx = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - mx)
    denom = e.sum(dim=-1, keepdim=True)
    lse = (mx + torch.log(denom))[..., 0]
    probs = e / denom
    scale = _scale_mask(seed, B, H, T, S, dropout_p, keep, row0, h0,
                        heads_total)
    if scale is not None:
        probs = probs * scale
    probs = probs.to(v.dtype).float()
    out = torch.einsum("bhts,bshd->bthd", probs, _heads(v, H))
    return out.to(q.dtype).reshape(B, T, E), lse


def flash_attention_bwd_plain(q, k, v, bias, seed, lse, g, num_heads: int,
                              dropout_p: float = 0.0,
                              keep: Optional[torch.Tensor] = None,
                              row0: int = 0, h0: int = 0,
                              heads_total: Optional[int] = None):
    """(dq, dk, dv) of `flash_attention_fwd_plain` for the output
    gradient g [B, T, E], from the saved lse, as the TPU kernel forms
    them (see the module note)."""
    B, T, E = q.shape
    S, H = k.shape[1], num_heads
    qh, kh, vh, gh = (_heads(x, H) for x in (q, k, v, g))
    s = torch.einsum("bthd,bshd->bhts", qh, kh) + bias.float()[:, None, None, :]
    probs = torch.exp(s - lse[..., None])
    scale = _scale_mask(seed, B, H, T, S, dropout_p, keep, row0, h0,
                        heads_total)
    dropped = probs if scale is None else probs * scale
    dv = torch.einsum("bhts,bthd->bshd", dropped.to(v.dtype).float(), gh)
    dp = torch.einsum("bthd,bshd->bhts", gh, vh)
    if scale is not None:
        dp = dp * scale
    delta = (dp * probs).sum(dim=-1, keepdim=True)
    ds = (probs * (dp - delta)).to(v.dtype).float()
    dq = torch.einsum("bhts,bshd->bthd", ds, kh)
    dk = torch.einsum("bhts,bthd->bshd", ds, qh)
    return (dq.to(q.dtype).reshape(B, T, E), dk.to(k.dtype).reshape(B, S, E),
            dv.to(v.dtype).reshape(B, S, E))


def flash_cross_attention_plain(q, k, v, bias, seed, num_heads: int,
                                dropout_p: float = 0.0,
                                keep: Optional[torch.Tensor] = None,
                                row0: int = 0, h0: int = 0,
                                heads_total: Optional[int] = None):
    """out of `flash_attention_fwd_plain`; autograd through it is the
    reference gradient of `flash_cross_attention`."""
    return flash_attention_fwd_plain(q, k, v, bias, seed, num_heads,
                                     dropout_p, keep, row0, h0,
                                     heads_total)[0]


def _dispatch(name: str, q: torch.Tensor, keep) -> bool:
    """True for the plain version (CPU tensors); raise where no kernel
    runs."""
    if q.device.type == "cpu":
        return True
    _build.require(q.device.type == "cuda",
                   f"{name}: no kernel for device {q.device}")
    _build.require(keep is None, f"{name}: the kernel draws its own mask;"
                   " an explicit keep mask is for the plain version")
    return False


def flash_attention_fwd(q, k, v, bias, seed, num_heads: int,
                        dropout_p: float = 0.0,
                        keep: Optional[torch.Tensor] = None,
                        row0: int = 0, h0: int = 0,
                        heads_total: Optional[int] = None,
                        route: Optional[str] = None):
    """(out, lse); see `flash_attention_fwd_plain`. A CPU tensor takes
    the plain version; a CUDA tensor launches a kernel or raises: the one
    `route_flash` chooses, or `route` ("fast" or "generic") where the
    caller names it."""
    if _dispatch("flash_attention_fwd", q, keep):
        return flash_attention_fwd_plain(q, k, v, bias, seed, num_heads,
                                         dropout_p, keep, row0, h0,
                                         heads_total)
    return _launch_fwd(q, k, v, bias, seed, num_heads, dropout_p, row0, h0,
                       heads_total, route)


def _launch_fwd(q, k, v, bias, seed, num_heads, dropout_p, row0, h0,
                heads_total, route):
    B, T, E = q.shape
    S = k.shape[1]
    route, plan = _check(q, k, v, bias, seed, num_heads,
                         "flash_attention_fwd", route)
    heads_total = _heads_total(num_heads, h0, heads_total,
                               "flash_attention_fwd")
    out = torch.empty_like(q)
    lse = torch.empty(B, num_heads, T, device=q.device, dtype=torch.float32)
    tail = (dropout_threshold(dropout_p), 1.0 / (1.0 - dropout_p))
    if route == "generic":
        fn = _build.function("nic_flash_fwd_generic", _FWD_ARGTYPES_GENERIC)
        _build.check(fn(_build.GENERIC_DTYPES[q.dtype], q.data_ptr(),
                        k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                        seed.data_ptr(), out.data_ptr(), lse.data_ptr(), B, T,
                        S, E, num_heads, *tail, plan.fwd_smem_bytes, row0, h0,
                        heads_total, _build.stream_of(q)),
                     "flash_attention_fwd generic")
        flash_attention_fwd_generic.launches += 1
        return out, lse
    fn = _build.function("nic_flash_fwd", _FWD_ARGTYPES)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                    seed.data_ptr(), out.data_ptr(), lse.data_ptr(), B, T, S,
                    E, num_heads, *tail, plan.fwd.stages,
                    plan.fwd.smem_bytes, row0, h0, heads_total,
                    _build.stream_of(q)),
                 "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


def flash_attention_bwd(q, k, v, bias, seed, lse, g, num_heads: int,
                        dropout_p: float = 0.0,
                        keep: Optional[torch.Tensor] = None,
                        row0: int = 0, h0: int = 0,
                        heads_total: Optional[int] = None,
                        route: Optional[str] = None):
    """(dq, dk, dv); see `flash_attention_bwd_plain`. A CPU tensor takes
    the plain version; a CUDA tensor launches a kernel or raises, as
    `flash_attention_fwd` chooses it."""
    if _dispatch("flash_attention_bwd", q, keep):
        return flash_attention_bwd_plain(q, k, v, bias, seed, lse, g,
                                         num_heads, dropout_p, keep, row0,
                                         h0, heads_total)
    return _launch_bwd(q, k, v, bias, seed, lse, g, num_heads, dropout_p,
                       row0, h0, heads_total, route)


def _launch_bwd(q, k, v, bias, seed, lse, g, num_heads, dropout_p, row0, h0,
                heads_total, route):
    B, T, E = q.shape
    S = k.shape[1]
    route, plan = _check(q, k, v, bias, seed, num_heads,
                         "flash_attention_bwd", route)
    heads_total = _heads_total(num_heads, h0, heads_total,
                               "flash_attention_bwd")
    _build.require(g.shape == q.shape and g.dtype == q.dtype
                   and g.is_contiguous() and g.device == q.device
                   and g.data_ptr() % 16 == 0
                   and lse.shape == (B, num_heads, T)
                   and lse.dtype == torch.float32 and lse.is_contiguous()
                   and lse.device == q.device,
                   "flash_attention_bwd: g must be like q and lse fp32"
                   " [B, H, T], contiguous, on q's device")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # Several T tiles: their fp32 parts of dk and dv, added by the
    # launch's second kernel.
    parts = (torch.empty(plan.parts_floats, device=q.device,
                         dtype=torch.float32) if plan.t_tiles > 1 else None)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            seed.data_ptr(), lse.data_ptr(), g.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(),
            None if parts is None else parts.data_ptr(), B, T, S, E,
            num_heads, dropout_threshold(dropout_p), 1.0 / (1.0 - dropout_p))
    if route == "generic":
        fn = _build.function("nic_flash_bwd_generic", _BWD_ARGTYPES_GENERIC)
        _build.check(fn(_build.GENERIC_DTYPES[q.dtype], *ptrs,
                        plan.bwd_smem_bytes, row0, h0, heads_total,
                        _build.stream_of(q)), "flash_attention_bwd generic")
        flash_attention_bwd_generic.launches += 1
        return dq, dk, dv
    fn = _build.function("nic_flash_bwd", _BWD_ARGTYPES)
    _build.check(fn(*ptrs, plan.bwd.stages, plan.bwd.smem_bytes, row0, h0,
                    heads_total, _build.stream_of(q)),
                 "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


def flash_attention_fwd_generic(q, k, v, bias, seed, num_heads: int,
                                dropout_p: float = 0.0,
                                keep: Optional[torch.Tensor] = None,
                                row0: int = 0, h0: int = 0,
                                heads_total: Optional[int] = None):
    """`flash_attention_fwd` through the generic kernel alone (at a shape
    the fast kernel takes too, for comparing the two)."""
    return flash_attention_fwd(q, k, v, bias, seed, num_heads, dropout_p,
                               keep, row0, h0, heads_total, "generic")


def flash_attention_bwd_generic(q, k, v, bias, seed, lse, g, num_heads: int,
                                dropout_p: float = 0.0,
                                keep: Optional[torch.Tensor] = None,
                                row0: int = 0, h0: int = 0,
                                heads_total: Optional[int] = None):
    """`flash_attention_bwd` through the generic kernel alone."""
    return flash_attention_bwd(q, k, v, bias, seed, lse, g, num_heads,
                               dropout_p, keep, row0, h0, heads_total,
                               "generic")


flash_attention_fwd.launches = 0
flash_attention_bwd.launches = 0
flash_attention_fwd_generic.launches = 0
flash_attention_bwd_generic.launches = 0


def _heads_total(num_heads: int, h0: int, heads_total: Optional[int],
                 name: str) -> int:
    """heads_total (default num_heads), checked to hold heads [h0, h0 +
    num_heads)."""
    total = num_heads if heads_total is None else heads_total
    _build.require(0 <= h0 and h0 + num_heads <= total,
                   f"{name}: heads [{h0}, {h0 + num_heads}) are not among"
                   f" {total}")
    return total


def _check(q, k, v, bias, seed, num_heads, name, route=None):
    """Raise for what the kernels do not take; else (the route, the
    call's plan): `route_flash`'s route, or the caller's where it names
    one (which must admit the call)."""
    B, T, E = q.shape
    S = k.shape[1]
    _build.require(E % num_heads == 0, f"{name}: E % num_heads != 0")
    dh = E // num_heads
    _build.require(route in (None, "fast", "generic"),
                   f"{name}: no route {route!r}")
    ok, why = (admits_generic if route == "generic" else admits)(q.dtype, dh)
    if route is None:     # route_flash's choice, with both reasons
        route = "fast" if ok else "generic"
        if not ok:
            ok, why_generic = admits_generic(q.dtype, dh)
            why = f"{why}; {why_generic}"
    _build.require(ok, f"{name}: {why}")
    _build.require(k.dtype == q.dtype and v.dtype == q.dtype
                   and bias.dtype == torch.float32
                   and seed.dtype == torch.int32 and seed.numel() == 1,
                   f"{name} kernel takes q/k/v of one dtype, an fp32 bias"
                   " and an int32 seed of one element")
    _build.require(k.shape == (B, S, E) and v.shape == (B, S, E)
                   and bias.shape == (B, S),
                   f"{name}: k, v must be [B, S, E] and bias [B, S]")
    _build.require(all(t.is_contiguous() and t.device == q.device
                       for t in (q, k, v, bias, seed)),
                   f"{name}: inputs must be contiguous, on one device")
    if route == "generic":
        return route, generic_flash_plan(B, T, S, num_heads, dh)
    _build.require(all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
                   f"{name}: q, k and v must be 16-byte aligned")
    return route, flash_plan(B, T, S, num_heads, dh, _build.sms_of(q.device))


class _FlashCrossAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, num_heads, dropout_p, keep, row0,
                h0, heads_total):
        out, lse = flash_attention_fwd(q, k, v, bias, seed, num_heads,
                                       dropout_p, keep, row0, h0,
                                       heads_total)
        ctx.save_for_backward(q, k, v, bias, seed, lse, keep)
        # The backward takes the forward's kernel (its route).
        route = None if q.device.type == "cpu" else route_flash(
            q.dtype, q.shape[2] // num_heads)
        ctx.args = (num_heads, dropout_p, row0, h0, heads_total, route)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, seed, lse, keep = ctx.saved_tensors
        num_heads, dropout_p, row0, h0, heads_total, route = ctx.args
        dq, dk, dv = flash_attention_bwd(q, k, v, bias, seed, lse,
                                         g.contiguous(), num_heads,
                                         dropout_p, keep, row0, h0,
                                         heads_total, route)
        return (dq, dk, dv) + (None,) * 8


def flash_cross_attention(q, k, v, bias, seed, num_heads: int,
                          dropout_p: float = 0.0,
                          keep: Optional[torch.Tensor] = None,
                          row0: int = 0, h0: int = 0,
                          heads_total: Optional[int] = None):
    """out [B, T, E] = dropout(softmax(q kᵀ + bias)) v per head, with
    kernel forward and backward on CUDA tensors (the fast kernels or
    their generic variants, by `route_flash`); differentiable in q, k
    and v (bias and seed get no gradient). Arguments as in
    `flash_attention_fwd_plain`."""
    return _FlashCrossAttention.apply(q, k, v, bias, seed, num_heads,
                                      dropout_p, keep, row0, h0,
                                      heads_total)
