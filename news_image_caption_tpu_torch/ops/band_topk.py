"""Fused top-k + logsumexp of one adaptive-softmax band.

Kernel: `csrc/band_topk.cu`, replacing the TPU kernel
`news_image_caption_tpu/ops/pallas_topk.py::band_topk_lse`. The kernel
never writes the [N, V] logits to device memory: it is bound by one
read of the band's table (10 / 31 / 62 MB of bf16 for the flagship's
5002 / 15000 / 30265-row bands). It is designed for the H100: about one
block a multiprocessor walks its share of the 64-id vocab tiles in
ascending order, the table streaming through a ring of `cp.async`
slots into tensor-core products, and carries (max, sumexp, top-k) a
row as the TPU kernel does; a second small kernel merges the blocks'
states in block order (see the source). `band_plan` is the host-side plan, `admits`
what the kernel takes.

`band_topk_lse_plain` is the same function in plain PyTorch: the CPU
path, and the oracle the kernel is held against on the card.

`band_topk_lse_generic` is the generic variant (`csrc/decode_generic.cu`):
bf16 or fp32, any D and V, FFMA with fp32 sums and no tensor cores, for
the models the fast kernel does not take (fp32, the toy's and the tiny
configs' widths). `route_band` is the one predicate that chooses:
"fast" where `admits` holds, else "generic" where `admits_generic`
holds, else ValueError with both reasons.

`band_topk_lse_int8` is the same walk over an int8 table with one scale
a row (`ops/adaptive.py::QuantTable`), the port's route for the
reference's quantized head, which the reference computes in XLA: the
kernel reads half the table's bytes and turns its rows into bf16 in
shared memory. A logit is rounded once, after the scale: bf16(fp32 sum
x scale); the reference's `_word_logits` rounds the sum to the compute
dtype, then the product in that dtype (ROADMAP Queue 3, "by design"). In
fp32 on the CPU the two agree.

`band_topk_lse_int8_generic` is the int8 walk of the generic variant
(`csrc/decode_generic.cu`, `nic_band_topk_lse_int8_generic`): x and the
scales bf16 or fp32, any D and V, for the models the int8 kernel does
not take (fp32 `quantize_head`, the tiny configs' widths).
`route_band_int8` chooses between the two as `route_band` does.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from news_image_caption_tpu_torch.ops import _build

MAX_K = 16
TILE = 64                   # vocab ids a tile
MAX_ROWS = 128              # rows of x a launch
RESIDENT_ROWS = 32          # rows of x that may stay in shared memory
MAX_BLOCKS = 256            # lists the merge's tournament takes
LOGIT_STRIDE = TILE + 8     # bf16 elements a row of the logits tile
_ARGTYPES = [_build.P] * 9 + [_build.I] * 10 + [_build.P]
_ARGTYPES_INT8 = [_build.P] * 10 + [_build.I] * 10 + [_build.P]
_ARGTYPES_GENERIC = [_build.I] + [_build.P] * 9 + [_build.I] * 7 + [_build.P]
_ARGTYPES_INT8_GENERIC = [_build.I] + [_build.P] * 10 + [_build.I] * 7 + [
    _build.P]
# The generic kernel: the most chunks of tiles a row tile, the blocks a
# launch aims at.
GENERIC_MAX_CHUNKS = 1024
GENERIC_BLOCKS = 1024
# The blocks' partials, per (device, rows, blocks, k). Calls on one
# device share them, so they must follow one another (one stream).
_scratch: dict = {}


class BandPlan(NamedTuple):
    """How `band_topk_lse`'s kernel cuts a call: block b of `blocks`
    walks vocab tiles b, b + blocks, ... (`tile` ids each, at most
    `tiles_per_block`); `rows` is N padded to the kernel variant's 16,
    32 or 128 rows; a ring slot holds `kc` columns of a tile's table
    rows (and of x where it is not resident); N above 128 rows goes
    through `launches` launches (each the walk and its merge kernel)."""

    tile: int
    n_tiles: int
    blocks: int
    tiles_per_block: int
    rows: int
    kc: int
    stages: int
    x_resident: bool
    smem_bytes: int
    launches: int
    scratch_floats: int


def band_smem_bytes(rows: int, D: int, kc: int, stages: int,
                    x_resident: bool, int8: bool = False) -> int:
    """Dynamic shared memory of a block (csrc/band_topk.cu::
    band_smem_bytes): resident x, the ring's slots (int8 table rows
    padded by 16 bytes), the logits tile, the rows' top-k lists."""
    table_row = kc + 16 if int8 else (kc + 8) * 2
    return ((rows * (D + 8) * 2 if x_resident else 0)
            + stages * (TILE * table_row
                        + (0 if x_resident else rows * (kc + 8) * 2))
            + rows * LOGIT_STRIDE * 2 + rows * MAX_K * 8)


def admits(dtype, N: int, D: int, V: int, k: int,
           sel_limit: int) -> Tuple[bool, str]:
    """Whether the kernel takes x [N, D] and table [V, D] of `dtype`
    with this k and sel_limit, and if not, why."""
    if dtype != torch.bfloat16:
        return False, "band_topk_lse kernel takes bf16 x and table"
    if not (N >= 1 and V >= 1 and D >= 64 and D % 64 == 0):
        return False, (f"band_topk_lse: need N, V >= 1 and D % 64 == 0,"
                       f" got N={N}, V={V}, D={D}")
    if not (1 <= k <= min(MAX_K, sel_limit) and sel_limit <= V):
        return False, (f"band_topk_lse: need 1 <= k <= min({MAX_K},"
                       " sel_limit) and sel_limit <= V")
    return True, ""


def admits_int8(dtype, N: int, D: int, V: int, k: int,
                sel_limit: int) -> Tuple[bool, str]:
    """`admits` of the int8 variant: x of `dtype`, an int8 table, scales
    of x's dtype."""
    if dtype != torch.bfloat16:
        return False, ("band_topk_lse_int8 kernel takes bf16 x, an int8"
                       " table and bf16 scales")
    return admits(dtype, N, D, V, k, sel_limit)


def admits_int8_generic(dtype, N: int, D: int, V: int, k: int,
                        sel_limit: int) -> Tuple[bool, str]:
    """`admits_generic` of the int8 walk: x of `dtype`, an int8 table,
    scales of x's dtype."""
    if dtype not in _build.GENERIC_DTYPES:
        return False, ("band_topk_lse_int8 generic kernel takes bf16 or fp32"
                       " x, an int8 table and scales of x's dtype")
    return admits_generic(dtype, N, D, V, k, sel_limit)


def route_band_int8(dtype, N: int, D: int, V: int, k: int,
                    sel_limit: int) -> str:
    """"fast" (`band_topk_lse_int8`'s kernel) where `admits_int8` holds,
    else "generic" where `admits_int8_generic` holds; ValueError with
    both reasons otherwise."""
    ok, why = admits_int8(dtype, N, D, V, k, sel_limit)
    if ok:
        return "fast"
    ok, why_generic = admits_int8_generic(dtype, N, D, V, k, sel_limit)
    _build.require(ok, f"{why}; {why_generic}")
    return "generic"


def admits_generic(dtype, N: int, D: int, V: int, k: int,
                   sel_limit: int) -> Tuple[bool, str]:
    """Whether the generic kernel takes x [N, D] and table [V, D] of
    `dtype` with this k and sel_limit, and if not, why."""
    if dtype not in _build.GENERIC_DTYPES:
        return False, ("band_topk_lse generic kernel takes bf16 or fp32 x"
                       " and table")
    if not (N >= 1 and V >= 1 and D >= 1):
        return False, (f"band_topk_lse generic: need N, V, D >= 1, got N={N},"
                       f" V={V}, D={D}")
    if not (1 <= k <= min(MAX_K, sel_limit) and sel_limit <= V):
        return False, (f"band_topk_lse generic: need 1 <= k <= min({MAX_K},"
                       " sel_limit) and sel_limit <= V")
    return True, ""


def route_band(dtype, N: int, D: int, V: int, k: int, sel_limit: int) -> str:
    """"fast" (`band_topk_lse`'s kernel) where `admits` holds, else
    "generic" where `admits_generic` holds; ValueError with both
    reasons otherwise."""
    ok, why = admits(dtype, N, D, V, k, sel_limit)
    if ok:
        return "fast"
    ok, why_generic = admits_generic(dtype, N, D, V, k, sel_limit)
    _build.require(ok, f"{why}; {why_generic}")
    return "generic"


class GenericBandPlan(NamedTuple):
    """How the generic kernel cuts a call: row tiles of `rows` (16 or
    32) rows; the 64-id tiles of the vocab go `tiles_per_chunk` a chunk
    to `chunks` blocks a row tile, each walking its tiles in ascending
    order; the merge kernel adds the chunks' states in chunk order."""

    rows: int
    row_tiles: int
    tiles_per_chunk: int
    chunks: int


def generic_band_plan(N: int, V: int) -> GenericBandPlan:
    """At most GENERIC_BLOCKS blocks (and GENERIC_MAX_CHUNKS chunks a row
    tile), a tile of ids a block where the vocab allows, none empty."""
    rows = 16 if N <= 16 else 32
    row_tiles = -(-N // rows)
    n_tiles = -(-V // TILE)
    want = max(1, min(GENERIC_MAX_CHUNKS, GENERIC_BLOCKS // row_tiles))
    per = -(-n_tiles // min(n_tiles, want))
    return GenericBandPlan(rows, row_tiles, per, -(-n_tiles // per))


def band_plan(N: int, D: int, V: int, k: int, sms: int,
              int8: bool = False) -> BandPlan:
    """The kernel's plan for x [N, D] over a table of V rows on a card
    of `sms` multiprocessors, or ValueError for a shape it does not
    take. One block a multiprocessor, none without a tile; x resident
    where at most 32 rows and four slots fit beside it; else the deepest
    ring that fits. int8: the int8 variant's plan."""
    ok, why = admits(torch.bfloat16, N, D, V, k, V)
    _build.require(ok and sms >= 1, why or "band_topk_lse: sms < 1")
    n = min(N, MAX_ROWS)
    rows = 16 if n <= 16 else 32 if n <= 32 else MAX_ROWS
    n_tiles = -(-V // TILE)
    blocks = min(n_tiles, sms, MAX_BLOCKS)
    kc = next(c for c in (256, 128, 64) if D % c == 0)
    choices = [(kc, 4, True)] if rows <= RESIDENT_ROWS else []
    choices += [(min(kc, 128), s, False) for s in (4, 3, 2)]
    for kc_, stages, resident in choices:     # the last always fits
        smem = band_smem_bytes(rows, D, kc_, stages, resident, int8)
        if smem <= _build.MAX_SMEM_BYTES:
            break
    return BandPlan(TILE, n_tiles, blocks, -(-n_tiles // blocks), rows, kc_,
                    stages, resident, smem, -(-N // MAX_ROWS),
                    2 * rows * blocks * (1 + k))


def stable_topk(vals: torch.Tensor, k: int):
    """(values, positions) of the k largest along the last dim, ties to
    the lowest position (the lax.top_k rule, which torch.topk does not
    promise), through a stable descending sort."""
    order = torch.sort(vals, dim=-1, descending=True, stable=True).indices
    order = order[..., :k]
    return torch.gather(vals, -1, order), order


def band_topk_lse_plain(x: torch.Tensor, table: torch.Tensor, k: int,
                        sel_limit: int | None = None):
    """Reference semantics of `band_topk_lse`, in plain PyTorch.

    Logits are x @ tableᵀ with fp32 accumulation, rounded to x's dtype
    (the reference's rounding point). Ties break toward the lowest id.
    """
    V = table.shape[0]
    sel_limit = V if sel_limit is None else sel_limit
    logits = (x.float() @ table.float().T).to(x.dtype).float()
    lse = torch.logsumexp(logits, dim=1, keepdim=True)
    vals, ids = stable_topk(logits[:, :sel_limit], k)
    return vals, ids.to(torch.int32), lse


def band_topk_lse_int8_plain(x: torch.Tensor, table_q: torch.Tensor,
                             scale: torch.Tensor, k: int,
                             sel_limit: int | None = None):
    """`band_topk_lse_plain` over an int8 table [V, D] with one scale a
    row [V]: logits (x . table_q[v]) * scale[v], fp32 sums rounded once
    to x's dtype."""
    V = table_q.shape[0]
    sel_limit = V if sel_limit is None else sel_limit
    logits = ((x.float() @ table_q.float().T) * scale.float()).to(
        x.dtype).float()
    lse = torch.logsumexp(logits, dim=1, keepdim=True)
    vals, ids = stable_topk(logits[:, :sel_limit], k)
    return vals, ids.to(torch.int32), lse


def band_topk_lse(x: torch.Tensor, table: torch.Tensor, k: int,
                  sel_limit: int | None = None):
    """Top-k and logsumexp of x [N, D] @ table [V, D]ᵀ along V.

    Returns (vals [N, k] fp32 logits, ids [N, k] int32, lse [N, 1]
    fp32). The top-k considers ids < sel_limit (default V); the
    logsumexp covers every row. A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel or raises.
    """
    if x.device.type == "cpu":
        return band_topk_lse_plain(x, table, k, sel_limit)
    _build.require(x.device.type == "cuda",
                   f"band_topk_lse: no kernel for device {x.device}")
    sel = table.shape[0] if sel_limit is None else sel_limit
    if route_band(x.dtype, *x.shape, table.shape[0], k, sel) == "fast":
        return _launch(x, table, k, sel)
    return _launch_generic(x, table, k, sel)


def band_topk_lse_generic(x: torch.Tensor, table: torch.Tensor, k: int,
                          sel_limit: int | None = None):
    """`band_topk_lse` through the generic kernel alone (see
    `band_topk_lse_plain`). A CPU tensor takes the plain version; a
    CUDA tensor launches the generic kernel or raises."""
    if x.device.type == "cpu":
        return band_topk_lse_plain(x, table, k, sel_limit)
    _build.require(x.device.type == "cuda",
                   f"band_topk_lse: no kernel for device {x.device}")
    return _launch_generic(x, table, k, table.shape[0] if sel_limit is None
                           else sel_limit)


def _launch_generic(x, table, k, sel_limit):
    N, D = x.shape
    V = table.shape[0]
    ok, why = admits_generic(x.dtype, N, D, V, k, sel_limit)
    _build.require(ok, why)
    _build.require(table.dtype == x.dtype and table.shape[1] == D
                   and table.device == x.device,
                   "band_topk_lse: table must be [V, D] of x's dtype on x's"
                   " device")
    _build.require(x.is_contiguous() and table.is_contiguous(),
                   "band_topk_lse generic: inputs must be contiguous")
    fn = _build.function("nic_band_topk_lse_generic", _ARGTYPES_GENERIC)
    out = _generic_walk(lambda *a: fn(a[0], a[1], table.data_ptr(), *a[2:]),
                        x, V, k, sel_limit, "band_topk_lse generic")
    band_topk_lse_generic.launches += 1
    return out


def _generic_walk(call, x, V, k, sel_limit, what):
    """Launch `call` (a generic C entry point with its table bound after
    x) on x, with the generic plan's scratch."""
    N, D = x.shape
    plan = generic_band_plan(N, V)
    dev = x.device
    vals = torch.empty(N, k, device=dev, dtype=torch.float32)
    ids = torch.empty(N, k, device=dev, dtype=torch.int32)
    lse = torch.empty(N, 1, device=dev, dtype=torch.float32)
    cells = N * plan.chunks
    scratch = torch.empty(cells * (2 + 2 * k), device=dev,
                          dtype=torch.float32)
    pid = scratch[(2 + k) * cells:].view(torch.int32)
    _build.check(call(_build.GENERIC_DTYPES[x.dtype], x.data_ptr(),
                      scratch.data_ptr(), scratch[cells:].data_ptr(),
                      scratch[2 * cells:].data_ptr(), pid.data_ptr(),
                      vals.data_ptr(), ids.data_ptr(), lse.data_ptr(), N, D,
                      V, sel_limit, k, plan.tiles_per_chunk, plan.chunks,
                      _build.stream_of(x)), what)
    return vals, ids, lse


def _launch(x, table, k, sel_limit):
    N, D = x.shape
    V = table.shape[0]
    ok, why = admits(x.dtype, N, D, V, k, sel_limit)
    _build.require(ok, why)
    _build.require(table.dtype == x.dtype and table.shape[1] == D
                   and table.device == x.device,
                   "band_topk_lse: table must be [V, D] of x's dtype on x's"
                   " device")
    _build.require(x.is_contiguous() and table.is_contiguous()
                   and x.data_ptr() % 16 == 0 and table.data_ptr() % 16 == 0,
                   "band_topk_lse: inputs must be contiguous and 16-byte"
                   " aligned")
    fn = _build.function("nic_band_topk_lse", _ARGTYPES)
    return _walk(lambda *a: fn(a[0], table.data_ptr(), *a[1:]), x, V, k,
                 sel_limit, False, band_topk_lse, "band_topk_lse")


def band_topk_lse_int8(x: torch.Tensor, table_q: torch.Tensor,
                       scale: torch.Tensor, k: int,
                       sel_limit: int | None = None):
    """`band_topk_lse` over an int8 table [V, D] with one scale a row
    [V] (see `band_topk_lse_int8_plain`). A CPU tensor takes the plain
    version; a CUDA tensor launches the int8 kernel, or its generic
    variant where `route_band_int8` says so, or raises (it never widens
    the table to call a kernel of another type)."""
    if x.device.type == "cpu":
        return band_topk_lse_int8_plain(x, table_q, scale, k, sel_limit)
    _build.require(x.device.type == "cuda",
                   f"band_topk_lse_int8: no kernel for device {x.device}")
    sel = table_q.shape[0] if sel_limit is None else sel_limit
    if route_band_int8(x.dtype, *x.shape, table_q.shape[0], k,
                       sel) == "fast":
        return _launch_int8(x, table_q, scale, k, sel)
    return _launch_int8_generic(x, table_q, scale, k, sel)


def band_topk_lse_int8_generic(x: torch.Tensor, table_q: torch.Tensor,
                               scale: torch.Tensor, k: int,
                               sel_limit: int | None = None):
    """`band_topk_lse_int8` through the generic variant alone. A CPU
    tensor takes the plain version; a CUDA tensor launches the generic
    int8 walk or raises."""
    if x.device.type == "cpu":
        return band_topk_lse_int8_plain(x, table_q, scale, k, sel_limit)
    _build.require(x.device.type == "cuda",
                   f"band_topk_lse_int8: no kernel for device {x.device}")
    return _launch_int8_generic(x, table_q, scale, k, table_q.shape[0]
                                if sel_limit is None else sel_limit)


def _check_int8_table(x, table_q, scale, what):
    """table_q int8 [V, D] and its scales [V] of x's dtype, contiguous on
    x's device (both int8 launches' check)."""
    D = x.shape[1]
    V = table_q.shape[0]
    _build.require(table_q.dtype == torch.int8 and table_q.shape[1] == D
                   and scale.dtype == x.dtype and scale.shape == (V,)
                   and table_q.device == x.device
                   and scale.device == x.device,
                   f"{what}: table must be [V, D] int8 and its scales [V] of"
                   " x's dtype, on x's device")
    _build.require(x.is_contiguous() and table_q.is_contiguous()
                   and scale.is_contiguous(),
                   f"{what}: inputs must be contiguous")


def _launch_int8_generic(x, table_q, scale, k, sel_limit):
    N, D = x.shape
    V = table_q.shape[0]
    ok, why = admits_int8_generic(x.dtype, N, D, V, k, sel_limit)
    _build.require(ok, why)
    _check_int8_table(x, table_q, scale, "band_topk_lse_int8 generic")
    fn = _build.function("nic_band_topk_lse_int8_generic",
                         _ARGTYPES_INT8_GENERIC)
    out = _generic_walk(lambda *a: fn(a[0], a[1], table_q.data_ptr(),
                                      scale.data_ptr(), *a[2:]),
                        x, V, k, sel_limit, "band_topk_lse_int8 generic")
    band_topk_lse_int8_generic.launches += 1
    return out


def _launch_int8(x, table_q, scale, k, sel_limit):
    N, D = x.shape
    V = table_q.shape[0]
    ok, why = admits_int8(x.dtype, N, D, V, k, sel_limit)
    _build.require(ok, why)
    _check_int8_table(x, table_q, scale, "band_topk_lse_int8")
    _build.require(x.data_ptr() % 16 == 0 and table_q.data_ptr() % 16 == 0,
                   "band_topk_lse_int8: inputs must be 16-byte aligned")
    fn = _build.function("nic_band_topk_lse_int8", _ARGTYPES_INT8)
    return _walk(lambda *a: fn(a[0], table_q.data_ptr(), scale.data_ptr(),
                               *a[1:]), x, V, k, sel_limit, True,
                 band_topk_lse_int8, "band_topk_lse_int8")


def _walk(call, x, V, k, sel_limit, int8, counted, what):
    """Launch `call` (the C entry point with its table bound) on each
    128-row slice of x, its plan and the blocks' scratch; count each
    launch on `counted`."""
    N, D = x.shape
    dev = x.device
    sms = _build.sms_of(dev)
    vals = torch.empty(N, k, device=dev, dtype=torch.float32)
    ids = torch.empty(N, k, device=dev, dtype=torch.int32)
    lse = torch.empty(N, 1, device=dev, dtype=torch.float32)
    for r0 in range(0, N, MAX_ROWS):
        n = min(MAX_ROWS, N - r0)
        plan = band_plan(n, D, V, k, sms, int8)
        key = (dev, plan.rows, plan.blocks, k)
        scratch = _scratch.get(key)
        if scratch is None:
            scratch = _scratch[key] = torch.empty(
                plan.scratch_floats, device=dev, dtype=torch.float32)
        cells = plan.rows * plan.blocks
        pmax, psum = scratch[:cells], scratch[cells:2 * cells]
        pval = scratch[2 * cells:(2 + k) * cells]
        pid = scratch[(2 + k) * cells:]
        _build.check(call(x[r0:].data_ptr(), pmax.data_ptr(),
                          psum.data_ptr(), pval.data_ptr(), pid.data_ptr(),
                          vals[r0:].data_ptr(), ids[r0:].data_ptr(),
                          lse[r0:].data_ptr(), n, D, V, sel_limit, k,
                          plan.blocks, plan.kc, plan.stages,
                          int(plan.x_resident), plan.smem_bytes,
                          _build.stream_of(x)), what)
        counted.launches += 1
    return vals, ids, lse


band_topk_lse.launches = 0
band_topk_lse_int8.launches = 0
band_topk_lse_generic.launches = 0
band_topk_lse_int8_generic.launches = 0
