"""Fused top-k + logsumexp of one adaptive-softmax band.

Kernel: `csrc/band_topk.cu`, replacing the TPU kernel
`news_image_caption_tpu/ops/pallas_topk.py::band_topk_lse`. The kernel
never writes the [N, V] logits to device memory: it is bound by one
read of the band's table (10 / 31 / 62 MB of bf16 for the flagship's
5002 / 15000 / 30265-row bands), and splits the TPU's sequential
vocab walk into per-tile partials and a merge pass (see the source).

`band_topk_lse_plain` is the same function in plain PyTorch: the CPU
path, and the oracle the kernel is held against on the card.
"""

from __future__ import annotations

import torch

from news_image_caption_tpu_torch.ops import _build

MAX_K = 16
_ARGTYPES = [_build.P] * 9 + [_build.I] * 6 + [_build.P]


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
    return _launch(x, table, k, table.shape[0] if sel_limit is None
                   else sel_limit)


def _launch(x, table, k, sel_limit):
    N, D = x.shape
    V = table.shape[0]
    _build.require(x.dtype == torch.bfloat16 and table.dtype == torch.bfloat16,
                   "band_topk_lse kernel takes bf16 x and table")
    _build.require(table.shape[1] == D and table.device == x.device,
                   "band_topk_lse: table must be [V, D] on x's device")
    _build.require(x.is_contiguous() and table.is_contiguous(),
                   "band_topk_lse: inputs must be contiguous")
    _build.require(1 <= k <= min(MAX_K, sel_limit) and sel_limit <= V,
                   f"band_topk_lse: need 1 <= k <= min({MAX_K}, sel_limit)"
                   " and sel_limit <= V")
    fn = _build.function("nic_band_topk_lse", _ARGTYPES)
    n_tiles = -(-V // _build.lib().nic_band_topk_tile_cols())
    f32 = dict(device=x.device, dtype=torch.float32)
    pmax = torch.empty(N, n_tiles, **f32)
    psum = torch.empty(N, n_tiles, **f32)
    pval = torch.empty(N, n_tiles, k, **f32)
    pid = torch.empty(N, n_tiles, k, device=x.device, dtype=torch.int32)
    vals = torch.empty(N, k, **f32)
    ids = torch.empty(N, k, device=x.device, dtype=torch.int32)
    lse = torch.empty(N, 1, **f32)
    _build.check(fn(x.data_ptr(), table.data_ptr(), pmax.data_ptr(),
                    psum.data_ptr(), pval.data_ptr(), pid.data_ptr(),
                    vals.data_ptr(), ids.data_ptr(), lse.data_ptr(),
                    N, D, V, sel_limit, k, n_tiles, _build.stream_of(x)),
                 "band_topk_lse")
    band_topk_lse.launches += 1
    return vals, ids, lse


band_topk_lse.launches = 0
