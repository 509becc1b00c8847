"""Few-query cross-attention over per-item context K/V, for decode.

Kernel: `csrc/decode_attention.cu`, replacing the TPU kernel
`news_image_caption_tpu/ops/pallas_kernels.py::decode_cross_attention`.
It is bound by reading the context K and V once per step (33.7 MB per
layer for the article at batch 16). The kernel is designed for the
H100: the keys of one (head, item) are shared by a cluster of up to 8
blocks, each of which requests all its K and V rows at once, multiplies
on the tensor cores and keeps the scores in shared memory; the cluster
exchanges row maxima and sums and adds its partial outputs through
distributed shared memory in a fixed order (see the source).
`attention_plan` is its host-side plan.

The port follows the TPU kernel's numerics, fp32 scores and softmax
with probabilities rounded to the value dtype; the reference's XLA
decode path (`ops/attention.py::attend_flat_beam` over `DecodeKV`)
instead materializes the scores in the compute dtype.

`decode_cross_attention_int8` is the same kernel over int8 K and V with
one scale a (item, key, head) (`ops/attention.py::quantize_kv`), the
port's route for the reference's `QuantDecodeKV`, which the reference
computes in XLA: the kernel reads half the bytes of K and V and turns
the int8 rows into bf16 in shared memory. The scales factor out of
both products in the reference's order: an fp32 score times its key's
K scale, then the key bias and the fp32 softmax; the probability
rounded to bf16, times the key's V scale, rounded to bf16 again, then
the value product. The reference rounds the scores to the compute dtype
before and after the scale; the port keeps them fp32, as its bf16
kernel does (ROADMAP Queue 3, "by design"). In fp32 on the CPU the two
agree.

`decode_cross_attention_generic` is the generic variant
(`csrc/decode_generic.cu`): bf16 or fp32, any head size from 1 to 256,
with FFMA and fp32 sums, for the models the fast kernel does not take
(fp32, the toy's head size 8, tiny_test's 4). It splits each (item,
head)'s keys over blocks of at most 64 keys (`generic_attention_plan`): a
kernel writes each split's fp32 scores and its max and sum, a second
merges them, forms the probabilities and each split's p v, a third adds
the splits in order; one split is one kernel. K and V are read once.
`route_attention` is the one predicate that chooses: "fast" where
`admits` holds, else "generic" where `admits_generic` holds, else
ValueError with both reasons.

`decode_cross_attention_int8_generic` is the int8 attention of the
generic variant (`nic_decode_attention_int8_generic`): q and the scales
bf16 or fp32, head sizes 1 to 256, for the models the int8 kernel does
not take (fp32 `quantize_kv`, tiny_test's head size 4).
`route_attention_int8` chooses between the two as `route_attention`
does.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from news_image_caption_tpu_torch.ops import _build

MAX_Q = 16
HEAD_DIMS = (16, 32, 64, 128)
MAX_SPLITS = 8              # blocks a cluster
KEY_STEP = 16               # keys a block come in whole mma steps
BLOCKS_PER_SM = 3           # blocks the plan aims to give a multiprocessor
MIN_KEYS = 64               # keys a block before the plan splits further
_ARGTYPES = [_build.P] * 5 + [_build.I] * 8 + [_build.P]
_ARGTYPES_INT8 = [_build.P] * 7 + [_build.I] * 8 + [_build.P]
_ARGTYPES_GENERIC = [_build.I] + [_build.P] * 8 + [_build.I] * 8 + [_build.P]
_ARGTYPES_INT8_GENERIC = [_build.I] + [_build.P] * 10 + [_build.I] * 8 + [
    _build.P]
# The generic kernel: its largest head size, keys a split (at most).
GENERIC_MAX_HEAD = 256
GENERIC_SPLIT_KEYS = 64
GENERIC_THREADS = 256
GENERIC_QUERY_GROUP = 4     # queries' p v parts a warp keeps, at most


class AttentionPlan(NamedTuple):
    """How `decode_cross_attention`'s kernel cuts its work: the keys of
    each (head, item) go to `splits` blocks of one cluster, block z
    taking keys [z * per, min(S, (z + 1) * per))."""

    splits: int
    per: int
    smem_bytes: int


def admits(dtype, Q: int, head_dim: int) -> Tuple[bool, str]:
    """Whether the kernel takes q/k/v of `dtype` with Q queries an item
    and this head size, and if not, why. (How many keys it takes depends
    on the call: `attention_plan`.)"""
    if dtype != torch.bfloat16:
        return False, ("decode_cross_attention kernel takes bf16 q/k/v and"
                       " an fp32 bias")
    if not (1 <= Q <= MAX_Q and head_dim in HEAD_DIMS):
        return False, (f"decode_cross_attention: need 1 <= Q <= {MAX_Q} and"
                       f" a head size E / num_heads in {HEAD_DIMS}, got"
                       f" Q={Q}, head size {head_dim}")
    return True, ""


def admits_int8(dtype, Q: int, head_dim: int) -> Tuple[bool, str]:
    """`admits` of the int8 variant: q of `dtype`, int8 K and V, scales
    of q's dtype."""
    if dtype != torch.bfloat16:
        return False, ("decode_cross_attention_int8 kernel takes bf16 q,"
                       " int8 k/v, bf16 scales and an fp32 bias")
    return admits(dtype, Q, head_dim)


def admits_int8_generic(dtype, Q: int, head_dim: int) -> Tuple[bool, str]:
    """`admits_generic` of the int8 attention: q of `dtype`, int8 K and
    V, scales of q's dtype."""
    if dtype not in _build.GENERIC_DTYPES:
        return False, ("decode_cross_attention_int8 generic kernel takes bf16"
                       " or fp32 q, int8 k/v, scales of q's dtype and an fp32"
                       " bias")
    return admits_generic(dtype, Q, head_dim)


def route_attention_int8(dtype, Q: int, head_dim: int) -> str:
    """"fast" (`decode_cross_attention_int8`'s kernel) where
    `admits_int8` holds, else "generic" where `admits_int8_generic`
    holds; ValueError with both reasons otherwise."""
    ok, why = admits_int8(dtype, Q, head_dim)
    if ok:
        return "fast"
    ok, why_generic = admits_int8_generic(dtype, Q, head_dim)
    _build.require(ok, f"{why}; {why_generic}")
    return "generic"


def admits_generic(dtype, Q: int, head_dim: int) -> Tuple[bool, str]:
    """Whether the generic kernel takes q/k/v of `dtype` with Q queries
    an item and this head size, and if not, why."""
    if dtype not in _build.GENERIC_DTYPES:
        return False, ("decode_cross_attention generic kernel takes bf16 or"
                       " fp32 q/k/v and an fp32 bias")
    if not (1 <= Q <= MAX_Q and 1 <= head_dim <= GENERIC_MAX_HEAD):
        return False, (f"decode_cross_attention generic: need 1 <= Q <="
                       f" {MAX_Q} and a head size in 1..{GENERIC_MAX_HEAD},"
                       f" got Q={Q}, head size {head_dim}")
    return True, ""


def route_attention(dtype, Q: int, head_dim: int) -> str:
    """"fast" (`decode_cross_attention`'s kernel) where `admits` holds,
    else "generic" where `admits_generic` holds; ValueError with both
    reasons otherwise."""
    ok, why = admits(dtype, Q, head_dim)
    if ok:
        return "fast"
    ok, why_generic = admits_generic(dtype, Q, head_dim)
    _build.require(ok, f"{why}; {why_generic}")
    return "generic"


class GenericAttentionPlan(NamedTuple):
    """How the generic kernel cuts a call: grid (num_heads, B, splits),
    split z taking keys [z * per, min(S, (z + 1) * per)), none empty;
    fp32 scratch (0 for one split): the scores [B, H, Q, S], each
    split's max and sum [2, B, H, Q, splits], its p v [B, H, splits, Q,
    head_dim]."""

    splits: int
    per: int
    smem_bytes: int
    blocks: int
    scores_floats: int
    stats_floats: int
    parts_floats: int


def generic_smem_bytes(Q: int, head_dim: int, per: int) -> int:
    """Dynamic shared memory of the generic kernels' blocks
    (csrc/decode_generic.cu::att_smem_floats): q [Q][dhp], the split's
    scores, then probabilities [Q][per] and the warps' parts of p v
    [8][min(Q, 4)][dhp], fp32, dhp the head size rounded up to 16."""
    dhp = -(-head_dim // 16) * 16
    return 4 * (Q * dhp + Q * per + GENERIC_THREADS // 32
                * min(Q, GENERIC_QUERY_GROUP) * dhp)


def generic_attention_plan(B: int, Q: int, S: int, num_heads: int,
                           head_dim: int) -> GenericAttentionPlan:
    """The generic kernel's plan (csrc/decode_generic.cu::att_plan):
    ceil(S / GENERIC_SPLIT_KEYS) splits of equal length but the last;
    ValueError for what it does not take."""
    _build.require(B >= 1 and S >= 1 and 1 <= Q <= MAX_Q and num_heads >= 1,
                   f"decode_cross_attention: need B, S >= 1 and 1 <= Q <="
                   f" {MAX_Q}, got B={B}, Q={Q}, S={S}")
    splits = -(-S // GENERIC_SPLIT_KEYS)
    per = -(-S // splits)
    smem = generic_smem_bytes(Q, head_dim, per)
    _build.require(smem <= _build.MAX_SMEM_BYTES,
                   f"decode_cross_attention generic: {smem} bytes of shared"
                   f" memory exceed the card's {_build.MAX_SMEM_BYTES}")
    rows = B * num_heads * Q
    return GenericAttentionPlan(
        splits, per, smem, num_heads * B * splits,
        rows * S if splits > 1 else 0, 2 * rows * splits if splits > 1 else 0,
        rows * splits * head_dim if splits > 1 else 0)


def _generic_scratch(plan: GenericAttentionPlan, device):
    """The plan's fp32 scratch as three tensors on `device` (None each
    for one split)."""
    if plan.splits == 1:
        return None, None, None
    return tuple(torch.empty(n, device=device, dtype=torch.float32) for n in
                 (plan.scores_floats, plan.stats_floats, plan.parts_floats))


def _ptr(t):
    return None if t is None else t.data_ptr()


def attention_smem_bytes(Q: int, per: int, head_dim: int,
                         int8: bool = False) -> int:
    """Dynamic shared memory of a block (csrc/decode_attention.cu::
    attn_smem_bytes): K rows (then V's; int8 rows padded by 16 bytes),
    fp32 scores and bf16 probabilities for Q query rows, the key bias
    (and the int8 rows' K and V scales), the row maxima and sums (the
    warps', every block's of the cluster, the context's), the parts of
    the output this block adds."""
    row = head_dim + 16 if int8 else head_dim * 2
    return (per * row + Q * (per + 8) * (4 + 2) + per * 4 * (3 if int8 else 1)
            + (2 * 4 + 2 * MAX_SPLITS + 2) * MAX_Q * 4
            + (Q * head_dim // 2 + MAX_SPLITS) * 8)


def attention_plan(B: int, Q: int, S: int, num_heads: int, head_dim: int,
                   sms: int, int8: bool = False) -> AttentionPlan:
    """The kernel's plan for B items of Q queries over S keys on a card
    of `sms` multiprocessors: enough splits to give every
    multiprocessor BLOCKS_PER_SM blocks (so batch 1 spreads over the
    card, and at batch 16 several blocks' loads are in flight on each),
    but at least MIN_KEYS keys a block (a short context is not worth a
    cluster) and no more than 8 splits, none empty; more where one
    block's keys would not fit in shared memory. ValueError where S
    needs more than 8 splits."""
    _build.require(B >= 1 and S >= 1 and 1 <= Q <= MAX_Q and num_heads >= 1
                   and sms >= 1,
                   f"decode_cross_attention: need B, S >= 1 and 1 <= Q <="
                   f" {MAX_Q}, got B={B}, Q={Q}, S={S}")
    want = max(1, min(MAX_SPLITS, S // MIN_KEYS,
                      -(-BLOCKS_PER_SM * sms // (B * num_heads))))
    while True:
        per = -(-(-(-S // want)) // KEY_STEP) * KEY_STEP
        smem = attention_smem_bytes(Q, per, head_dim, int8)
        if smem <= _build.MAX_SMEM_BYTES:
            return AttentionPlan(-(-S // per), per, smem)
        want += 1
        _build.require(want <= MAX_SPLITS,
                       f"decode_cross_attention: S={S} keys do not fit in"
                       f" the shared memory of {MAX_SPLITS} blocks")


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


def decode_cross_attention_int8_plain(q: torch.Tensor, k_q: torch.Tensor,
                                      k_scale: torch.Tensor,
                                      v_q: torch.Tensor,
                                      v_scale: torch.Tensor,
                                      bias: torch.Tensor,
                                      num_heads: int) -> torch.Tensor:
    """`decode_cross_attention_plain` over int8 K/V, in plain PyTorch.

    q [B, Q, E] (pre-scaled); k_q, v_q [B, S, E] int8; k_scale, v_scale
    [B, S, H] (one scale a key and head); bias [B, S] fp32. Scores
    (q . k_q) * k_scale + bias and softmax in fp32; probabilities
    rounded to q's dtype, times v_scale in q's dtype; the value product
    in fp32; output in q's dtype.
    """
    B, Q, E = q.shape
    S = k_q.shape[1]
    dh = E // num_heads
    heads = lambda t: t.float().view(B, S, num_heads, dh)
    qh = q.float().view(B, Q, num_heads, dh)
    s = torch.einsum("bqhd,bshd->bhqs", qh, heads(k_q))
    s = s * k_scale.float().permute(0, 2, 1)[:, :, None, :] \
        + bias.float()[:, None, None, :]
    p = torch.softmax(s, dim=-1).to(q.dtype)
    p = p * v_scale.to(q.dtype).permute(0, 2, 1)[:, :, None, :]
    out = torch.einsum("bhqs,bshd->bqhd", p.float(), heads(v_q))
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
    B, Q, E = q.shape
    _build.require(E % num_heads == 0,
                   "decode_cross_attention: E % num_heads != 0")
    if route_attention(q.dtype, Q, E // num_heads) == "fast":
        return _launch(q, k, v, bias, num_heads)
    return _launch_generic(q, k, v, bias, num_heads)


def decode_cross_attention_generic(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, bias: torch.Tensor,
                                   num_heads: int) -> torch.Tensor:
    """`decode_cross_attention` through the generic kernel alone. A CPU
    tensor takes the plain version; a CUDA tensor launches the generic
    kernel or raises."""
    if q.device.type == "cpu":
        return decode_cross_attention_plain(q, k, v, bias, num_heads)
    _build.require(q.device.type == "cuda",
                   f"decode_cross_attention: no kernel for device {q.device}")
    return _launch_generic(q, k, v, bias, num_heads)


def _launch_generic(q, k, v, bias, num_heads):
    B, Q, E = q.shape
    S = k.shape[1]
    _build.require(E % num_heads == 0,
                   "decode_cross_attention: E % num_heads != 0")
    ok, why = admits_generic(q.dtype, Q, E // num_heads)
    _build.require(ok, why)
    _build.require(k.dtype == q.dtype and v.dtype == q.dtype
                   and bias.dtype == torch.float32,
                   "decode_cross_attention generic kernel takes q/k/v of one"
                   " dtype and an fp32 bias")
    _check_kv(q, k, v, bias)
    _build.require(B >= 1 and S >= 1,
                   f"decode_cross_attention: need B, S >= 1, got B={B},"
                   f" S={S}")
    plan = generic_attention_plan(B, Q, S, num_heads, E // num_heads)
    scratch = _generic_scratch(plan, q.device)
    fn = _build.function("nic_decode_attention_generic", _ARGTYPES_GENERIC)
    out = torch.empty_like(q)
    _build.check(fn(_build.GENERIC_DTYPES[q.dtype], q.data_ptr(),
                    k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                    *map(_ptr, scratch), out.data_ptr(), B, Q, S, E,
                    num_heads, plan.splits, plan.per, plan.smem_bytes,
                    _build.stream_of(q)),
                 "decode_cross_attention generic")
    decode_cross_attention_generic.launches += 1
    return out


def _check_kv(q, k, v, bias):
    """k, v [B, S, E] and bias [B, S] of q's batch, contiguous on q's
    device (both kernels' check)."""
    B, _, E = q.shape
    S = k.shape[1]
    _build.require(k.shape == (B, S, E) and v.shape == (B, S, E)
                   and bias.shape == (B, S),
                   "decode_cross_attention: k, v must be [B, S, E] and bias"
                   " [B, S]")
    _build.require(all(t.is_contiguous() and t.device == q.device
                       for t in (q, k, v, bias)),
                   "decode_cross_attention: inputs must be contiguous, on"
                   " one device")


def _launch(q, k, v, bias, num_heads):
    B, Q, E = q.shape
    S = k.shape[1]
    _build.require(E % num_heads == 0,
                   "decode_cross_attention: E % num_heads != 0")
    ok, why = admits(q.dtype, Q, E // num_heads)
    _build.require(ok, why)
    _build.require(k.dtype == q.dtype and v.dtype == q.dtype
                   and bias.dtype == torch.float32,
                   "decode_cross_attention kernel takes bf16 q/k/v and an"
                   " fp32 bias")
    _check_kv(q, k, v, bias)
    _build.require(all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
                   "decode_cross_attention: q, k and v must be 16-byte"
                   " aligned")
    plan = attention_plan(B, Q, S, num_heads, E // num_heads,
                          _build.sms_of(q.device))
    fn = _build.function("nic_decode_attention", _ARGTYPES)
    out = torch.empty_like(q)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    bias.data_ptr(), out.data_ptr(), B, Q, S, E, num_heads,
                    plan.splits, plan.per, plan.smem_bytes,
                    _build.stream_of(q)),
                 "decode_cross_attention")
    decode_cross_attention.launches += 1
    return out


decode_cross_attention.launches = 0
decode_cross_attention_generic.launches = 0


def decode_cross_attention_int8(q: torch.Tensor, k_q: torch.Tensor,
                                k_scale: torch.Tensor, v_q: torch.Tensor,
                                v_scale: torch.Tensor, bias: torch.Tensor,
                                num_heads: int) -> torch.Tensor:
    """Returns [B, Q, E]; see `decode_cross_attention_int8_plain`. A CPU
    tensor takes the plain version; a CUDA tensor launches the int8
    kernel, or its generic variant where `route_attention_int8` says so,
    or raises (it never widens K/V to call a kernel of another type)."""
    if q.device.type == "cpu":
        return decode_cross_attention_int8_plain(q, k_q, k_scale, v_q,
                                                 v_scale, bias, num_heads)
    _build.require(q.device.type == "cuda",
                   f"decode_cross_attention_int8: no kernel for device"
                   f" {q.device}")
    B, Q, E = q.shape
    _build.require(E % num_heads == 0,
                   "decode_cross_attention_int8: E % num_heads != 0")
    if route_attention_int8(q.dtype, Q, E // num_heads) == "fast":
        return _launch_int8(q, k_q, k_scale, v_q, v_scale, bias, num_heads)
    return _launch_int8_generic(q, k_q, k_scale, v_q, v_scale, bias,
                                num_heads)


def decode_cross_attention_int8_generic(q: torch.Tensor, k_q: torch.Tensor,
                                        k_scale: torch.Tensor,
                                        v_q: torch.Tensor,
                                        v_scale: torch.Tensor,
                                        bias: torch.Tensor,
                                        num_heads: int) -> torch.Tensor:
    """`decode_cross_attention_int8` through the generic variant alone. A
    CPU tensor takes the plain version; a CUDA tensor launches the
    generic int8 attention or raises."""
    if q.device.type == "cpu":
        return decode_cross_attention_int8_plain(q, k_q, k_scale, v_q,
                                                 v_scale, bias, num_heads)
    _build.require(q.device.type == "cuda",
                   f"decode_cross_attention_int8: no kernel for device"
                   f" {q.device}")
    return _launch_int8_generic(q, k_q, k_scale, v_q, v_scale, bias,
                                num_heads)


def _check_int8_kv(q, k_q, k_scale, v_q, v_scale, bias, num_heads, what):
    """int8 k_q, v_q [B, S, E], their scales [B, S, H] of q's dtype and an
    fp32 bias [B, S], contiguous on q's device (both int8 launches'
    check)."""
    B, _, E = q.shape
    S = k_q.shape[1]
    _build.require(k_q.dtype == torch.int8 and v_q.dtype == torch.int8
                   and k_scale.dtype == q.dtype and v_scale.dtype == q.dtype
                   and bias.dtype == torch.float32,
                   f"{what} kernel takes int8 k/v, scales of q's dtype and an"
                   " fp32 bias")
    _build.require(k_q.shape == (B, S, E) and v_q.shape == (B, S, E)
                   and k_scale.shape == (B, S, num_heads)
                   and v_scale.shape == (B, S, num_heads)
                   and bias.shape == (B, S),
                   f"{what}: k_q, v_q must be [B, S, E], the scales [B, S, H]"
                   " and bias [B, S]")
    _build.require(all(t.is_contiguous() and t.device == q.device
                       for t in (q, k_q, k_scale, v_q, v_scale, bias)),
                   f"{what}: inputs must be contiguous, on one device")
    _build.require(B >= 1 and S >= 1,
                   f"{what}: need B, S >= 1, got B={B}, S={S}")


def _launch_int8_generic(q, k_q, k_scale, v_q, v_scale, bias, num_heads):
    B, Q, E = q.shape
    S = k_q.shape[1]
    _build.require(E % num_heads == 0,
                   "decode_cross_attention_int8: E % num_heads != 0")
    ok, why = admits_int8_generic(q.dtype, Q, E // num_heads)
    _build.require(ok, why)
    _check_int8_kv(q, k_q, k_scale, v_q, v_scale, bias, num_heads,
                   "decode_cross_attention_int8 generic")
    plan = generic_attention_plan(B, Q, S, num_heads, E // num_heads)
    scratch = _generic_scratch(plan, q.device)
    fn = _build.function("nic_decode_attention_int8_generic",
                         _ARGTYPES_INT8_GENERIC)
    out = torch.empty_like(q)
    _build.check(fn(_build.GENERIC_DTYPES[q.dtype], q.data_ptr(),
                    k_q.data_ptr(), k_scale.data_ptr(), v_q.data_ptr(),
                    v_scale.data_ptr(), bias.data_ptr(), *map(_ptr, scratch),
                    out.data_ptr(), B, Q, S, E, num_heads, plan.splits,
                    plan.per, plan.smem_bytes, _build.stream_of(q)),
                 "decode_cross_attention_int8 generic")
    decode_cross_attention_int8_generic.launches += 1
    return out


def _launch_int8(q, k_q, k_scale, v_q, v_scale, bias, num_heads):
    B, Q, E = q.shape
    S = k_q.shape[1]
    _build.require(E % num_heads == 0,
                   "decode_cross_attention_int8: E % num_heads != 0")
    ok, why = admits_int8(q.dtype, Q, E // num_heads)
    _build.require(ok, why)
    _check_int8_kv(q, k_q, k_scale, v_q, v_scale, bias, num_heads,
                   "decode_cross_attention_int8")
    _build.require(all(t.data_ptr() % 16 == 0 for t in (q, k_q, v_q)),
                   "decode_cross_attention_int8: q, k_q and v_q must be"
                   " 16-byte aligned")
    plan = attention_plan(B, Q, S, num_heads, E // num_heads,
                          _build.sms_of(q.device), int8=True)
    fn = _build.function("nic_decode_attention_int8", _ARGTYPES_INT8)
    out = torch.empty_like(q)
    _build.check(fn(q.data_ptr(), k_q.data_ptr(), k_scale.data_ptr(),
                    v_q.data_ptr(), v_scale.data_ptr(), bias.data_ptr(),
                    out.data_ptr(), B, Q, S, E, num_heads, plan.splits,
                    plan.per, plan.smem_bytes, _build.stream_of(q)),
                 "decode_cross_attention_int8")
    decode_cross_attention_int8.launches += 1
    return out


decode_cross_attention_int8.launches = 0
decode_cross_attention_int8_generic.launches = 0
