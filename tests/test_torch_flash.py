"""The port's flash cross-attention against the JAX Pallas kernel.

`flash_attention_*_plain` (what CPU tensors take) is held against
`news_image_caption_tpu.ops.pallas_flash.flash_cross_attention` in
interpret mode at the sizes of tests/test_pallas_flash.py (B=2, H=4,
T=10, D=16, S=24, the second item's last 7 keys padded), fp32:
forward within 1e-5, dq/dk/dv within 2e-4 (the JAX test's
tolerances). JAX's dropout bits cannot be reproduced, so at p > 0 its
mask is read back with v = I (one head, E = S: the output is the
dropped probability matrix) and fed to the port as `keep`. The port's
own generator is checked for its law, its seeds, and for using one
mask in the forward and the backward.

The head sizes the generic kernels add (4: tiny_test, 8: the toy, 24,
and 256 in one head) are held the same way at p = 0.1 in fp32 (forward
1e-5, gradients 2e-4) and bf16 (0.02, `test_bf16_rounding_points`'s):
the mask of every (item, head) is read back through one-head calls over
B * H items, since JAX keys head h of item b as item b * H + h of a
one-head call. One JAX call a (head size, dtype), jitted, computed once
a module.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from news_image_caption_tpu.ops.pallas_flash import \
    flash_cross_attention as jax_flash  # noqa: E402
from news_image_caption_tpu_torch.ops.flash_attention import (  # noqa: E402
    _fmix32, _mul32, dropout_keep, dropout_threshold, flash_attention_bwd,
    flash_attention_fwd, flash_cross_attention, flash_cross_attention_plain)

B, H, T, D, S = 2, 4, 10, 16, 24
E = H * D


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    q = rng.randn(B, T, E).astype(np.float32)
    k = rng.randn(B, S, E).astype(np.float32)
    v = rng.randn(B, S, E).astype(np.float32)
    bias = np.zeros((B, S), np.float32)
    bias[1, -7:] = -1e9
    return q, k, v, bias


def _t(*arrays, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrays]


def _seed(s):
    return torch.tensor([s], dtype=torch.int32)


def _jax_out_and_grads(q, k, v, bias, heads, p, seed):
    """JAX's output and the gradients of sum(sin(out))."""
    def fwd(q, k, v):
        return jax_flash(q, k, v, jnp.asarray(bias),
                         jnp.full((1,), seed, jnp.int32), heads, p, True)

    grads = jax.grad(lambda *a: jnp.sum(jnp.sin(fwd(*a))),
                     argnums=(0, 1, 2))(q, k, v)
    return fwd(q, k, v), grads


def test_forward_matches_pallas(data):
    q, k, v, bias = data
    want = jax_flash(q, k, v, jnp.asarray(bias), jnp.zeros((1,), jnp.int32),
                     H, 0.0, True)
    out, lse = flash_attention_fwd(*_t(q, k, v, bias), _seed(0), H)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    s = np.einsum("bthd,bshd->bhts", q.reshape(B, T, H, D),
                  k.reshape(B, S, H, D)) + bias[:, None, None, :]
    np.testing.assert_allclose(lse.numpy(),
                               np.log(np.exp(s - s.max(-1, keepdims=True))
                                      .sum(-1)) + s.max(-1),
                               rtol=1e-5, atol=1e-5)


def test_gradients_match_pallas(data):
    q, k, v, bias = data
    _, want = _jax_out_and_grads(q, k, v, bias, H, 0.0, 0)
    tq, tk, tv = _t(q, k, v, grad=True)
    out = flash_cross_attention(tq, tk, tv, torch.from_numpy(bias),
                                _seed(0), H)
    got = torch.autograd.grad(torch.sin(out).sum(), (tq, tk, tv))
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-4, err_msg=name)


def _jax_mask(q, k, p, seed):
    """JAX's keep mask for one head, read back through v = I."""
    Bs, Ss = q.shape[0], k.shape[1]
    eye = np.broadcast_to(np.eye(Ss, q.shape[2], dtype=np.float32),
                          (Bs, Ss, q.shape[2]))
    dropped = jax_flash(q, k, eye, jnp.zeros((Bs, Ss), jnp.float32),
                        jnp.full((1,), seed, jnp.int32), 1, p, True)
    return np.asarray(dropped)[:, :, :Ss] > 0


def test_dropout_with_jax_mask_matches_pallas():
    """p = 0.25, one head (E = S = 32): the port's plain forward and the
    Function's backward fed JAX's own mask equal JAX's values (1e-5)
    and gradients (2e-4)."""
    rng = np.random.RandomState(1)
    Bs, Ts, Es = 2, 8, 32
    p, seed = 0.25, 3
    q = rng.randn(Bs, Ts, Es).astype(np.float32)
    k = rng.randn(Bs, Es, Es).astype(np.float32)
    v = rng.randn(Bs, Es, Es).astype(np.float32)
    bias = np.zeros((Bs, Es), np.float32)
    keep = _jax_mask(q, k, p, seed)
    assert abs(keep.mean() - (1 - p)) < 0.07
    want, want_g = _jax_out_and_grads(q, k, v, bias, 1, p, seed)
    tq, tk, tv = _t(q, k, v, grad=True)
    keep_t = torch.from_numpy(keep)[:, None]
    out = flash_cross_attention(tq, tk, tv, torch.from_numpy(bias),
                                _seed(seed), 1, p, keep_t)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    got = torch.autograd.grad(torch.sin(out).sum(), (tq, tk, tv))
    for g, w, name in zip(got, want_g, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-4, err_msg=name)


def test_mul32_and_fmix32_are_exact_uint32_arithmetic():
    rng = np.random.RandomState(2)
    a = rng.randint(0, 2 ** 32, size=1000, dtype=np.uint64)
    for c in (0x85EBCA6B, 0xC2B2AE35, 2654435761, 1):
        want = (a * np.uint64(c)) & np.uint64(0xFFFFFFFF)
        got = _mul32(torch.from_numpy(a.astype(np.int64)), c)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    h = a.astype(np.uint32)     # murmur3 fmix32 in numpy uint32
    with np.errstate(over="ignore"):
        h ^= h >> np.uint32(16)
        h *= np.uint32(0x85EBCA6B)
        h ^= h >> np.uint32(13)
        h *= np.uint32(0xC2B2AE35)
        h ^= h >> np.uint32(16)
    np.testing.assert_array_equal(
        _fmix32(torch.from_numpy(a.astype(np.int64))).numpy(),
        h.astype(np.int64))


@pytest.mark.parametrize("p", [0.1, 0.25, 0.5])
def test_generator_keeps_one_minus_p(p):
    keep = dropout_keep(_seed(7), 4, 4, 25, 40, p)   # 16,000 draws
    assert keep.shape == (4, 4, 25, 40) and keep.dtype == torch.bool
    assert abs(keep.float().mean().item() - (1 - p)) < 0.03
    # No (b, h) or row is a copy of another.
    rows = keep.reshape(-1, 40)
    assert len({tuple(r.tolist()) for r in rows}) > 0.95 * rows.shape[0]


def test_generator_seeds():
    a = dropout_keep(_seed(11), 2, 4, 10, 24, 0.3)
    assert torch.equal(a, dropout_keep(_seed(11), 2, 4, 10, 24, 0.3))
    b = dropout_keep(_seed(12), 2, 4, 10, 24, 0.3)
    assert (a != b).float().mean().item() > 0.2
    c = dropout_keep(_seed(-5), 2, 4, 10, 24, 0.3)    # negative int32 seeds
    assert (a != c).float().mean().item() > 0.2
    assert dropout_threshold(0.0) == 0
    assert dropout_threshold(0.1) == int(0.1 * 2 ** 32)


def test_forward_and_backward_use_one_mask(data):
    """The Function's backward (its own generator in both passes)
    equals autograd through the plain forward with that mask
    materialised, and the forward equals the plain forward with it."""
    q, k, v, bias = data
    p, seed = 0.3, 9
    keep = dropout_keep(_seed(seed), B, H, T, S, p)
    tq, tk, tv = _t(q, k, v, grad=True)
    tb = torch.from_numpy(bias)
    out = flash_cross_attention(tq, tk, tv, tb, _seed(seed), H, p)
    ref = flash_cross_attention_plain(tq, tk, tv, tb, _seed(seed), H, p, keep)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    g = torch.randn(B, T, E, generator=torch.Generator().manual_seed(0))
    got = torch.autograd.grad(out, (tq, tk, tv), g)
    want = torch.autograd.grad(ref, (tq, tk, tv), g)
    for a, b_, name in zip(got, want, ("dq", "dk", "dv")):
        torch.testing.assert_close(a, b_, rtol=1e-5, atol=1e-5, msg=name)
    # Another seed gives another output.
    other = flash_cross_attention(tq, tk, tv, tb, _seed(seed + 1), H, p)
    assert not torch.allclose(out, other)


def test_bf16_rounding_points(data):
    """bf16 inputs: probabilities rounded to bf16 before the value
    product, out in bf16; lse fp32; grads in the inputs' dtypes."""
    q, k, v, bias = data
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    tb = torch.from_numpy(bias)
    out, lse = flash_attention_fwd(tq, tk, tv, tb, _seed(1), H, 0.1)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    dq, dk, dv = flash_attention_bwd(tq, tk, tv, tb, _seed(1), lse,
                                     torch.ones_like(out), H, 0.1)
    assert (dq.dtype, dk.dtype, dv.dtype) == (torch.bfloat16,) * 3
    ref, _ = flash_attention_fwd(tq.float(), tk.float(), tv.float(), tb,
                                 _seed(1), H, 0.1)
    torch.testing.assert_close(out.float(), ref, rtol=0.02, atol=0.02)


# -- the generic kernels' head sizes -----------------------------------------

GENERIC_HEADS = [(4, 4), (8, 4), (24, 4), (256, 1)]   # (head size, heads)
P_GENERIC, SEED_GENERIC = 0.1, 3


def _jax_mask_heads(H, p, seed):
    """JAX's keep mask [B, H, T, S] of an H-head call, read back through
    one one-head call over B * H items (item b * H + h of that call
    hashes as head h of item b)."""
    rng = np.random.RandomState(5)
    q = (rng.randn(B * H, T, S) * 0.3).astype(np.float32)
    k = rng.randn(B * H, S, S).astype(np.float32)
    return _jax_mask(q, k, p, seed).reshape(B, H, T, S)


@pytest.fixture(scope="module")
def generic_reference():
    """get(head, H, dtype) -> (q, k, v, bias, keep, JAX's out, JAX's
    dq, dk, dv of sum(sin(out))), numpy, for p = 0.1 and JAX's own mask;
    each computed on first use."""
    masks, cache = {}, {}

    def get(head, H, dtype):
        if H not in masks:
            masks[H] = _jax_mask_heads(H, P_GENERIC, SEED_GENERIC)
        if (head, H, dtype) not in cache:
            rng = np.random.RandomState(head)
            E = head * H
            q = (rng.randn(B, T, E) * head ** -0.5).astype(np.float32)
            k = rng.randn(B, S, E).astype(np.float32)
            v = rng.randn(B, S, E).astype(np.float32)
            bias = np.zeros((B, S), np.float32)
            bias[1, -7:] = -1e9
            jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
            seed = jnp.full((1,), SEED_GENERIC, jnp.int32)

            def fwd(q, k, v):
                return jax_flash(q, k, v, jnp.asarray(bias), seed, H,
                                 P_GENERIC, True)

            @jax.jit
            def run(q, k, v):
                # One forward: the output and the vjp of sum(sin(out)).
                out, vjp = jax.vjp(fwd, q, k, v)
                return out, vjp(jnp.cos(out.astype(jnp.float32)).astype(
                    out.dtype))

            out, grads = run(*(jnp.asarray(a, jd) for a in (q, k, v)))
            cache[head, H, dtype] = (
                q, k, v, bias, masks[H], np.asarray(out, np.float32),
                [np.asarray(g, np.float32) for g in grads])
        return cache[head, H, dtype]
    return get


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head,H", GENERIC_HEADS)
def test_generic_head_sizes_match_pallas(generic_reference, head, H, dtype):
    """Heads of 4, 8, 24 and 256 (the generic kernels' sizes), p = 0.1
    with JAX's mask: the port's output and gradients against the Pallas
    kernel's, fp32 at 1e-5 / 2e-4, bf16 at 0.02 (one bf16 rounding of a
    probability, of ds or of the output)."""
    q, k, v, bias, keep, want, want_g = generic_reference(head, H, dtype)
    td = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(td).requires_grad_()
                  for a in (q, k, v))
    out = flash_cross_attention(tq, tk, tv, torch.from_numpy(bias),
                                _seed(SEED_GENERIC), H, P_GENERIC,
                                torch.from_numpy(keep))
    assert out.dtype == td
    got = torch.autograd.grad(torch.sin(out.float()).sum(), (tq, tk, tv))
    tol_out, tol_grad = (1e-5, 2e-4) if dtype == "float32" else (0.02, 0.02)
    np.testing.assert_allclose(out.detach().float().numpy(), want,
                               rtol=tol_out, atol=tol_out)
    for g, w, name in zip(got, want_g, ("dq", "dk", "dv")):
        assert g.dtype == td
        np.testing.assert_allclose(g.float().numpy(), w, rtol=tol_grad,
                                   atol=tol_grad, err_msg=name)
