"""The port's dynamic conv against the JAX reference, on the CPU.

`ops/dynamic_conv.py::dynamic_conv_plain` (what CPU tensors take) is
held against `news_image_caption_tpu.ops.pallas_kernels.
dynamic_conv_pallas` in interpret mode at the shapes of
tests/test_pallas_kernels.py plus one at flagship width (C=1024, H=16,
K=31), fp32, atol 1e-5 (that test's tolerance). The port's
`ops/conv.py::DynamicConv`, carried from a JAX `DynamicConv` by
`params_from_jax`, is held against it for every route and flag at fp32,
atol = rtol = 1e-5 (the tolerance of test_torch_model.py). The JAX
module calls its kernel without interpret mode, so its pallas route at
T % 128 == 0 is composed from its own pieces: `_weights`, then
`dynamic_conv_pallas(interpret=True)`, then the conv bias.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from news_image_caption_tpu.ops.conv import \
    DynamicConv as JaxDynamicConv  # noqa: E402
from news_image_caption_tpu.ops.pallas_kernels import \
    dynamic_conv_pallas  # noqa: E402
from news_image_caption_tpu_torch.models.from_jax import \
    params_from_jax  # noqa: E402
from news_image_caption_tpu_torch.ops import DynamicConv  # noqa: E402
from news_image_caption_tpu_torch.ops.conv import \
    _shift_accumulate  # noqa: E402
from news_image_caption_tpu_torch.ops.dynamic_conv import (  # noqa: E402
    dynamic_conv, dynamic_conv_plain)

C, H, K = 32, 4, 5
FLAGS = {"default": {}, "use_bias": {"use_bias": True},
         "conv_bias": {"conv_bias": True},
         "no_softmax": {"weight_softmax": False}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, so that the suite's parallel
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _taps(rng, B, T, H, K):
    logits = rng.randn(B, T, H, K)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("B,T,C,H,K,tile", [
    (2, 16, 32, 4, 3, 8),
    (1, 32, 64, 8, 7, 16),
    (2, 16, 16, 2, 15, 16),
    (1, 128, 1024, 16, 31, 128),    # flagship width, widest layer
])
def test_plain_matches_pallas_interpret(B, T, C, H, K, tile):
    rng = np.random.RandomState(K)
    x = rng.randn(B, T, C).astype(np.float32)
    w = _taps(rng, B, T, H, K)
    want = dynamic_conv_pallas(jnp.asarray(x), jnp.asarray(w), H, tile=tile,
                               interpret=True)
    before = dynamic_conv.launches
    got = dynamic_conv(torch.from_numpy(x), torch.from_numpy(w), H)
    assert dynamic_conv.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_plain_rounds_once_in_bf16():
    """bf16 in: the fp32 tap-order sum rounded once, which the shift
    route (K roundings in bf16) does not give."""
    rng = np.random.RandomState(3)
    B, T = 2, 40
    x = torch.from_numpy(rng.randn(B, T, C).astype(np.float32)).bfloat16()
    w = torch.from_numpy(_taps(rng, B, T, H, 31)).bfloat16()
    got = dynamic_conv_plain(x, w, H)
    assert got.dtype == torch.bfloat16
    want = dynamic_conv_plain(x.float(), w.float(), H).bfloat16()
    assert torch.equal(got, want)
    shift = _shift_accumulate(x.view(B, T, H, C // H), w, 31).view(B, T, C)
    assert not torch.equal(got, shift)


def test_plain_is_causal():
    rng = np.random.RandomState(1)
    B, T, t = 1, 16, 10
    x = torch.from_numpy(rng.randn(B, T, C).astype(np.float32))
    w = torch.from_numpy(_taps(rng, B, T, H, 7))
    x2 = x.clone()
    x2[:, t:] = 99.0
    out1, out2 = dynamic_conv(x, w, H), dynamic_conv(x2, w, H)
    assert torch.equal(out1[:, :t], out2[:, :t])
    assert not torch.equal(out1[:, t:], out2[:, t:])


def _pair(method, flags, T, seed=0):
    """A JAX DynamicConv and the port's, with one set of params (the
    zero-initialized biases replaced by random ones), and x [2, T, C]."""
    rng = np.random.RandomState(seed)
    x = rng.randn(2, T, C).astype(np.float32)
    jmod = JaxDynamicConv(input_size=C, kernel_size=K, num_heads=H,
                          method=method, **flags)
    # Initialized on 8 rows: the pallas route at T % 128 == 0 would
    # call the kernel outside interpret mode.
    params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(0),
                                                jnp.asarray(x[:, :8])))
    inner = params["params"]
    if "bias" in inner["weight_linear"]:
        inner["weight_linear"]["bias"] = rng.randn(H * K).astype(np.float32)
    if "conv_bias" in inner:
        inner["conv_bias"] = rng.randn(C).astype(np.float32)
    mod = DynamicConv(C, K, H, device="cpu", dtype=torch.float32,
                      method=method, **flags)
    mod.load_state_dict(params_from_jax(params, mod))
    return jmod, params, mod, x


def _jax_forward(jmod, params, x, query=None):
    B, T, _ = x.shape
    if jmod.method != "pallas" or T % 128:
        return jmod.apply(params, jnp.asarray(x), query)
    w = jmod.apply(params, jnp.asarray(x if query is None else query), True,
                   method=JaxDynamicConv._weights)
    out = dynamic_conv_pallas(jnp.asarray(x), w, H, interpret=True)
    if jmod.conv_bias:
        out = out + params["params"]["conv_bias"]
    return out


@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("T", [128, 63])
@pytest.mark.parametrize("method", ["shift", "band", "pallas"])
def test_module_matches_jax(method, T, flags):
    jmod, params, mod, x = _pair(method, FLAGS[flags], T)
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(
        _jax_forward(jmod, params, x)), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("method", ["shift", "pallas"])
def test_module_taps_from_query_match_jax(method):
    jmod, params, mod, x = _pair(method, {}, 128)
    query = np.random.RandomState(9).randn(*x.shape).astype(np.float32)
    with torch.no_grad():
        got = mod(torch.from_numpy(x), query=torch.from_numpy(query))
    np.testing.assert_allclose(got.numpy(), np.asarray(
        _jax_forward(jmod, params, x, jnp.asarray(query))), atol=1e-5,
        rtol=1e-5)


def test_module_step_ring_adds_conv_bias():
    jmod, params, mod, x = _pair("shift", {"conv_bias": True}, 6)
    jcache, cache = jnp.zeros((2, K - 1, C)), torch.zeros(2, K - 1, C)
    for t in range(x.shape[1]):
        jout, jcache = jmod.apply(params, jnp.asarray(x[:, t]), jcache, t,
                                  method=JaxDynamicConv.step_ring)
        with torch.no_grad():
            out, cache = mod.step_ring(torch.from_numpy(x[:, t]), cache, t)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5,
                                   rtol=1e-5)


def test_pallas_route_short_sequence_is_the_shift_route():
    """T % 128 != 0: the pallas route is the shift route, bit for bit, in
    bf16 too, and no kernel is launched."""
    _, _, mod, x = _pair("pallas", {}, 63)
    shift = DynamicConv(C, K, H, device="cpu", dtype=torch.float32)
    shift.load_state_dict(mod.state_dict())
    before = dynamic_conv.launches
    for dtype in (torch.float32, torch.bfloat16):
        xt = torch.from_numpy(x).to(dtype)
        with torch.no_grad():
            assert torch.equal(mod.to(dtype)(xt), shift.to(dtype)(xt))
    assert dynamic_conv.launches == before


def test_pallas_route_rounds_once_in_bf16():
    """At T % 128 == 0 the pallas route is the plain kernel twin on the
    module's taps: fp32 sums rounded once, not the shift route's."""
    _, _, mod, x = _pair("pallas", {}, 128)
    mod = mod.to(torch.bfloat16)
    xt = torch.from_numpy(x).bfloat16()
    with torch.no_grad():
        w = mod._weights(xt)
        got = mod(xt)
    assert torch.equal(got, dynamic_conv_plain(xt, w, H))
    shift = _shift_accumulate(xt.view(2, 128, H, C // H), w, K)
    assert not torch.equal(got, shift.reshape(got.shape))


def test_pallas_route_is_causal():
    _, _, mod, x = _pair("pallas", {}, 128)
    x2 = x.copy()
    x2[:, 70:] = 99.0
    with torch.no_grad():
        out1, out2 = mod(torch.from_numpy(x)), mod(torch.from_numpy(x2))
    assert torch.equal(out1[:, :70], out2[:, :70])


def test_pallas_route_backward_raises():
    """The reference kernel has no gradient; neither has the port's."""
    _, _, mod, x = _pair("pallas", {}, 128)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = mod(xt)
    assert out.requires_grad
    with pytest.raises(NotImplementedError, match="no gradient"):
        out.sum().backward()
    # The shift route at T % 128 != 0 trains as before.
    _, _, mod, x = _pair("pallas", {}, 63)
    xt = torch.from_numpy(x).requires_grad_(True)
    mod(xt).sum().backward()
    assert xt.grad is not None and torch.isfinite(xt.grad).all()


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="method 'conv'"):
        DynamicConv(C, K, H, device="cpu", dtype=torch.float32,
                    method="conv")
