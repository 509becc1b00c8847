"""The port's module options against the JAX reference, on the CPU.

Each module the decoder's options reach is initialized in JAX, carried
into the port by `params_from_jax`, and fed the same seeded numpy
inputs: `LightweightConv` (full forward, the shift `step`, `chunk`, the
ring-major `step_ring` and `ring_step` against the full forward),
`DynamicConv(weight_softmax=False)`, `LearnedPositionalEmbedding`,
`MultiHeadAttention`'s `use_bias` / `add_bias_kv` / `add_zero_attn` with
an additive causal mask (`causal_mask`, `extend_attn_mask`) in
self-attention, `GatedLinear`, `DownsampledMultiHeadAttention` on the
reference tests' cases, the adaptive embedding and softmax with
`factor`, `tie_proj` and untied tables through `loss_sum`, `log_prob`
and `topk_log_prob` (the port's band-kernel form), and parameters
stored in bf16 for an fp32 input. fp32 at atol = rtol = 1e-5 (the
tolerance of test_torch_model.py's op tests; 2e-4 for log-probs).
Dropout laws (the conv taps, the tail projections) are held against
the mask drawn from a copy of the generator.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import linen as fnn  # noqa: E402

from news_image_caption_tpu.ops import adaptive as jax_adaptive  # noqa: E402
from news_image_caption_tpu.ops import attention as jax_attention  # noqa: E402
from news_image_caption_tpu.ops import conv as jax_conv  # noqa: E402
from news_image_caption_tpu.ops.linear import \
    GehringLinear as JaxGehringLinear  # noqa: E402
from news_image_caption_tpu.ops.positional import \
    LearnedPositionalEmbedding as JaxLearnedPositions  # noqa: E402
from news_image_caption_tpu_torch.models.from_jax import \
    params_from_jax  # noqa: E402
from news_image_caption_tpu_torch.ops.adaptive import (  # noqa: E402
    AdaptiveEmbedding, AdaptiveSoftmax)
from news_image_caption_tpu_torch.ops.attention import (  # noqa: E402
    DownsampledMultiHeadAttention, GatedLinear, MultiHeadAttention,
    causal_mask, extend_attn_mask)
from news_image_caption_tpu_torch.ops.conv import (  # noqa: E402
    DynamicConv, LightweightConv, _shift_accumulate)
from news_image_caption_tpu_torch.ops.linear import \
    GehringLinear  # noqa: E402
from news_image_caption_tpu_torch.ops.positional import \
    LearnedPositionalEmbedding  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
F32 = torch.float32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, so that the suite's parallel
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _carry(params, module):
    module.load_state_dict(params_from_jax(_np(params), module))
    return module


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


# -- convolutions -------------------------------------------------------------

C, H = 16, 4


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("weight_softmax", [True, False])
def test_lightweight_conv_matches(K, weight_softmax):
    """Forward, step, chunk and step_ring against JAX's, and the ring
    steps against the full forward."""
    rng = np.random.RandomState(K)
    B, T = 3, 9
    xs = rng.randn(B, T, C).astype(np.float32)
    jconv = jax_conv.LightweightConv(input_size=C, kernel_size=K,
                                     num_heads=H, conv_bias=True,
                                     weight_softmax=weight_softmax)
    params = jax.jit(jconv.init)(jax.random.PRNGKey(K), jnp.asarray(xs))
    params = jax.tree.map(lambda a: a + 0.1, params)    # a nonzero bias
    conv = _carry(params, LightweightConv(C, K, H, conv_bias=True,
                                          weight_softmax=weight_softmax,
                                          device="cpu", dtype=F32))
    with torch.no_grad():
        full = conv(_t(xs))
    _close(full, jax.jit(jconv.apply)(params, jnp.asarray(xs)))

    step = jax.jit(lambda p, x, c: jconv.apply(
        p, x, c, method=jax_conv.LightweightConv.step))
    ring_step = jax.jit(lambda p, x, c, t: jconv.apply(
        p, x, c, t, method=jax_conv.LightweightConv.step_ring))
    chunk = jax.jit(lambda p, x, c: jconv.apply(
        p, x, c, method=jax_conv.LightweightConv.chunk))
    jcache = jring = jnp.zeros((B, K - 1, C))
    cache = conv.init_cache(B, "cpu")
    ring = torch.zeros(K - 1, B, C)
    with torch.no_grad():
        for t in range(T):
            x_t = _t(xs[:, t])
            jout, jcache = step(params, jnp.asarray(xs[:, t]), jcache)
            out, cache = conv.step(x_t, cache)
            _close(out, jout)
            # the positions as a per-row tensor read the same slots
            _close(conv.ring_step(x_t, ring, torch.full((B,), t)),
                   full[:, t])
            jrout, jring = ring_step(params, jnp.asarray(xs[:, t]), jring, t)
            rout, ring = conv.step_ring(x_t, ring, t)
            _close(rout, jrout)
            _close(rout, full[:, t])
        _close(cache, jcache)
        _close(ring.transpose(0, 1), jring)
        # a chunk of the last 4 inputs after the first T - 4
        jc = jnp.asarray(xs[:, T - 4 - (K - 1):T - 4]) if K > 1 else \
            jnp.zeros((B, 0, C))
        got = conv.chunk(_t(xs[:, T - 4:]), _t(jc))
        _close(got, chunk(params, jnp.asarray(xs[:, T - 4:]), jc))
        _close(got, full[:, T - 4:])


def test_lightweight_conv_bf16_params_match():
    """bf16 taps for an fp32 input: softmaxed in fp32, rounded to bf16,
    then widened, as the reference's `_weights`."""
    rng = np.random.RandomState(7)
    xs = rng.randn(2, 6, C).astype(np.float32)
    jconv = jax_conv.LightweightConv(input_size=C, kernel_size=3,
                                     num_heads=H, param_dtype=jnp.bfloat16)
    params = jax.jit(jconv.init)(jax.random.PRNGKey(3), jnp.asarray(xs))
    conv = _carry(params, LightweightConv(C, 3, H, device="cpu",
                                          dtype=torch.bfloat16))
    assert conv.weight.dtype == torch.bfloat16
    with torch.no_grad():
        _close(conv(_t(xs)), jax.jit(jconv.apply)(params, jnp.asarray(xs)))


def test_lightweight_conv_weight_dropout_draws_from_generator():
    conv = LightweightConv(C, 5, H, weight_dropout=0.3, device="cpu",
                           dtype=F32, generator=torch.Generator().manual_seed(1))
    x = torch.randn(2, 7, C, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got = conv(x, torch.Generator().manual_seed(9))
        w = torch.softmax(conv.weight, dim=-1)
        keep = torch.rand(w.shape, generator=torch.Generator().manual_seed(9))
        w = torch.where(keep < 0.7, w / 0.7, torch.zeros(()))
        want = _shift_accumulate(x.view(2, 7, H, C // H),
                                 w.expand(2, 7, H, 5), 5).reshape(2, 7, C)
        assert torch.equal(got, want)
        assert not torch.equal(got, conv(x))


def test_dynamic_conv_without_softmax_matches():
    """weight_softmax=False: the raw predicted taps, full forward and
    the ring-major `ring_step` at a position a row."""
    rng = np.random.RandomState(11)
    B, T, K = 2, 8, 4
    xs = rng.randn(B, T, C).astype(np.float32)
    jconv = jax_conv.DynamicConv(input_size=C, kernel_size=K, num_heads=H,
                                 weight_softmax=False)
    params = jax.jit(jconv.init)(jax.random.PRNGKey(4), jnp.asarray(xs))
    conv = _carry(params, DynamicConv(C, K, H, weight_softmax=False,
                                      device="cpu", dtype=F32))
    with torch.no_grad():
        full = conv(_t(xs))
        _close(full, jax.jit(jconv.apply)(params, jnp.asarray(xs)))
        ring = torch.zeros(K - 1, B, C)
        for t in range(T):
            out = conv.ring_step(_t(xs[:, t]), ring, torch.full((B,), t))
            _close(out, full[:, t])
            ring[t % (K - 1)] = _t(xs[:, t])


# -- positions ----------------------------------------------------------------

def test_learned_positions_match():
    ids = np.array([[0, 5, 6, 7, 1, 1], [0, 9, 9, 9, 9, 9]], np.int32)
    jpos = JaxLearnedPositions(max_positions=16, embedding_dim=8)
    params = jax.jit(jpos.init)(jax.random.PRNGKey(0), jnp.asarray(ids))
    pos = _carry(params, LearnedPositionalEmbedding(16, 8, device="cpu",
                                                    dtype=F32))
    apply = jax.jit(jpos.apply)
    with torch.no_grad():
        _close(pos(_t(ids).long()), apply(params, jnp.asarray(ids)))
        _close(pos(_t(ids[:, :1]).long(), 4),
               apply(params, jnp.asarray(ids[:, :1]), 4))
        _close(pos(_t(ids[:, :1]).long(), torch.tensor([[2], [5]])),
               apply(params, jnp.asarray(ids[:, :1]),
                     jnp.asarray([[2], [5]])))
    fresh = LearnedPositionalEmbedding(
        512, 64, device="cpu", dtype=F32,
        generator=torch.Generator().manual_seed(0))
    table = fresh.embedding.detach()
    assert table.shape == (515, 64) and not table[1].any()
    assert abs(table.std().item() - 0.1) < 0.005


# -- attention ----------------------------------------------------------------

E = 16


@pytest.mark.parametrize("flags", [
    dict(use_bias=False, add_bias_kv=False, add_zero_attn=False),
    dict(use_bias=True, add_bias_kv=False, add_zero_attn=True),
    dict(use_bias=False, add_bias_kv=True, add_zero_attn=False)])
def test_mha_options_causal_self_attention_match(flags):
    """Self-attention under `extend_attn_mask(causal_mask(T))`, with the
    head-averaged weights; then `attend_flat_beam` (the decode kernel's
    plain twin) at beam 2 over kv of S' = S + extra slots."""
    rng = np.random.RandomState(len(str(flags)))
    B, T = 2, 6
    x = rng.randn(B, T, E).astype(np.float32)
    pad = np.zeros((B, T), bool)
    pad[1, -2:] = True
    jm = jax_attention.MultiHeadAttention(embed_dim=E, num_heads=4, **flags)
    am = jax_attention.extend_attn_mask(jax_attention.causal_mask(T),
                                        int(flags["add_bias_kv"])
                                        + int(flags["add_zero_attn"]))
    params = jax.jit(lambda k: jm.init(k, x, x, x, attn_mask=am))(
        jax.random.PRNGKey(5))
    want, want_w = jax.jit(lambda p: jm.apply(
        p, x, x, x, key_padding_mask=pad, attn_mask=am,
        need_weights=True))(params)
    m = _carry(params, MultiHeadAttention(E, 4, E, device="cpu", dtype=F32,
                                          **flags))
    mask = extend_attn_mask(causal_mask(T), m.extra_slots())
    np.testing.assert_array_equal(mask.numpy(), np.asarray(am))
    with torch.no_grad():
        got, got_w = m(_t(x), _t(x), _t(x), _t(pad), mask, need_weights=True)
        assert m(_t(x), _t(x), _t(x), _t(pad), mask).shape == (B, T, E)
    _close(got, want)
    _close(got_w, want_w)
    q = rng.randn(2 * B, E).astype(np.float32)

    def jax_fn(mod, q, c, msk):
        return mod.attend_flat_beam(q, mod.precompute_kv(c, c, msk), 2)

    want = jax.jit(lambda p: jm.apply(p, q, x, pad, method=jax_fn))(params)
    with torch.no_grad():
        kv = m.precompute_kv(_t(x), _t(x), _t(pad))
        assert kv.k.shape == (B, T + m.extra_slots(), E)
        _close(m.attend_flat_beam(_t(q), kv, 2), want)


def test_gated_linear_matches():
    x = np.random.RandomState(3).randn(3, 5, 12).astype(np.float32)
    jm = jax_attention.GatedLinear(features=8)
    params = jax.jit(jm.init)(jax.random.PRNGKey(6), x)
    m = _carry(params, GatedLinear(12, 8, device="cpu", dtype=F32))
    with torch.no_grad():
        _close(m(_t(x)), jax.jit(jm.apply)(params, x))


@pytest.mark.parametrize("case", [
    dict(mod=dict(downsample=True), call=dict(mask_future_timesteps=True,
                                              use_scalar_bias=True)),
    dict(mod=dict(downsample=False, project_input=False),
         call=dict(mask_future_timesteps=True, use_scalar_bias=False)),
    dict(mod=dict(downsample=False, gated=True),
         call=dict(key_padding_mask=True)),
    dict(mod=dict(downsample=True, gated=True),
         call=dict(mask_future_timesteps=True, use_scalar_bias=True))],
    ids=["strided_causal_scalar", "unprojected_causal", "gated_padded",
         "strided_gated"])
def test_downsampled_mha_matches(case):
    B, T, Dm, Hm = 2, 7, 8, 4
    x = np.random.RandomState(4).randn(B, T, Dm).astype(np.float32)
    call = dict(case["call"])
    if call.pop("key_padding_mask", False):
        pad = np.zeros((B, T), bool)
        pad[0, -3:] = True
        call["key_padding_mask"] = pad
    jm = jax_attention.DownsampledMultiHeadAttention(
        out_channels=Dm, embed_dim=Dm, num_heads=Hm, **case["mod"])
    params = jax.jit(lambda k: jm.init(k, x, x, x, **call))(
        jax.random.PRNGKey(1))
    want, want_w = jax.jit(lambda p: jm.apply(p, x, x, x, **call))(params)
    m = _carry(params, DownsampledMultiHeadAttention(
        Dm, Dm, Hm, device="cpu", dtype=F32, **case["mod"]))
    tcall = {k: (_t(v) if isinstance(v, np.ndarray) else v)
             for k, v in call.items()}
    with torch.no_grad():
        got, got_w = m(_t(x), _t(x), _t(x), **tcall)
    _close(got, want, rtol=1e-4, atol=1e-5)
    _close(got_w, want_w)


# -- adaptive embedding and softmax -------------------------------------------

V, D = 96, 32
CUT = (24, 48, V)


class _JaxAdaptive(fnn.Module):
    """The reference's embedder and softmax side by side."""

    factor: float = 1.0
    tied: bool = True
    tie_proj: bool = False
    dropout: float = 0.0

    def setup(self):
        self.emb = jax_adaptive.AdaptiveEmbedding(
            cutoff=CUT, initial_dim=D, output_dim=D, factor=self.factor)
        self.sm = jax_adaptive.AdaptiveSoftmax(
            vocab_size=V, input_dim=D, cutoff=CUT, factor=self.factor,
            tied=self.tied, tie_proj=self.tie_proj, dropout=self.dropout)

    def tables(self):
        if not self.tied:
            return None
        return [self.emb.weights_for_band(i) for i in range(len(CUT))]

    def __call__(self, ids, x):
        return self.emb(ids), self.sm.loss_sum(x, ids, 1, self.tables())

    def log_prob(self, x):
        return self.sm.log_prob(x, self.tables())

    def topk(self, x):
        return self.sm.topk_log_prob(x, 5, self.tables())


def _port_adaptive(opts):
    kw = dict(device="cpu", dtype=F32)
    return torch.nn.ModuleDict({
        "emb": AdaptiveEmbedding(CUT, D, D, factor=opts.get("factor", 1.0),
                                 **kw),
        "sm": AdaptiveSoftmax(D, CUT, factor=opts.get("factor", 1.0),
                              tied=opts.get("tied", True),
                              tie_proj=opts.get("tie_proj", False),
                              dropout=opts.get("dropout", 0.0), **kw)})


@pytest.mark.parametrize("opts", [dict(factor=4.0), dict(tie_proj=True),
                                  dict(factor=2.0, tie_proj=True),
                                  dict(tied=False), dict(tied=False,
                                                         factor=4.0)],
                         ids=["factor4", "tie_proj", "factor2_tie_proj",
                              "untied", "untied_factor4"])
def test_adaptive_options_match(opts):
    """Embeddings, loss_sum, log_prob and the band-kernel topk_log_prob
    (head [word table; class_projᵀ], tails through band_topk_lse)
    against the reference's."""
    rng = np.random.RandomState(2)
    N = 20
    ids = rng.randint(0, V, size=(N,)).astype(np.int32)
    ids[:3] = [1, 25, 49]          # the padding id and in-band pads
    x = rng.randn(N, D).astype(np.float32)
    jm = _JaxAdaptive(**opts)
    params = jax.jit(jm.init)(jax.random.PRNGKey(8), ids, x)
    (jemb, (jloss, jn)) = jax.jit(jm.apply)(params, ids, x)
    jlp = jax.jit(lambda p: jm.apply(p, x, method=_JaxAdaptive.log_prob))(
        params)
    jv, ji = jax.jit(lambda p: jm.apply(p, x, method=_JaxAdaptive.topk))(
        params)
    m = _carry(params, _port_adaptive(opts))
    sm = m["sm"]
    tables = (m["emb"].weights_for_band(i) for i in range(len(CUT)))
    tables = list(tables) if opts.get("tied", True) else None
    with torch.no_grad():
        _close(m["emb"](_t(ids).long()), jemb)
        loss, n = sm.loss_sum(_t(x), _t(ids).long(), 1, tables)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
        assert n.item() == int(jn)
        _close(sm.log_prob(_t(x), tables), jlp, atol=2e-4, rtol=2e-4)
        v, i = sm.topk_log_prob(_t(x), 5, tables)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    _close(v, jv)


def test_adaptive_tail_dropout_draws_from_generator():
    m = _port_adaptive(dict(dropout=0.25, tie_proj=True))
    tables = [m["emb"].weights_for_band(i) for i in range(len(CUT))]
    x = torch.randn(6, D, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        got = m["sm"].tail_hidden(x, 2, tables,
                                  torch.Generator().manual_seed(4))
        h = x @ tables[2][1].T
        keep = torch.rand(h.shape, generator=torch.Generator().manual_seed(4))
        assert torch.equal(got, torch.where(keep < 0.75, h / 0.75,
                                            torch.zeros(())))
        assert torch.equal(m["sm"].tail_hidden(x, 2, tables), h)


def test_untied_requires_no_tie_proj():
    with pytest.raises(ValueError, match="tie_proj requires tied"):
        AdaptiveSoftmax(D, CUT, tied=False, tie_proj=True, device="meta",
                        dtype=F32)


# -- parameters stored in bf16 ------------------------------------------------

def test_gehring_linear_bf16_params_match():
    """bf16 parameters for an fp32 input: the weight-norm scale rounded
    at bf16 as the reference computes it (its sums in fp32 rounded once,
    the square root and the quotient each rounded)."""
    x = np.random.RandomState(0).randn(5, 32).astype(np.float32)
    jm = JaxGehringLinear(48, param_dtype=jnp.bfloat16)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), x)
    m = _carry(params, GehringLinear(32, 48, device="cpu",
                                     dtype=torch.bfloat16))
    want = jax.jit(jm.apply)(params, x)
    with torch.no_grad():
        _close(m(_t(x)), want)
        w, b = m.folded(F32)
        _close(_t(x) @ w + b, want)


def test_mha_bf16_params_match():
    rng = np.random.RandomState(1)
    q = rng.randn(2, 3, E).astype(np.float32)
    c = rng.randn(2, 5, 10).astype(np.float32)
    jm = jax_attention.MultiHeadAttention(embed_dim=E, num_heads=4,
                                          param_dtype=jnp.bfloat16)
    params = jax.jit(jm.init)(jax.random.PRNGKey(2), q, c, c)
    want, _ = jax.jit(jm.apply)(params, q, c, c)
    m = _carry(params, MultiHeadAttention(E, 4, 10, device="cpu",
                                          dtype=torch.bfloat16))
    assert m.bias_k.dtype == torch.bfloat16
    with torch.no_grad():
        _close(m(_t(q), _t(c), _t(c)), want)


def test_causal_mask_matches():
    np.testing.assert_array_equal(
        causal_mask(5).numpy(), np.asarray(jax_attention.causal_mask(5)))
    assert math.isclose(causal_mask(3)[0, 2].item(), -1e9)
