"""What each kernel admits, which kernel each model's decode routes to,
and the models the fast kernels do not admit (fp32, narrow widths, a
pointwise conv layer), on the CPU.

Each kernel wrapper has one predicate, `admits(dtype, shapes...) ->
(bool, reason)`, and its `_launch*` check calls the same predicate: here
the launch is driven on CPU tensors with the C entry point replaced by a
stub, over a grid of dtypes and shapes, and must accept exactly what the
predicate admits, with the predicate's reason where it refuses. The four
decode wrappers, the flash kernels and the two int8 variants have a
generic variant each (`admits*_generic`, `_launch*_generic` or the flash
launches' generic route, held the same way) and choose between the two
by one predicate, `route_*(dtype, shapes...) -> "fast" | "generic"`: the
flagship in bf16 routes "fast" everywhere, the fp32 flagship, the tiny
configs' and the toy's widths and a K = 1 layer "generic", and a shape
neither takes raises with both reasons. Nothing gives way to a plain
version on the card: a wrapper takes it on CPU tensors only; a decoder
with `kernel_sizes=(1, 3)` is held against the JAX decoder here (weights
through `params_from_jax`, fp32: greedy tokens equal, log-probs within
2e-4).
"""

from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from news_image_caption_tpu.generation.generator import \
    GenerationConfig as JaxGenerationConfig  # noqa: E402
from news_image_caption_tpu.models.captioner import \
    TransformerFlattened as JaxTransformerFlattened  # noqa: E402
from news_image_caption_tpu.ops.conv import \
    DynamicConv as JaxDynamicConv  # noqa: E402
from news_image_caption_tpu_torch.config import FLAGSHIP  # noqa: E402
from news_image_caption_tpu_torch.generation.generator import \
    GenerationConfig  # noqa: E402
from news_image_caption_tpu_torch.models.captioner import \
    TransformerFlattened  # noqa: E402
from news_image_caption_tpu_torch.models.decoder_flattened import \
    DynamicConvDecoder  # noqa: E402
from news_image_caption_tpu_torch.models.from_jax import \
    params_from_jax  # noqa: E402
from news_image_caption_tpu_torch.ops import (_build, band_topk,  # noqa: E402
                                              decode_attention,
                                              decode_blocks, flash_attention)
from news_image_caption_tpu_torch.ops.conv import DynamicConv  # noqa: E402
from news_image_caption_tpu_torch.serving.worker import TOY  # noqa: E402

DTYPES = [torch.bfloat16, torch.float32, torch.float16]
TINY = dict(vocab_size=64, embed_dim=16, ffn_dim=32, num_heads=4,
            num_layers=2, kernel_sizes=(3, 5), cutoff=(16, 32, 64),
            image_dim=16, article_dim=12, max_positions=64)   # tiny_test.yaml


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, so that the suite's parallel
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def stub_library(monkeypatch):
    """The kernel library's entry points as stubs that succeed, so a
    `_launch*` runs its checks on CPU tensors and 'launches'."""
    monkeypatch.setattr(_build, "function", lambda name, argtypes:
                        lambda *args: 0)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(_build, "sms_of", lambda device: _build.H100_SMS)


def launch_outcome(launch, *args):
    """(accepted, the refusal's text)."""
    try:
        launch(*args)
    except ValueError as e:
        return False, str(e)
    return True, ""


def z(dtype, *shape):
    return torch.zeros(*shape, dtype=dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N,D,V,k,sel", [
    (1, 1024, 5002, 1, 5000), (16, 1024, 30265, 16, 30265),
    (130, 64, 300, 5, 250), (4, 64, 63, 1, 63), (4, 96, 300, 1, 300),
    (4, 32, 300, 1, 300), (4, 128, 300, 17, 300), (4, 128, 300, 0, 300),
    (4, 128, 300, 5, 4), (4, 128, 300, 1, 301), (16, 16, 64, 1, 16)])
def test_band_admits_is_what_its_launch_accepts(stub_library, dtype, N, D, V,
                                                k, sel):
    ok, why = band_topk.admits(dtype, N, D, V, k, sel)
    before = band_topk.band_topk_lse.launches
    got = launch_outcome(band_topk._launch, z(dtype, N, D), z(dtype, V, D), k,
                         sel)
    assert got == (ok, why)
    assert band_topk.band_topk_lse.launches == before + (
        -(-N // band_topk.MAX_ROWS) if ok else 0)
    assert ok == (dtype == torch.bfloat16 and D % 64 == 0
                  and 1 <= k <= min(16, sel) and sel <= V)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N,C,H,K", [
    (1, 1024, 16, 3), (16, 1024, 16, 31), (80, 1024, 16, 32), (5, 64, 4, 7),
    (4, 1024, 16, 33), (4, 64, 4, 1), (4, 16, 4, 3), (4, 96, 4, 3),
    (4, 1000, 8, 3), (4, 2048, 16, 3), (4, 128, 1, 2)])
def test_conv_admits_is_what_its_launch_accepts(stub_library, dtype, N, C, H,
                                                K):
    ok, why = decode_blocks.admits_conv(dtype, N, C, H, K)
    args = (z(dtype, N, C), z(dtype, max(K - 1, 0), N, C), 0,
            z(dtype, C, 2 * C), z(dtype, 2 * C), z(dtype, C, H * K),
            z(dtype, C, C), z(dtype, C), H, None)
    before = decode_blocks.decode_conv_block.launches
    assert launch_outcome(decode_blocks._launch_conv, *args) == (ok, why)
    assert decode_blocks.decode_conv_block.launches == before + (
        -(-N // 128) if ok else 0)
    assert ok == (dtype == torch.bfloat16 and 2 <= K <= 32 and C % 16 == 0
                  and C % H == 0 and (C // H) % 16 == 0 and C <= 1024)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N,C,F", [(16, 1024, 4096), (1, 64, 32),
                                   (40, 192, 96), (4, 16, 32), (4, 96, 128),
                                   (4, 64, 100), (4, 2048, 64),
                                   (16, 1024, 8192)])
def test_ffn_admits_is_what_its_launch_accepts(stub_library, dtype, N, C, F):
    ok, why = decode_blocks.admits_ffn(dtype, N, C, F)
    args = (z(dtype, N, C), z(dtype, C, F), z(dtype, F), z(dtype, F, C),
            z(dtype, C))
    assert launch_outcome(decode_blocks._launch_ffn, *args) == (ok, why)
    assert ok == (dtype == torch.bfloat16 and C % 64 == 0 and F % 32 == 0
                  and C <= 1024 and F <= 4096)
    # A smaller card holds fewer blocks at once: the same predicate.
    assert decode_blocks.admits_ffn(torch.bfloat16, 16, 1024, 4096,
                                    108)[1].endswith("it holds 108")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("Q,E,H", [(1, 1024, 16), (16, 64, 4), (5, 512, 4),
                                   (17, 1024, 16), (1, 16, 4), (3, 48, 4),
                                   (1, 1024, 4)])
def test_attention_admits_is_what_the_launches_accept(stub_library, dtype, Q,
                                                      E, H):
    B, S, T = 2, 9, 5
    ok, why = decode_attention.admits(dtype, Q, E // H)
    args = (z(dtype, B, Q, E), z(dtype, B, S, E), z(dtype, B, S, E),
            torch.zeros(B, S), H)
    assert launch_outcome(decode_attention._launch, *args) == (ok, why)
    assert ok == (dtype == torch.bfloat16 and Q <= 16
                  and E // H in (16, 32, 64, 128))
    # Flash: the fast kernels where `admits` holds, else the generic ones
    # where `admits_generic` does; refused with both reasons otherwise.
    ok, why = flash_attention.admits(dtype, E // H)
    ok_generic, why_generic = flash_attention.admits_generic(dtype, E // H)
    seed = torch.zeros(1, dtype=torch.int32)
    got, text = launch_outcome(
        flash_attention._check, z(dtype, B, T, E), z(dtype, B, S, E),
        z(dtype, B, S, E), torch.zeros(B, S), seed, H, "flash_attention_fwd")
    assert got == (ok or ok_generic)
    assert got or text.endswith(f"{why}; {why_generic}")
    assert ok == (dtype == torch.bfloat16 and E // H in (16, 32, 64, 128))
    assert ok_generic == (dtype != torch.float16 and E // H <= 256)


def _model_answers(dtype, cfg, N):
    """Each decode kernel's and the flash kernels' answer for a model of
    `cfg` at `dtype` and N rows."""
    D, H, F = cfg["embed_dim"], cfg["num_heads"], cfg["ffn_dim"]
    cut = cfg["cutoff"]
    bands = [(cut[0] + len(cut) - 1, cut[0])] + [
        (hi - lo, hi - lo) for lo, hi in zip(cut, cut[1:])]
    return {
        "decode_conv_block": [decode_blocks.admits_conv(dtype, N, D, H, K)
                              for K in cfg["kernel_sizes"]],
        "decode_cross_attention": [decode_attention.admits(dtype, 1, D // H)],
        "decode_ffn_block": [decode_blocks.admits_ffn(dtype, N, D, F)],
        "band_topk_lse": [band_topk.admits(dtype, N, D, V, 1, sel)
                          for V, sel in bands],
        "flash_attention": [flash_attention.admits(dtype, D // H)],
        "decode_cross_attention_int8": [decode_attention.admits_int8(
            dtype, 1, D // H)],
        "band_topk_lse_int8": [band_topk.admits_int8(dtype, N, D, V, 1, sel)
                               for V, sel in bands]}


@pytest.mark.parametrize("N", [1, 16, 80])
def test_every_kernel_admits_the_flagship(N):
    """The flagship at bf16, 1 to 80 rows (a beam-5 step of 16): every
    kernel of the step and of the train step takes it, and its decode
    weights (built without storage) carry the taps as the kernel reads
    them."""
    answers = _model_answers(torch.bfloat16, FLAGSHIP, N)
    assert all(a == (True, "") for op in answers.values() for a in op)
    dec = DynamicConvDecoder(device="meta", dtype=torch.bfloat16, **FLAGSHIP)
    weights = dec.decode_weights()
    assert all(w.conv_taps.shape == (16, taps, 1024)
               for w, taps in zip(weights.layers, (8, 8, 16, 32)))


@pytest.mark.parametrize("dtype,cfg,reasons", [
    (torch.float32, FLAGSHIP, ["bf16"] * 7),
    (torch.bfloat16, TINY, ["head size", "head size", "C % 64 == 0",
                            "D % 64 == 0", "head size", "head size",
                            "D % 64 == 0"]),
    (torch.float32, TINY, ["bf16"] * 7)])
def test_models_no_kernel_admits_are_refused_with_the_reason(dtype, cfg,
                                                             reasons):
    """An fp32 model and the widths of configs/tiny_test.yaml (embed 16,
    4 heads, ffn 32): every fast kernel, the flash kernels and the int8
    variants included, refuses, and says why; every generic variant, the
    flash kernels' and the int8 ones included, admits them."""
    answers = _model_answers(dtype, cfg, 1)
    assert len(answers) == len(reasons)
    for (op, got), text in zip(answers.items(), reasons):
        assert all(not ok and text in why for ok, why in got), op
    generic = _generic_answers(dtype, cfg, 1)
    assert set(generic) == set(answers)
    assert all(a == (True, "") for op in generic.values() for a in op)


def _generic_answers(dtype, cfg, N):
    """Each generic variant's answer for a model of `cfg` at `dtype` and N
    rows."""
    D, H, F = cfg["embed_dim"], cfg["num_heads"], cfg["ffn_dim"]
    return {
        "decode_conv_block": [decode_blocks.admits_conv_generic(dtype, N, D, H,
                                                                K)
                              for K in cfg["kernel_sizes"]],
        "decode_cross_attention": [decode_attention.admits_generic(
            dtype, 1, D // H)],
        "decode_ffn_block": [decode_blocks.admits_ffn_generic(dtype, N, D, F)],
        "band_topk_lse": [band_topk.admits_generic(dtype, N, D, V, 1, sel)
                          for V, sel in _bands(cfg)],
        "flash_attention": [flash_attention.admits_generic(dtype, D // H)],
        "decode_cross_attention_int8": [decode_attention.admits_int8_generic(
            dtype, 1, D // H)],
        "band_topk_lse_int8": [band_topk.admits_int8_generic(dtype, N, D, V,
                                                             1, sel)
                               for V, sel in _bands(cfg)]}


def _bands(cfg):
    """(V, sel_limit) of the adaptive softmax's bands: the head [table0;
    class rows] with its words selectable, then the tails."""
    cut = cfg["cutoff"]
    return [(cut[0] + len(cut) - 1, cut[0])] + [
        (hi - lo, hi - lo) for lo, hi in zip(cut, cut[1:])]


def _routes(dtype, cfg, N):
    """Each decode wrapper's route for a model of `cfg` at `dtype`: N
    rows, the attention's queries one an item (N <= 16) or a beam-5
    step's five."""
    D, H, F = cfg["embed_dim"], cfg["num_heads"], cfg["ffn_dim"]
    Q = 1 if N <= 16 else 5
    return {
        "decode_conv_block": [decode_blocks.route_conv(dtype, N, D, H, K)
                              for K in cfg["kernel_sizes"]],
        "decode_cross_attention": [decode_attention.route_attention(
            dtype, Q, D // H)],
        "decode_ffn_block": [decode_blocks.route_ffn(dtype, N, D, F)],
        "band_topk_lse": [band_topk.route_band(dtype, N, D, V, min(5, sel),
                                               sel)
                          for V, sel in _bands(cfg)],
        "flash_attention": [flash_attention.route_flash(dtype, D // H)],
        "decode_cross_attention_int8": [decode_attention.route_attention_int8(
            dtype, Q, D // H)],
        "band_topk_lse_int8": [band_topk.route_band_int8(dtype, N, D, V,
                                                         min(5, sel), sel)
                               for V, sel in _bands(cfg)]}


@pytest.mark.parametrize("N", [1, 16, 80, 640])
def test_flagship_routes_fast(N):
    """The flagship at bf16, one row to a beam-5 step at B=128: every
    decode wrapper, the flash kernels and the int8 variants route "fast",
    so every shape launched before the generic variants existed launches
    the same kernel."""
    routes = _routes(torch.bfloat16, FLAGSHIP, N)
    assert all(r == "fast" for op in routes.values() for r in op), routes


@pytest.mark.parametrize("N", [1, 16, 80])
@pytest.mark.parametrize("dtype,cfg", [
    (torch.float32, FLAGSHIP), (torch.bfloat16, TINY),
    (torch.float32, TINY), (torch.float32, TOY)],
    ids=["fp32_flagship", "bf16_tiny", "fp32_tiny", "toy"])
def test_models_the_fast_kernels_refuse_route_generic(dtype, cfg, N):
    """The fp32 flagship, configs/tiny_test.yaml's widths in bf16 and
    fp32, and the toy (`serving/worker.py::TOY`, fp32, head size 8):
    every decode wrapper, the flash kernels and the int8 variants route
    "generic"."""
    routes = _routes(dtype, cfg, N)
    assert all(r == "generic" for op in routes.values() for r in op), routes


@pytest.mark.parametrize("N", [1, 16, 80])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_pointwise_layer_routes_generic(dtype, N):
    """A K = 1 layer at the flagship's width: its conv block routes
    "generic" (the fast kernel needs K >= 2), in bf16 beside K = 3 layers
    that route "fast"."""
    assert decode_blocks.route_conv(dtype, N, 1024, 16, 1) == "generic"
    assert decode_blocks.route_conv(dtype, N, 1024, 16, 3) == (
        "fast" if dtype == torch.bfloat16 else "generic")


@pytest.mark.parametrize("route,args,reasons", [
    (band_topk.route_band, (torch.float16, 4, 64, 100, 1, 100),
     ("takes bf16 x", "bf16 or fp32")),
    (band_topk.route_band, (torch.bfloat16, 4, 64, 100, 17, 100),
     ("1 <= k", "generic: need 1 <= k")),
    (decode_attention.route_attention, (torch.float16, 1, 64),
     ("takes bf16 q/k/v", "bf16 or fp32")),
    (decode_attention.route_attention, (torch.float32, 17, 64),
     ("1 <= Q <= 16", "generic: need 1 <= Q <= 16")),
    (decode_attention.route_attention, (torch.bfloat16, 1, 260),
     ("head size", "head size in 1..256")),
    (decode_blocks.route_conv, (torch.float16, 4, 64, 4, 3),
     ("takes bf16", "bf16 or fp32")),
    (decode_blocks.route_conv, (torch.bfloat16, 4, 64, 4, 33),
     ("2 <= K <= 32", "1 <= K <= 32")),
    (decode_blocks.route_conv, (torch.float32, 4, 64, 7, 3),
     ("takes bf16", "C % H == 0")),
    (decode_blocks.route_ffn, (torch.float16, 4, 64, 128),
     ("takes bf16", "bf16 or fp32")),
    (flash_attention.route_flash, (torch.float16, 64),
     ("take bf16 q/k/v", "bf16 or fp32")),
    (flash_attention.route_flash, (torch.bfloat16, 257),
     ("head size E / num_heads in", "head size in 1..256")),
    (flash_attention.route_flash, (torch.float32, 257),
     ("take bf16 q/k/v", "head size in 1..256")),
    (band_topk.route_band_int8, (torch.float16, 4, 64, 100, 1, 100),
     ("takes bf16 x, an int8 table", "bf16 or fp32 x, an int8 table")),
    (band_topk.route_band_int8, (torch.float32, 4, 64, 100, 17, 100),
     ("takes bf16 x", "generic: need 1 <= k")),
    (decode_attention.route_attention_int8, (torch.float16, 1, 64),
     ("takes bf16 q, int8 k/v", "bf16 or fp32 q, int8 k/v")),
    (decode_attention.route_attention_int8, (torch.bfloat16, 1, 260),
     ("head size", "head size in 1..256"))])
def test_routes_raise_with_both_reasons(route, args, reasons):
    """A shape neither kernel takes raises, naming the fast kernel's
    reason and the generic variant's."""
    with pytest.raises(ValueError) as e:
        route(*args)
    assert all(r in str(e.value) for r in reasons), str(e.value)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N,D,V,k,sel", [
    (1, 1024, 5002, 1, 5000), (80, 1024, 30265, 5, 30265), (5, 32, 18, 5, 16),
    (1, 16, 32, 16, 32), (3, 1, 5, 5, 5), (40, 100, 129, 16, 129),
    (4, 32, 18, 17, 18), (4, 32, 18, 0, 16), (4, 32, 18, 5, 19),
    (4, 32, 18, 17, 16)])
def test_band_generic_admits_is_what_its_launch_accepts(stub_library, dtype,
                                                        N, D, V, k, sel):
    ok, why = band_topk.admits_generic(dtype, N, D, V, k, sel)
    before = band_topk.band_topk_lse_generic.launches
    got = launch_outcome(band_topk._launch_generic, z(dtype, N, D),
                         z(dtype, V, D), k, sel)
    assert got == (ok, why)
    assert band_topk.band_topk_lse_generic.launches == before + int(ok)
    assert ok == (dtype in (torch.bfloat16, torch.float32)
                  and 1 <= k <= min(16, sel) and sel <= V)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N,C,H,K", [
    (16, 1024, 16, 31), (80, 1024, 16, 1), (1, 32, 4, 3), (5, 16, 4, 5),
    (40, 48, 3, 32), (4, 32, 4, 33), (4, 32, 4, 0), (4, 30, 4, 3),
    (4, 2048, 16, 3)])
def test_conv_generic_admits_is_what_its_launch_accepts(stub_library, dtype,
                                                        N, C, H, K):
    ok, why = decode_blocks.admits_conv_generic(dtype, N, C, H, K)
    args = (z(dtype, N, C), z(dtype, max(K - 1, 0), N, C), 3,
            z(dtype, C, 2 * C), z(dtype, 2 * C), z(dtype, C, H * K),
            z(dtype, C, C), z(dtype, C), H, None)
    before = decode_blocks.decode_conv_block_generic.launches
    assert launch_outcome(decode_blocks._launch_conv_generic,
                          *args) == (ok, why)
    assert decode_blocks.decode_conv_block_generic.launches == before + int(ok)
    assert ok == (dtype in (torch.bfloat16, torch.float32) and 1 <= K <= 32
                  and C % H == 0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("partial", [False, True])
@pytest.mark.parametrize("N,C,F", [(16, 1024, 4096), (80, 1024, 4096),
                                   (1, 32, 64), (5, 16, 32), (33, 100, 200),
                                   (4, 2048, 64)])
def test_ffn_generic_admits_is_what_its_launch_accepts(stub_library, dtype,
                                                       partial, N, C, F):
    ok, why = decode_blocks.admits_ffn_generic(dtype, N, C, F)
    args = (z(dtype, N, C), z(dtype, C, F), z(dtype, F), z(dtype, F, C),
            None if partial else z(dtype, C))
    before = decode_blocks.decode_ffn_block_generic.launches
    assert launch_outcome(decode_blocks._launch_ffn_generic,
                          *args) == (ok, why)
    assert decode_blocks.decode_ffn_block_generic.launches == before + int(ok)
    assert ok == (dtype in (torch.bfloat16, torch.float32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("Q,E,H", [(1, 1024, 16), (5, 32, 4), (4, 16, 4),
                                   (16, 512, 2), (3, 39, 13), (2, 4, 4),
                                   (17, 32, 4), (1, 520, 2)])
def test_attention_generic_admits_is_what_its_launch_accepts(stub_library,
                                                             dtype, Q, E, H):
    B, S = 2, 6
    ok, why = decode_attention.admits_generic(dtype, Q, E // H)
    args = (z(dtype, B, Q, E), z(dtype, B, S, E), z(dtype, B, S, E),
            torch.zeros(B, S), H)
    before = decode_attention.decode_cross_attention_generic.launches
    assert launch_outcome(decode_attention._launch_generic,
                          *args) == (ok, why)
    assert (decode_attention.decode_cross_attention_generic.launches
            == before + int(ok))
    assert ok == (dtype in (torch.bfloat16, torch.float32) and Q <= 16
                  and E // H <= 256)


# -- the flash kernels' and the int8 variants' generic routes ----------------

@pytest.mark.parametrize("dtype,head,route", [
    (torch.bfloat16, 16, "fast"), (torch.bfloat16, 32, "fast"),
    (torch.bfloat16, 64, "fast"), (torch.bfloat16, 128, "fast"),
    (torch.float32, 64, "generic"), (torch.bfloat16, 4, "generic"),
    (torch.float32, 4, "generic"), (torch.bfloat16, 8, "generic"),
    (torch.float32, 8, "generic"), (torch.bfloat16, 24, "generic"),
    (torch.bfloat16, 256, "generic"), (torch.float32, 256, "generic"),
    (torch.float32, 1, "generic")])
def test_flash_routes(dtype, head, route):
    """bf16 at the fast kernels' head sizes routes "fast" (the flagship
    in bf16: heads of 64); fp32 (the flagship at fp32) and any other head
    size up to 256 (tiny_test's 4, the toy's 8) routes "generic"."""
    assert flash_attention.route_flash(dtype, head) == route


@pytest.mark.parametrize("N", [1, 16, 80])
@pytest.mark.parametrize("dtype,cfg,route", [
    (torch.bfloat16, FLAGSHIP, "fast"), (torch.float32, FLAGSHIP, "generic"),
    (torch.bfloat16, TINY, "generic"), (torch.float32, TINY, "generic"),
    (torch.float32, TOY, "generic")],
    ids=["bf16_flagship", "fp32_flagship", "bf16_tiny", "fp32_tiny", "toy"])
def test_int8_routes(dtype, cfg, route, N):
    """The int8 variants at the flagship's widths route "fast" in bf16
    and "generic" in fp32; at tiny_test's widths (embed 16, heads of 4)
    and the toy's (fp32, heads of 8) "generic": the head's word tables
    (the head band is table0 alone) and the tails, a greedy step's and a
    beam-5 step's rows."""
    D, H = cfg["embed_dim"], cfg["num_heads"]
    Q = 1 if N <= 16 else 5
    cut = (0, *cfg["cutoff"])
    tables = [(hi - lo, hi - lo) for lo, hi in zip(cut, cut[1:])]
    routes = [band_topk.route_band_int8(dtype, N, D, V, min(5, V), sel)
              for V, sel in tables]
    routes.append(decode_attention.route_attention_int8(dtype, Q, D // H))
    assert routes == [route] * len(routes)


@pytest.fixture
def recording_library(monkeypatch):
    """`stub_library` whose entry points record their name and arguments
    in the returned list."""
    calls = []
    monkeypatch.setattr(_build, "function", lambda name, argtypes:
                        lambda *args: calls.append((name, args)) or 0)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(_build, "sms_of", lambda device: _build.H100_SMS)
    return calls


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T,S,E,H", [
    (63, 514, 1024, 16), (63, 51, 1024, 16), (11, 20, 16, 4),
    (70, 65, 32, 4), (10, 24, 96, 4), (33, 1, 256, 1), (5, 7, 257, 1),
    (4, 9, 520, 2)])
def test_flash_generic_admits_is_what_its_launches_accept(recording_library,
                                                          dtype, T, S, E, H):
    """The generic route of both flash launches accepts exactly what
    `admits_generic` admits (fp32 or bf16, head sizes 1 to 256), passes
    the dtype code, the plan's shared memory and row0 / h0 / heads_total
    through to `nic_flash_*_generic`, and raises with the reason
    otherwise; each launch counts one on its generic counter."""
    B, dh = 3, E // H
    ok, why = flash_attention.admits_generic(dtype, dh)
    q, k, v = z(dtype, B, T, E), z(dtype, B, S, E), z(dtype, B, S, E)
    bias, seed = torch.zeros(B, S), torch.zeros(1, dtype=torch.int32)
    lse = torch.zeros(B, H, T)
    tail = (0.1, 4, 0, 2 * H)       # p, row0, h0 (heads [0, H) of 2 H)
    counts = (flash_attention.flash_attention_fwd_generic,
              flash_attention.flash_attention_bwd_generic,
              flash_attention.flash_attention_fwd,
              flash_attention.flash_attention_bwd)
    before = [fn.launches for fn in counts]
    fwd = launch_outcome(flash_attention._launch_fwd, q, k, v, bias, seed, H,
                         *tail, "generic")
    bwd = launch_outcome(flash_attention._launch_bwd, q, k, v, bias, seed,
                         lse, q, H, *tail, "generic")
    assert fwd[0] == bwd[0] == ok
    assert ok or (fwd[1].endswith(why) and bwd[1].endswith(why))
    assert [fn.launches - n for fn, n in zip(counts, before)] == (
        [1, 1, 0, 0] if ok else [0, 0, 0, 0])
    assert ok == (dtype != torch.float16 and dh <= 256)
    if not ok:
        assert recording_library == []
        return
    plan = flash_attention.generic_flash_plan(B, T, S, H, dh)
    (fname, fargs), (bname, bargs) = recording_library
    assert (fname, bname) == ("nic_flash_fwd_generic",
                              "nic_flash_bwd_generic")
    code = _build.GENERIC_DTYPES[dtype]
    assert fargs[0] == bargs[0] == code
    assert fargs[8:15] == (B, T, S, E, H,
                           flash_attention.dropout_threshold(0.1),
                           pytest.approx(1 / 0.9))
    assert fargs[15:19] == (plan.fwd_smem_bytes, 4, 0, 2 * H)
    assert bargs[12:19] == fargs[8:15]
    assert bargs[19:23] == (plan.bwd_smem_bytes, 4, 0, 2 * H)
    # Several query tiles: the backward's fp32 parts of dk and dv.
    assert (bargs[11] is None) == (plan.t_tiles == 1)


def test_generic_flash_plans_fit_the_card():
    """Every head size 1 to 256 has a tile class whose blocks fit shared
    memory in both passes (two backward blocks a multiprocessor up to
    heads of 128); the forward holds the flagship's score rows (64 rows,
    2 ring slots, one block a multiprocessor at S' = 514 and two at 51);
    T past the class's rows makes several query tiles and the backward's
    fp32 parts of dk and dv; the flagship's call is one tile of 256
    blocks in both passes."""
    for dh in range(1, 257):
        plan = flash_attention.generic_flash_plan(16, 63, 514, 16, dh)
        width, rows, keys = next(t for t in flash_attention.GENERIC_TILES
                                 if dh <= t[0])
        assert (plan.rows, plan.keys) == (rows, keys)
        assert plan.fwd_smem_bytes <= _build.MAX_SMEM_BYTES
        assert plan.bwd_smem_bytes <= _build.MAX_SMEM_BYTES
        assert (plan.fwd_rows, plan.fwd_stages, plan.fwd_smem_bytes) == (
            flash_attention.generic_fwd_plan(dh, 514))
        assert plan.fwd_stages in (2, 3)            # S' = 514 is held
        if dh <= 128:
            assert 2 * (plan.bwd_smem_bytes
                        + flash_attention.BLOCK_RESERVED_BYTES) <= (
                flash_attention.SM_SMEM_BYTES)
        long = flash_attention.generic_flash_plan(2, 2 * rows + 1, 7, 3, dh)
        assert long.t_tiles == 3 and long.parts_floats == 2 * 3 * 2 * 7 * 3 * dh
        assert long.fwd_t_tiles == -(-(2 * rows + 1) // long.fwd_rows)
        assert long.fwd_blocks == 3 * 2 * long.fwd_t_tiles
    plan = flash_attention.generic_flash_plan(16, 63, 514, 16, 64)
    assert (plan.t_tiles, plan.blocks, plan.parts_floats) == (1, 256, 0)
    assert (plan.fwd_rows, plan.fwd_stages, plan.fwd_t_tiles,
            plan.fwd_blocks, plan.fwd_smem_bytes) == (64, 2, 1, 256, 222224)
    assert 2 * (plan.fwd_smem_bytes + flash_attention.BLOCK_RESERVED_BYTES) > (
        flash_attention.SM_SMEM_BYTES)
    image = flash_attention.generic_flash_plan(16, 63, 51, 16, 64)
    assert (image.fwd_rows, image.fwd_stages, image.fwd_blocks) == (64, 2, 256)
    assert 2 * (image.fwd_smem_bytes + flash_attention.BLOCK_RESERVED_BYTES) <= (
        flash_attention.SM_SMEM_BYTES)
    with pytest.raises(ValueError, match="head size in 1..256"):
        flash_attention.generic_flash_plan(16, 63, 514, 4, 257)


@pytest.mark.parametrize("width,limits", [
    # The largest S' each row count holds at 3 and at 2 ring slots (0:
    # no block of that many rows and slots at this width), then where the
    # two walks take over.
    (16, {64: (752, 788), 32: (1504, 1580), 16: (2944, 3092)}),
    (32, {64: (640, 712), 32: (1300, 1440), 16: (2564, 2836)}),
    (64, {64: (420, 552), 32: (896, 1160), 16: (1812, 2324)}),
    (128, {64: (0, 240), 32: (92, 604), 16: (308, 1300)}),
    (256, {64: (0, 0), 32: (0, 496), 16: (232, 1212)})])
def test_generic_flash_forward_rows_follow_the_keys(width, limits):
    """The generic forward's rows a block by S' (`generic_fwd_plan`, the
    mirror of csrc/flash_generic.cu::fwd_plan): the most rows that hold
    the score rows, 3 ring slots before 2 (2 where S' is one chunk of K
    and one of V), at every S' from 1 to the limit of 16 rows and past
    it, where the forward walks the keys twice in the backward's tiles;
    every held plan fits the card and every head size of a width class
    gets its plan."""
    for rows, (lim3, lim2) in limits.items():
        assert flash_attention.held_rows_ok(width, rows) == (lim2 > 0)
        for stages, lim in ((3, lim3), (2, lim2)):
            if lim:
                assert flash_attention.held_smem_bytes(
                    width, rows, lim, stages) <= _build.MAX_SMEM_BYTES
                assert flash_attention.held_smem_bytes(
                    width, rows, lim + 1, stages) > _build.MAX_SMEM_BYTES
    held = [(r, st, lim) for r, lims in limits.items()
            for st, lim in zip((3, 2), lims) if lim]
    last = max(lim for _, _, lim in held)
    keys = flash_attention.held_keys(width)
    for S in list(range(1, 260)) + list(range(260, last + 40, 7)) + [
            last, last + 1]:
        most = 3 if S > keys else 2
        want = next(((r, st) for r, st, lim in held
                     if S <= lim and st <= most), None)
        for dh in (width // 2 + 1, width):
            rows, stages, smem = flash_attention.generic_fwd_plan(dh, S)
            if want is None:
                tiles = next(t for t in flash_attention.GENERIC_TILES
                             if dh <= t[0])
                assert (rows, stages, smem) == (
                    tiles[1], 0, flash_attention.generic_flash_smem_bytes(
                        False, dh)), S
            else:
                assert (rows, stages) == want, S
                assert smem == flash_attention.held_smem_bytes(
                    width, rows, S, stages) <= _build.MAX_SMEM_BYTES


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_routes_its_launch(recording_library, dtype):
    """flash_attention's launches take the route `route_flash` names: the
    flagship's heads of 64 the fast kernels in bf16 and the generic ones
    in fp32; heads of 4 the generic ones; fp16 neither, with both
    reasons."""
    for E, H in ((1024, 16), (16, 4)):
        recording_library.clear()
        q, k = z(dtype, 2, 9, E), z(dtype, 2, 5, E)
        args = (q, k, k, torch.zeros(2, 5), torch.zeros(1, dtype=torch.int32),
                H, 0.0, 0, 0, None, None)
        try:
            route = flash_attention.route_flash(dtype, E // H)
        except ValueError as e:
            assert dtype == torch.float16 and "bf16 or fp32" in str(e)
            with pytest.raises(ValueError, match="bf16 or fp32"):
                flash_attention._launch_fwd(*args)
            continue
        flash_attention._launch_fwd(*args)
        name = recording_library[0][0]
        assert name == ("nic_flash_fwd" if route == "fast"
                        else "nic_flash_fwd_generic")
        assert route == ("fast" if dtype == torch.bfloat16 and E == 1024
                         else "generic")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N,D,V,k", [(16, 1024, 5000, 1), (80, 1024, 30265, 5),
                                     (1, 16, 16, 1), (5, 32, 32, 5),
                                     (37, 100, 129, 16), (4, 16, 16, 17)])
def test_band_int8_generic_admits_is_what_its_launch_accepts(
        recording_library, dtype, N, D, V, k):
    ok, why = band_topk.admits_int8_generic(dtype, N, D, V, k, V)
    before = band_topk.band_topk_lse_int8_generic.launches
    args = (z(dtype, N, D), z(torch.int8, V, D), torch.ones(V, dtype=dtype),
            k, V)
    assert launch_outcome(band_topk._launch_int8_generic, *args) == (ok, why)
    assert band_topk.band_topk_lse_int8_generic.launches == before + int(ok)
    assert ok == (dtype != torch.float16 and k <= 16)
    if ok:
        ((name, cargs),) = recording_library
        plan = band_topk.generic_band_plan(N, V)
        assert name == "nic_band_topk_lse_int8_generic"
        assert cargs[0] == _build.GENERIC_DTYPES[dtype]
        assert cargs[11:18] == (N, D, V, V, k, plan.tiles_per_chunk,
                                plan.chunks)
    # The non-int8 generic kernel never takes an int8 table in its place.
    assert not launch_outcome(band_topk._launch_generic, args[0], args[1], k,
                              V)[0]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("Q,E,H", [(1, 1024, 16), (5, 1024, 16), (1, 16, 4),
                                   (4, 32, 4), (3, 39, 13), (16, 512, 2),
                                   (17, 32, 4), (1, 520, 2)])
def test_attention_int8_generic_admits_is_what_its_launch_accepts(
        recording_library, dtype, Q, E, H):
    B, S = 2, 9
    ok, why = decode_attention.admits_int8_generic(dtype, Q, E // H)
    i8 = torch.zeros(B, S, E, dtype=torch.int8)
    scale = torch.ones(B, S, H, dtype=dtype)
    args = (z(dtype, B, Q, E), i8, scale, i8, scale, torch.zeros(B, S), H)
    before = decode_attention.decode_cross_attention_int8_generic.launches
    assert launch_outcome(decode_attention._launch_int8_generic,
                          *args) == (ok, why)
    assert (decode_attention.decode_cross_attention_int8_generic.launches
            == before + int(ok))
    assert ok == (dtype != torch.float16 and Q <= 16 and E // H <= 256)
    if ok:
        ((name, cargs),) = recording_library
        plan = decode_attention.generic_attention_plan(B, Q, S, H, E // H)
        assert name == "nic_decode_attention_int8_generic"
        assert cargs[0] == _build.GENERIC_DTYPES[dtype]
        assert cargs[7:10] == (None, None, None)     # one split: no scratch
        assert cargs[11:19] == (B, Q, S, E, H, plan.splits, plan.per,
                                plan.smem_bytes)
    assert not launch_outcome(decode_attention._launch_generic, args[0], i8,
                              i8, args[5], H)[0]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 128, 129, 514, 4096])
def test_generic_attention_launch_passes_the_plan(recording_library, int8,
                                                   S):
    """Both generic attention launches pass the plan's splits, keys a
    split and shared memory, and fp32 scratch of the plan's sizes where
    S' takes several splits (none for one split); one launch counted."""
    B, Q, E, H = 2, 3, 96, 4
    plan = decode_attention.generic_attention_plan(B, Q, S, H, E // H)
    q = z(torch.float32, B, Q, E)
    if int8:
        i8 = torch.zeros(B, S, E, dtype=torch.int8)
        scale = torch.ones(B, S, H)
        decode_attention._launch_int8_generic(q, i8, scale, i8, scale,
                                              torch.zeros(B, S), H)
        ptrs, sizes = slice(7, 10), slice(11, 19)
    else:
        kv = z(torch.float32, B, S, E)
        decode_attention._launch_generic(q, kv, kv, torch.zeros(B, S), H)
        ptrs, sizes = slice(5, 8), slice(9, 17)
    ((name, cargs),) = recording_library
    assert name == ("nic_decode_attention_int8_generic" if int8
                    else "nic_decode_attention_generic")
    assert cargs[sizes] == (B, Q, S, E, H, plan.splits, plan.per,
                            plan.smem_bytes)
    assert all((p is None) == (plan.splits == 1) for p in cargs[ptrs])
    assert (plan.splits == 1) == (S <= 64)


def test_generic_attention_splits_cover_the_keys():
    """The generic attention's splits (`generic_attention_plan`, the
    mirror of csrc/decode_generic.cu::att_plan) cover S' = 1 to 4096 in
    ascending order with no gap and none empty, at most 64 keys each and
    at most one key apart; the scratch is B H Q S' scores, two stats and
    a p v part of every split, none for one split; every head size 1 to
    256 at Q = 1 to 16 fits shared memory; the flagship's article call
    (S' = 514) is 9 splits, 2304 blocks at B = 16, its image call (S' =
    51) one split, 256 blocks."""
    for S in range(1, 4097):
        plan = decode_attention.generic_attention_plan(3, 2, S, 5, 7)
        starts = [z_ * plan.per for z_ in range(plan.splits)]
        ends = [min(S, s0 + plan.per) for s0 in starts]
        assert starts[0] == 0 and ends[-1] == S
        assert all(e > s0 for s0, e in zip(starts, ends))
        assert all(a == b for a, b in zip(ends, starts[1:]))
        assert plan.splits == -(-S // 64) and plan.per <= 64
        assert all(plan.per - 1 <= e - s0 <= plan.per
                   for s0, e in zip(starts[:-1], ends[:-1]))
        one = plan.splits == 1
        assert plan.blocks == 5 * 3 * plan.splits
        assert (plan.scores_floats, plan.stats_floats, plan.parts_floats) == (
            (0, 0, 0) if one else (3 * 5 * 2 * S, 2 * 3 * 5 * 2 * plan.splits,
                                   3 * 5 * plan.splits * 2 * 7))
    for dh in range(1, 257):
        for Q in range(1, 17):
            plan = decode_attention.generic_attention_plan(16, Q, 4096, 16,
                                                           dh)
            dhp = -(-dh // 16) * 16
            assert plan.smem_bytes == 4 * (Q * dhp + Q * plan.per + 8 * min(
                Q, 4) * dhp) <= _build.MAX_SMEM_BYTES
    article = decode_attention.generic_attention_plan(16, 1, 514, 16, 64)
    image = decode_attention.generic_attention_plan(16, 1, 51, 16, 64)
    assert (article.splits, article.per, article.blocks) == (9, 58, 2304)
    assert article.scores_floats == 16 * 16 * 514          # 0.5 MB
    assert (image.splits, image.per, image.blocks) == (1, 51, 256)
    beam = decode_attention.generic_attention_plan(16, 5, 514, 16, 64)
    assert beam.scores_floats * 4 == 2631680                 # 2.6 MB
    with pytest.raises(ValueError, match="1 <= Q <= 16"):
        decode_attention.generic_attention_plan(16, 17, 514, 16, 64)


# -- the generic blocks' products (csrc/decode_generic.cu::product_kernel) --

GENERIC_ROWS = [1, 5, 16, 17, 33, 80, 81, 640]
GENERIC_PRODUCTS = [
    (1024, 4096, False), (4096, 1024, False),       # fc1, fc2
    (1024, 1024, True), (1024, 1024, False),        # linear1, linear2
    (1024, 16 * 31, False), (1024, 16 * 3, False),  # the tap logits
    (48, 100, False), (100, 200, False), (200, 48, False), (100, 7, False),
    (48, 48, True), (100, 100, True), (200, 200, True), (32, 1, True)]


def _product_checks(M, depth, width, glu):
    """The plan's blocks cover every output element once, its splits the
    depth in order; its tile, strips, scratch and shared memory."""
    plan = decode_blocks.generic_product_plan(M, depth, width, glu)
    rows, cols, stages = decode_blocks.GENERIC_TILES[plan.tile]
    narrow = -(-width // (32 if glu else 64)) < decode_blocks.GENERIC_NARROW
    assert (plan.rows, plan.cols) == (rows, cols) == (
        16 if M <= 16 or narrow else 32 if M <= 32 else 80, 64)
    seen = np.zeros((M, width), np.int32)
    for s in range(plan.strips):
        for r in range(plan.row_tiles):
            seen[r * plan.rows:(r + 1) * plan.rows,
                 s * plan.strip_cols:(s + 1) * plan.strip_cols] += 1
    assert (seen == 1).all()
    assert plan.strips == -(-width // plan.strip_cols)
    assert plan.row_tiles == -(-M // plan.rows)
    # The GLU's tile holds a strip's a and g columns, half a tile each.
    assert plan.strip_cols == (plan.cols // 2 if glu else plan.cols)
    # The depth: splits of whole 32-deep chunks, in order, none empty.
    assert plan.ksplit % 32 == 0 and plan.ksplit >= 32
    ends = [min(depth, (z + 1) * plan.ksplit) for z in range(plan.splits)]
    assert ends[-1] == depth and all(
        e > z * plan.ksplit for z, e in enumerate(ends))
    # The depth splits into at most depth / GENERIC_MIN_SPLIT pieces, only
    # where the tiles are fewer than a wave of GENERIC_BLOCKS blocks, and
    # only where that leaves the busiest multiprocessor less work.
    base = plan.strips * plan.row_tiles
    waves = decode_blocks.GENERIC_BLOCKS

    def busiest(s):
        return Fraction(-(-base * s // waves), s)
    assert plan.splits <= max(1, -(-depth // decode_blocks.GENERIC_MIN_SPLIT))
    assert plan.splits == 1 or busiest(plan.splits) < busiest(1)
    assert plan.splits == 1 or base < waves
    # Scratch: each split's fp32 tile, one arrival counter a strip and
    # row tile, none without a split.
    split = plan.splits > 1
    assert plan.part_floats == (plan.splits * plan.row_tiles * plan.strips
                                * plan.rows * plan.cols if split else 0)
    assert plan.counters == (base if split else 0)
    assert plan.counters <= decode_blocks.GENERIC_COUNTERS
    # Shared memory: the ring's slots of an A chunk [rows][36] and a B
    # chunk [32][64] fit a block, and hold the depth slices' tiles [rows]
    # [68] (8 slices of the 16- and 32-row tiles, 4 of the 80-row one);
    # two 16-row blocks a multiprocessor (228 KB, 1 KB a block reserved).
    assert plan.smem_bytes == 4 * stages * (rows * 36 + 32 * cols)
    assert plan.smem_bytes <= _build.MAX_SMEM_BYTES
    assert (4 if rows == 80 else 8) * rows * 68 * 4 <= plan.smem_bytes
    assert rows != 16 or 2 * (plan.smem_bytes + 1024) <= 228 * 1024
    return plan


@pytest.mark.parametrize("M", GENERIC_ROWS)
@pytest.mark.parametrize("depth,width,glu", GENERIC_PRODUCTS)
def test_generic_product_plan_covers_every_output_once(M, depth, width, glu):
    """`generic_product_plan` at the plan's row edges (1 to 640 rows),
    the flagship's products and widths off every tile: every output
    element in exactly one tile, the depth split in order into whole
    chunks only where that evens the card's load, the scratch and
    counters of its splits, shared memory for the ring and the depth
    slices' sums."""
    _product_checks(M, depth, width, glu)


@pytest.mark.parametrize("M", GENERIC_ROWS)
def test_generic_tap_logits_plan_at_every_kernel_size(M):
    """The tap logits' product at K = 1 to 32 taps, 16 and 3 heads
    (width H K): every logit once."""
    for K in range(1, 33):
        for H, depth in ((16, 1024), (3, 48)):
            _product_checks(M, depth, H * K, False)


def test_generic_product_plans_of_the_flagship():
    """The fp32 flagship's products: greedy (16 rows) and beam-5 B=16 (80
    rows) in one row tile each, so every weight is read once a call;
    fc1's 64 strips split in 2, fc2's 16 in 8, linear1's 32 in 4,
    linear2's 16 in 8 (128 blocks each, one wave); the tap logits' 8
    strips (K = 31) in 16-row tiles, split in 8 at greedy and in 3 over
    beam-5's 5 row tiles; 640 rows in 8 row tiles, no split."""
    plan = decode_blocks.generic_product_plan
    for M in (16, 80):
        got = [plan(M, 1024, 4096), plan(M, 4096, 1024),
               plan(M, 1024, 1024, True), plan(M, 1024, 1024),
               plan(M, 1024, 16 * 31)]
        assert [(p.row_tiles, p.strips, p.splits) for p in got] == [
            (1, 64, 2), (1, 16, 8), (1, 32, 4), (1, 16, 8),
            (1, 8, 8) if M == 16 else (5, 8, 3)]
        assert got[0].rows == (16 if M == 16 else 80)
    big = [plan(640, 1024, 4096), plan(640, 4096, 1024),
           plan(640, 1024, 1024, True), plan(640, 1024, 1024)]
    assert [(p.row_tiles, p.splits) for p in big] == [
        (8, 1), (8, 1), (8, 1), (8, 1)]
    with pytest.raises(ValueError, match="generic product"):
        plan(16, 0, 100)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("partial", [False, True])
@pytest.mark.parametrize("N,C,F", [(16, 1024, 4096), (80, 1024, 4096),
                                   (640, 1024, 4096), (1, 32, 64),
                                   (33, 100, 200)])
def test_generic_ffn_launch_passes_the_plan(recording_library, dtype, partial,
                                            N, C, F):
    """The generic FFN's launch passes fc1's and fc2's tiles and depth a
    block from `generic_product_plan`, and fp32 scratch and the device's
    arrival counters exactly where a product splits its depth; one launch
    counted."""
    before = decode_blocks.decode_ffn_block_generic.launches
    decode_blocks._launch_ffn_generic(z(dtype, N, C), z(dtype, C, F),
                                      z(dtype, F), z(dtype, F, C),
                                      None if partial else z(dtype, C))
    ((name, args),) = recording_library
    plans = (decode_blocks.generic_product_plan(N, C, F),
             decode_blocks.generic_product_plan(N, F, C))
    assert name == "nic_decode_ffn_block_generic"
    assert args[0] == _build.GENERIC_DTYPES[dtype]
    assert args[11:18] == (N, C, F, plans[0].tile, plans[0].ksplit,
                           plans[1].tile, plans[1].ksplit)
    split = any(p.splits > 1 for p in plans)
    assert (args[7] is not None, args[8] is not None) == (split, split)
    assert (args[9] is None, args[10] is None) == (partial, not partial)
    assert decode_blocks.decode_ffn_block_generic.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,C,H,K", [(16, 1024, 16, 31), (80, 1024, 16, 3),
                                     (640, 1024, 16, 7), (5, 32, 4, 1),
                                     (40, 48, 3, 32), (81, 100, 4, 5)])
def test_generic_conv_launch_passes_the_plan(recording_library, dtype, N, C,
                                             H, K):
    """The generic conv block's launch passes linear1's, the tap logits'
    and linear2's tiles and depth a block from `generic_product_plan`,
    scratch and counters where any splits, no cache at K = 1, and the
    step or the positions; one launch counted."""
    before = decode_blocks.decode_conv_block_generic.launches
    args = (z(dtype, N, C), z(dtype, max(K - 1, 0), N, C), 3,
            z(dtype, C, 2 * C), z(dtype, 2 * C), z(dtype, C, H * K),
            z(dtype, C, C), z(dtype, C), H, None)
    decode_blocks._launch_conv_generic(*args)
    pos = torch.arange(N, dtype=torch.int32)
    decode_blocks._launch_conv_generic(*args[:2], pos, *args[3:])
    plans = (decode_blocks.generic_product_plan(N, C, C, True),
             decode_blocks.generic_product_plan(N, C, H * K),
             decode_blocks.generic_product_plan(N, C, C))
    split = any(p.splits > 1 for p in plans)
    for (name, cargs), step in zip(recording_library, (True, False)):
        assert name == "nic_decode_conv_block_generic"
        assert cargs[15:26] == (N, C, H, K, 3 if step else 0,
                                *(v for p in plans
                                  for v in (p.tile, p.ksplit)))
        assert (cargs[2] is None) == (K == 1)
        assert (cargs[3] is None) == step
        assert (cargs[12] is not None, cargs[13] is not None) == (split,
                                                                  split)
    assert decode_blocks.decode_conv_block_generic.launches == before + 2


def test_tiny_model_decodes_and_trains_on_the_cpu():
    """On CPU tensors every wrapper takes its plain version, so a model
    no kernel admits decodes and takes a loss and gradients there, flash
    attention on, with no launch counted."""
    gen = torch.Generator().manual_seed(0)
    model = TransformerFlattened(device="cpu", dtype=torch.float32,
                                 generator=gen, use_flash_train=True, **TINY)
    g = torch.Generator().manual_seed(1)
    batch = {"image": torch.randn(3, 4, 16, generator=g),
             "article": torch.randn(3, 16, 12, generator=g),
             "image_mask": torch.zeros(3, 4, dtype=torch.bool),
             "article_mask": torch.zeros(3, 16, dtype=torch.bool),
             "caption_ids": torch.randint(2, 64, (3, 12), generator=g)}
    counted = (band_topk.band_topk_lse,
               decode_attention.decode_cross_attention,
               decode_blocks.decode_conv_block, decode_blocks.decode_ffn_block,
               flash_attention.flash_attention_fwd,
               flash_attention.flash_attention_bwd)
    before = [fn.launches for fn in counted]
    tokens, log_probs = model.generate(batch, GenerationConfig(max_len=8))
    assert tokens.shape == (3, 9) and bool(torch.isfinite(log_probs).all())
    loss, _ = model.loss_fn(batch, torch.Generator().manual_seed(2))
    loss.backward()
    grads = [p.grad for p in model.decoder.parameters() if p.grad is not None]
    assert grads and all(bool(torch.isfinite(g).all()) for g in grads)
    assert [fn.launches for fn in counted] == before


# -- kernel size 1 -----------------------------------------------------------

POINTWISE = dict(vocab_size=120, cutoff=(40, 80, 120), embed_dim=32,
                 ffn_dim=64, num_heads=4, num_layers=2, kernel_sizes=(1, 3),
                 image_dim=48, article_dim=32, max_positions=64)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def pointwise_params():
    """JAX's init of the POINTWISE model (PRNGKey(0), jitted) and its
    batch, shared by the cases."""
    B, T, P, S = 3, 10, 5, 7
    rng = np.random.RandomState(0)
    caption = rng.randint(2, 120, size=(B, T)).astype(np.int32)
    caption[:, 0] = 0
    image = rng.randn(B, P, 48).astype(np.float32)
    article = rng.randn(B, S, 32).astype(np.float32)
    article_mask = np.zeros((B, S), bool)
    article_mask[1, -2:] = True
    jbatch = {"caption_ids": jnp.asarray(caption), "image": jnp.asarray(image),
              "image_mask": jnp.zeros((B, P), bool),
              "article": jnp.asarray(article),
              "article_mask": jnp.asarray(article_mask)}
    jmodel = JaxTransformerFlattened(**POINTWISE)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jbatch)
    return dict(jmodel=jmodel, params=params, jbatch=jbatch, caption=caption,
                image=image, article=article, article_mask=article_mask)


@pytest.mark.parametrize("early_exit", [False, True])
def test_pointwise_layer_decodes_as_jax_does(pointwise_params, early_exit):
    """kernel_sizes = (1, 3): the K = 1 layer has an empty cache; greedy
    tokens equal JAX's, log-probs within 2e-4."""
    B, P = 3, 5
    pw = pointwise_params
    jmodel, params, jbatch = pw["jmodel"], pw["params"], pw["jbatch"]
    model = TransformerFlattened(device="cpu", dtype=torch.float32,
                                 **POINTWISE)
    model.decoder.load_state_dict(
        params_from_jax(_np_tree(params), model.decoder))
    weights = model.decoder.decode_weights()
    caches = model.decoder.init_cache(B, "cpu")
    assert [tuple(c.shape) for c in caches] == [(0, B, 32), (2, B, 32)]
    tbatch = {"image": torch.from_numpy(pw["image"]),
              "image_mask": torch.zeros(B, P, dtype=torch.bool),
              "article": torch.from_numpy(pw["article"]),
              "article_mask": torch.from_numpy(pw["article_mask"])}
    want, want_lp = jmodel.generate(
        params, jbatch, JaxGenerationConfig(max_len=12, early_exit=early_exit))
    got, got_lp = model.generate(
        tbatch, GenerationConfig(max_len=12, early_exit=early_exit), weights)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp), atol=2e-4,
                               rtol=2e-4)
    # Teacher forcing through the same layers agrees too.
    lp_jax = jax.jit(lambda p, ids, ctx: jmodel.decoder.apply(
        p, ids, ctx, method=type(jmodel.decoder).log_prob))(
            params, jbatch["caption_ids"], jmodel._contexts(jbatch))
    with torch.no_grad():
        lp = model.decoder.log_prob(torch.from_numpy(pw["caption"]).long(),
                                    tbatch)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_jax), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("conv_bias", [False, True])
def test_step_ring_at_kernel_size_one_matches_jax(conv_bias):
    rng = np.random.RandomState(1)
    C, H, steps = 32, 4, 4
    xs = rng.randn(2, steps, C).astype(np.float32)
    jconv = JaxDynamicConv(input_size=C, kernel_size=1, num_heads=H,
                           weight_softmax=False, conv_bias=conv_bias)
    params = jconv.init(jax.random.PRNGKey(2), jnp.asarray(xs))
    conv = DynamicConv(C, 1, H, device="cpu", dtype=torch.float32,
                       weight_softmax=False, conv_bias=conv_bias)
    conv.load_state_dict(params_from_jax(_np_tree(params), conv))
    jcache, cache = jnp.zeros((2, 0, C)), torch.zeros(2, 0, C)
    for t in range(steps):
        jout, jcache = jconv.apply(params, jnp.asarray(xs[:, t]), jcache, t,
                                   method=JaxDynamicConv.step_ring)
        with torch.no_grad():
            out, cache = conv.step_ring(torch.from_numpy(xs[:, t]), cache, t)
        assert cache.shape == (2, 0, C)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5,
                                   rtol=1e-5)
    with torch.no_grad():
        full = conv(torch.from_numpy(xs))
    np.testing.assert_allclose(full.numpy()[:, -1], out.numpy(), atol=1e-5,
                               rtol=1e-5)
