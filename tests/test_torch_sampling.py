"""The port's top-k sampling against JAX, on the CPU.

JAX samples with `jax.random.categorical`: argmax(logits + Gumbel
noise), the noise drawn from a key that `generate_candidates` splits
once a step (`key, sub = split(key)`), and that a sampling slot of the
continuous pool splits for its own request. torch's generators draw
other bits, so these tests feed the port JAX's own draws through its
one noise function, `generation/generator.py::gumbel_noise`, replaying
the reference's key schedule; tokens must then be JAX's and log-probs
within 1e-5. Within the port, with its own generators: a sampling slot
seeded s samples what `generate` samples alone with a generator seeded
s, one generator a row samples each row as it would be sampled alone,
and `evaluate` with `generation.sampling_topk` writes the same file
twice. The small captioner is `tests/torch_decode_pair.py`'s.
"""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from news_image_caption_tpu.generation.generator import \
    GenerationConfig as JaxConfig  # noqa: E402
from news_image_caption_tpu_torch import cli  # noqa: E402
from news_image_caption_tpu_torch.generation import \
    generator as gen  # noqa: E402
from news_image_caption_tpu_torch.generation.continuous import \
    ContinuousBatcher  # noqa: E402
from news_image_caption_tpu_torch.serving.client import \
    CaptioningClient  # noqa: E402
from news_image_caption_tpu_torch.serving.worker import (  # noqa: E402
    TOY, TOY_ARTICLE_LEN, TOY_IMAGE_LEN, default_model_builder)

import torch_decode_pair as tp  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
MAX_LEN, TOPK, TEMP = 12, 4, 0.8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class JaxKeys:
    """A stand-in generator: JAX's key schedule, one split a draw."""

    def __init__(self, key):
        self.key = key

    def draw(self, shape):
        self.key, sub = jax.random.split(self.key)
        return torch.from_numpy(np.array(jax.random.gumbel(sub, shape)))


@pytest.fixture
def jax_noise(monkeypatch):
    """gumbel_noise drawing JaxKeys' noise ([B, k] from one, [1, k] a
    row from a sequence); torch's own generators (a pool's spare) as
    before."""
    real = gen.gumbel_noise

    def fed(generator, shape):
        if isinstance(generator, JaxKeys):
            return generator.draw(shape)
        if isinstance(generator, torch.Generator):
            return real(generator, shape)
        return torch.cat([fed(g, (1,) + tuple(shape[1:]))
                          for g in generator])

    monkeypatch.setattr(gen, "gumbel_noise", fed)


@pytest.fixture(scope="module")
def setup():
    jmodel, params, model = tp.make_pair((3, 7))
    cfg = JaxConfig(max_len=MAX_LEN, sampling_topk=TOPK, sampling_temp=TEMP)
    sample = jax.jit(lambda b, key: jmodel.generate(params, b, cfg, rng=key))
    greedy = jax.jit(lambda b: jmodel.generate(
        params, b, JaxConfig(max_len=MAX_LEN, sampling_topk=1))[0])
    return dict(jmodel=jmodel, params=params, model=model, sample=sample,
                greedy=greedy, weights=model.decoder.decode_weights(),
                cfg=gen.GenerationConfig(max_len=MAX_LEN,
                                         sampling_topk=TOPK,
                                         sampling_temp=TEMP))


@pytest.mark.parametrize("path", ["generate", "generate_full"])
def test_sampling_matches_jax_with_its_draws(setup, jax_noise, path):
    """B = 3 sampled from PRNGKey(5) in JAX; the port's candidate and
    full-vocab loops fed the same draws give JAX's tokens."""
    arrays = tp.request_arrays(3, 20)
    want_t, want_lp = (np.asarray(a) for a in setup["sample"](
        tp.jax_batch(arrays), jax.random.PRNGKey(5)))
    got_t, got_lp = getattr(setup["model"], path)(
        tp.torch_batch(arrays), setup["cfg"], setup["weights"],
        generator=JaxKeys(jax.random.PRNGKey(5)))
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    np.testing.assert_allclose(got_lp.numpy(), want_lp, atol=1e-5, rtol=1e-5)
    greedy = np.asarray(setup["greedy"](tp.jax_batch(arrays)))
    assert not np.array_equal(got_t.numpy(), greedy)   # it did sample


def test_sampling_slots_match_jax_generate_with_same_key(setup, jax_noise):
    """Each sampling slot replays its request's key as JAX's `generate`
    does at B = 1: every request's caption is JAX's, whenever it entered
    the 2-slot pool."""
    reqs = [tp.request_arrays(1, 100 + i) for i in range(5)]
    keys = [jax.random.PRNGKey(1000 + i) for i in range(5)]
    singles = [tuple(np.asarray(a)[0] for a in setup["sample"](
        tp.jax_batch(r), k)) for r, k in zip(reqs, keys)]
    eng = ContinuousBatcher.for_flattened(setup["model"], setup["cfg"], 2,
                                          weights=setup["weights"],
                                          inner_steps=2)
    ids = [eng.submit(tp.torch_batch(r), generator=JaxKeys(k))
           for r, k in zip(reqs, keys)]
    results = eng.run()
    for rid, (want_t, want_lp) in zip(ids, singles):
        np.testing.assert_array_equal(results[rid][0], want_t)
        np.testing.assert_allclose(results[rid][1], want_lp, atol=1e-5,
                                   rtol=1e-5)
    assert eng.stats()["sampling_topk"] == TOPK


def test_sampling_slots_match_generate_with_same_generator(setup):
    """The port's own contract: a slot seeded s samples what `generate`
    samples alone from a generator seeded s; without one, the request id
    seeds the slot."""
    model, w, cfg = setup["model"], setup["weights"], setup["cfg"]
    reqs = [tp.torch_batch(tp.request_arrays(1, 200 + i)) for i in range(4)]
    eng = ContinuousBatcher.for_flattened(model, cfg, 2, weights=w,
                                          inner_steps=3)
    seeds = [11, 12, None, None]
    ids = [eng.submit(r, generator=None if s is None else
                      torch.Generator().manual_seed(s))
           for r, s in zip(reqs, seeds)]
    results = eng.run()
    for rid, r, s in zip(ids, reqs, seeds):
        want_t, want_lp = model.generate(
            r, cfg, w, generator=torch.Generator().manual_seed(
                rid if s is None else s))
        np.testing.assert_array_equal(results[rid][0], want_t[0].numpy())
        np.testing.assert_allclose(results[rid][1], want_lp[0].numpy(),
                                   atol=1e-6, rtol=1e-6)


def test_a_generator_a_row_samples_each_row_as_alone(setup):
    """One generator a row: row b of a batch of 3 is what a batch of 1
    samples with row b's generator (the yardstick of the card's pool)."""
    model, w, cfg = setup["model"], setup["weights"], setup["cfg"]
    arrays = tp.request_arrays(3, 30)
    rows, _ = model.generate(tp.torch_batch(arrays), cfg, w, generator=[
        torch.Generator().manual_seed(40 + b) for b in range(3)])
    for b in range(3):
        one = {k: v[b:b + 1] for k, v in arrays.items()}
        alone, _ = model.generate(tp.torch_batch(one), cfg, w,
                                  generator=torch.Generator().manual_seed(
                                      40 + b))
        assert torch.equal(rows[b], alone[0])


def test_default_generator_is_seeded_with_zero(setup):
    model, w, cfg = setup["model"], setup["weights"], setup["cfg"]
    batch = tp.torch_batch(tp.request_arrays(2, 31))
    a, _ = model.generate(batch, cfg, w)
    b, _ = model.generate(batch, cfg, w,
                          generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b)


def test_gumbel_noise_rows_and_moments():
    """A sequence of generators draws each row's [1, k] alone; the noise
    has Gumbel(0, 1)'s mean (Euler's gamma) and variance (pi^2 / 6)."""
    rows = gen.gumbel_noise([torch.Generator().manual_seed(s)
                             for s in (1, 2)], (2, 5))
    for i, s in enumerate((1, 2)):
        one = gen.gumbel_noise(torch.Generator().manual_seed(s), (1, 5))
        assert torch.equal(rows[i:i + 1], one)
    big = gen.gumbel_noise(torch.Generator().manual_seed(0), (400, 500))
    assert bool(torch.isfinite(big).all())
    assert abs(big.mean().item() - 0.5772) < 0.01
    assert abs(big.var().item() - np.pi ** 2 / 6) < 0.03


def test_greedy_select_draws_nothing():
    cfg = gen.GenerationConfig(sampling_temp=2.0)
    lp = torch.tensor([[-0.5, -1.0], [-0.2, -3.0]])
    ids = torch.tensor([[7, 3], [4, 9]])
    sel_lp, sel = gen.select_candidates(lp, ids, cfg, generator=object())
    assert sel.tolist() == [7, 4]
    assert torch.equal(sel_lp, lp[:, 0] / 2.0)


def test_evaluate_sampled_generations_are_reproducible(tmp_path):
    """`evaluate` with generation.sampling_topk 3 on configs/tiny_test.yaml
    writes the same generations.jsonl twice (a generator seeded with 0 a
    batch), and not the greedy one."""
    texts = []
    for run, topk in (("a", 3), ("b", 3), ("greedy", 1)):
        overrides = json.dumps({
            "generation": {"sampling_topk": topk, "sampling_temp": 1.5},
            "trainer": {"serialization_dir": str(tmp_path / run)}})
        assert cli.main(["evaluate", str(REPO / "configs/tiny_test.yaml"),
                         "--platform", "cpu", "--no-enrich", "-o",
                         overrides]) == 0
        texts.append((tmp_path / run / "generations.jsonl").read_bytes())
    assert texts[0] == texts[1] != texts[2]


def _serve(*args):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "news_image_caption_tpu_torch.cli", "serve",
         *args], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=REPO, env=env)


def test_cli_serve_sampling_slots():
    """`serve --task toy --platform cpu --continuous-slots 2
    --sampling-topk 4 --sampling-temp 0.8`: a job's rng_seed seeds its
    slot, so its caption is the toy's `generate` from a generator seeded
    the same; the same seed twice gives the same caption."""
    predict = default_model_builder("cpu")
    cfg = gen.GenerationConfig(max_len=predict.config.max_len,
                               sampling_topk=4, sampling_temp=0.8)
    rng = np.random.default_rng(3)
    jobs = [{"image": rng.standard_normal(
                 (1, TOY_IMAGE_LEN, TOY["image_dim"])).astype(np.float32),
             "image_mask": np.zeros((1, TOY_IMAGE_LEN), bool),
             "article": rng.standard_normal(
                 (1, TOY_ARTICLE_LEN, TOY["article_dim"])).astype(np.float32),
             "article_mask": np.zeros((1, TOY_ARTICLE_LEN), bool)}
            for _ in range(3)]
    want = [predict.model.generate(
        predict.stage(j), cfg, predict.weights,
        generator=torch.Generator().manual_seed(50 + i))[0].numpy()
        for i, j in enumerate(jobs)]
    proc = _serve("--task", "toy", "--platform", "cpu", "--continuous-slots",
                  "2", "--sampling-topk", "4", "--sampling-temp", "0.8")
    try:
        info = json.loads(proc.stdout.readline())
        client = CaptioningClient(info["frontend_addr"],
                                  info["sink_pub_addr"], timeout_ms=120000)
        try:
            seeded = [dict(j, rng_seed=np.array([50 + i]))
                      for i, j in enumerate(jobs)]
            got = list(client.caption_stream(seeded + seeded[:1], window=4))
            for g, w in zip(got, want + want[:1]):
                np.testing.assert_array_equal(g["tokens"], w)
            assert client.stats()["sampling_topk"] == 4
        finally:
            client.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
