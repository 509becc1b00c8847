"""The port's continuous slot pool against JAX, on the CPU.

`generation/continuous.py` must give each request the caption that
JAX's `generate` (greedy) or `generate_beam` gives it alone, whenever
it entered a slot and whatever the other slots were doing. The small
captioner of `tests/torch_decode_pair.py` (2 layers, kernels 3 and 7,
d = 32, 4 heads, JAX's init carried across, its eos row leaned toward
the mean state so captions end at different steps) serves 7 batch-1
requests. The cases mirror the reference's `tests/test_continuous.py`
(staggered submits, log-probs within 1e-5, speculative slots with
oracle and garbage sources, a request's own max_len, a malformed
request failing alone, batched requests, reset, the beam pool, the
first request sizing the pool, the constructors' checks, harvest_lag);
its quantized cases are in `tests/test_torch_quantize.py`, its Gen-2,
pointer and TGNC engines' in those families' files. Then the toy's
builders and the `serve` command with
`--continuous-slots` against JAX's `generate` of the reference's toy.
JAX's references are computed once a module, under jit.
"""

import json
import os
import signal
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from news_image_caption_tpu.generation.generator import \
    GenerationConfig as JaxConfig  # noqa: E402
from news_image_caption_tpu.models.captioner import \
    TransformerFlattened as JaxTransformerFlattened  # noqa: E402
from news_image_caption_tpu_torch.generation.continuous import (  # noqa: E402
    ContinuousBatcher, ContinuousBeamBatcher)
from news_image_caption_tpu_torch.generation.generator import \
    GenerationConfig  # noqa: E402
from news_image_caption_tpu_torch.serving.client import \
    CaptioningClient  # noqa: E402
from news_image_caption_tpu_torch.serving.worker import (  # noqa: E402
    TOY, TOY_ARTICLE_LEN, TOY_IMAGE_LEN, TOY_MAX_LEN, default_model_builder)

import torch_decode_pair as tp  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
MAX_LEN, BEAM, N_REQ = 12, 3, 7


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def setup():
    jmodel, params, model = tp.make_pair((3, 7), eos_bias=4.0)
    arrays = [tp.request_arrays(1, 100 + i) for i in range(N_REQ)]
    gen = jax.jit(lambda b: jmodel.generate(
        params, b, JaxConfig(max_len=MAX_LEN, sampling_topk=1)))
    singles = [tuple(np.asarray(a)[0] for a in gen(tp.jax_batch(r)))
               for r in arrays]
    beam = jax.jit(lambda b: jmodel.generate_beam(
        params, b, JaxConfig(max_len=MAX_LEN, beam_size=BEAM,
                             early_exit=True)))
    beams = [tuple(np.asarray(a)[0] for a in beam(tp.jax_batch(r)))
             for r in arrays]
    return dict(jmodel=jmodel, params=params, model=model,
                requests=[tp.torch_batch(r) for r in arrays],
                singles=singles, beams=beams,
                weights=model.decoder.decode_weights(),
                cfg=GenerationConfig(max_len=MAX_LEN))


def _engine(setup, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("inner_steps", 2)
    return ContinuousBatcher.for_flattened(setup["model"], setup["cfg"],
                                           weights=setup["weights"], **kw)


def _beam_engine(setup, cfg=None, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("inner_steps", 2)
    cfg = cfg or GenerationConfig(max_len=MAX_LEN, beam_size=BEAM,
                                  early_exit=True)
    return ContinuousBeamBatcher(setup["model"], cfg,
                                 weights=setup["weights"], **kw)


def test_the_weights_end_captions_at_different_steps(setup):
    ends = {int(np.argmax(t == 2)) for t, _ in setup["singles"]
            if (t == 2).any()}
    assert len(ends) >= 2 and any(not (t == 2).any()
                                  for t, _ in setup["singles"])


@pytest.mark.parametrize("harvest_lag", [1, 3])
def test_staggered_submits_match_single_request_greedy(setup, harvest_lag):
    """Requests submitted mid-flight, while the other slots decode at
    other depths, get JAX's caption of the request alone; finished slots
    are harvested and refilled (7 requests through 3 slots), and with
    harvest_lag 3 every view goes to the request that owned its slot."""
    eng = _engine(setup, n_slots=3, harvest_lag=harvest_lag)
    ids = [eng.submit(r) for r in setup["requests"][:4]]
    results = {}
    results.update(eng.step())
    results.update(eng.step())
    ids += [eng.submit(r) for r in setup["requests"][4:]]   # mid-flight
    results.update(eng.run())
    assert sorted(results) == sorted(ids) and not eng._pending
    for rid, (want, _) in zip(ids, setup["singles"]):
        np.testing.assert_array_equal(results[rid][0], want)
    assert eng.stats()["harvest_lag"] == harvest_lag


def test_continuous_log_probs_match_generate(setup):
    eng = _engine(setup, inner_steps=3)
    ids = [eng.submit(r) for r in setup["requests"][:3]]
    results = eng.run()
    for rid, (_, want) in zip(ids, setup["singles"]):
        np.testing.assert_allclose(results[rid][1], want, rtol=1e-5,
                                   atol=1e-5)


def test_speculative_slots_are_exact_and_fewer_chunks(setup):
    """spec_k = 4 slots draft from their own source (the caption itself,
    an oracle): the same captions, fewer dispatches, more tokens a
    slot-step."""
    plain = _engine(setup, inner_steps=1)
    for r in setup["requests"][:4]:
        plain.submit(r)
    plain.run()
    spec = _engine(setup, inner_steps=1, spec_k=4, source_len=16)
    ids = [spec.submit(r, source_row=setup["singles"][i][0][1:])
           for i, r in enumerate(setup["requests"][:4])]
    res = spec.run()
    for i, rid in enumerate(ids):
        np.testing.assert_array_equal(res[rid][0], setup["singles"][i][0])
        np.testing.assert_allclose(res[rid][1], setup["singles"][i][1],
                                   rtol=1e-5, atol=1e-5)
    assert spec.n_chunks < plain.n_chunks
    assert spec.occupancy > plain.occupancy


def test_garbage_source_still_exact(setup):
    eng = _engine(setup, spec_k=3, source_len=8)
    garbage = np.full((8,), 3, np.int64)
    ids = [eng.submit(r, source_row=garbage) for r in setup["requests"][:3]]
    results = eng.run()
    for i, rid in enumerate(ids):
        np.testing.assert_array_equal(results[rid][0],
                                      setup["singles"][i][0])


def test_empty_engine_step_is_noop(setup):
    eng = _engine(setup)
    assert eng.step() == {}
    assert eng.n_chunks == 0
    assert eng.run() == {}


def test_per_request_max_len_frees_slots_early(setup):
    """A request capped at 3 tokens ends at its cap with the greedy
    prefix, and frees its slot for the request queued behind it; a
    rejected cap leaves nothing queued."""
    singles, requests = setup["singles"], setup["requests"]
    eng = _engine(setup, n_slots=1, inner_steps=1)
    short = eng.submit(requests[2], max_len=3)   # no eos before step 12
    long = eng.submit(requests[1])
    first = {}
    while short not in first:
        first.update(eng.step())
    assert long not in first
    toks, _ = first[short]
    np.testing.assert_array_equal(toks[:4], singles[2][0][:4])
    assert np.all(toks[4:] == 1)
    rest = eng.run()
    np.testing.assert_array_equal(rest[long][0], singles[1][0])
    with pytest.raises(ValueError):
        eng.submit(requests[2], max_len=MAX_LEN + 1)
    assert eng.backlog == 0 and eng.idle
    ok = eng.submit(requests[2], max_len=2)
    res = eng.run()
    assert not eng.drain_failed()
    np.testing.assert_array_equal(res[ok][0][:3], singles[2][0][:3])


def _short(request, n=3):
    return {k: (v[:, :n] if k in ("article", "article_mask") else v)
            for k, v in request.items()}


def test_malformed_request_fails_alone(setup):
    eng = _engine(setup)
    good = eng.submit(setup["requests"][0])
    bad = eng.submit(_short(setup["requests"][1]))
    results, failed = {}, {}
    while good not in results:
        results.update(eng.step())
        failed.update(eng.drain_failed())
    assert bad in failed and good not in failed
    np.testing.assert_array_equal(results[good][0], setup["singles"][0][0])
    assert eng.idle


def test_batched_request_rejected(setup):
    eng = _engine(setup, inner_steps=1)
    two = {k: torch.cat([v, v]) for k, v in setup["requests"][0].items()}
    rid = eng.submit(two)
    eng.step()
    failed = eng.drain_failed()
    assert rid in failed and "B=1" in str(failed[rid])


def test_reset_recovers_and_stays_warm(setup):
    eng = _engine(setup)
    eng.submit(setup["requests"][0])
    eng.step()
    eng.reset()
    assert eng.idle
    rid = eng.submit(setup["requests"][1])
    np.testing.assert_array_equal(eng.run()[rid][0], setup["singles"][1][0])


def test_first_request_sizes_pool_later_mismatches_fail_alone(setup):
    eng = _engine(setup)
    short = _short(setup["requests"][0])
    first = eng.submit(short)               # sizes the pool at S = 3
    mismatched = eng.submit(setup["requests"][1])
    results, failed = {}, {}
    while not eng.idle:
        results.update(eng.step())
        failed.update(eng.drain_failed())
    assert mismatched in failed and first in results
    jshort = {k: jnp.asarray(v.numpy()) for k, v in short.items()}
    want, _ = setup["jmodel"].generate(setup["params"], jshort,
                                       JaxConfig(max_len=MAX_LEN,
                                                 sampling_topk=1))
    np.testing.assert_array_equal(results[first][0], np.asarray(want)[0])


@pytest.mark.parametrize("harvest_lag", [1, 2])
def test_beam_engine_matches_generate_beam(setup, harvest_lag):
    """Staggered beam-3 requests through a 2-slot pool: JAX's
    generate_beam of each request alone, tokens and scores."""
    eng = _beam_engine(setup, harvest_lag=harvest_lag)
    ids = [eng.submit(r) for r in setup["requests"][:3]]
    results = {}
    results.update(eng.step())
    ids += [eng.submit(r) for r in setup["requests"][3:]]   # mid-flight
    results.update(eng.run())
    assert sorted(results) == sorted(ids)
    for i, rid in enumerate(ids):
        want_t, want_s = setup["beams"][i]
        np.testing.assert_array_equal(results[rid][0], want_t)
        np.testing.assert_allclose(results[rid][1], want_s, rtol=1e-5,
                                   atol=1e-5)
    assert eng.stats()["beam_size"] == BEAM


def test_beam_engine_per_request_cap_and_failures(setup):
    cfg_cap = JaxConfig(max_len=4, beam_size=BEAM, early_exit=True)
    jr = tp.jax_batch({k: v.numpy() for k, v in setup["requests"][2].items()})
    want_t, _ = setup["jmodel"].generate_beam(setup["params"], jr, cfg_cap)
    eng = _beam_engine(setup, GenerationConfig(max_len=MAX_LEN,
                                               beam_size=BEAM),
                       n_slots=1, inner_steps=1)
    capped = eng.submit(setup["requests"][2], max_len=4)
    bad = eng.submit(_short(setup["requests"][1]))
    results, failed = {}, {}
    while not eng.idle:
        results.update(eng.step())
        failed.update(eng.drain_failed())
    got_t = results[capped][0]
    np.testing.assert_array_equal(got_t[:, :5], np.asarray(want_t)[0])
    assert np.all(got_t[:, 5:] == 1)
    assert bad in failed


def test_engine_constructor_validation(setup):
    with pytest.raises(ValueError):
        _engine(setup, inner_steps=0)
    with pytest.raises(ValueError):
        _beam_engine(setup, GenerationConfig(max_len=8, beam_size=2),
                     inner_steps=0)
    with pytest.raises(ValueError):
        _engine(setup, n_slots=0)
    with pytest.raises(ValueError, match="harvest_lag"):
        _engine(setup, harvest_lag=0)
    with pytest.raises(ValueError, match="greedy-only"):
        ContinuousBatcher.for_flattened(
            setup["model"], GenerationConfig(max_len=8, sampling_topk=3), 2,
            spec_k=2)
    with pytest.raises(ValueError, match="freeze-in-slot"):
        _beam_engine(setup, GenerationConfig(max_len=8, beam_size=2,
                                             harvest_finished=True))


@pytest.mark.parametrize("name", ["for_tgnc", "for_gen2"])
def test_other_families_raise_naming_item_10(name):
    """TGNC's and Gen-2's engines, ported with their families (ROADMAP
    Queue 1 item 10b), refuse sampling as the reference's do."""
    if name == "for_tgnc":
        with pytest.raises(ValueError, match="greedy-only"):
            ContinuousBatcher.for_tgnc(
                None, GenerationConfig(max_len=4, sampling_topk=3), 2)
        return
    with pytest.raises(ValueError, match="greedy-only"):
        ContinuousBatcher.for_gen2(
            None, GenerationConfig(max_len=4, sampling_topk=3), 2)


# -- the toy's builders and the serve command -----------------------------

def _toy_job(seed, article_len=TOY_ARTICLE_LEN):
    rng = np.random.default_rng(seed)
    mask = np.zeros((1, TOY_ARTICLE_LEN), bool)
    mask[:, article_len:] = True
    return {"image": rng.standard_normal(
                (1, TOY_IMAGE_LEN, TOY["image_dim"])).astype(np.float32),
            "image_mask": np.zeros((1, TOY_IMAGE_LEN), bool),
            "article": rng.standard_normal(
                (1, TOY_ARTICLE_LEN, TOY["article_dim"])).astype(np.float32),
            "article_mask": mask}


TOY_JOBS = [_toy_job(10 + i, article_len=6 - i % 3) for i in range(5)]


@pytest.fixture(scope="module")
def toy():
    """The reference's toy with its PRNGKey(0) init saved as the .npz the
    port loads, and JAX's greedy tokens of TOY_JOBS."""
    model = JaxTransformerFlattened(**TOY)
    init = {"caption_ids": jnp.zeros((1, 8), jnp.int32),
            **{k: jnp.asarray(v) for k, v in _toy_job(0).items()}}
    params = jax.jit(model.init)(jax.random.PRNGKey(0), init)
    gen = jax.jit(lambda b: model.generate(
        params, b, JaxConfig(max_len=TOY_MAX_LEN))[0])
    tokens = [np.asarray(gen({k: jnp.asarray(v) for k, v in j.items()}))
              for j in TOY_JOBS]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "toy.npz")
        np.savez(path, **{"/".join(k): np.asarray(v)
                          for k, v in flatten_dict(params).items()})
        yield {"params_path": path, "tokens": tokens}


@pytest.mark.parametrize("kwargs", [
    dict(speculative_k=4),
    dict(continuous_slots=2, inner_steps=3),
    dict(continuous_slots=2, speculative_k=3, harvest_lag=2),
], ids=["speculative", "continuous", "continuous_speculative"])
def test_toy_builders_serve_jax_greedy_tokens(toy, kwargs):
    """The builders' switches on the CPU: speculative jobs carrying
    article_ids (a plain worker), or the slot pool, give JAX's greedy
    tokens; the pool's warmup request leaves its counters at zero."""
    predict = default_model_builder("cpu", params_path=toy["params_path"],
                                    **kwargs)
    predict.warmup()
    engine = getattr(predict, "engine", None)
    ids = np.random.default_rng(1).integers(2, TOY["vocab_size"], (1, 9))
    if engine is None:
        for job, want in zip(TOY_JOBS, toy["tokens"]):
            got = predict(dict(job, article_ids=ids))["tokens"]
            np.testing.assert_array_equal(got, want)
        return
    assert engine.n_chunks == 0 and engine.stats()["busy_slots"] == 0
    rids = []
    for job in TOY_JOBS:
        staged = predict.stage(dict(job, article_ids=ids))
        src = staged.pop("article_ids", None)
        rids.append(engine.submit(staged, source_row=(
            None if src is None else src[0])))
    results = engine.run()
    for rid, want in zip(rids, toy["tokens"]):
        np.testing.assert_array_equal(results[rid][0], want[0])


def _serve(*args):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "news_image_caption_tpu_torch.cli", "serve",
         *args], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=REPO, env=env)


def test_cli_serve_continuous_slots(toy):
    """`serve --task toy --platform cpu --continuous-slots 4`: jobs sent
    together through the client come back with JAX's greedy tokens, a
    job's max_len caps its caption, a malformed job and an rng_seed on a
    greedy pool are answered alone, the stats RPC reports the pool; then
    SIGTERM ends it with rc 0."""
    proc = _serve("--task", "toy", "--platform", "cpu", "--continuous-slots",
                  "4", "--inner-steps", "3", "--params", toy["params_path"])
    try:
        info = json.loads(proc.stdout.readline())
        client = CaptioningClient(info["frontend_addr"],
                                  info["sink_pub_addr"], timeout_ms=120000)
        try:
            results = list(client.caption_stream(TOY_JOBS, window=4))
            for got, want in zip(results, toy["tokens"]):
                assert got["tokens"].dtype == np.int32
                np.testing.assert_array_equal(got["tokens"], want)
            capped = client.caption(dict(TOY_JOBS[0],
                                         max_len=np.array([3])))
            np.testing.assert_array_equal(capped["tokens"][0, :4],
                                          toy["tokens"][0][0, :4])
            assert np.all(capped["tokens"][0, 4:] == 1)
            bad = dict(TOY_JOBS[1], article=TOY_JOBS[1]["article"][:, :3],
                       article_mask=TOY_JOBS[1]["article_mask"][:, :3])
            with pytest.raises(RuntimeError, match="shapes"):
                client.caption(bad)
            with pytest.raises(RuntimeError, match="B=1"):
                client.caption({k: np.concatenate([v, v])
                                for k, v in TOY_JOBS[2].items()})
            again = client.caption(dict(TOY_JOBS[2],
                                        rng_seed=np.array([7])))
            np.testing.assert_array_equal(again["tokens"], toy["tokens"][2])
            stats = client.stats()
            assert stats["mode"] == "continuous" and stats["slots"] == 4
            assert stats["inner_steps"] == 3 and stats["in_flight"] == 0
            assert stats["engine"] == "ContinuousBatcher"
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
