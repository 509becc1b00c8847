"""The port's copies of the reference's plain-Python modules, and its
config reader and builders, against the reference on the CPU.

The copies (`evaluation/*`, `data/collate.py`, `data/dataset.py`) must
give the reference's answers on the same inputs: scores, enriched
records, offline metrics, diffs, batches bit for bit. The port's YAML
reader must read every file under `configs/` as `yaml.safe_load` does,
types included, and raise outside its subset. `build_model` must build
every `transformer_flattened` config: at full width on the meta device
(every parameter's shape the reference's, traced with `jax.eval_shape`,
nothing allocated) and, with the widths narrowed by overrides, decoding
on the CPU; every other model type raises NotImplementedError.
"""

import glob
import json
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
yaml = pytest.importorskip("yaml")

import jax  # noqa: E402

from news_image_caption_tpu import config as jax_config  # noqa: E402
from news_image_caption_tpu.data import collate as jax_collate  # noqa: E402
from news_image_caption_tpu.data import dataset as jax_dataset  # noqa: E402
from news_image_caption_tpu.evaluation import (  # noqa: E402
    checkdiff as jax_checkdiff, compute_metrics as jax_compute_metrics,
    enrich as jax_enrich, meteor as jax_meteor, metrics as jax_metrics,
    text_analysis as jax_text_analysis)
from news_image_caption_tpu_torch import config  # noqa: E402
from news_image_caption_tpu_torch.data import (collate,  # noqa: E402
                                               dataset)
from news_image_caption_tpu_torch.evaluation import (  # noqa: E402
    checkdiff, compute_metrics, enrich, meteor, metrics, text_analysis)
from news_image_caption_tpu_torch.generation.generator import \
    GenerationConfig  # noqa: E402
from news_image_caption_tpu_torch.models.from_jax import \
    params_from_jax  # noqa: E402
from news_image_caption_tpu_torch.yaml_subset import (  # noqa: E402
    YamlSubsetError, safe_load)

REPO = Path(__file__).resolve().parent.parent
CONFIGS = sorted(str(Path(p).relative_to(REPO)) for p in
                 glob.glob(str(REPO / "configs" / "**" / "*.yaml"),
                           recursive=True))
FLATTENED = ["configs/goodnews_transformer_roberta.yaml",
             "configs/nytimes/location_aware.yaml",
             "configs/nytimes/transformer_roberta.yaml",
             "configs/tiny_test.yaml"]
# Widths that make any transformer_flattened config a small model.
NARROW = dict(vocab_size=64, cutoff=[16, 32, 64], embed_dim=16, ffn_dim=32,
              num_heads=4, image_dim=16, article_dim=12, max_positions=64)

PAIRS = [
    ("the cat sat on the mat", ["the cat is on the mat"]),
    ("a man riding a horse", ["a man rides a horse on the beach",
                              "someone on a horse"]),
    ("", ["an empty hypothesis"]),
    ("word", ["word"]),
    ("word", [""]),
    ("Barack Obama spoke in Washington on Monday",
     ["President Barack Obama speaking in Washington"]),
    ("w12 w7 w7 w99", ["w7 w12 w99"]),
]


def same(a, b) -> bool:
    """Equal values of equal types (True is not 1, 1.0 is not 1)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(same, a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


# -- scorers -----------------------------------------------------------

def _corpus(mod, name):
    scorer = {"bleu": lambda: mod.BleuScorer(4), "cider": mod.CiderScorer,
              "rouge": mod.RougeScorer}[name]()
    for hyp, refs in PAIRS:
        scorer += (hyp, refs)
    return scorer.compute_score()


@pytest.mark.parametrize("name", ["bleu", "cider", "rouge"])
def test_corpus_scorers_equal(name):
    assert same(_corpus(metrics, name), _corpus(jax_metrics, name))


@pytest.mark.parametrize("fn", ["bleu", "cider", "rouge_l"])
def test_score_functions_equal(fn):
    hyps = [h for h, _ in PAIRS]
    refs = [r for _, r in PAIRS]
    assert same(getattr(metrics, fn)(hyps, refs),
                getattr(jax_metrics, fn)(hyps, refs))


@pytest.mark.parametrize("params", ["1.5", "classic"])
@pytest.mark.parametrize("pair", range(len(PAIRS)))
def test_meteor_equal(pair, params):
    hyp, refs = PAIRS[pair]
    assert same(meteor.meteor(hyp, refs[0], params=params),
                jax_meteor.meteor(hyp, refs[0], params=params))


@pytest.mark.parametrize("text", [
    "", "word", "Mr. John Smith of Acme Corp visited Paris in March 2019.",
    "The New York Times reported that Angela Merkel met Emmanuel Macron."])
def test_text_analysis_equal(text):
    a, b = text_analysis.HeuristicAnalyzer(), \
        jax_text_analysis.HeuristicAnalyzer()
    assert same(a.proper_nouns(text), b.proper_nouns(text))
    assert same(a.entities(text), b.entities(text))
    assert same(text_analysis.readability_scores(text),
                jax_text_analysis.readability_scores(text))
    assert same(text_analysis.narrative_productivity(text),
                jax_text_analysis.narrative_productivity(text))


# -- enrichment, offline metrics, diffs --------------------------------

RECORDS = [
    dict(caption="President Barack Obama speaks in Washington on Monday",
         generation="Barack Obama speaks in New York",
         context="Barack Obama visited Washington. The White House said.",
         metadata={"web_url": "http://example.com/a", "caption": "raw"}),
    dict(caption="w12 w7 w99", generation="w12 w7", copied_text="w7"),
    dict(caption="Dr. Jane Doe of Acme Inc", generation=""),
]


@pytest.mark.parametrize("i", range(len(RECORDS)))
def test_enrich_record_equal(i):
    got = enrich.enrich_record(**RECORDS[i], cache=enrich.EnrichmentCache())
    want = jax_enrich.enrich_record(**RECORDS[i],
                                    cache=jax_enrich.EnrichmentCache())
    assert same(got, want)


@pytest.fixture(scope="module")
def jsonl(tmp_path_factory):
    """Two runs' generations.jsonl, written by the port's
    `write_generations`: the second differs in one generation, has a
    duplicate caption and a record without enrichment."""
    root = tmp_path_factory.mktemp("jsonl")
    recs = [enrich.enrich_record(**r) for r in RECORDS]
    other = [dict(r) for r in recs] + [dict(recs[0])]
    other[1]["generation"] = "w99"
    other.append({"caption": "bare", "generation": "w1"})
    a, b = root / "a.jsonl", root / "b.jsonl"
    enrich.write_generations(str(a), recs, append=False)
    enrich.write_generations(str(b), other, append=False)
    with open(a) as f:
        assert [json.loads(line) for line in f] == recs
    return str(a), str(b)


@pytest.mark.parametrize("which", ["a", "b"])
def test_compute_metrics_equal(jsonl, which):
    path = jsonl[which == "b"]
    counters = {"caption": {"Obama": 3}, "context": {"Washington": 1}}
    for c in (None, counters):
        assert same(compute_metrics.compute_metrics(path, c),
                    jax_compute_metrics.compute_metrics(path, c))


def test_checkdiff_equal(jsonl):
    a, b = jsonl
    assert same(checkdiff.diff_runs(a, b), jax_checkdiff.diff_runs(a, b))
    for path in (a, b):
        assert same(checkdiff.integrity_check(path),
                    jax_checkdiff.integrity_check(path))


@pytest.mark.parametrize("argv", [["{a}", "{b}"], ["--check", "{b}"]])
def test_checkdiff_main_equal(jsonl, argv, capsys):
    argv = [x.format(a=jsonl[0], b=jsonl[1]) for x in argv]
    assert checkdiff.main(argv) == 0
    got = capsys.readouterr().out
    assert jax_checkdiff.main(argv) == 0
    assert got == capsys.readouterr().out


def test_compute_metrics_main_equal(jsonl, capsys):
    out = Path(jsonl[0]).with_name("a_reported_metrics.json")
    assert compute_metrics.main([jsonl[0]]) == 0
    got = (capsys.readouterr().out, out.read_bytes())
    assert jax_compute_metrics.main([jsonl[0]]) == 0
    assert got == (capsys.readouterr().out, out.read_bytes())


# -- data --------------------------------------------------------------

DATASETS = {
    "tiny": dict(size=6, vocab_size=64, caption_len=12, article_len=16,
                 n_patches=4, image_dim=16, article_dim=12, seed=2,
                 n_templates=3, n_faces=2, face_dim=8, n_objects=3,
                 obj_dim=6, n_entities=2, entity_dim=5),
    "tiny_raw_image": dict(size=4, vocab_size=64, caption_len=12,
                           article_len=16, article_dim=12, seed=1,
                           raw_image_size=8),
    "flagship": dict(size=4, vocab_size=50265, caption_len=64,
                     article_len=512, n_patches=49, image_dim=2048,
                     article_dim=1024, seed=2, n_templates=5, n_faces=4,
                     n_objects=4, n_entities=4),
}


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("name", sorted(DATASETS))
def test_dataset_batches_bit_equal(name, shuffle):
    kw = DATASETS[name]
    got = list(dataset.SyntheticNewsDataset(**kw).batches(
        2, shuffle=shuffle, seed=3))
    want = list(jax_dataset.SyntheticNewsDataset(**kw).batches(
        2, shuffle=shuffle, seed=3))
    assert len(got) == len(want) == kw["size"] // 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_dataset_examples_equal():
    kw = DATASETS["tiny"]
    got = dataset.SyntheticNewsDataset(**kw)[3]
    want = jax_dataset.SyntheticNewsDataset(**kw)[3]
    for field in ("caption_ids", "article_ids", "caption_copy_masks",
                  "context_proper_masks", "caption_text", "metadata"):
        assert getattr(got, field) == getattr(want, field), field
    for field in ("image_feats", "article_feats", "template_label", "faces",
                  "faces_mask", "obj", "obj_mask", "entity", "entity_mask"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)


def test_collate_helpers_equal():
    ids = [[0, 5, 6, 2], [0, 7, 2], list(range(3, 15))]
    for length in (3, 8):
        for c in ids:
            np.testing.assert_array_equal(collate.pad_to(c, length, 1),
                                          jax_collate.pad_to(c, length, 1))
    arr = np.stack([collate.pad_to(c, 8, 1) for c in ids])
    np.testing.assert_array_equal(collate.make_causal_pad_mask(arr, 1),
                                  jax_collate.make_causal_pad_mask(arr, 1))
    images = np.random.RandomState(0).randn(3, 2, 4)
    for kw in (dict(), dict(articles=ids, article_len=5, images=images)):
        got = collate.collate_captions(ids, 6, **kw)
        want = jax_collate.collate_captions(ids, 6, **kw)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -- config ------------------------------------------------------------

@pytest.mark.parametrize("path", CONFIGS)
def test_yaml_reader_equals_safe_load(path):
    text = (REPO / path).read_text()
    assert same(safe_load(text), yaml.safe_load(text))


def test_every_config_is_read():
    assert len(CONFIGS) == 39


@pytest.mark.parametrize("text", [
    "a: &anchor 1\nb: *anchor\n",
    "a: |\n  literal text\n",
    "a: >\n  folded text\n",
    "a:\n  - 1\n  - 2\n",
    "a: 'quoted'\n",
    "a: !!str 1\n",
    "a: 12:30\n",
    "a: 1\na: 2\n",
    "a: {b: 1\n",
])
def test_yaml_reader_raises_outside_its_subset(text):
    with pytest.raises(YamlSubsetError):
        safe_load(text)


@pytest.mark.parametrize("text", [
    "a: 1e-6\nb: 1.0e-6\nc: 017\nd: 0x1f\ne: 0b11\nf: 1_000\ng: .5\n",
    "a: yes\nb: Off\nc: ~\nd:\ne: -.inf\nf: TRUE\ng: 09\nh: x:y\n",
    "a: {b: [1, {c: d}], e: , f}\n# comment\ng: [1,\n    2]  # more\n",
])
def test_yaml_scalars_resolve_as_safe_load(text):
    assert same(safe_load(text), yaml.safe_load(text))


def test_load_config_merges_overrides():
    cfg = config.load_config(str(REPO / "configs/tiny_test.yaml"),
                             json.dumps({"generation": {"max_len": 3},
                                         "dataset": {"test": {"size": 4}}}))
    want = jax_config.load_config(str(REPO / "configs/tiny_test.yaml"),
                                  json.dumps({"generation": {"max_len": 3},
                                              "dataset": {"test":
                                                          {"size": 4}}}))
    assert same(cfg, want)
    assert cfg["generation"] == {"max_len": 3, "sampling_topk": 1}
    assert cfg["dataset"]["test"] == {"size": 4, "seed": 2}


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_build_dataset_equal(split):
    cfg = config.load_config(str(REPO / "configs/tiny_test.yaml"))
    got, want = config.build_dataset(cfg, split), \
        jax_config.build_dataset(cfg, split)
    assert len(got) == len(want)
    g, w = next(got.batches(4, shuffle=False)), \
        next(want.batches(4, shuffle=False))
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _jax_shapes(cfg):
    """The reference model's parameter tree, shapes only."""
    model = jax_config.build_model(cfg)
    ds = jax_config.build_dataset(cfg, "test")
    ex = ds.collate([ds[0]])
    sample = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
              for k, v in ex.items()}
    return jax.eval_shape(model.init, jax.random.PRNGKey(0), sample)


@pytest.mark.parametrize("path", FLATTENED)
def test_build_model_maps_the_config_at_full_width(path):
    cfg = config.load_config(str(REPO / path))
    model = config.build_model(cfg, "meta")
    tree = jax.tree.map(lambda s: np.lib.stride_tricks.as_strided(
        np.zeros(1, np.float32), s.shape, (0,) * len(s.shape)),
        _jax_shapes(cfg))
    params_from_jax(tree, model.decoder)     # strict: names and shapes
    want = config.config_dtype(cfg["model"].get("dtype", "float32"))
    assert model.decoder.dtype == want
    assert all(p.dtype == want for p in model.decoder.parameters())


@pytest.mark.parametrize("path", FLATTENED)
def test_build_model_decodes_narrowed_on_the_cpu(path):
    cfg = config.load_config(str(REPO / path))
    narrow = ({"decoder": NARROW} if "decoder" in cfg["model"] else NARROW)
    cfg = config.merge_overrides(cfg, {"model": narrow})
    gen = torch.Generator().manual_seed(0)
    model = config.build_model(cfg, "cpu", generator=gen)
    rng = np.random.RandomState(0)
    article_mask = np.arange(5)[None, :] >= np.array([[5], [3]])
    batch = {k: torch.from_numpy(v) for k, v in (
        ("image", rng.randn(2, 3, 16).astype(np.float32)),
        ("image_mask", np.zeros((2, 3), bool)),
        ("article", rng.randn(2, 5, 12).astype(np.float32)),
        ("article_mask", article_mask))}
    tokens, lps = model.generate(batch, GenerationConfig(max_len=4))
    assert tokens.shape == (2, 5) and bool((tokens[:, 0] == 0).all())
    assert bool(torch.isfinite(lps).all())


@pytest.mark.parametrize("path", sorted(set(CONFIGS) - set(FLATTENED)))
def test_build_model_raises_for_models_not_ported(path):
    cfg = config.load_config(str(REPO / path))
    with pytest.raises(NotImplementedError,
                       match=r"ROADMAP Queue 1 item (8|9|10)\)"):
        config.build_model(cfg, "meta")


@pytest.mark.parametrize("key,value", [
    ("conv_type", "lightweight"), ("decoder_glu", False),
    ("weight_softmax", False), ("normalize_before", True),
    ("final_norm", True), ("include_image", False),
    ("extra_contexts", [["faces", 512]]), ("param_dtype", "bfloat16"),
])
def test_build_model_raises_for_decoder_options_not_ported(key, value):
    cfg = config.load_config(str(REPO / "configs/tiny_test.yaml"))
    cfg = config.merge_overrides(cfg, {"model": {"decoder": {key: value}}})
    with pytest.raises(NotImplementedError,
                       match=rf"{key}=.*ROADMAP Queue 1 item 8\)"):
        config.build_model(cfg, "meta")


def test_build_model_accepts_the_implemented_values():
    cfg = config.load_config(
        str(REPO / "configs/goodnews_transformer_roberta.yaml"))
    for key in ("conv_type", "decoder_glu", "weight_softmax",
                "normalize_before", "final_norm", "use_flash_train"):
        assert key in cfg["model"]["decoder"]
    kw = config.decoder_kwargs(cfg)
    assert kw["use_flash_train"] is True and kw["kernel_sizes"] == (3, 7, 15,
                                                                    31)
    bad = config.merge_overrides(cfg, {"model": {"decoder": {"mystery": 1}}})
    with pytest.raises(TypeError, match="mystery"):
        config.build_model(bad, "meta")
