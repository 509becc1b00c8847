"""The port's signature-compatible commands (`compat/`) against the JAX
package's, on the CPU.

- `parse_opt` takes the Gen-1 flags with the reference's defaults and
  checks (the same namespace as the JAX package's, `--platform` aside);
- `compat.train` against the reference's command on the same flags and
  synthetic data (`--drop_prob_lm 0`), the port's model starting from
  the reference's PRNGKey(0) init carried by `params_from_jax`: a
  show_tell run of 6 iterations, and a show_attend_tell run of 3 with
  scheduled sampling and step decay every epoch resumed by
  `--start_from` to 6. Each step's loss within rtol 1e-5 and its
  scheduled-sampling probability equal; the logged lines (time aside),
  the result line, `infos_{id}.json` and `meta.json` equal (CIDEr and
  losses within 1e-5, the captions scored being equal); the last
  checkpoint's params within rtol 1e-5 / atol 1e-5. The scheduled
  sampling's draws are JAX's (the reference's key schedule replayed
  into `Gen1Model._scheduled` from the seed the command gives each
  step); a show_tell run of 4 iterations over a small HDF5 written with
  h5py (`--input_image_h5` / `--input_json`, the reference's
  `H5DataLoader`): losses within 1e-5, logs, infos and metadata equal;
- `compat.test` decodes a config's test split (8 captions) from the
  reference's init and from the checkpoint of a `train` command: the
  interim lines and the final BLEU, CIDEr and n_samples equal to the
  reference command's;
- `eval_split` and `eval_split_visual_news` on a Gen-1 model carrying
  the reference's PRNGKey(0) init: the loss within 1e-5 and the
  predictions and scores equal to the JAX package's; the visual-news
  loop's image ids and paths, and its attention maps.
"""

import contextlib
import io
import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402

from news_image_caption_tpu import cli as jax_cli  # noqa: E402
from news_image_caption_tpu import config as jax_config  # noqa: E402
from news_image_caption_tpu.compat import eval_utils as jax_eval  # noqa
from news_image_caption_tpu.compat import test as jax_compat_test  # noqa
from news_image_caption_tpu.compat import train as jax_compat_train  # noqa
from news_image_caption_tpu.compat.opts import \
    parse_opt as jax_parse_opt  # noqa: E402
from news_image_caption_tpu.models import gen1 as jax_gen1  # noqa: E402
from news_image_caption_tpu_torch import cli  # noqa: E402
from news_image_caption_tpu_torch import config  # noqa: E402
from news_image_caption_tpu_torch.compat import eval_utils  # noqa: E402
from news_image_caption_tpu_torch.compat import test as compat_test  # noqa
from news_image_caption_tpu_torch.compat import train as compat_train  # noqa
from news_image_caption_tpu_torch.compat.opts import parse_opt  # noqa: E402
from news_image_caption_tpu_torch.data.dataset import \
    SyntheticNewsDataset  # noqa: E402
from news_image_caption_tpu_torch.data.synthetic import to_device  # noqa
from news_image_caption_tpu_torch.models import gen1  # noqa: E402
from news_image_caption_tpu_torch.models.from_jax import \
    params_from_jax  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
TINY = ["--rnn_size", "32", "--input_encoding_size", "24",
        "--att_hid_size", "16", "--fc_feat_size", "12",
        "--att_feat_size", "12", "--sentence_embed_size", "8",
        "--batch_size", "4", "--tpu_vocab_size", "50", "--drop_prob_lm", "0"]
END_TO_END = [["--caption_model", "show_tell", "--tpu_synthetic_size", "16",
               "--tpu_max_iters", "6", "--save_checkpoint_every", "3",
               "--losses_log_every", "2"]]
SS = ["--caption_model", "show_attend_tell", "--sentence_embed", "x",
      "--sentence_length", "6", "--tpu_synthetic_size", "8",
      "--save_checkpoint_every", "3", "--losses_log_every", "1",
      "--scheduled_sampling_start", "0",
      "--scheduled_sampling_increase_every", "1",
      "--learning_rate_decay_start", "0", "--learning_rate_decay_every", "1",
      "--learning_rate_decay_rate", "0.5"]
# The second run resumes from the first's directory ({first}).
SS_RESUME = [SS + ["--tpu_max_iters", "3"],
             SS + ["--tpu_max_iters", "6", "--start_from", "{first}"]]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_parse_opt_accepts_the_reference_flags():
    argv = ["--caption_model", "show_tell", "--rnn_size", "64",
            "--input_encoding_size", "32", "--batch_size", "4",
            "--learning_rate", "5e-4", "--beam_size", "3",
            "--scheduled_sampling_start", "0",
            "--checkpoint_path", "save/x", "--id", "st1"]
    opt = parse_opt(argv)
    assert opt.caption_model == "show_tell"
    assert opt.rnn_size == 64 and opt.beam_size == 3
    for args in (argv, []):
        got = vars(parse_opt(args))
        assert got.pop("platform") is None
        assert got == vars(jax_parse_opt(args))
    d = parse_opt([])
    assert d.caption_model == "show_attend_tell"
    assert d.max_epochs == 150 and d.grad_clip == 5.0
    assert d.scheduled_sampling_max_prob == 0.25


@pytest.mark.parametrize("argv", [["--rnn_size", "0"],
                                  ["--drop_prob_lm", "1.5"]])
def test_parse_opt_checks(argv):
    with pytest.raises(AssertionError):
        parse_opt(argv)


# -- compat.train against the reference's ------------------------------------

def _record_reference(mp, rec):
    """The reference's init and, each step, (loss, ss_prob), read from
    inside its jitted step."""
    init, loss_fn = jax_gen1.Gen1Model.init, jax_gen1.Gen1Model.loss_fn

    def recorded_init(self, rng, batch):
        rec["init"] = jax.tree.map(np.asarray, init(self, rng, batch))
        return rec["init"]

    def recorded_loss(self, params, batch, dropout_rng=None, ss_prob=0.0):
        loss, aux = loss_fn(self, params, batch, dropout_rng, ss_prob)
        jax.debug.callback(
            lambda v, ss=ss_prob: rec["steps"].append((float(v), ss)), loss)
        return loss, aux

    mp.setattr(jax_gen1.Gen1Model, "init", recorded_init)
    mp.setattr(jax_gen1.Gen1Model, "loss_fn", recorded_loss)


def _record_port(mp, rec, init):
    """The port's command on the reference's init, each step's (loss,
    ss_prob) recorded, its scheduled sampling drawing JAX's draws: the
    reference's key schedule from PRNGKey(seed of the step), one
    split(key, 3) a position."""
    factory = compat_train.gen1_factory
    make_step = compat_train.make_train_step
    loss_fn = gen1.Gen1Model.loss_fn
    keys = {}

    def carried(**kw):
        model = factory(**kw)
        model.param_module.load_state_dict(params_from_jax(
            init, model.param_module))
        rec["model"] = model
        return model

    def keyed_step(fn, tx, **kw):
        step = make_step(fn, tx, **kw)

        def run(state, batch, seed=0):
            keys["key"] = jax.random.PRNGKey(seed)
            return step(state, batch, seed=seed)
        return run

    def recorded_loss(self, batch, generator=None, ss_prob=0.0):
        loss, aux = loss_fn(self, batch, generator, ss_prob)
        rec["steps"].append((loss.item(), ss_prob))
        return loss, aux

    def jax_draws(self, seq, t, prev_lp, ss_prob, generator):
        it = seq[:, t]
        if ss_prob <= 0.0:
            return it
        keys["key"], k1, k2 = jax.random.split(keys["key"], 3)
        if t == 0:
            return it
        use = jax.random.uniform(k1, (seq.shape[0],)) < ss_prob
        sampled = jax.random.categorical(
            k2, jnp.asarray(prev_lp.detach().numpy()), axis=-1)
        return torch.where(torch.from_numpy(np.array(use)),
                           torch.from_numpy(np.array(sampled)).long(), it)

    mp.setattr(compat_train, "gen1_factory", carried)
    mp.setattr(compat_train, "make_train_step", keyed_step)
    mp.setattr(gen1.Gen1Model, "loss_fn", recorded_loss)
    mp.setattr(gen1.Gen1Model, "_scheduled", jax_draws)


def _run_both(factory, name, runs):
    """Each package's `compat.train` over `runs` (argument lists run one
    after another in their own directories). Returns {package: {"dirs",
    "lines" (each run's stdout lines), "steps", ...}}."""
    out = {}
    for pkg in ("reference", "port"):
        root = factory.mktemp(f"{pkg}_{name}")
        rec = {"dirs": [], "lines": [], "steps": []}
        with pytest.MonkeyPatch.context() as mp:
            if pkg == "reference":
                _record_reference(mp, rec)
                main, more = jax_compat_train.main, []
            else:
                _record_port(mp, rec, out["reference"]["init"])
                main, more = compat_train.main, ["--platform", "cpu"]
            for i, extra in enumerate(runs):
                ckpt = root / f"run{i}"
                extra = [a.replace("{first}", str(root / "run0"))
                         for a in extra]
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    assert main(TINY + extra + more + [
                        "--checkpoint_path", str(ckpt), "--id", name]) == 0
                rec["dirs"].append(ckpt)
                rec["lines"].append(buf.getvalue().splitlines())
        out[pkg] = rec
    return out


@pytest.fixture(scope="module")
def end_to_end(tmp_path_factory):
    return _run_both(tmp_path_factory, "t", END_TO_END)


@pytest.fixture(scope="module")
def ss_resume(tmp_path_factory):
    return _run_both(tmp_path_factory, "ss", SS_RESUME)


def _json(path):
    with open(path) as f:
        return json.load(f)


def _same_files(run, name):
    """infos_{id}.json and meta.json of every run equal the reference's
    (scores within 1e-9 relative)."""
    ref, port = run["reference"], run["port"]
    for r, p in zip(ref["dirs"], port["dirs"]):
        want = _json(r / f"infos_{name}.json")
        got = _json(p / f"infos_{name}.json")
        assert got.pop("best_val_score") == pytest.approx(
            want.pop("best_val_score"), rel=1e-9)
        assert got == want
        want = _json(r / "checkpoints" / "meta.json")
        got = _json(p / "checkpoints" / "meta.json")
        assert [c["step"] for c in got["checkpoints"]] == \
            [c["step"] for c in want["checkpoints"]]
        assert got["best"]["step"] == want["best"]["step"]
        assert got["best"]["value"] == pytest.approx(want["best"]["value"],
                                                     rel=1e-9)


def test_compat_train_end_to_end(end_to_end):
    """show_tell, 6 iterations: the logs, the result line, the infos and
    the checkpoints of the reference's command."""
    _same_files(end_to_end, "t")
    port = end_to_end["port"]
    assert _json(port["dirs"][0] / "infos_t.json")["iter"] == 6
    meta = _json(port["dirs"][0] / "checkpoints" / "meta.json")
    assert [c["step"] for c in meta["checkpoints"]] == [3, 6]
    lines = port["lines"][0]
    assert [line.split(",")[0] for line in lines[:3]] == [
        "iter 2 (epoch 0)", "iter 4 (epoch 0)", "iter 6 (epoch 1)"]
    got = json.loads(lines[-1])
    want = json.loads(end_to_end["reference"]["lines"][0][-1])
    assert got["iter"] == want["iter"] == 6
    assert got["cider"] == pytest.approx(want["cider"], rel=1e-9)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)


def test_compat_train_scheduled_sampling_and_resume(ss_resume):
    """Scheduled sampling from epoch 0, raised every epoch (2 iterations
    an epoch), in both packages alike; the second run resumes from the
    first's directory at its iteration."""
    _same_files(ss_resume, "ss")
    ref, port = ss_resume["reference"], ss_resume["port"]
    probs = [ss for _, ss in port["steps"]]
    assert probs == [ss for _, ss in ref["steps"]]
    assert probs == [0.0, 0.0, 0.05, 0.05, 0.1, 0.1]
    assert [_json(d / "infos_ss.json")["iter"] for d in port["dirs"]] == \
        [3, 6]
    assert [line.split(",")[0] for line in port["lines"][1][:3]] == [
        "iter 4 (epoch 1)", "iter 5 (epoch 2)", "iter 6 (epoch 2)"]


@pytest.mark.parametrize("scenario", ["end_to_end", "ss_resume"])
def test_compat_train_steps_match_reference(scenario, request):
    """Each step's loss within 1e-5 and its ss_prob equal; the logged
    lines equal but for their times."""
    run = request.getfixturevalue(scenario)
    ref, port = run["reference"], run["port"]
    assert len(port["steps"]) == len(ref["steps"]) == 6
    for (g, gss), (w, wss) in zip(port["steps"], ref["steps"]):
        np.testing.assert_allclose(g, w, rtol=1e-5)
        assert gss == wss

    def logged(lines):
        return [line.rsplit(",", 1)[0] for line in lines
                if line.startswith("iter ")]
    for g, w in zip(port["lines"], ref["lines"]):
        assert logged(g) and logged(g) == logged(w)


@pytest.mark.parametrize("scenario", ["end_to_end", "ss_resume"])
def test_compat_train_params_match_reference(scenario, request):
    """The last checkpoint's params within rtol 1e-5 / atol 1e-5 of the
    reference's. Adam divides each gradient element by its own root mean
    square, so an element whose gradient is small carries the rounding
    of the two packages' sums up to the rate's scale (2e-3): atol 1e-5
    is half a percent of one update (one element of 512 in the
    show_attend_tell run lies 2.3e-6 off). The attention's score bias is
    held by its effect, as in tests/test_torch_tgnc_gen1_cli.py: its
    gradient is rounding noise alone, which the softmax cancels."""
    run = request.getfixturevalue(scenario)
    ref, port = run["reference"], run["port"]
    want = serialization.msgpack_restore(
        (ref["dirs"][-1] / "checkpoints" / "ckpt_6.msgpack").read_bytes())
    got = torch.load(port["dirs"][-1] / "checkpoints" / "ckpt_6.pt",
                     weights_only=True)
    model = port["model"]
    flat = params_from_jax(want["params"], model.param_module)
    assert set(flat) == set(got["params"])
    noise = [k for k in flat if k.endswith("alpha_net.bias")]
    assert len(noise) == (scenario == "ss_resume")
    for k, w in flat.items():
        if k not in noise:
            np.testing.assert_allclose(got["params"][k].numpy(), w.numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
    assert got["opt_state"]["count"] == 6
    if noise:
        model.param_module.load_state_dict(got["params"])
        ds = SyntheticNewsDataset(size=8, vocab_size=50, caption_len=16,
                                  article_len=6, n_patches=8, image_dim=12,
                                  article_dim=8)
        batch = to_device(next(ds.batches(4)), "cpu")
        with torch.no_grad():
            loss, _ = model.loss_fn(batch)
            for k in noise:
                model.param_module.get_parameter(k).zero_()
            again, _ = model.loss_fn(batch)
        np.testing.assert_allclose(again.item(), loss.item(), rtol=1e-6)


def _h5_inputs(where: Path):
    """A Gen-1 HDF5 (7 images of 20 x 20, 2-6 captions of 6 words each)
    and its split JSON (train 5, val 2; vocab 40)."""
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(6)
    per = [5, 2, 6, 3, 5, 4, 5]
    labels = rng.integers(1, 41, size=(sum(per), 6)).astype(np.uint32)
    labels[::3, 4:] = 0
    start = np.cumsum([0] + per[:-1]) + 1
    with h5py.File(where / "data.h5", "w") as f:
        f["images"] = rng.integers(0, 256, size=(7, 20, 20, 3),
                                   dtype=np.uint8)
        f["labels"] = labels
        f["label_start_ix"] = start
        f["label_end_ix"] = start + np.array(per) - 1
    splits = ["train", "val", "train", "train", "val", "train", "train"]
    (where / "data.json").write_text(json.dumps({
        "images": [{"split": s, "id": i, "file_path": f"{i}.jpg"}
                   for i, s in enumerate(splits)],
        "ix_to_word": {str(i): f"w{i}" for i in range(1, 41)}}))
    return str(where / "data.h5"), str(where / "data.json")


@pytest.fixture(scope="module")
def h5_run(tmp_path_factory):
    h5, js = _h5_inputs(tmp_path_factory.mktemp("h5"))
    return _run_both(tmp_path_factory, "h5", [[
        "--caption_model", "show_tell", "--input_image_h5", h5,
        "--input_json", js, "--seq_per_img", "2", "--tpu_max_iters", "4",
        "--save_checkpoint_every", "2", "--losses_log_every", "1"]])


def test_compat_train_hdf5_inputs_match_reference(h5_run):
    """`--input_image_h5` / `--input_json` (once raising for want of the
    HDF5 loader) train through `H5DataLoader` as the reference's command
    does: an iteration an epoch (5 train images // batches of 4), each
    step's loss within 1e-5, the logs (times aside), result line, infos
    and checkpoints' metadata equal, the vocabulary the split JSON's."""
    _same_files(h5_run, "h5")
    ref, port = h5_run["reference"], h5_run["port"]
    assert len(port["steps"]) == len(ref["steps"]) == 4
    for (g, _), (w, _) in zip(port["steps"], ref["steps"]):
        np.testing.assert_allclose(g, w, rtol=1e-5)
    assert [line.split(",")[0] for line in port["lines"][0][:4]] == [
        f"iter {i + 1} (epoch {i})" for i in range(4)]
    assert [line.rsplit(",", 1)[0] for line in port["lines"][0][:4]] == \
        [line.rsplit(",", 1)[0] for line in ref["lines"][0][:4]]
    got, want = (json.loads(r["lines"][0][-1]) for r in (port, ref))
    assert got["iter"] == want["iter"] == 4
    assert got["cider"] == pytest.approx(want["cider"], rel=1e-9)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert _json(port["dirs"][0] / "infos_h5.json")["vocab_size"] == 40


# -- compat.test against the reference's -------------------------------------

NO_DROPOUT = ("    dropout: 0.0\n    weight_dropout: 0.0\n"
              "    relu_dropout: 0.0\n    input_dropout: 0.0\n"
              "    attention_dropout: 0.0\n")


def _tiny_config(where: Path) -> str:
    """configs/tiny_test.yaml with every dropout 0, in `where` (its
    serialization directory is `where/serialization`)."""
    text = (REPO / "configs" / "tiny_test.yaml").read_text()
    anchor = "    max_positions: 64\n"
    assert anchor in text
    where.mkdir(parents=True, exist_ok=True)
    path = where / "cfg.yaml"
    path.write_text(text.replace(anchor, anchor + NO_DROPOUT))
    return str(path)


def _reference_tiny_init(path: str):
    cfg = jax_config.load_config(path)
    sample = next(jax_config.build_dataset(cfg, "train").batches(4))
    return jax.tree.map(np.asarray, jax_config.build_model(cfg).init(
        jax.random.PRNGKey(0), sample))


def test_compat_gen2_test_command(tmp_path, capsys):
    """From the reference's init, then from a train command's step-8
    checkpoint: the lines and scores of the reference's command."""
    argv = ["--batch_size", "4", "--max_batches", "2", "--max_length", "8",
            "--log_every", "1"]
    train = ["--platform", "cpu", "-o",
             json.dumps({"trainer": {"num_epochs": 1}})]
    ref_cfg = _tiny_config(tmp_path / "reference")
    want = []
    for more in ([], ["--checkpoint", "8"]):
        assert jax_compat_test.main(["--config", ref_cfg] + argv + more) == 0
        want.append(capsys.readouterr().out.strip().splitlines())
        if not more:
            assert jax_cli.main(["train", ref_cfg] + train) == 0
            capsys.readouterr()

    cfg = _tiny_config(tmp_path / "port")
    variables = _reference_tiny_init(cfg)

    def carried():
        model = config.build_model(config.load_config(cfg), "cpu")
        model.param_module.load_state_dict(params_from_jax(
            variables, model.param_module))
        return model

    def evaluated():
        model = carried()
        model.param_module.eval()
        return model

    argv = ["--config", cfg, "--platform", "cpu"] + argv
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "evaluation_model",
                   lambda c, device: evaluated())
        assert compat_test.main(argv) == 0
    captured = capsys.readouterr()
    assert "random init" in captured.err
    got = [captured.out.strip().splitlines()]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "training_model",
                   lambda c, device, seed: carried())
        assert cli.main(["train", cfg] + train) == 0
    capsys.readouterr()
    assert compat_test.main(argv + ["--checkpoint", "8"]) == 0
    captured = capsys.readouterr()
    assert "random init" not in captured.err
    got.append(captured.out.strip().splitlines())
    for g, w in zip(got, want):
        assert g[0].startswith("batch 1: BLEU-4")
        assert g[:-1] == w[:-1]
        metrics, ref = json.loads(g[-1]), json.loads(w[-1])
        assert {"bleu-1", "bleu-4", "cider", "n_samples"} <= metrics.keys()
        assert metrics["n_samples"] == ref["n_samples"] == 8
        assert metrics == pytest.approx(ref, rel=1e-9)
    assert json.loads(got[0][-1]) != json.loads(got[1][-1])


def _gen1_pair(model_type):
    kw = dict(model_type=model_type, vocab_size=40, input_encoding_size=16,
              rnn_size=16, att_hid_size=16, fc_feat_size=8, att_feat_size=8,
              drop_prob=0.0)
    if model_type == "show_attend_tell":
        kw.update(sentence_embed_method="fc", sentence_embed_size=6,
                  sentence_length=6)
    ds = SyntheticNewsDataset(size=8, vocab_size=40, caption_len=10,
                              article_len=6, n_patches=4, image_dim=8,
                              article_dim=6)
    jmodel = jax_gen1.gen1_factory(**kw)
    params = jmodel.init(jax.random.PRNGKey(0), next(ds.batches(4)))
    model = gen1.gen1_factory(device="cpu", **kw)
    model.param_module.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, params), model.param_module))
    return ds, jmodel, params, model


def test_eval_split_equals_the_references():
    ds, jmodel, params, model = _gen1_pair("show_tell")
    want = jax_eval.eval_split(jmodel, params, ds.batches(4, shuffle=False),
                               max_len=6)
    loss, preds, stats = eval_utils.eval_split(
        model, ds.batches(4, shuffle=False), max_len=6)
    np.testing.assert_allclose(loss, want[0], rtol=1e-5)
    assert len(preds) == 8 and preds == want[1]
    assert stats == pytest.approx(want[2], rel=1e-9)
    assert 0.0 <= stats["Bleu_4"] <= 1.0 and "CIDEr" in stats


def test_eval_split_visual_news_variant():
    ds, jmodel, params, model = _gen1_pair("show_attend_tell")

    def with_infos(batches):
        for b in batches:
            b = dict(b)
            b["infos"] = [{"id": f"im{i}", "file_path": f"p/{i}.jpg"}
                          for i in range(len(b["caption_ids"]))]
            yield b

    want = jax_eval.eval_split_visual_news(
        jmodel, params, with_infos(ds.batches(4, shuffle=False)), max_len=6,
        return_attention=True)
    loss, preds, stats = eval_utils.eval_split_visual_news(
        model, with_infos(ds.batches(4, shuffle=False)), max_len=6,
        return_attention=True)
    np.testing.assert_allclose(loss, want[0], rtol=1e-5)
    assert len(preds) == 8
    assert preds[0]["image_id"] == "im0"
    assert preds[0]["image_path"] == "p/0.jpg"
    for got, ref in zip(preds, want[1]):
        assert got["caption"] == ref["caption"]
        np.testing.assert_allclose(got["vis_att"], ref["vis_att"], atol=1e-5)
        np.testing.assert_allclose(got["sen_att"], ref["sen_att"], atol=1e-5)
    assert stats == pytest.approx(want[2], rel=1e-9)
