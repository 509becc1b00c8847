"""The port's train step against the JAX reference, on the CPU.

The small model of tests/test_torch_model.py (V=120, cutoff (40, 80,
120), D=32, H=4, FFN=64, kernels (3, 5)) is initialized in JAX and
carried into the port by `params_from_jax`; the batch comes from the
port's synthetic dataset. At fp32 the two packages must agree on the
deterministic loss (rtol 1e-5) and on every parameter gradient (rtol
5e-4, atol 5e-5, the tolerance of tests/test_pallas_flash.py's decoder
test), with the flash route on (JAX's Pallas kernel in interpret mode)
and off; on a 5-step O2 BertAdam trajectory (losses and fp32 master
params within 1e-5 relative); on `loss_sum` where targets hit the
padding index inside a tail band; and on skipping a non-finite batch.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from news_image_caption_tpu.data.dataset import \
    SyntheticNewsDataset as JaxSyntheticNewsDataset  # noqa: E402
from news_image_caption_tpu.models.captioner import \
    TransformerFlattened as JaxTransformerFlattened  # noqa: E402
from news_image_caption_tpu.ops.adaptive import \
    AdaptiveSoftmax as JaxAdaptiveSoftmax  # noqa: E402
from news_image_caption_tpu.ops.attention import \
    MultiHeadAttention as JaxMultiHeadAttention  # noqa: E402
from news_image_caption_tpu.training import optim as jax_optim  # noqa: E402
from news_image_caption_tpu.training import \
    train_step as jax_train_step  # noqa: E402
from news_image_caption_tpu_torch.data.synthetic import (  # noqa: E402
    SyntheticNewsDataset, to_device)
from news_image_caption_tpu_torch.models.captioner import \
    TransformerFlattened  # noqa: E402
from news_image_caption_tpu_torch.models.from_jax import (  # noqa: E402
    params_from_jax, torch_key)
from news_image_caption_tpu_torch.ops.adaptive import \
    AdaptiveSoftmax  # noqa: E402
from news_image_caption_tpu_torch.ops.attention import \
    MultiHeadAttention  # noqa: E402
from news_image_caption_tpu_torch.ops.dropout import dropout  # noqa: E402
from news_image_caption_tpu_torch.ops.flash_attention import \
    flash_attention_fwd  # noqa: E402
from news_image_caption_tpu_torch.training import builder  # noqa: E402
from news_image_caption_tpu_torch.training.optim import (  # noqa: E402
    make_bert_adam, warmup_linear_schedule)
from news_image_caption_tpu_torch.training.train_step import (  # noqa: E402
    create_o2_train_state, make_eval_step, make_train_step)
from news_image_caption_tpu_torch.training.trainer import (  # noqa: E402
    Trainer, TrainerConfig)

V, D, H = 120, 32, 4
SMALL = dict(vocab_size=V, cutoff=(40, 80, V), embed_dim=D, ffn_dim=64,
             num_heads=H, num_layers=2, kernel_sizes=(3, 5), image_dim=48,
             article_dim=32, max_positions=64)
NO_DROPOUT = dict(dropout=0.0, weight_dropout=0.0, relu_dropout=0.0,
                  input_dropout=0.0, attention_dropout=0.0)
DATA = dict(vocab_size=V, caption_len=12, article_len=9, n_patches=5,
            image_dim=48, article_dim=32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny models: one intra-op thread, so that the suite's parallel
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(B=4, seed=0):
    ds = SyntheticNewsDataset(size=B, seed=seed, **DATA)
    return next(ds.batches(B, shuffle=False))


def _jax_pair(flash: bool, **extra):
    """(JAX model, its params, the port's model with them) at fp32."""
    jbatch = {k: jnp.asarray(v) for k, v in _batch().items()}
    flags = dict(use_flash_train=True, flash_interpret=True) if flash else {}
    jmodel = JaxTransformerFlattened(**SMALL, **flags, **extra)
    params = jmodel.init(jax.random.PRNGKey(0), jbatch)
    model = TransformerFlattened(device="cpu", dtype=torch.float32,
                                 use_flash_train=flash, **SMALL, **extra)
    model.decoder.load_state_dict(
        params_from_jax(jax.tree.map(np.asarray, params), model.decoder))
    return jmodel, params, model


def _flat(tree):
    return {torch_key(k): np.asarray(v)
            for k, v in flatten_dict(tree["params"], sep="/").items()}


@pytest.mark.parametrize("flash", [False, True])
def test_loss_and_gradients_match(flash):
    jmodel, params, model = _jax_pair(flash)
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, b, None), has_aux=True))(params, jbatch)
    loss, aux = model.loss_fn(to_device(batch, "cpu"))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(aux["loss_sum"].item(),
                               float(jaux["loss_sum"]), rtol=1e-5)
    assert aux["sample_size"].item() == int(jaux["sample_size"])
    want = _flat(jgrads)
    got = {k: p.grad for k, p in model.decoder.named_parameters()}
    assert set(got) == set(want)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k], rtol=5e-4, atol=5e-5,
                                   err_msg=k)


def test_attend_flash_route_matches_reference():
    """MultiHeadAttention.attend with use_flash (the port's plain flash
    version) against JAX's flash route (Pallas, interpret) and against
    the port's own plain route, deterministic, with padded keys."""
    rng = np.random.RandomState(2)
    query = rng.randn(2, 6, D).astype(np.float32)
    ctx = rng.randn(2, 11, 48).astype(np.float32)
    mask = np.zeros((2, 11), bool)
    mask[0, -3:] = True
    jattn = JaxMultiHeadAttention(embed_dim=D, num_heads=H, kdim=48, vdim=48,
                                  use_flash=True, flash_interpret=True)
    params = jattn.init(jax.random.PRNGKey(0), jnp.asarray(query),
                        jnp.asarray(ctx), jnp.asarray(ctx),
                        key_padding_mask=jnp.asarray(mask))
    want, _ = jattn.apply(params, jnp.asarray(query), jnp.asarray(ctx),
                          jnp.asarray(ctx), key_padding_mask=jnp.asarray(mask))
    sd = params_from_jax(jax.tree.map(np.asarray, params),
                         MultiHeadAttention(D, H, 48, device="meta",
                                            dtype=torch.float32))
    outs = []
    for use_flash in (True, False):
        attn = MultiHeadAttention(D, H, 48, device="cpu", dtype=torch.float32,
                                  use_flash=use_flash)
        attn.load_state_dict(sd)
        c = torch.from_numpy(ctx)
        kv = attn.precompute_kv(c, c, torch.from_numpy(mask))
        with torch.no_grad():
            outs.append(attn.attend(torch.from_numpy(query), kv).numpy())
    np.testing.assert_allclose(outs[0], np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-5)


def test_attend_flash_route_draws_its_seed_from_the_generator():
    attn = MultiHeadAttention(D, H, D, device="cpu", dtype=torch.float32,
                              generator=torch.Generator().manual_seed(0),
                              dropout=0.5, use_flash=True)
    x = torch.randn(2, 5, D, generator=torch.Generator().manual_seed(1))
    kv = attn.precompute_kv(x, x)
    with torch.no_grad():
        det = attn.attend(x, kv)
        a = attn.attend(x, kv, torch.Generator().manual_seed(3))
        b = attn.attend(x, kv, torch.Generator().manual_seed(3))
        c = attn.attend(x, kv, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.allclose(a, c)
    assert not torch.allclose(a, det)


def test_dropout_law():
    x = torch.ones(200, 100)
    g = torch.Generator().manual_seed(0)
    y = dropout(x, 0.25, g)
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.75) < 0.02
    assert torch.allclose(y[y != 0], torch.tensor(1 / 0.75))
    assert dropout(x, 0.25, None) is x and dropout(x, 0.0, g) is x


def test_training_forward_uses_every_dropout():
    """With a generator the loss moves off the deterministic value, and
    the same generator seed gives the same loss (flash on, as the
    flagship trains)."""
    model = TransformerFlattened(device="cpu", dtype=torch.float32,
                                 generator=torch.Generator().manual_seed(0),
                                 use_flash_train=True, **SMALL)
    batch = to_device(_batch(), "cpu")
    with torch.no_grad():
        det, _ = model.loss_fn(batch)
        a, _ = model.loss_fn(batch, torch.Generator().manual_seed(5))
        b, _ = model.loss_fn(batch, torch.Generator().manual_seed(5))
    assert a.item() == b.item() and abs(a.item() - det.item()) > 1e-4


def test_loss_sum_padding_quirk_in_tail_bands():
    """Targets equal to padding_idx (1), and tail targets whose in-band
    index is 1 (ids 41 and 81), are left out as the reference leaves
    them out."""
    rng = np.random.RandomState(4)
    N, cutoff = 12, (40, 80, V)
    x = rng.randn(N, D).astype(np.float32)
    target = np.array([1, 41, 81, 3, 45, 100, 41, 1, 0, 79, 80, 119],
                      np.int32)
    tables = [(rng.randn(hi - lo, D).astype(np.float32) * 0.3,
               np.zeros((D, D), np.float32))
              for lo, hi in zip((0,) + cutoff[:-1], cutoff)]
    jsm = JaxAdaptiveSoftmax(vocab_size=V, input_dim=D, cutoff=cutoff)
    jtables = [(jnp.asarray(t), jnp.asarray(p)) for t, p in tables]

    def fn(m, x, t):
        return m.loss_sum(x, t, padding_idx=1, embed_tables=jtables)

    params = jsm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                      jnp.asarray(target), method=fn)
    want, want_n = jsm.apply(params, jnp.asarray(x), jnp.asarray(target),
                             method=fn)
    sm = AdaptiveSoftmax(D, cutoff, device="cpu", dtype=torch.float32)
    flat = flatten_dict(params["params"], sep="/")
    sm.class_proj.data = torch.from_numpy(np.array(flat["class_proj"]))
    for i in (1, 2):
        getattr(sm, f"tail_proj_{i}").data = torch.from_numpy(
            np.array(flat[f"tail_proj_{i}"]))
    ttables = [(torch.from_numpy(t), torch.from_numpy(p)) for t, p in tables]
    got, n = sm.loss_sum(torch.from_numpy(x), torch.from_numpy(target).long(),
                         1, ttables)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    assert n.item() == int(want_n) == 10
    # The quirk itself: a tail target at in-band index 1 adds its head
    # (class-slot) term only.
    only = torch.from_numpy(target).long().clone()
    only[:] = 1
    only[1] = 41
    head_only, _ = sm.loss_sum(torch.from_numpy(x), only, 1, ttables)
    logits = sm.head_logits(torch.from_numpy(x[1:2]), ttables)
    np.testing.assert_allclose(
        head_only.item(),
        (torch.logsumexp(logits, -1) - logits[:, 40]).item(), rtol=1e-5)


def _jax_trajectory(jmodel, params, batches, lr, t_total):
    tx = jax_optim.make_bert_adam(lr, t_total)
    state = jax_train_step.create_o2_train_state(params, tx,
                                                 compute_dtype=jnp.float32)
    step = jax_train_step.make_train_step(jmodel.loss_fn, tx, donate=False,
                                          compute_dtype=jnp.float32,
                                          o2_master=True)
    out = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                        jax.random.PRNGKey(0))
        out.append(m)
    return state, out


def test_o2_bert_adam_trajectory_matches():
    """5 steps, dropout 0, t_total=10 (lr(0) = 0, then 0.9 lr, 0.8 lr,
    ...): losses and final fp32 master params within 1e-5 relative (atol
    1e-7 for entries near zero)."""
    lr, t_total = 1e-3, 10
    jmodel, params, model = _jax_pair(True, **NO_DROPOUT)
    batches = [_batch(seed=s) for s in range(5)]
    jstate, jmetrics = _jax_trajectory(jmodel, params, batches, lr, t_total)
    tx = make_bert_adam(lr, t_total)
    state = create_o2_train_state(model.decoder, tx)
    step = make_train_step(model.loss_fn, tx, compute_dtype=torch.float32)
    for b, jm in zip(batches, jmetrics):
        state, m = step(state, to_device(b, "cpu"))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-4)
        assert m["skipped"] == int(jm["skipped"]) == 0
    assert state.step == int(jstate.step) == 5
    assert state.opt_state["inner"].count == 5
    want = _flat({"params": jstate.opt_state["master"]["params"]})
    master = state.opt_state["master"]
    moved = 0
    for k, w in want.items():
        np.testing.assert_allclose(master[k].numpy(), w, rtol=1e-5,
                                   atol=1e-7, err_msg=k)
        moved += int(not np.array_equal(w, _flat(params)[k]))
        np.testing.assert_array_equal(state.params[k].detach().numpy(),
                                      master[k].numpy())
    assert moved == len(want)


def test_warmup_linear_schedule_matches():
    sched = warmup_linear_schedule(1e-4, 100, 0.05)
    # Jitted, as the reference's train step runs it (XLA's float32
    # reciprocals decide n = 5, the warmup's end).
    jsched = jax.jit(jax_optim.warmup_linear_schedule(1e-4, 100, 0.05))
    for n in (0, 1, 4, 5, 6, 50, 99, 100, 150):
        np.testing.assert_allclose(sched(n), float(jsched(jnp.int32(n))),
                                   rtol=1e-6,
                                   atol=1e-12)
    assert sched(0) == 0.0


def test_nonfinite_batch_is_skipped():
    """A NaN image makes the loss NaN: params and optimizer state stay
    as they were, the step counter advances, skipped = 1, as in JAX."""
    jmodel, params, model = _jax_pair(False, **NO_DROPOUT)
    good, bad = _batch(seed=0), _batch(seed=1)
    bad["image"][0, 0, 0] = np.nan
    _, jmetrics = _jax_trajectory(jmodel, params, [good, bad], 1e-3, 10)
    assert [int(m["skipped"]) for m in jmetrics] == [0, 1]
    tx = make_bert_adam(1e-3, 10)
    state = create_o2_train_state(model.decoder, tx)
    step = make_train_step(model.loss_fn, tx, compute_dtype=torch.float32)
    state, m = step(state, to_device(good, "cpu"))
    assert m["skipped"] == 0
    inner = state.opt_state["inner"]
    before = {"params": {k: v.detach().clone()
                         for k, v in state.params.items()},
              "master": {k: v.clone()
                         for k, v in state.opt_state["master"].items()},
              "mu": [t.clone() for t in inner.mu],
              "nu": [t.clone() for t in inner.nu], "count": inner.count}
    state, m = step(state, to_device(bad, "cpu"))
    assert m["skipped"] == 1 and not torch.isfinite(m["loss"])
    assert state.step == 2 and inner.count == before["count"] == 1
    for k, v in state.params.items():
        assert torch.equal(v.detach(), before["params"][k]), k
    for k, v in state.opt_state["master"].items():
        assert torch.equal(v, before["master"][k]), k
    for a, b in zip(inner.mu + inner.nu, before["mu"] + before["nu"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_batches_are_the_references(seed):
    kw = dict(size=10, vocab_size=50265, caption_len=16, article_len=20,
              n_patches=7, image_dim=24, article_dim=12, seed=seed)
    want = list(JaxSyntheticNewsDataset(**kw).batches(4, seed=5))
    got = list(SyntheticNewsDataset(**kw).batches(4, seed=5))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == {"caption_ids", "image", "image_mask", "article",
                          "article_mask"}
        for k, v in g.items():
            assert v.dtype == w[k].dtype and v.shape == w[k].shape, k
            np.testing.assert_array_equal(v, w[k], err_msg=k)


def test_trainer_loop_logs_and_validates(tmp_path):
    model = TransformerFlattened(device="cpu", dtype=torch.float32,
                                 generator=torch.Generator().manual_seed(0),
                                 **SMALL)
    tx = make_bert_adam(1e-3, 20)
    state = create_o2_train_state(model.decoder, tx)
    ds = SyntheticNewsDataset(size=12, **DATA)
    trainer = Trainer(model.loss_fn, tx, TrainerConfig(
        num_epochs=2, log_every=2, mixed_precision="fp32",
        serialization_dir=str(tmp_path)))

    def batches(epoch):
        return (to_device(b, "cpu") for b in ds.batches(4, seed=epoch))

    state = trainer.train(state, batches, batches)
    assert state.step == 6
    train = [r for r in trainer.history if r["split"] == "train"]
    val = [r for r in trainer.history if r["split"] == "val"]
    assert [r["step"] for r in train] == [2, 5] and len(val) == 2
    assert all(np.isfinite(r["loss"]) and r["skipped"] == 0 for r in train)
    assert val[1]["n_batches"] == 3 and val[1]["loss"] < val[0]["loss"]
    with pytest.raises(ValueError, match="mixed_precision"):
        Trainer(model.loss_fn, tx, TrainerConfig(
            mixed_precision="fp16", serialization_dir=str(tmp_path)))


def test_flagship_trainer_builder_runs_bf16_o2(monkeypatch):
    """The builder at a small width on the CPU: bf16 stored params, fp32
    master, flash route on; two steps run and the eval step is
    deterministic."""
    monkeypatch.setattr(builder, "FLAGSHIP", SMALL)
    model, state, train_step, eval_step = builder.flagship_trainer_builder(
        "cpu", seed=0, t_total=10)
    assert all(p.dtype == torch.bfloat16 for p in state.params.values())
    assert all(m.dtype == torch.float32
               for m in state.opt_state["master"].values())
    assert model.decoder.layers[0].article_attn.use_flash
    batch = to_device(_batch(), "cpu")
    before = flash_attention_fwd.launches
    for _ in range(2):
        state, m = train_step(state, batch, 0)
        assert m["skipped"] == 0 and torch.isfinite(m["loss"])
    assert flash_attention_fwd.launches == before     # CPU: plain version
    a, b = eval_step(batch), eval_step(batch)
    assert a["loss"].item() == b["loss"].item()
    assert make_eval_step(model.loss_fn)(batch)["loss"].dtype == torch.float32
