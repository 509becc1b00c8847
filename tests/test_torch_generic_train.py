"""The generic flash slice end to end on the CPU against the reference: a
captioner of configs/tiny_test.yaml's widths (embed 16, 4 heads of 4,
ffn 32, 2 layers), whose flash attentions only the generic flash kernels
take on the card, trained through flash attention.

The reference builds the model with use_flash_train and flash_interpret,
so its context attentions run the Pallas flash kernel in interpret mode;
its init (PRNGKey(0)) is carried into the port by `params_from_jax`, and
both take 5 fp32 train steps at p = 0 through their own train step on
the same batches: losses within 1e-5 relative (the tolerance of
test_torch_training_loop.py's fp32 records). The reference's steps run
once a module, jitted.
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from news_image_caption_tpu import config as jax_config  # noqa: E402
from news_image_caption_tpu.training import \
    train_step as jax_train_step  # noqa: E402
from news_image_caption_tpu_torch.config import (  # noqa: E402
    build_model, build_optimizer, load_config, merge_overrides)
from news_image_caption_tpu_torch.data.synthetic import LOSS_KEYS  # noqa: E402
from news_image_caption_tpu_torch.models.from_jax import \
    params_from_jax  # noqa: E402
from news_image_caption_tpu_torch.ops import attention  # noqa: E402
from news_image_caption_tpu_torch.ops.flash_attention import \
    route_flash  # noqa: E402
from news_image_caption_tpu_torch.training.train_step import (  # noqa: E402
    create_train_state, make_train_step)

TINY = str(Path(__file__).resolve().parent.parent / "configs" /
           "tiny_test.yaml")
NO_DROPOUT = {"model": {"decoder": dict(
    dropout=0.0, weight_dropout=0.0, relu_dropout=0.0, input_dropout=0.0,
    attention_dropout=0.0)}}
FLASH = {"model": {"decoder": {"use_flash_train": True,
                               "flash_interpret": True}}}
STEPS = 5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference():
    """The reference's 5 fp32 flash train steps: (overrides, its init,
    the batches, its losses)."""
    overrides = json.dumps(merge_overrides(NO_DROPOUT, FLASH))
    jcfg = jax_config.load_config(TINY, overrides)
    jmodel = jax_config.build_model(jcfg)
    assert jmodel.decoder.use_flash_train and jmodel.decoder.flash_interpret
    ds = jax_config.build_dataset(jcfg, "train")
    batches = [b for _, b in zip(range(STEPS), ds.batches(4, seed=0))]
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), batches[0])
    jtx = jax_config.build_optimizer(jcfg)
    jstate = jax_train_step.create_train_state(params, jtx)
    jstep = jax_train_step.make_train_step(jmodel.loss_fn, jtx, donate=False)
    losses = []
    for b in batches:
        jstate, m = jstep(jstate, b, jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
    return overrides, params, batches, losses


def test_flash_train_steps_match_reference(reference, monkeypatch):
    """Heads of 4 (the generic route on the card, in fp32 and bf16): 5
    fp32 steps of the port's flash path, every context attention through
    `flash_cross_attention` (2 layers x 2 contexts a step), losses within
    1e-5 relative of the reference's Pallas flash steps."""
    overrides, params, batches, want = reference
    cfg = load_config(TINY, overrides)
    model = build_model(cfg, "cpu", torch.float32)
    model.decoder.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, params), model.decoder))
    flash = [m for m in model.param_module.modules()
             if getattr(m, "use_flash", False)]
    assert {m.head_dim for m in flash} == {4}
    assert {route_flash(d, 4) for d in (torch.float32,
                                         torch.bfloat16)} == {"generic"}
    calls = []
    real = attention.flash_cross_attention
    monkeypatch.setattr(attention, "flash_cross_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    tx = build_optimizer(cfg)
    state = create_train_state(model.param_module, tx)
    step = make_train_step(model.loss_fn, tx, compute_dtype=torch.float32)
    got = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(b[k]) for k in LOSS_KEYS})
        got.append(m["loss"].item())
        assert m["skipped"] == 0
    assert len(calls) == 2 * 2 * STEPS
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
