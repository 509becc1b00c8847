"""The port's copies of the reference's plain-Python training utilities
against the reference, on the CPU: `utils/tensorboard.py` (the same
event bytes at a fixed wall time, read back alike by both readers),
`training/preemption.py` (the same latch and restore) and
`utils/logging.py` (the same handlers and lines)."""

import logging
import os
import signal

import pytest

pytest.importorskip("torch")

from news_image_caption_tpu.training import \
    preemption as jax_preemption  # noqa: E402
from news_image_caption_tpu.utils import logging as jax_logging  # noqa: E402
from news_image_caption_tpu.utils import \
    tensorboard as jax_tensorboard  # noqa: E402
from news_image_caption_tpu_torch.training import preemption  # noqa: E402
from news_image_caption_tpu_torch.utils import logging as port_logging  # noqa: E402
from news_image_caption_tpu_torch.utils import tensorboard  # noqa: E402

SCALARS = [("train/loss", 2.5), ("train/input_wait", 0.0625),
           ("validation/loss", -1.0e-3), ("train/tokens_per_sec", 123456.75)]


def _write(mod, logdir, monkeypatch):
    monkeypatch.setattr(mod.time, "time", lambda: 1_700_000_000.5)
    with mod.SummaryWriter(str(logdir)) as w:
        w.add_scalar("train/loss", 3.25, step=7)
        w.add_scalars(SCALARS, step=512)
        w.add_scalar("neg/step", 1.0, step=-3, wall_time=12.0)
    return w.path


def test_summary_writer_bytes_equal(tmp_path, monkeypatch):
    got = _write(tensorboard, tmp_path / "port", monkeypatch)
    want = _write(jax_tensorboard, tmp_path / "ref", monkeypatch)
    assert os.path.basename(got).split(".")[:4] == \
        os.path.basename(want).split(".")[:4]
    with open(got, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()
    for path in (got, want):
        a = tensorboard.read_events(path)
        b = jax_tensorboard.read_events(path)
        assert [tuple(e) for e in a] == [tuple(e) for e in b]
        # Both readers return a negative step as its unsigned varint.
        assert [(e.step, e.tag) for e in a] == (
            [(7, "train/loss")] + [(512, t) for t, _ in SCALARS]
            + [(2 ** 64 - 3, "neg/step")])


@pytest.mark.parametrize("data", [b"", b"a", b"123456789", bytes(range(256))])
def test_crc32c_equal(data):
    assert tensorboard.crc32c(data) == jax_tensorboard.crc32c(data)
    assert tensorboard.masked_crc32c(data) == \
        jax_tensorboard.masked_crc32c(data)


def test_read_events_rejects_a_corrupt_frame_alike(tmp_path, monkeypatch):
    path = _write(tensorboard, tmp_path, monkeypatch)
    data = bytearray(open(path, "rb").read())
    data[20] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(data))
    for mod in (tensorboard, jax_tensorboard):
        with pytest.raises(ValueError, match="CRC mismatch"):
            mod.read_events(path)


@pytest.mark.parametrize("mod", [preemption, jax_preemption],
                         ids=["port", "reference"])
def test_preemption_handler_latches_and_restores(mod):
    before = signal.getsignal(signal.SIGTERM)
    with mod.PreemptionHandler() as guard:
        assert not guard.triggered and guard.signum is None
        os.kill(os.getpid(), signal.SIGTERM)
        signal.getsignal(signal.SIGTERM)    # lets CPython run the handler
        assert guard.triggered and guard.signum == signal.SIGTERM
    assert signal.getsignal(signal.SIGTERM) is before
    with mod.PreemptionHandler(()) as inert:
        assert not inert.triggered
    assert signal.getsignal(signal.SIGTERM) is before


def test_preemption_handler_is_inert_off_the_main_thread():
    import threading
    out = {}

    def run():
        for name, mod in (("port", preemption), ("ref", jax_preemption)):
            with mod.PreemptionHandler() as guard:
                out[name] = (guard._installed, guard.triggered)

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    assert out == {"port": (False, False), "ref": (False, False)}


def test_setup_logger_equal(tmp_path):
    lines = []
    for name, mod in (("nic_port_copy", port_logging),
                      ("nic_ref_copy", jax_logging)):
        path = tmp_path / f"{name}.log"
        logger = mod.setup_logger(name, logging.DEBUG, str(path))
        assert mod.setup_logger(name) is logger         # configured once
        assert [type(h) for h in logger.handlers] == [
            logging.StreamHandler, logging.FileHandler]
        logger.info("step %d", 3)
        for h in logger.handlers:
            h.flush()
        text = path.read_text().replace(name, "NAME")
        lines.append(text.split(" ", 1)[1])            # drop the clock
        for h in list(logger.handlers):
            h.close()
            logger.removeHandler(h)
    assert lines[0] == lines[1] == "INFO NAME: step 3\n"
