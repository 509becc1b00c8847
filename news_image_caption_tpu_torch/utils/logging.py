"""Logging setup (capability parity with the reference's
ttl/tell/utils/logger.py).

A copy of `news_image_caption_tpu/utils/logging.py`: the port imports
nothing of the JAX package.
`tests/test_torch_training_copies.py` holds the two equal.
"""

from __future__ import annotations

import logging
import sys


def setup_logger(name: str = "news_image_caption_tpu",
                 level: int = logging.INFO,
                 log_path: str | None = None) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if not logger.handlers:
        fmt = logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s", "%H:%M:%S")
        sh = logging.StreamHandler(sys.stderr)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        if log_path:
            fh = logging.FileHandler(log_path)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger
