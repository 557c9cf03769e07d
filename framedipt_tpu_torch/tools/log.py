"""The package's logger: stdlib logging to stderr, one handler."""
from __future__ import annotations

import logging
import sys


def get_logger(name: str = "framedipt_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s", datefmt="%H:%M:%S")
        )
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False  # no second line through the root logger
    return logger
