"""Leveled logging (trimmed copy of ``kungfu_tpu/utils/log.py``)."""

from __future__ import annotations

import logging
import os
import sys

_FMT = "[kf-torch] %(asctime)s %(levelname).1s %(name)s: %(message)s"


def get_logger(name: str = "kungfu_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(_FMT, datefmt="%H:%M:%S"))
        logger.addHandler(h)
        level = os.environ.get("KF_CONFIG_LOG_LEVEL", "INFO").upper()
        logger.setLevel(getattr(logging, level, logging.INFO))
        logger.propagate = False
    return logger
