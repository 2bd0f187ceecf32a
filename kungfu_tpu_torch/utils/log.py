"""Leveled logging (trimmed copy of ``kungfu_tpu/utils/log.py``)."""

from __future__ import annotations

import logging
import os
import sys
import time

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


def log_event(name: str) -> None:
    """Log an event with wall time and its offsets from the job's and the
    process's start (``KF_JOB_START_TIMESTAMP``,
    ``KF_PROC_START_TIMESTAMP``)."""
    now = time.time()
    job0 = float(os.environ.get("KF_JOB_START_TIMESTAMP", now))
    proc0 = float(os.environ.get("KF_PROC_START_TIMESTAMP", now))
    get_logger("event").info("%s | wall=%.3f job+%.3fs proc+%.3fs", name,
                             now, now - job0, now - proc0)
