"""Shared dataset cache-base resolution (one policy for every helper).

Copy of ``kungfu_tpu/datasets/cache.py``.
"""

from __future__ import annotations

import os

DATA_DIR_ENV = "KF_DATA_DIR"


def cache_dir(name: str) -> str:
    """``$KF_DATA_DIR`` (default ``~/.cache/kungfu_tpu``) ``/<name>``."""
    base = os.environ.get(DATA_DIR_ENV) or os.path.join(
        os.path.expanduser("~"), ".cache", "kungfu_tpu"
    )
    return os.path.join(base, name)
