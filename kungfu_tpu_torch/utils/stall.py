"""Stall detector (copy of ``kungfu_tpu/utils/stall.py``): wrap a
blocking operation; a watchdog thread logs ``"<op> stalled for <t>"``
every ``period`` seconds until it finishes, then ``recovered``.  On
with ``KF_CONFIG_ENABLE_STALL_DETECTION`` (or ``force=True``).
"""

from __future__ import annotations

import contextlib
import threading
import time

from kungfu_tpu_torch.utils.envs import ENABLE_STALL_DETECTION, parse_bool_env
from kungfu_tpu_torch.utils.log import get_logger

_log = get_logger("stall")
DEFAULT_PERIOD_S = 3.0


@contextlib.contextmanager
def stall_detector(name: str, period: float = DEFAULT_PERIOD_S,
                   force: bool = False):
    if not (force or parse_bool_env(ENABLE_STALL_DETECTION)):
        yield
        return
    done = threading.Event()
    t0 = time.time()
    stalled = [False]

    def watch():
        while not done.wait(period):
            stalled[0] = True
            _log.warning("%s stalled for %.1fs", name, time.time() - t0)

    th = threading.Thread(target=watch, daemon=True)
    th.start()
    try:
        yield
    finally:
        done.set()
        th.join(timeout=1)
        if stalled[0]:
            _log.warning("%s recovered after %.1fs", name, time.time() - t0)
