"""Worker-side heartbeat signal senders.

Parity with reference ``kungfu/cmd/__init__.py:11-29`` (monitor_batch_begin
/ monitor_batch_end / monitor_epoch_end / monitor_train_end) →
``libkungfu-comm/send.go:32-57`` (POST to the rank-0 host's detector at
:7756).  The detector address comes from ``KF_MONITOR_ADDR`` (set by the
monitored runner); with it unset these are no-ops, so instrumented training
scripts run unchanged under plain ``kfrun``.

Failures to deliver are swallowed by design: a dying detector must not
take the training job down with it.  Per-batch begin/end heartbeats are
fire-and-forget (the next batch re-sends fresher liveness anyway), but
``epoch``/``trainend`` are *bookkeeping* — a dropped epoch signal makes
the post-failure restart resume from an older epoch (observed on a
loaded box: the detector's accept backlog ate an epoch POST and the job
re-trained an epoch it had finished) — so those retry a few times
before giving up.

Copy of ``kungfu_tpu/monitor/signals.py``.
"""

from __future__ import annotations

import http.client
import os
import time
from typing import Optional

from kungfu_tpu_torch.monitor.detector import DEFAULT_DETECTOR_PORT, post_signal
from kungfu_tpu_torch.utils import envs
from kungfu_tpu_torch.utils.log import get_logger

_log = get_logger("signals")

MONITOR_ADDR_ENV = envs.MONITOR_ADDR


def _target() -> Optional[tuple]:
    addr = os.environ.get(MONITOR_ADDR_ENV)
    if not addr:
        return None
    if ":" in addr:
        host, port = addr.rsplit(":", 1)
        return host, int(port)
    return addr, DEFAULT_DETECTOR_PORT


def _send(sig: dict, attempts: int = 1) -> None:
    target = _target()
    if target is None:
        return
    for i in range(attempts):
        try:
            post_signal(target[0], target[1], sig, timeout=3)
            return
        # HTTPException is NOT an OSError (e.g. BadStatusLine from a
        # half-dead detector); both must be swallowed or the monitoring
        # sidecar's death takes the training job down with it
        except (OSError, http.client.HTTPException) as e:
            if i + 1 < attempts:
                time.sleep(0.2 * (i + 1))
            else:
                _log.debug("signal %s not delivered: %s", sig.get("kind"), e)


def monitor_batch_begin(rank: int) -> None:
    _send({"kind": "begin", "rank": rank})


def monitor_batch_end(rank: int) -> None:
    _send({"kind": "end", "rank": rank})


def monitor_epoch_end(rank: int, epoch: int) -> None:
    _send({"kind": "epoch", "rank": rank, "epoch": epoch}, attempts=3)


def monitor_compile_grace(rank: int) -> None:
    """Announce an upcoming known-long stall (resize re-jit): the
    detector extends this rank's allowance to its compile-grace window
    instead of the batch-stall timeout.  Retried — a dropped grace signal
    turns a healthy recompile into a spurious cluster restart."""
    _send({"kind": "grace", "rank": rank}, attempts=3)


def monitor_train_end(rank: int) -> None:
    _send({"kind": "trainend", "rank": rank}, attempts=3)


def monitor_report_down(epoch: int = -1) -> None:
    """Worker-side escalation to the detector-driven full restart — the
    last resort when in-flight shrink recovery loses quorum
    (``elastic/shrink.py``).  ``epoch=-1`` = "sender has no epoch
    accounting": the detector falls back to its own records instead of
    restarting from epoch 0.  Retried: this IS the recovery path, a
    dropped signal strands the job."""
    _send({"kind": "otherdown", "epoch": epoch}, attempts=3)
