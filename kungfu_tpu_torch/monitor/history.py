"""kf-sentinel durable history: bounded per-stream segmented JSONL rings
(port of ``kungfu_tpu/monitor/history.py``, stdlib only).

The :class:`~kungfu_tpu_torch.monitor.sentinel.Sentinel` appends one
record per sample to per-stream rings under ``KF_SENTINEL_DIR`` (stream
``cluster`` holds the rollup series the detector judges, ``rank-<r>``
each rank's condensed row, ``decisions`` the ledger's records), and
``python -m kungfu_tpu_torch.monitor.kfhist`` reads them back.  The
segment files (``<stream>-<seq:08d>.jsonl``, one ``json.dumps(record,
sort_keys=True)`` a line) are the reference's byte for byte, so either
package's reader reads what the other wrote.

Each append rewrites the small open segment through ``mkstemp`` +
``os.replace``, so a crash leaves a whole segment and at worst a
``*.tmp`` orphan the reader ignores.  At ``segment_records`` records the
segment is sealed and the ring is collected oldest-sealed-first down to
``KF_SENTINEL_KEEP_BYTES``; the open segment is never collected.  A
restarted writer opens a fresh segment.  The reader skips and counts a
torn line instead of raising.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Dict, List, Optional, Tuple

# env mirror constants, defined next to their reader like timeline.py's
# DUMP_ENV/CAP_ENV; utils/envs.py registers the same tokens for the
# env-contract scan
DIR_ENV = "KF_SENTINEL_DIR"
KEEP_BYTES_ENV = "KF_SENTINEL_KEEP_BYTES"

#: per-stream ring byte budget (sealed + open segments)
DEFAULT_KEEP_BYTES = 8 << 20
#: records per segment before it seals; small on purpose — the open
#: segment is rewritten whole on every append, so this bounds the
#: rewrite cost at ~a few KiB of JSON per push
DEFAULT_SEGMENT_RECORDS = 64

_SEG_RE = re.compile(r"^(?P<stream>.+)-(?P<seq>\d{8})\.jsonl$")


def keep_bytes_from_env() -> int:
    try:
        v = int(os.environ.get(KEEP_BYTES_ENV, "") or DEFAULT_KEEP_BYTES)
    except ValueError:
        return DEFAULT_KEEP_BYTES
    return v if v > 0 else DEFAULT_KEEP_BYTES


def _atomic_write(path: str, data: bytes) -> None:
    """Atomic replace in the target directory (same-filesystem rename);
    a crash mid-write leaves only a ``*.tmp`` orphan, never a torn
    file — the persist plane's write discipline."""
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _segments(root: str, stream: str) -> List[Tuple[int, str]]:
    """Sorted ``(seq, path)`` of a stream's segments on disk (``*.tmp``
    orphans and foreign files ignored)."""
    try:
        names = os.listdir(root)
    except OSError:
        return []
    out = []
    for name in names:
        m = _SEG_RE.match(name)
        if m and m.group("stream") == stream:
            out.append((int(m.group("seq")), os.path.join(root, name)))
    out.sort()
    return out


class HistoryRing:
    """One stream's bounded, durable, append-only record ring."""

    def __init__(self, root: str, stream: str,
                 keep_bytes: Optional[int] = None,
                 segment_records: int = DEFAULT_SEGMENT_RECORDS):
        if not stream or "/" in stream or stream.startswith("."):
            raise ValueError(f"bad stream name {stream!r}")
        self.root = root
        self.stream = stream
        self.keep_bytes = (keep_bytes if keep_bytes is not None
                           else keep_bytes_from_env())
        self.segment_records = max(1, int(segment_records))
        os.makedirs(root, exist_ok=True)
        # always start a FRESH segment past anything on disk (crash or
        # restart): sealed history is immutable
        existing = _segments(root, stream)
        self._seq = (existing[-1][0] + 1) if existing else 0
        self._open_lines: List[str] = []

    def _seg_path(self, seq: int) -> str:
        return os.path.join(self.root, f"{self.stream}-{seq:08d}.jsonl")

    def append(self, record: dict) -> None:
        """Append one record durably: the open segment is rewritten
        whole and atomically renamed into place."""
        self._open_lines.append(json.dumps(record, sort_keys=True))
        data = ("\n".join(self._open_lines) + "\n").encode("utf-8")
        _atomic_write(self._seg_path(self._seq), data)
        if len(self._open_lines) >= self.segment_records:
            self._seq += 1
            self._open_lines = []
            self.gc()

    def gc(self) -> int:
        """Drop oldest SEALED segments until the stream fits
        ``keep_bytes``; the open segment is never a candidate.  Returns
        segments removed."""
        segs = _segments(self.root, self.stream)
        sizes = {}
        for seq, path in segs:
            try:
                sizes[seq] = os.path.getsize(path)
            except OSError:
                sizes[seq] = 0
        total = sum(sizes.values())
        removed = 0
        for seq, path in segs:
            if total <= self.keep_bytes:
                break
            if seq >= self._seq:  # the open segment
                break
            try:
                os.unlink(path)
            except OSError:
                continue
            total -= sizes[seq]
            removed += 1
        return removed


# -- reader side (kfhist; incident bundles) ---------------------------------
def streams(root: str) -> List[str]:
    """Stream names present under ``root``, sorted."""
    try:
        names = os.listdir(root)
    except OSError:
        return []
    found = {m.group("stream")
             for m in (_SEG_RE.match(n) for n in names) if m}
    return sorted(found)


def scan_stream(root: str, stream: str) -> Tuple[List[dict], int]:
    """``(records, skipped)`` oldest-first across the stream's segments.
    A torn/garbled line (or a whole unreadable segment) is counted in
    ``skipped`` and passed over — corrupt history must not crash the
    reader."""
    records: List[dict] = []
    skipped = 0
    for _seq, path in _segments(root, stream):
        try:
            with open(path, "r", encoding="utf-8") as f:
                lines = f.read().splitlines()
        except OSError:
            skipped += 1
            continue
        for line in lines:
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                skipped += 1
                continue
            if isinstance(rec, dict):
                records.append(rec)
            else:
                skipped += 1
    return records, skipped


def read_stream(root: str, stream: str,
                last: Optional[int] = None) -> List[dict]:
    """The stream's records oldest-first (``last`` keeps only the newest
    N), torn lines silently skipped — the common-case read."""
    records, _ = scan_stream(root, stream)
    if last is not None and last >= 0:
        records = records[-last:]
    return records


def series_from_records(records: List[dict]) -> Dict[str, List[float]]:
    """Per-series sample lists from cluster-rollup records (each record
    carries a ``series`` dict) — the detector feedstock ``kfhist
    --verdict`` rebuilds from disk.  Samples keep record order; a record
    missing a series contributes no sample to it (exactly how the online
    plane accumulates)."""
    out: Dict[str, List[float]] = {}
    for rec in records:
        series = rec.get("series")
        if not isinstance(series, dict):
            continue
        for name, value in series.items():
            if isinstance(value, (int, float)) and not isinstance(value, bool):
                out.setdefault(name, []).append(float(value))
    return out
