"""kf-persist: the durable state plane -- async sharded checkpoints,
manifest selection, and checkpoint-shape-agnostic cold restore (port of
``kungfu_tpu/elastic/persist.py``).

Every recovery rung below this one (shrink, slice loss) assumes some
rank survives with its in-memory boundary.  A whole-job preemption
loses every process at once, so the last line of defense is durable
storage:

* **Async off the step path**: each rank streams its committed
  :class:`~kungfu_tpu_torch.elastic.reshard.ZeroBoundary` shard to the
  manifest directory on a single ordered writer thread;
  :meth:`PersistPlane.persist_async` issues a :class:`PersistHandle`,
  :meth:`PersistPlane.persist_fence` settles every in-flight write.
* **Ring-buddy de-duplication**: in chunk mode a rank writes only its
  own chunk; the buddy mirror is never written, its owner writes it.
* **Torn writes are detectable, never restorable**: each rank's segment
  is written atomically (tempfile + ``os.replace``) and then committed
  by ``rank<r>.ok.json`` with its byte count and blake2b digest.  A
  manifest is complete iff its ``meta.json`` and every old rank's
  verified (segment, commit record) pair are present.
* **Shape-agnostic restore**: :func:`restore_from_manifest` re-carves
  the persisted chunks into any new world size through the same pure
  :func:`~kungfu_tpu_torch.parallel.zero.reshard_plan` the live
  re-carve uses, so a cold restart onto another world size is bitwise
  what a fixed-world replay would give.
* **Restore-time agreement**: :meth:`PersistPlane.agree_manifest` --
  rank 0 picks the manifest and fans it out, the rest block on it.

The disk format is the reference's, file for file: ``meta.json``,
``rank<r>.seg.npz`` (numpy ``.npz``; bf16 widened to f32, its dtype name
recorded) and ``rank<r>.ok.json``, under ``manifest_name(step,
version)``, so a manifest written by either package restores in the
other.  Pipeline-stage geometry (:func:`stage_restore_plan`) raises
``NotImplementedError`` until ROADMAP A4b.
"""

from __future__ import annotations

import hashlib
import io
import json
import math
import os
import re
import shutil
import tempfile
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutureTimeout
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from kungfu_tpu_torch.checkpoint import _DTYPE_NAMES, _torch_dtype
from kungfu_tpu_torch.elastic.reshard import ZeroBoundary, _recv_or_fail
from kungfu_tpu_torch.monitor import timeline
from kungfu_tpu_torch.monitor.registry import REGISTRY
from kungfu_tpu_torch.utils import envs
from kungfu_tpu_torch.utils.log import get_logger

_log = get_logger("persist")

#: manifest directory name: ``step_<NNNNNNNN>.v<cluster_version>``
MANIFEST_RE = re.compile(r"^step_(\d{8})\.v(\d+)$")
META_NAME = "meta.json"
#: manifest format version (meta.json "format"); bump on layout changes
FORMAT = 1

#: persist-plane gauges (monitor/registry.py METRIC_HELP documents them)
G_LAST_STEP = "kf_ckpt_last_step"
G_AGE = "kf_ckpt_age_seconds"
G_BYTES = "kf_ckpt_bytes_total"
G_PERIOD = "kf_ckpt_period_seconds"


class ManifestError(RuntimeError):
    """A manifest failed verification: torn segment, digest mismatch,
    or missing commit record.  Callers restore an OLDER complete
    manifest instead — a partial write must never become state."""


def _dtype_name(a) -> str:
    """The numpy ``dtype.name`` the manifest records for a leaf
    (``bfloat16`` is ml_dtypes' name for it)."""
    if isinstance(a, torch.Tensor):
        return _DTYPE_NAMES[a.dtype]
    return np.asarray(a).dtype.name


def _npz_safe(a) -> np.ndarray:
    """A host numpy copy of a leaf that ``.npz`` can hold: bfloat16 is
    widened to f32 (lossless; the recorded dtype name casts it back on
    restore)."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return np.array(t.numpy())
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16" or arr.dtype.kind == "V":
        return arr.astype(np.float32)
    return np.array(arr)


def _leaf(arr: np.ndarray, name: str) -> torch.Tensor:
    """A stored array as a torch tensor of its recorded dtype."""
    return torch.from_numpy(np.array(arr)).to(_torch_dtype(name))


def _atomic_write(path: str, data: bytes) -> None:
    """Write-then-rename so a reader never observes a half-written
    file (the checkpoint.py pattern); a crash leaves only a ``.tmp``."""
    d = os.path.dirname(path)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _digest_file(path: str) -> Tuple[str, int]:
    """(blake2b hexdigest, byte count) of a file's current content."""
    h = hashlib.blake2b(digest_size=16)
    n = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(1 << 20)
            if not block:
                break
            h.update(block)
            n += len(block)
    return h.hexdigest(), n


def manifest_name(step: int, cluster_version: int) -> str:
    return f"step_{int(step):08d}.v{int(cluster_version)}"


def _seg_path(mdir: str, rank: int) -> str:
    return os.path.join(mdir, f"rank{rank}.seg.npz")


def _ok_path(mdir: str, rank: int) -> str:
    return os.path.join(mdir, f"rank{rank}.ok.json")


def load_manifest_meta(mdir: str) -> dict:
    with open(os.path.join(mdir, META_NAME), "rb") as f:
        return json.loads(f.read().decode())


def verify_rank_file(mdir: str, rank: int, *, digest: bool = True) -> dict:
    """Verify old rank ``rank``'s (segment, commit record) pair; returns
    the parsed commit record.  Raises :class:`ManifestError` on a torn
    or tampered segment — the digest is the commit.  ``digest=False``
    checks the recorded byte count against the file size only (an
    atomic-rename filesystem can't leave a right-sized wrong-content
    segment short of corruption): the cheap mode for GC's am-I-allowed-
    to-delete scans, never for choosing a restore source."""
    okp, segp = _ok_path(mdir, rank), _seg_path(mdir, rank)
    if not os.path.isfile(okp):
        raise ManifestError(f"{mdir}: rank {rank} has no commit record")
    with open(okp, "rb") as f:
        ok = json.loads(f.read().decode())
    if not os.path.isfile(segp):
        raise ManifestError(f"{mdir}: rank {rank} segment file missing")
    if not digest:
        nbytes = os.stat(segp).st_size
        if nbytes != ok.get("nbytes"):
            raise ManifestError(
                f"{mdir}: rank {rank} segment is short "
                f"({nbytes} != committed {ok.get('nbytes')} bytes)")
        return ok
    hexd, nbytes = _digest_file(segp)
    if nbytes != ok.get("nbytes") or hexd != ok.get("blake2b"):
        raise ManifestError(
            f"{mdir}: rank {rank} segment is torn/corrupt "
            f"({nbytes} bytes, digest {hexd[:12]}… != committed "
            f"{ok.get('nbytes')} bytes, {str(ok.get('blake2b'))[:12]}…)")
    return ok


def manifest_complete(mdir: str, *, digest: bool = True) -> bool:
    """A manifest is restorable iff its meta and EVERY old rank's
    digest-verified segment landed.  Anything less is a partial write
    in progress or a preemption mid-persist — never restored."""
    try:
        meta = load_manifest_meta(mdir)
    except (OSError, ValueError):
        return False
    try:
        for r in range(int(meta["old_n"])):
            verify_rank_file(mdir, r, digest=digest)
    except (ManifestError, KeyError, ValueError):
        return False
    return True


def manifest_dirs(root: str) -> List[Tuple[int, int, str]]:
    """Every manifest directory under ``root`` as sorted
    ``[(step, cluster_version, path)]`` (oldest first)."""
    if not os.path.isdir(root):
        return []
    out = []
    for name in sorted(os.listdir(root)):
        m = MANIFEST_RE.match(name)
        if m:
            out.append((int(m.group(1)), int(m.group(2)),
                        os.path.join(root, name)))
    out.sort()
    return out


def newest_complete_manifest(root: str) -> Optional[str]:
    """The restore source: the newest manifest that verifies complete.
    A newer partial one (preempted mid-persist) is skipped — restoring
    it would blend a torn write into training state."""
    for _, _, path in reversed(manifest_dirs(root)):
        if manifest_complete(path):
            return path
    return None


def gc_manifests(root: str, keep: int) -> List[str]:
    """Keep the newest ``keep`` (≥ 1) COMPLETE manifests; drop older
    complete ones and any partial older than the newest complete (a
    partial newer than it may still be landing and is left alone).  The
    only complete manifest is never deleted — it is the last restore
    point.  Returns the removed paths."""
    keep = max(1, int(keep))
    entries = manifest_dirs(root)
    # size-only completeness: GC runs on the writer thread after EVERY
    # persist, and digest-verifying keep+ manifests x old_n segments
    # there would put O(state bytes) of hashing on a 1-core host's step
    # path; deciding what to KEEP needs only will-this-restore-attempt-
    # consider-it, and restore itself still full-verifies
    complete = [(s, v, p) for (s, v, p) in entries
                if manifest_complete(p, digest=False)]
    if not complete:
        return []
    survivors = {p for _, _, p in complete[-keep:]}
    newest_key = complete[-1][:2]
    removed = []
    for s, v, p in entries:
        if p in survivors or (s, v) > newest_key:
            continue
        try:
            shutil.rmtree(p)
            removed.append(p)
        except OSError:
            pass  # concurrent GC: someone else removed it first
    return removed


# -- restore -----------------------------------------------------------------
@dataclass
class RestoredState:
    """One rank's re-carved view of a manifest: the geometry it was
    restored INTO, the ZeRO vector chunks for that geometry, the
    replicated scalar optimizer leaves, and the named replicated
    arrays (params, counters, KV snapshots — whatever the trainer
    persisted)."""

    step: int
    cluster_version: int
    total: int
    new_n: int
    my_new: int
    chunk: int
    vec: Dict[int, torch.Tensor] = field(default_factory=dict)
    scal: Dict[int, torch.Tensor] = field(default_factory=dict)
    replicated: Dict[str, torch.Tensor] = field(default_factory=dict)
    meta: dict = field(default_factory=dict)

    def install_into_boundary(self, boundary: ZeroBoundary) -> None:
        """Seed a :class:`ZeroBoundary` with the restored carve so the
        live elastic machinery (buddy mirrors, re-carve on the next
        membership change) continues from the restored step.  Leaf
        classification is by ndim (the boundary contract), so the
        scalar leaves ride along in the same tree."""
        tree = {f"s{i}": a for i, a in sorted(self.scal.items())}
        tree.update({f"v{i}": a for i, a in sorted(self.vec.items())})
        boundary.commit_local(self.step, tree, self.total, self.new_n,
                              self.my_new)


def restore_from_manifest(mdir: str, my_new: int, new_n: int
                          ) -> RestoredState:
    """Checkpoint-shape-agnostic restore: assemble new rank ``my_new``'s
    chunk of a ``new_n``-rank world from a manifest written under ANY
    old geometry, by slicing the persisted old chunks along the same
    pure :func:`~kungfu_tpu_torch.parallel.zero.reshard_plan` the live
    re-carve exchanges over the wire.  Purely file-driven — every new
    rank computes the identical plan and reads only the old rank files
    its segments live in.  Every touched file is digest-verified first
    (:class:`ManifestError` on a torn segment)."""
    from kungfu_tpu_torch.parallel.zero import reshard_plan

    if new_n < 1 or not 0 <= my_new < new_n:
        raise ValueError(f"bad restore geometry rank {my_new} of {new_n}")
    meta = load_manifest_meta(mdir)
    if int(meta.get("format", 0)) != FORMAT:
        raise ManifestError(
            f"{mdir}: manifest format {meta.get('format')!r} != {FORMAT}")
    step = int(meta["step"])
    total, old_n, oc = int(meta["total"]), int(meta["old_n"]), \
        int(meta["chunk"])
    new_chunk = math.ceil(total / new_n) if total else 0
    plan = reshard_plan(total, old_n, new_n) if total else []
    lo = my_new * new_chunk

    loaded: Dict[int, Tuple[dict, dict]] = {}

    def rank_file(r: int) -> Tuple[dict, dict]:
        if r not in loaded:
            ok = verify_rank_file(mdir, r)
            with np.load(_seg_path(mdir, r), allow_pickle=False) as z:
                loaded[r] = ({k: z[k] for k in z.files}, ok)
        return loaded[r]

    # replicated + scalar leaves live in the lowest rank's file (they
    # have no owner: any copy is THE copy — rank 0 writes it once)
    z0, ok0 = rank_file(0)
    repl = {k[2:]: _leaf(z0[k], ok0["repl_dtypes"][k[2:]])
            for k in z0 if k.startswith("r_")}
    scal = {int(k[2:]): _leaf(z0[k], ok0["scal_dtypes"][k[2:]])
            for k in z0 if k.startswith("s_")}
    vec_dtypes = {int(i): name
                  for i, name in ok0.get("vec_dtypes", {}).items()}
    vec: Dict[int, torch.Tensor] = {}
    if old_n == 1 and new_n == 1:
        # degenerate round trip: the stored leaves as they are (also the
        # only geometry a full-mode manifest, whose leaves keep their
        # own shapes, restores onto)
        for i, name in vec_dtypes.items():
            vec[i] = _leaf(z0[f"v{i}"], name)
    else:
        vec = {i: torch.zeros((new_chunk,), dtype=_torch_dtype(name))
               for i, name in vec_dtypes.items()}
        for (o, r, s, ln) in plan:
            if r != my_new:
                continue
            z, _ = rank_file(o)
            off = o * oc
            for i in vec:
                src = z[f"v{i}"]
                if src.ndim != 1:
                    raise ManifestError(
                        f"{mdir}: leaf {i} has shape {src.shape}; only "
                        "flat (host-plane ZeRO) manifests re-carve onto "
                        "a different world size")
                got = src[s - off:s - off + ln]
                if got.shape[0] != ln:
                    raise ManifestError(
                        f"{mdir}: rank {o} chunk of leaf {i} is short — "
                        f"segment [{s},{s + ln}) falls outside it")
                vec[i][s - lo:s - lo + ln] = _leaf(got, vec_dtypes[i])
    timeline.event("ckpt", "restore", step=step, old_n=old_n, new_n=new_n,
                   rank=my_new, manifest=os.path.basename(mdir))
    _log.info("restored manifest %s (step %d, %d->%d ranks) as rank %d",
              mdir, step, old_n, new_n, my_new)
    return RestoredState(
        step=step, cluster_version=int(meta.get("cluster_version", 0)),
        total=total, new_n=new_n, my_new=my_new, chunk=new_chunk,
        vec=vec, scal=scal, replicated=repl, meta=meta)


def stage_restore_plan(n_layers: int, old_stages: int, new_stages: int
                       ) -> List[Tuple[int, int, int]]:
    """The pipeline-stage analog of the restore re-carve (reference
    ``persist.py:391``, over ``parallel/pp.py stage_recarve_plan``):
    raises until ROADMAP A4b ports the cross-host pipeline."""
    raise NotImplementedError(
        f"restoring {n_layers} layers from {old_stages} onto {new_stages} "
        "pipeline stages waits for ROADMAP A4b: parallel/pp.py's "
        "stage re-carve is not ported yet")


# -- the async persist plane -------------------------------------------------
class PersistHandle:
    """One in-flight durable write (the kf-overlap handle shape):
    :meth:`wait` blocks until the manifest segment is durable and
    returns the manifest path, re-raising any write failure."""

    def __init__(self, fut: "Future[str]", step: int, mdir: str):
        self._fut = fut
        self.step = int(step)
        self.manifest = mdir

    def wait(self, timeout: Optional[float] = None) -> str:
        try:
            return self._fut.result(timeout)
        except _FutureTimeout:
            raise TimeoutError(
                f"persist of step {self.step} still in flight after "
                f"{timeout}s") from None

    def done(self) -> bool:
        return self._fut.done()


class PersistPlane:
    """Per-rank durable state plane over one manifest root.

    ``rank`` is this worker's rank in the CURRENT world; in chunk mode
    it must equal the boundary's ``my_old`` (one process per rank — the
    host-plane training contract).  Knobs default from the
    persist env registry (:func:`kungfu_tpu_torch.utils.envs.
    persist_knobs`): ``period_s`` seconds between issued persists (0 =
    every commit), ``depth`` bound on in-flight handles, ``keep``
    complete manifests retained by GC (rank 0 runs GC after each
    durable write)."""

    def __init__(self, root: str, rank: int, *,
                 cluster_version: int = 0,
                 period_s: Optional[float] = None,
                 depth: Optional[int] = None,
                 keep: Optional[int] = None):
        knobs = envs.persist_knobs()
        self.root = root
        self.rank = int(rank)
        self.cluster_version = int(cluster_version)
        self.period_s = float(knobs["period_s"] if period_s is None
                              else period_s)
        self.depth = max(1, int(knobs["depth"] if depth is None else depth))
        self.keep = max(1, int(knobs["keep"] if keep is None else keep))
        self._lock = threading.Lock()
        self._inflight: "deque[PersistHandle]" = deque()
        self._writer = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="kf-persist")
        self._last_issue_t: Optional[float] = None
        self._last_done_t = time.monotonic()
        os.makedirs(root, exist_ok=True)
        REGISTRY.gauge(G_PERIOD).set(float(self.period_s))
        self.touch_age()

    # -- gauges -----------------------------------------------------------
    def touch_age(self) -> None:
        """Refresh ``kf_ckpt_age_seconds`` = seconds since the last
        DURABLE write.  Called on every commit/fence so the gauge keeps
        growing while training runs with a wedged writer — the signal
        kftop's CKPT STALE alarm fires on."""
        with self._lock:
            age = time.monotonic() - self._last_done_t
        REGISTRY.gauge(G_AGE).set(float(age))

    # -- issue ------------------------------------------------------------
    def due(self, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        with self._lock:
            last = self._last_issue_t
        return last is None or (now - last) >= self.period_s

    def commit(self, step: int, boundary: Optional[ZeroBoundary] = None,
               replicated: Optional[Dict[str, np.ndarray]] = None
               ) -> Optional[PersistHandle]:
        """Period-gated persist at a committed step boundary: issues a
        durable write when the persist period has elapsed (always, when
        ``period_s`` is 0) and returns its handle, else ``None``.  The
        returned handle is also tracked internally — a plain
        :meth:`persist_fence` at the next boundary settles it."""
        self.touch_age()
        if not self.due():
            return None
        return self.persist_async(step, boundary, replicated)

    def persist_async(self, step: int,
                      boundary: Optional[ZeroBoundary] = None,
                      replicated: Optional[Dict[str, torch.Tensor]] = None
                      ) -> PersistHandle:
        """Issue one durable write of this rank's shard of step
        ``step``: the boundary's OWN vector chunks (the ring-buddy
        mirror is skipped — its owner writes those bytes), plus — on
        rank 0 only — the replicated scalar leaves and every named
        ``replicated`` array.  Snapshot copies are taken HERE,
        synchronously (donated-buffer discipline); serialization and
        the atomic writes run on the single ordered writer thread.
        Issuing past the depth bound blocks on the oldest handle
        (local backpressure, the kf-overlap window)."""
        writes_repl = self.rank == 0
        noop = False
        if boundary is not None:
            (bstep, total, old_n, my_old, chunk, full_mode, vec, scal) = \
                boundary.export_carve()
            if bstep is None:
                raise ValueError("persist before any boundary commit")
            if full_mode:
                # every rank holds the full vectors — rank 0 writes them
                # once under a 1-rank geometry; the rest add nothing
                old_n, my_old, chunk = 1, 0, int(total)
                noop = self.rank != 0
        else:
            # single-writer mode (serve workers, driver-side state):
            # only plane rank 0 persists; the manifest is 1-rank shaped
            total, old_n, my_old, chunk = 0, 1, 0, 0
            vec, scal = {}, {}
            noop = self.rank != 0
        mdir = os.path.join(self.root,
                            manifest_name(step, self.cluster_version))
        with self._lock:
            self._last_issue_t = time.monotonic()
        if noop:
            done: "Future[str]" = Future()
            done.set_result(mdir)
            return PersistHandle(done, step, mdir)
        # dtype names are recorded BEFORE the npz-safe widening so a
        # bfloat16 carve casts back bitwise on restore
        vec_dtypes = {str(i): _dtype_name(a) for i, a in vec.items()}
        vec_snap = {i: _npz_safe(a) for i, a in vec.items()}
        scal_dtypes = {str(i): _dtype_name(a)
                       for i, a in scal.items()} if writes_repl else {}
        scal_snap = {str(i): _npz_safe(a)
                     for i, a in scal.items()} if writes_repl else {}
        repl_snap: Dict[str, np.ndarray] = {}
        repl_dtypes: Dict[str, str] = {}
        if writes_repl and replicated:
            for name, a in replicated.items():
                repl_dtypes[name] = _dtype_name(a)
                repl_snap[name] = _npz_safe(a)
        meta = {
            "format": FORMAT, "step": int(step),
            "cluster_version": self.cluster_version,
            "total": int(total), "old_n": int(old_n), "chunk": int(chunk),
        }
        while True:
            with self._lock:
                if len(self._inflight) < self.depth:
                    break
                oldest = self._inflight.popleft()
            oldest.wait()
        timeline.event("ckpt", "persist-issue", step=int(step),
                       rank=self.rank, leaves=len(vec_snap))
        fut = self._writer.submit(
            self._write, int(step), mdir, meta, self.rank == 0, my_old,
            vec_snap, vec_dtypes, scal_snap, scal_dtypes, repl_snap,
            repl_dtypes)
        h = PersistHandle(fut, step, mdir)
        with self._lock:
            self._inflight.append(h)
        return h

    def _write(self, step: int, mdir: str, meta: dict, writes_meta: bool,
               my_old: int, vec, vec_dtypes, scal, scal_dtypes,
               repl, repl_dtypes) -> str:
        os.makedirs(mdir, exist_ok=True)
        if writes_meta:
            _atomic_write(os.path.join(mdir, META_NAME),
                          json.dumps(meta, sort_keys=True).encode())
        bio = io.BytesIO()
        arrays = {f"v{i}": a for i, a in vec.items()}
        arrays.update({f"s_{k}": a for k, a in scal.items()})
        arrays.update({f"r_{k}": a for k, a in repl.items()})
        np.savez(bio, **arrays)
        segp = _seg_path(mdir, my_old)
        payload = bio.getvalue()
        # digest the buffer we are about to fsync, not a re-read of the
        # file: same commit semantics (the rename only lands after the
        # bytes), half the hashing on the 1-writer-thread host
        digest = hashlib.blake2b(payload, digest_size=16).hexdigest()
        nbytes = len(payload)
        _atomic_write(segp, payload)
        ok = {
            "rank": my_old, "nbytes": nbytes, "blake2b": digest,
            "vec_dtypes": vec_dtypes, "scal_dtypes": scal_dtypes,
            "repl_dtypes": repl_dtypes,
        }
        # the ok record is the commit: it lands only after the segment
        # bytes are durable, so a torn segment can never verify
        _atomic_write(_ok_path(mdir, my_old),
                      json.dumps(ok, sort_keys=True).encode())
        with self._lock:
            self._last_done_t = time.monotonic()
        REGISTRY.gauge(G_LAST_STEP).set(float(step))
        REGISTRY.gauge(G_AGE).set(0.0)
        g = REGISTRY.gauge(G_BYTES)
        g.set(float(g.value) + float(nbytes))
        timeline.event("ckpt", "persist-done", step=step, rank=self.rank,
                       nbytes=nbytes, manifest=os.path.basename(mdir))
        if self.rank == 0:
            gc_manifests(self.root, self.keep)
        return mdir

    # -- fence ------------------------------------------------------------
    def persist_fence(self, timeout: Optional[float] = None) -> int:
        """Settle every in-flight persist handle (re-raising the first
        write failure); returns how many were waited.  This is the
        boundary fence of the handle pattern: call it before
        ``elastic_step``, a shrink/re-carve, or reporting progress that
        relies on the newest manifest being durable."""
        n = 0
        while True:
            with self._lock:
                if not self._inflight:
                    break
                h = self._inflight.popleft()
            h.wait(timeout)
            n += 1
        self.touch_age()
        return n

    def close(self) -> None:
        self.persist_fence()
        self._writer.shutdown(wait=True)

    # -- restore-time agreement ------------------------------------------
    def agree_manifest(self, chan, workers, my_rank: int,
                       step: int = -1, version: int = -1
                       ) -> Tuple[int, int]:
        """Restore-time manifest agreement: rank 0 has scanned the
        manifest root (:func:`choose_manifest`) and fans its choice
        ``(step, version)`` out to every other rank; everyone else
        blocks on rank 0's frame before touching the directory.
        ``(-1, -1)`` = fresh start (no complete manifest) — agreed the
        same way, so no rank restores what another ignores."""
        n = len(workers)
        name = f"kf.persist.agree.v{self.cluster_version}"
        if my_rank == 0:
            payload = json.dumps(
                {"step": int(step), "version": int(version)}).encode()
            for r in range(1, n):
                chan.send(workers[r], name, payload)
            return int(step), int(version)
        blob = _recv_or_fail(chan, workers[0], 0, "persist-agree", name)
        got = json.loads(bytes(blob).decode())
        return int(got["step"]), int(got["version"])


def agreed_manifest_path(root: str, step: int, version: int
                         ) -> Optional[str]:
    """Path of the agreed manifest (``None`` for the fresh-start
    sentinel ``(-1, -1)``)."""
    if step < 0:
        return None
    return os.path.join(root, manifest_name(step, version))


def choose_manifest(root: str) -> Tuple[int, int]:
    """Rank 0's scan for :meth:`PersistPlane.agree_manifest`:
    ``(step, cluster_version)`` of the newest complete manifest, or the
    fresh-start sentinel ``(-1, -1)``."""
    path = newest_complete_manifest(root)
    if path is None:
        return -1, -1
    m = MANIFEST_RE.match(os.path.basename(path))
    assert m is not None
    return int(m.group(1)), int(m.group(2))
