"""Planted faults: the linter's self-check on a copy of the port's tree.

One fault per rule family, each a small edit of a real module of
``kungfu_tpu_torch/``: an unregistered knob (env-contract), a
rank-conditional collective (collective-consistency), a reversed lock
pair (lock-order), a renamed ZeRO buddy tag (proto-verify: the wire no
longer matches the protocol model), a dropped ``HeaderCodec`` field
(wire-contract), a ``.item()`` in the captured decode step (jit-sync),
a typo'd pipeline axis (shard-axis), a duplicated axis in a
``ShardedTrainer`` spec (shard-spec), a ``torch.cuda.device_count()``
read in a captured lambda (recompile-hazard), the clock in the ZeRO
buddy tag (replay-taint), an unseeded global ``torch.randn`` in the
captured decode step (rng-discipline) and a ``+=`` over set iteration
in ``parallel/`` (reduction-order).  :func:`plant_all` applies them to a copy made by
:func:`copy_port`; a linter run over that copy must then report exactly
the plants' findings (:func:`unexplained` is empty) — no fault missed,
nothing else found.  The tests and ``chip_smoke.py`` phase 22 run it.
Stdlib only, like the linter.
"""

from __future__ import annotations

import os
import shutil
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class Plant:
    checker: str
    path: str  #: repo-root relative
    old: Optional[str]  #: text replaced once; None appends ``new``
    new: str
    count: int  #: findings the fault must produce, all on ``path``
    needle: str  #: a substring of each of those findings' messages


PLANTS: Tuple[Plant, ...] = (
    Plant("env-contract", "kungfu_tpu_torch/utils/log.py", None,
          "\n_PLANTED = __import__('os').environ.get("
          "'KF_PLANTED_UNREGISTERED')\n",
          1, "KF_PLANTED_UNREGISTERED is read here but not registered"),
    Plant("collective-consistency", "kungfu_tpu_torch/elastic/hooks.py",
          None,
          "\n\ndef _planted_leader_only(peer, blob):\n"
          "    if peer.rank() == 0:\n"
          "        peer.channel.broadcast_bytes(blob, peer.cluster.workers,"
          "\n                                     name='kf.planted')\n",
          1, "rank-conditional branch"),
    Plant("lock-order", "kungfu_tpu_torch/monitor/registry.py", None,
          "\n\nclass _PlantedInversion:\n"
          "    def __init__(self):\n"
          "        self.mu = threading.Lock()\n"
          "        self.nu = threading.Lock()\n\n"
          "    def forward(self):\n"
          "        with self.mu:\n"
          "            with self.nu:\n"
          "                return 0\n\n"
          "    def backward(self):\n"
          "        with self.nu:\n"
          "            with self.mu:\n"
          "                return 1\n",
          1, "lock-order cycle"),
    Plant("proto-verify", "kungfu_tpu_torch/elastic/reshard.py",
          'name = f"kf.zbuddy.{tag}"', 'name = f"kf.zbuddy2.{tag}"',
          2, "protocol model drift"),
    Plant("wire-contract", "kungfu_tpu_torch/comm/host.py",
          'HEAD_FMT = "<IIBH"', 'HEAD_FMT = "<IIB"', 2, "transport.cpp"),
    Plant("jit-sync", "kungfu_tpu_torch/serve/engine.py",
          "        B = last_ids.shape[0]\n",
          "        B = last_ids.shape[0]\n        last_ids.max().item()\n",
          1, "in capture scope `_decode`"),
    Plant("shard-axis", "kungfu_tpu_torch/parallel/train.py",
          "buf = coll.ppermute(out, AXIS_PP, perm)",
          'buf = coll.ppermute(out, "ppx", perm)', 1, "'ppx'"),
    Plant("shard-spec", "kungfu_tpu_torch/parallel/train.py",
          '"wq": {"w": (P(AXIS_PP, None, AXIS_TP), "tp_sharded"),',
          '"wq": {"w": (P(AXIS_PP, AXIS_TP, AXIS_TP), "tp_sharded"),',
          1, "names axis 'tp' twice"),
    Plant("recompile-hazard", "kungfu_tpu_torch/serve/engine.py",
          "self._v, last, pos))",
          "self._v, last, pos[:torch.cuda.device_count()]))",
          1, "frozen into the CUDA graph"),
    Plant("replay-taint", "kungfu_tpu_torch/elastic/reshard.py",
          "        stride = int(stride)\n",
          "        stride = int(stride)\n"
          "        tag = f\"{tag}.{__import__('time').time()}\"\n",
          1, "time.time()"),
    Plant("rng-discipline", "kungfu_tpu_torch/serve/engine.py",
          "        slots = torch.arange(B, device=pos.device)\n",
          "        slots = torch.arange(B, device=pos.device)\n"
          "        h = h + torch.randn(h.shape, device=h.device, dtype=h.dtype)"
          "\n", 1, "torch.randn() (process-global RNG)"),
    Plant("reduction-order", "kungfu_tpu_torch/parallel/zero.py",
          "    for l in tree_leaves(opt_state):",
          "    for l in set(tree_leaves(opt_state)):", 1, "set(...)"),
)


def copy_port(src_root: str, dst_root: str) -> str:
    """Copy ``src_root``'s ``kungfu_tpu_torch/`` sources (Python and
    C++; no build output) to ``dst_root``; returns ``dst_root``."""
    src = os.path.join(src_root, "kungfu_tpu_torch")
    shutil.copytree(
        src, os.path.join(dst_root, "kungfu_tpu_torch"),
        ignore=shutil.ignore_patterns("__pycache__", "_build", "*.so",
                                      "*.o", "*.log"))
    return dst_root


def plant_all(root: str) -> None:
    """Apply every plant to the tree at ``root``."""
    for p in PLANTS:
        path = os.path.join(root, p.path)
        with open(path, encoding="utf-8") as f:
            src = f.read()
        if p.old is None:
            out = src + p.new
        elif src.count(p.old) != 1:
            raise ValueError(f"{p.path}: the planted edit's anchor "
                             f"{p.old!r} must occur once, found "
                             f"{src.count(p.old)}")
        else:
            out = src.replace(p.old, p.new)
        with open(path, "w", encoding="utf-8") as f:
            f.write(out)


def unexplained(findings: List[dict]) -> List[str]:
    """What differs between ``findings`` (``--json`` records) and the
    plants: extra findings, missing ones, or a message without its
    plant's needle.  Empty means the linter caught exactly the plants."""
    got: Dict[Tuple[str, str], List[str]] = {}
    for f in findings:
        got.setdefault((f["checker"], f["path"]), []).append(f["message"])
    out = []
    for p in PLANTS:
        msgs = got.pop((p.checker, p.path), [])
        if len(msgs) != p.count:
            out.append(f"{p.checker} on {p.path}: {len(msgs)} finding(s), "
                       f"expected {p.count}")
        out.extend(f"{p.checker} on {p.path}: {m!r} lacks {p.needle!r}"
                   for m in msgs if p.needle not in m)
    out.extend(f"unplanted {c} on {path}: {m}"
               for (c, path), msgs in sorted(got.items()) for m in msgs)
    return out

