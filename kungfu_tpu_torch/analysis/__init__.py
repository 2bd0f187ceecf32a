"""kf-lint, kf-verify, kf-shard and kf-det over the port's tree (port
of ``kungfu_tpu/analysis/``).

Nineteen AST/structural checkers enforce the invariants of the reference's
catalog (``docs/lint.md``) over ``kungfu_tpu_torch/``, ``chip_smoke.py``
and the port's timing scripts.  The messages are the reference's; they
name the port's paths.

The single-function and schema rules:

* ``env-contract``  — every ``KF_*`` env read (Python and C++) appears in
  the :mod:`kungfu_tpu_torch.utils.envs` registry, and every registry
  entry has a reader (:mod:`kungfu_tpu_torch.analysis.envcheck`).
* ``jit-sync``      — no host-sync / side-effect calls inside jitted
  code or inside capture scope (a ``torch.cuda.graph`` block, what it
  calls, and the functions handed to a capture-entry parameter), at any
  call depth (:mod:`kungfu_tpu_torch.analysis.jitpurity`).
* ``blocking-io``   — no timeout-less blocking calls in modules that run
  background threads (:mod:`kungfu_tpu_torch.analysis.blockingio`).
* ``lock-discipline`` — every write to a ``// guarded_by(<mutex>)``
  C++ field happens in a scope holding that mutex
  (:mod:`kungfu_tpu_torch.analysis.lockcheck`).
* ``retry-discipline`` — network retry loops bound their attempts and
  back off with jitter (:mod:`kungfu_tpu_torch.analysis.retrydiscipline`).
* ``handle-discipline`` — every ``*_async`` handle is waited on every
  path and never crosses a membership fence
  (:mod:`kungfu_tpu_torch.analysis.handlecheck`).
* ``trace-vocab``, ``agg-schema``, ``ledger-schema`` — timeline kinds,
  aggregator fields and decision-ledger fields are literals of their
  declared schemas (:mod:`~kungfu_tpu_torch.analysis.tracevocab`,
  :mod:`~kungfu_tpu_torch.analysis.aggschema`,
  :mod:`~kungfu_tpu_torch.analysis.ledgerschema`).

The interprocedural (kf-verify) rules, built on the shared project call
graph (:mod:`kungfu_tpu_torch.analysis.callgraph`):

* ``collective-consistency`` — every peer issues the same collectives
  under the same rendezvous names
  (:mod:`kungfu_tpu_torch.analysis.collectives`).
* ``wire-contract`` — the Python framing (:class:`HeaderCodec` in
  ``comm/host.py``) and the C++ decoder (``native/transport.cpp``) parse
  into one schema IR and must diff clean
  (:mod:`kungfu_tpu_torch.analysis.wirecontract`).
* ``lock-order`` — the cross-module Python lock-acquisition graph must
  be acyclic (:mod:`kungfu_tpu_torch.analysis.pylockorder`).
* ``proto-verify`` — the SPMD protocol verifier over every
  ``ParallelPlan`` geometry up to 16 ranks (extraction in
  :mod:`kungfu_tpu_torch.analysis.commgraph`, proof in
  :mod:`kungfu_tpu_torch.analysis.protoverify`); the tags it proves are
  the reference's wire tags.

The kf-shard rules, on the axis environment
(:mod:`kungfu_tpu_torch.analysis.axisenv`: the rank worlds of
``Mesh.world()``, ``Communicator.world()`` and ``rank_world([...])``,
the ``with <world>:`` contexts and capture scope, beside the
reference's jax idioms):

* ``shard-axis`` — every collective's literal axis is declared by a
  rank world and bound where the call runs
  (:mod:`kungfu_tpu_torch.analysis.shardaxis`).
* ``shard-spec`` — the port's ``PartitionSpec`` names declared axes,
  each once (:mod:`kungfu_tpu_torch.analysis.shardspec`).
* ``recompile-hazard`` — no membership constant (``device_count()``,
  ``os.environ``, ``len(peers)``, ``.rank()``) is frozen into a captured
  graph (:mod:`kungfu_tpu_torch.analysis.recompilehazard`).

The replay-determinism (kf-det) rules, on the interprocedural taint
engine (:mod:`kungfu_tpu_torch.analysis.taint`, rules in
:mod:`kungfu_tpu_torch.analysis.detrules`):

* ``replay-taint`` — entropy (clocks, unseeded RNG draws including
  ``torch``'s global generator, uuid, os entropy, set order) must not
  reach a replay-critical sink.
* ``rng-discipline`` — no process-global draw in capture scope, and
  ``manual_seed`` material derives from agreed values (the jax key
  checks are kept for jax code).
* ``reduction-order`` — no order-sensitive accumulation over unordered
  iteration in the bitwise-pinned directories.

This package is stdlib-only (no torch/numpy import) so
``scripts/kflint_torch`` runs in any environment, including bare CI
images; ``python -m kungfu_tpu_torch.analysis`` runs the same CLI.
"""

from kungfu_tpu_torch.analysis.core import Violation, repo_root
from kungfu_tpu_torch.analysis.cli import (
    CHECKERS,
    DET_CHECKERS,
    PROTO_CHECKERS,
    VERIFY_CHECKERS,
    run_checkers,
)

__all__ = ["Violation", "repo_root", "CHECKERS", "DET_CHECKERS",
           "PROTO_CHECKERS", "VERIFY_CHECKERS", "run_checkers"]
