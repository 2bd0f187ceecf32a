"""kf-lint and kf-verify over the port's tree (port of
``kungfu_tpu/analysis/``, part 1).

Twelve AST/structural checkers enforce the invariants of the reference's
catalog (``docs/lint.md``) over ``kungfu_tpu_torch/``, ``chip_smoke.py``
and the port's timing scripts.  The messages are the reference's; they
name the port's paths.

The single-function and schema rules:

* ``env-contract``  — every ``KF_*`` env read (Python and C++) appears in
  the :mod:`kungfu_tpu_torch.utils.envs` registry, and every registry
  entry has a reader (:mod:`kungfu_tpu_torch.analysis.envcheck`).
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

The reference's axis-environment rules (jit-sync, shard-axis,
shard-spec, recompile-hazard) and kf-det (replay-taint, rng-discipline,
reduction-order) are part 2; asking for one exits 2 and names its
ROADMAP item (:data:`kungfu_tpu_torch.analysis.cli.PART2_CHECKERS`).

This package is stdlib-only (no torch/numpy import) so
``scripts/kflint_torch`` runs in any environment, including bare CI
images; ``python -m kungfu_tpu_torch.analysis`` runs the same CLI.
"""

from kungfu_tpu_torch.analysis.core import Violation, repo_root
from kungfu_tpu_torch.analysis.cli import (
    CHECKERS,
    PART2_CHECKERS,
    PROTO_CHECKERS,
    VERIFY_CHECKERS,
    run_checkers,
)

__all__ = ["Violation", "repo_root", "CHECKERS", "PART2_CHECKERS",
           "PROTO_CHECKERS", "VERIFY_CHECKERS", "run_checkers"]
