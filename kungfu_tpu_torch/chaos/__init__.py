"""Deterministic, seedable fault injection (copy of ``kungfu_tpu/chaos/``).

Faults are injected at exact, reproducible points (the Nth collective,
the Nth send, an announced step) controlled by two env vars:

``KF_CHAOS_SPEC``
    The fault clauses (grammar in :mod:`kungfu_tpu_torch.chaos.spec`).
    Unset ⇒ every hook is a ``None``-check no-op and the wire behavior
    is byte-identical to an injection-free build.
``KF_CHAOS_SEED``
    Seeds the (only) randomized perturbation, delay jitter.

Hook sites in the port: the collective engine's send/recv and
collective entry (:mod:`kungfu_tpu_torch.comm.engine`), the Python host
channel's frame writer
(:meth:`~kungfu_tpu_torch.comm.host.PyHostChannel.chaos_partial_send`),
and the train loop's step announcement (:func:`note_step`).  The
reference's other sites (the failure detector's fan-out, the elastic
config fetch, the serving worker) come with their modules.
"""

from kungfu_tpu_torch.chaos.inject import (
    DIE_EXIT_CODE,
    ChaosController,
    InjectedDeath,
    InjectedReset,
    SEED_ENV,
    SPEC_ENV,
    controller_for,
    note_step,
    reset,
)
from kungfu_tpu_torch.chaos.spec import Clause, parse_spec

__all__ = [
    "DIE_EXIT_CODE",
    "ChaosController",
    "Clause",
    "InjectedDeath",
    "InjectedReset",
    "SEED_ENV",
    "SPEC_ENV",
    "controller_for",
    "note_step",
    "parse_spec",
    "reset",
]
