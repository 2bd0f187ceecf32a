"""Drive policies around a training loop and execute their intents.

Copy of ``kungfu_tpu/policy/runner.py``, the PolicyHook analog
(reference ``policy/policy_hook.py:8-77``): it wraps a set of
:class:`~kungfu_tpu_torch.policy.base.BasePolicy` objects, keeps the
named training globals (batch size, trained samples, GNS), and on
``after_step`` executes a resize intent through the elastic protocol:
propose to the config server, run the consensus resize, re-broadcast the
parameters over the host channel
(:func:`~kungfu_tpu_torch.initializer.broadcast_parameters`), stop when
detached.  Without a channel or config server it runs the callbacks
only.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

from kungfu_tpu_torch.elastic.hooks import sync_step
from kungfu_tpu_torch.initializer import broadcast_parameters
from kungfu_tpu_torch.policy.base import BasePolicy, PolicyContext
from kungfu_tpu_torch.utils.log import get_logger, log_event

_log = get_logger("policy")


class PolicyRunner:
    def __init__(
        self,
        policies: Iterable[BasePolicy],
        peer=None,
        batch_size: int = 0,
    ):
        self.policies = list(policies)
        self.peer = peer
        self.ctx = PolicyContext(
            batch_size=batch_size,
            cluster_size=peer.size() if peer is not None else 1,
        )
        #: resize intent awaiting the NEXT step's fused step-sync/unanimity
        #: collective (multi-worker mode defers execution by one step so
        #: the whole control plane costs ONE small allreduce per step)
        self._pending_target: Optional[int] = None

    # -- lifecycle callbacks (reference before/after train/epoch) --------
    def before_train(self) -> None:
        for p in self.policies:
            p.before_train(self.ctx)

    def after_train(self) -> None:
        for p in self.policies:
            p.after_train(self.ctx)

    def before_epoch(self) -> None:
        for p in self.policies:
            p.before_epoch(self.ctx)
        self.ctx.epoch += 1

    def after_epoch(self) -> None:
        for p in self.policies:
            p.after_epoch(self.ctx)

    def before_step(self) -> None:
        for p in self.policies:
            p.before_step(self.ctx)

    # -- the per-step driver ---------------------------------------------
    def after_step(
        self,
        params=None,
        gradient_noise_scale: Optional[float] = None,
        gradient_variance: Optional[float] = None,
        **metrics: float,
    ) -> Tuple[object, bool]:
        """Run after each optimizer step.  Returns ``(params, stop)``;
        ``params`` are re-broadcast from rank 0 when membership changed.

        Multi-worker resize intents execute ONE STEP after the policy
        raises them: the step-sync collective that opens each call also
        carries the previous step's intent, fencing unanimity (divergent
        per-rank monitor values must not let one rank start a resize the
        others won't join — that deadlocks their consensus) without a
        second control-plane round trip."""
        ctx = self.ctx
        agreed: Optional[int] = None
        engine = self.peer.engine() if self.peer is not None else None
        if engine is not None and self.peer.size() > 1:
            # fused control op (same ordering slot as elastic_step's
            # sync_step — each step's single engine control collective):
            # [step, enc, -enc] under MAX gives the global step plus the
            # unanimity check (max enc == -max(-enc) iff all ranks agree)
            import numpy as np

            enc = -1 if self._pending_target is None else int(self._pending_target)
            out = engine.all_reduce(
                np.array([ctx.step, enc, -enc], np.int64), op="max",
                record=False,
            )
            ctx.step = int(out[0])
            hi, lo = int(out[1]), -int(out[2])
            if hi != lo:
                _log.warning(
                    "ranks disagree on the resize target (%d..%d) — "
                    "dropping the intent", lo, hi,
                )
            elif hi != -1:
                agreed = hi
            self._pending_target = None
        elif self.peer is not None:
            ctx.step = sync_step(self.peer, ctx.step)
            agreed, self._pending_target = self._pending_target, None
        ctx.step += 1
        ctx.trained_samples += ctx.batch_size * ctx.cluster_size
        if gradient_noise_scale is not None:
            ctx.gradient_noise_scale = float(gradient_noise_scale)
        if gradient_variance is not None:
            ctx.gradient_variance = float(gradient_variance)
        ctx.metrics.update(metrics)

        for p in self.policies:
            p.after_step(ctx)

        stop = ctx.stop_requested
        intent, ctx.requested_size, ctx.stop_requested = (
            ctx.requested_size, None, False,
        )
        if self.peer is None:
            return params, stop
        # this step's intent rides the NEXT step's fused collective
        if intent is not None:
            self._pending_target = int(intent)

        peer = self.peer
        target = agreed
        if target is None:
            return params, stop
        if target == peer.size():
            return params, stop
        if not peer.config.config_server:
            _log.warning("policy requested size %d but no config server", target)
            return params, stop
        log_event(f"policy-resize-{peer.size()}->{target}-at-step-{ctx.step}")
        peer.propose_new_size(target)
        changed = peer.resize_cluster_from_url()
        if changed:
            if peer.detached:
                log_event("policy-detached-stopping")
                return params, True
            ctx.cluster_size = peer.size()
            if params is not None:
                # host-channel broadcast only — NO engine collective after a
                # resize (elastic/hooks.py's alignment invariant: the
                # new epoch's first engine op must be the next step's gradient
                # allreduce on every member; step alignment happens at the top
                # of the next after_step via sync_step)
                params = broadcast_parameters(params, peer)
        return params, stop
