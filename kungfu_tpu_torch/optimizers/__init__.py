"""Distributed optimizers over the functional optax subset
(``_transform.py``), under the reference's names
(``kungfu_tpu/optimizers/__init__.py:39-54``):

* :func:`synchronous_sgd` — allreduce-mean gradients, then ``inner``;
* :func:`synchronous_averaging` — SMA: average the weights, pull each
  replica towards the average, apply local gradients;
* :func:`adaptive_sgd` — SMA before ``change_step``, S-SGD after;
* :func:`monitor_gradient_noise_scale` / :func:`monitor_gradient_variance`
  — S-SGD whose state carries a training statistic;
* :class:`PairAveragingOptimizer` — AD-PSGD gossip: pull a peer's fused
  model from its versioned store over the host channel, average
  0.5/0.5, apply local gradients, publish;
* :class:`AsyncPairAveragingOptimizer` — the same with the pull off the
  critical path: a background thread keeps a triple-buffered receive in
  flight, and the step averages with the last landed model.
"""

from kungfu_tpu_torch.optimizers._transform import (GradientTransformation,
                                                    adam, adamw,
                                                    apply_updates, chain,
                                                    scale_by_adam, sgd)
from kungfu_tpu_torch.optimizers.ada_sgd import AdaptiveSGDState, adaptive_sgd
from kungfu_tpu_torch.optimizers.async_sgd import (
    AsyncPairAveragingOptimizer, PairAveragingOptimizer)
from kungfu_tpu_torch.optimizers.monitors import (
    GNSState, GradVarianceState, monitor_gradient_noise_scale,
    monitor_gradient_variance)
from kungfu_tpu_torch.optimizers.sma_sgd import synchronous_averaging
from kungfu_tpu_torch.optimizers.sync_sgd import synchronous_sgd

__all__ = ["GradientTransformation", "adam", "adamw", "apply_updates",
           "chain", "scale_by_adam", "sgd", "synchronous_sgd",
           "synchronous_averaging", "adaptive_sgd", "AdaptiveSGDState",
           "PairAveragingOptimizer", "AsyncPairAveragingOptimizer",
           "monitor_gradient_noise_scale", "monitor_gradient_variance",
           "GNSState", "GradVarianceState"]
