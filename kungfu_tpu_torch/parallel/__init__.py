"""Model parallelism over co-resident stacked ranks: dp / pp / sp / tp
(+ ep over dp), and the data-parallel and ZeRO training steps.

Port of ``kungfu_tpu/parallel/__init__.py``: ``mesh.py`` (the four mesh
axes), ``tp.py`` (Megatron column/row products), ``ring.py`` (ring
attention over the flash kernels), ``moe.py`` (switch MoE with an
all-to-all over dp), ``pp.py`` (the stage and schedule geometry),
``train.py`` (``ParallelPlan``, the in-mesh 4-D ``ShardedTrainer``, the
data-parallel step) and ``zero.py`` (ZeRO stages 1-3 and the re-carve of
their state).
"""

from kungfu_tpu_torch.parallel.mesh import (AXES, AXIS_DP, AXIS_PP, AXIS_SP,
                                            AXIS_TP, MeshPlan)
from kungfu_tpu_torch.parallel.moe import moe_apply, moe_init
from kungfu_tpu_torch.parallel.ring import make_ring_attn, ring_attention
from kungfu_tpu_torch.parallel.tp import (column_dense, row_dense,
                                          tp_region_enter, tp_region_exit)
from kungfu_tpu_torch.parallel.train import (ParallelPlan, ShardedTrainer,
                                             dp_train_step)
from kungfu_tpu_torch.parallel.zero import (zero1_reshard, zero1_restore,
                                            zero1_snapshot, zero1_train_step)

__all__ = [
    "AXES",
    "AXIS_DP",
    "AXIS_PP",
    "AXIS_SP",
    "AXIS_TP",
    "MeshPlan",
    "ParallelPlan",
    "ShardedTrainer",
    "zero1_reshard",
    "zero1_restore",
    "zero1_snapshot",
    "zero1_train_step",
    "column_dense",
    "row_dense",
    "make_ring_attn",
    "moe_apply",
    "moe_init",
    "ring_attention",
    "tp_region_enter",
    "tp_region_exit",
]
