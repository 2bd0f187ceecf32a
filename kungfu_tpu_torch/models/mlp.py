"""MNIST SLP / MLP: the minimum end-to-end model.

Port of ``kungfu_tpu/models/mlp.py`` (the reference's canonical example
workload, the single-layer perceptron of ``examples/tf1_mnist_session.py``).
Parameters are keyed ``dense_{i}/w`` and ``dense_{i}/b``, as the
reference's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from kungfu_tpu_torch.models import nn
from kungfu_tpu_torch.models.resnet import nll
from kungfu_tpu_torch.utils.device import resolve_device


class MLP:
    """Plain MLP: flatten -> dense(+relu)* -> dense(logits)."""

    def __init__(self, layer_dims: Sequence[int], num_classes: int = 10,
                 input_dim: int = 784):
        self.dims = [input_dim] + list(layer_dims) + [num_classes]

    def param_spec(self):
        spec = []
        for i in range(len(self.dims) - 1):
            spec += [(f"dense_{i}/w", (self.dims[i], self.dims[i + 1]),
                      "glorot"),
                     (f"dense_{i}/b", (self.dims[i + 1],), "zeros")]
        return spec

    def init(self, generator: Optional[torch.Generator] = None,
             device=None) -> dict:
        """f32 parameters drawn on the CPU from ``generator`` (default:
        seed 0), then moved to ``device`` (default ``cuda``; raises
        without a GPU unless ``device="cpu"``)."""
        gen = generator or torch.Generator().manual_seed(0)
        return nn.init_from_spec(self.param_spec(), gen,
                                 resolve_device(device))

    def apply(self, params, x: torch.Tensor,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        x = x.to(params["dense_0"]["w"].device).reshape(x.shape[0], -1)
        if dtype is not None:
            x = x.to(dtype)
        n = len(self.dims) - 1
        for i in range(n):
            x = nn.dense_apply(params[f"dense_{i}"], x, dtype=dtype)
            if i < n - 1:
                x = torch.relu(x)
        return x.float()

    def loss(self, params, batch, dtype: Optional[torch.dtype] = None
             ) -> torch.Tensor:
        """Softmax cross-entropy mean loss; batch = (images, int labels)."""
        x, y = batch
        return nll(self.apply(params, x, dtype=dtype), y)

    def accuracy(self, params, batch, dtype: Optional[torch.dtype] = None
                 ) -> torch.Tensor:
        x, y = batch
        pred = self.apply(params, x, dtype=dtype).argmax(-1)
        return (pred == y.to(pred.device)).float().mean()


def mnist_slp() -> MLP:
    """Single-layer perceptron 784 -> 10 (the reference example's model)."""
    return MLP(layer_dims=[], num_classes=10, input_dim=784)
