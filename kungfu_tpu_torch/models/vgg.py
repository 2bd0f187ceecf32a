"""VGG (11/16/19): NHWC activations, HWIO weights, bf16 compute over
f32 parameters.

Port of ``kungfu_tpu/models/vgg.py``: 3x3 conv stacks and 2x2 max
pools, the batch-norm variant included, a global-average-pooled head
(``fc1`` of ``hidden`` units, then ``head``).  Parameters and batch-norm
state are keyed like the reference's pytrees (``conv0/w``,
``conv0_bn/scale``, ``fc1/w``, ``head/w``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from kungfu_tpu_torch.models import nn
from kungfu_tpu_torch.models.resnet import Spec, nll
from kungfu_tpu_torch.utils.device import resolve_device

# channels per conv layer, "M" = 2x2 maxpool (the classic configurations)
_CFGS = {
    11: (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    16: (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
         512, 512, 512, "M", 512, 512, 512, "M"),
    19: (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512, "M"),
}


def _maxpool2x2(x: torch.Tensor) -> torch.Tensor:
    """``reduce_window`` max, 2x2 window and stride, ``"VALID"``."""
    return nn.max_pool(x, 2, 2, "VALID")


class VGG:
    def __init__(self, depth: int = 16, num_classes: int = 1000,
                 batch_norm: bool = True, hidden: int = 4096):
        if depth not in _CFGS:
            raise ValueError(f"depth must be one of {sorted(_CFGS)}")
        self.cfg = _CFGS[depth]
        self.num_classes = num_classes
        self.batch_norm = batch_norm
        self.hidden = hidden

    # -- init ------------------------------------------------------------
    def param_spec(self) -> Tuple[Spec, Spec]:
        """``(params, bn_state)`` as ``[(path, shape, kind)]``; bn_state
        is empty without batch norm."""
        params: Spec = []
        state: Spec = []
        in_ch, li = 3, 0
        for c in self.cfg:
            if c == "M":
                continue
            name = f"conv{li}"
            params.append((f"{name}/w", (3, 3, in_ch, c), "he"))
            if self.batch_norm:
                params += [(f"{name}_bn/scale", (c,), "ones"),
                           (f"{name}_bn/bias", (c,), "zeros")]
                state += [(f"{name}_bn/mean", (c,), "zeros"),
                          (f"{name}_bn/var", (c,), "ones")]
            else:
                params.append((f"{name}/b", (c,), "zeros"))
            in_ch = c
            li += 1
        params += [("fc1/w", (in_ch, self.hidden), "glorot"),
                   ("fc1/b", (self.hidden,), "zeros"),
                   ("head/w", (self.hidden, self.num_classes), "glorot"),
                   ("head/b", (self.num_classes,), "zeros")]
        return params, state

    def init(self, generator: Optional[torch.Generator] = None,
             device=None) -> Tuple[dict, dict]:
        """``(params, bn_state)``: f32, drawn on the CPU from
        ``generator`` (default: seed 0), then moved to ``device``
        (default ``cuda``; raises without a GPU unless ``device="cpu"``)."""
        dev = resolve_device(device)
        gen = generator or torch.Generator().manual_seed(0)
        pspec, sspec = self.param_spec()
        return (nn.init_from_spec(pspec, gen, dev),
                nn.init_from_spec(sspec, gen, dev))

    # -- apply -----------------------------------------------------------
    def apply(self, params, state, x: torch.Tensor, train: bool = False,
              dtype: torch.dtype = torch.bfloat16, axis_name=None):
        """x: ``[N, H, W, 3]`` float.  Returns ``(logits f32,
        new_state)``."""
        new_state = {}
        h = x.to(params["fc1"]["w"].device, dtype)
        li = 0
        for c in self.cfg:
            if c == "M":
                h = _maxpool2x2(h)
                continue
            name = f"conv{li}"
            h = nn.conv_apply(params[name], h, dtype=dtype)
            if self.batch_norm:
                h, new_state[f"{name}_bn"] = nn.batchnorm_apply(
                    params[f"{name}_bn"], state[f"{name}_bn"], h, train,
                    axis_name=axis_name)
            h = torch.relu(h)
            li += 1
        h = h.float().mean(dim=(-3, -2))  # GAP
        h = torch.relu(nn.dense_apply(params["fc1"], h))
        logits = nn.dense_apply(params["head"], h)
        return logits, new_state

    def loss(self, params, state, batch, train: bool = True,
             dtype: torch.dtype = torch.bfloat16, axis_name=None):
        x, y = batch
        logits, new_state = self.apply(params, state, x, train=train,
                                       dtype=dtype, axis_name=axis_name)
        return nll(logits, y), new_state


def vgg16(num_classes: int = 1000) -> VGG:
    return VGG(16, num_classes)
