"""ResNet v1.5 (50/101/152): NHWC activations, HWIO weights, bf16
compute over f32 parameters.

Port of ``kungfu_tpu/models/resnet.py``: bottleneck v1.5 (the stride in
the 3x3), the space-to-depth stem, sync-BN capable.  Parameters and
batch-norm state are plain nested dicts keyed like the reference's
pytrees (``stem/w``, ``s0b0/conv1/w``, ``s0b0/bn1/scale``, ``head/w``),
so :func:`kungfu_tpu_torch.interop.image_params_from_jax` carries them
across unchanged.  ``apply`` and ``loss`` are differentiable in the
parameters.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from kungfu_tpu_torch.models import nn
from kungfu_tpu_torch.utils.device import resolve_device

_STAGES = {
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}

Spec = List[Tuple[str, tuple, str]]


def _conv(spec: Spec, path: str, kernel, in_ch: int, out_ch: int) -> None:
    spec.append((f"{path}/w", tuple(kernel) + (in_ch, out_ch), "he"))


def _bn(spec: Spec, state: Spec, path: str, ch: int) -> None:
    spec += [(f"{path}/scale", (ch,), "ones"), (f"{path}/bias", (ch,), "zeros")]
    state += [(f"{path}/mean", (ch,), "zeros"), (f"{path}/var", (ch,), "ones")]


def nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` under ``log_softmax``
    of the f32 ``logits`` (the image models' loss)."""
    logp = F.log_softmax(logits, dim=-1)
    idx = labels.to(logits.device, torch.long)[..., None]
    return -logp.gather(-1, idx).squeeze(-1).mean()


def bottleneck(blk, bst, h: torch.Tensor, stride: int = 1,
               train: bool = False, dtype: torch.dtype = torch.bfloat16,
               axis_name=None):
    """One bottleneck v1.5 block (1x1, 3x3 with the stride, 1x1, and the
    projection where ``blk`` has one): ``(relu(y + shortcut),
    new_bn_state)``."""
    nst = {}
    shortcut = h
    y = nn.conv_apply(blk["conv1"], h, dtype=dtype)
    y, nst["bn1"] = nn.batchnorm_apply(blk["bn1"], bst["bn1"], y, train,
                                       axis_name=axis_name)
    y = torch.relu(y)
    y = nn.conv_apply(blk["conv2"], y, stride=stride, dtype=dtype)
    y, nst["bn2"] = nn.batchnorm_apply(blk["bn2"], bst["bn2"], y, train,
                                       axis_name=axis_name)
    y = torch.relu(y)
    y = nn.conv_apply(blk["conv3"], y, dtype=dtype)
    y, nst["bn3"] = nn.batchnorm_apply(blk["bn3"], bst["bn3"], y, train,
                                       axis_name=axis_name)
    if "proj" in blk:
        shortcut = nn.conv_apply(blk["proj"], h, stride=stride, dtype=dtype)
        shortcut, nst["proj_bn"] = nn.batchnorm_apply(
            blk["proj_bn"], bst["proj_bn"], shortcut, train,
            axis_name=axis_name)
    return torch.relu(y + shortcut), nst


class ResNet:
    def __init__(self, depth: int = 50, num_classes: int = 1000,
                 width: int = 64):
        if depth not in _STAGES:
            raise ValueError(f"depth must be one of {sorted(_STAGES)}")
        self.blocks_per_stage = _STAGES[depth]
        self.num_classes = num_classes
        self.width = width

    # -- init ------------------------------------------------------------
    def param_spec(self) -> Tuple[Spec, Spec]:
        """``(params, bn_state)`` as ``[(path, shape, kind)]``: the
        reference's tree, shapes only (the parameter count needs no
        draw)."""
        params: Spec = []
        state: Spec = []
        _conv(params, "stem", (7, 7), 3, self.width)
        _bn(params, state, "stem_bn", self.width)
        in_ch = self.width
        for s, nblocks in enumerate(self.blocks_per_stage):
            mid = self.width * (2 ** s)
            out_ch = mid * 4
            for b in range(nblocks):
                name = f"s{s}b{b}"
                _conv(params, f"{name}/conv1", (1, 1), in_ch, mid)
                _bn(params, state, f"{name}/bn1", mid)
                _conv(params, f"{name}/conv2", (3, 3), mid, mid)
                _bn(params, state, f"{name}/bn2", mid)
                _conv(params, f"{name}/conv3", (1, 1), mid, out_ch)
                _bn(params, state, f"{name}/bn3", out_ch)
                if b == 0:
                    _conv(params, f"{name}/proj", (1, 1), in_ch, out_ch)
                    _bn(params, state, f"{name}/proj_bn", out_ch)
                in_ch = out_ch
        params += [("head/w", (in_ch, self.num_classes), "glorot"),
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
        """x: ``[N, H, W, 3]`` float (or ``[n, N, H, W, 3]`` stacked for
        sync-BN over ``axis_name`` in a rank world).  Returns ``(logits
        f32, new_state)``."""
        new_state = {}
        x = x.to(params["stem"]["w"].device, dtype)

        # space-to-depth stem: the same linear map as the 7x7/s2 conv
        h = nn.conv_stem_s2d_apply(params["stem"], x, dtype=dtype)
        h, new_state["stem_bn"] = nn.batchnorm_apply(
            params["stem_bn"], state["stem_bn"], h, train,
            axis_name=axis_name)
        h = nn.max_pool(torch.relu(h), 3, 2, "SAME")

        for s, nblocks in enumerate(self.blocks_per_stage):
            for b in range(nblocks):
                name = f"s{s}b{b}"
                stride = 2 if (b == 0 and s > 0) else 1
                h, new_state[name] = bottleneck(
                    params[name], state[name], h, stride, train, dtype,
                    axis_name)

        h = h.float().mean(dim=(-3, -2))
        logits = nn.dense_apply(params["head"], h)
        return logits, new_state

    def loss(self, params, state, batch, train: bool = True,
             dtype: torch.dtype = torch.bfloat16, axis_name=None):
        x, y = batch
        logits, new_state = self.apply(params, state, x, train=train,
                                       dtype=dtype, axis_name=axis_name)
        return nll(logits, y), new_state


def resnet50(num_classes: int = 1000) -> ResNet:
    return ResNet(50, num_classes)
