"""Models of the port on the functional layers of :mod:`.nn`: the
flagship transformer (``transformer.py``), ResNet-50/101/152
(``resnet.py``), VGG-11/16/19 (``vgg.py``), the MNIST SLP/MLP
(``mlp.py``) and the gradient-shaped fake models (``fake.py``); the
exports of ``kungfu_tpu/models/__init__.py``."""

from kungfu_tpu_torch.models import nn
from kungfu_tpu_torch.models.fake import fake_grads, fake_model_sizes
from kungfu_tpu_torch.models.mlp import MLP, mnist_slp
from kungfu_tpu_torch.models.resnet import ResNet, resnet50
from kungfu_tpu_torch.models.transformer import (Transformer,
                                                 TransformerConfig,
                                                 bert_base, gpt_small)
from kungfu_tpu_torch.models.vgg import VGG, vgg16

__all__ = [
    "nn",
    "MLP",
    "mnist_slp",
    "ResNet",
    "resnet50",
    "VGG",
    "vgg16",
    "Transformer",
    "TransformerConfig",
    "bert_base",
    "gpt_small",
    "fake_model_sizes",
    "fake_grads",
]
