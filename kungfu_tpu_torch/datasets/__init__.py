"""The data plane: the elastic dataset adaptor, the MNIST, CIFAR-10 and
ImageNet-folder readers with their synthetic fallbacks, and device
prefetch (port of ``kungfu_tpu/datasets/``)."""

from kungfu_tpu_torch.datasets.adaptor import ElasticDataset  # noqa: F401
from kungfu_tpu_torch.datasets.cifar import load_cifar10  # noqa: F401
from kungfu_tpu_torch.datasets.imagenet import ImageNetFolder  # noqa: F401
from kungfu_tpu_torch.datasets.mnist import load_mnist, synthetic_mnist  # noqa: F401
from kungfu_tpu_torch.datasets.prefetch import prefetch_to_device  # noqa: F401
