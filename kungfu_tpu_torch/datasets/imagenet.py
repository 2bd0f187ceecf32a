"""ImageNet folder pipeline: lazy JPEG decode, standard augmentation,
elastic sharding.

Parity with the reference's ImageNet helper
(``srcs/python/kungfu/tensorflow/v1/helpers/imagenet.py`` — TFRecord
parse + random-crop/flip train pipeline feeding ResNet).  TPU-build
shape: the input is the standard ImageNet directory layout
(``<root>/<split>/<wnid>/*.JPEG``), decoding is lazy (per batch, PIL),
and the shard/offset machinery is COMPOSED from
:class:`~kungfu_tpu_torch.datasets.adaptor.ElasticDataset` over the sample
indices — so the pipeline inherits resize-surviving elastic semantics
(``set_cluster``/``skip``/``sync_consumed``) instead of reimplementing
them.

No download: ImageNet is license-gated, so there is nothing to pin or
fetch.  Without a dataset directory the loader falls back to a
deterministic synthetic set (loudly), like the MNIST/CIFAR helpers.

Transforms (the standard ResNet recipe):

* train: random-resized crop (scale 0.08–1, ratio 3/4–4/3) → ``size²``,
  random horizontal flip;
* eval: resize short side by 256/224 (256 for size 224), center crop.

Both return float32 NHWC normalized with the ImageNet mean/std.

Copy of ``kungfu_tpu/datasets/imagenet.py``: the scan, decode,
augmentation and synthetic set are the reference's, so the images and
labels are bitwise its arrays for the same seed, rank and size.
``next_batch`` returns them as tensors on the folder's ``device``
(default ``cuda``; raises without a GPU unless ``device="cpu"``).  A
pipeline that overlaps the copy with the step keeps the folder on
``"cpu"`` and stages with
:func:`~kungfu_tpu_torch.datasets.prefetch.prefetch_to_device`.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from kungfu_tpu_torch.datasets.adaptor import ElasticDataset
from kungfu_tpu_torch.datasets.cache import DATA_DIR_ENV, cache_dir  # noqa: F401
from kungfu_tpu_torch.utils.device import resolve_device
from kungfu_tpu_torch.utils.log import get_logger

_log = get_logger("imagenet")

MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


def default_root() -> str:
    return cache_dir("imagenet")


def _scan(split_dir: str) -> Tuple[List[str], np.ndarray, List[str]]:
    """(paths, labels, class_names) from ``<split_dir>/<class>/<img>``."""
    classes = sorted(
        d for d in os.listdir(split_dir)
        if os.path.isdir(os.path.join(split_dir, d))
    )
    paths: List[str] = []
    labels: List[int] = []
    exts = (".jpeg", ".jpg", ".png")
    for li, c in enumerate(classes):
        cdir = os.path.join(split_dir, c)
        for f in sorted(os.listdir(cdir)):
            if f.lower().endswith(exts):
                paths.append(os.path.join(cdir, f))
                labels.append(li)
    return paths, np.asarray(labels, np.int32), classes


class ImageNetFolder:
    """Elastic, lazily-decoded image-folder dataset.

    The same surface the examples use on :class:`ElasticDataset` —
    ``next_batch()``, ``set_cluster(rank, size)``, ``skip(consumed)``,
    ``sync_consumed(peer)`` — with decode+augment happening per batch.
    """

    def __init__(
        self,
        root: Optional[str] = None,
        split: str = "train",
        image_size: int = 224,
        batch_size: int = 32,
        rank: int = 0,
        size: int = 1,
        seed: int = 0,
        train_transform: Optional[bool] = None,
        synthetic_fallback: bool = True,
        n_synthetic: int = 1024,
        synthetic_classes: int = 1000,
        device=None,
    ):
        self.device = resolve_device(device)
        self.image_size = image_size
        self.train_transform = (
            split == "train" if train_transform is None else train_transform
        )
        self.seed = seed
        root = root or default_root()
        split_dir = os.path.join(root, split)
        self._synthetic = None
        if os.path.isdir(split_dir):
            self.paths, self.labels, self.classes = _scan(split_dir)
            if not self.paths:
                raise ValueError(f"no images under {split_dir}")
        elif synthetic_fallback:
            _log.warning(
                "no ImageNet at %s — using a deterministic SYNTHETIC set; "
                "results are not comparable to real ImageNet", split_dir,
            )
            rng = np.random.default_rng(seed)
            self._synthetic = rng.normal(
                size=(synthetic_classes, 8, 8, 3)
            ).astype(np.float32)  # low-res class templates, upsampled on read
            self.paths = [f"synthetic://{i}" for i in range(n_synthetic)]
            split_salt = sum(ord(c) for c in split)
            self.labels = np.random.default_rng((seed, split_salt)).integers(
                0, synthetic_classes, n_synthetic
            ).astype(np.int32)
            self.classes = [f"class{i}" for i in range(synthetic_classes)]
        else:
            raise OSError(f"no ImageNet directory at {split_dir}")
        # sharding/offset machinery: ElasticDataset over the INDICES
        self._index = ElasticDataset(
            [np.arange(len(self.paths), dtype=np.int64)],
            batch_size, rank=rank, size=size, seed=seed,
        )

    # -- elastic surface (delegated) --------------------------------------
    def set_cluster(self, rank: int, size: int) -> None:
        self._index.set_cluster(rank, size)

    def skip(self, consumed: int) -> None:
        self._index.skip(consumed)

    def sync_consumed(self, peer) -> int:
        return self._index.sync_consumed(peer)

    @property
    def consumed(self) -> int:
        return self._index.consumed

    def batches_per_epoch(self) -> int:
        return self._index.batches_per_epoch()

    def __len__(self) -> int:
        return len(self.paths)

    # -- decode + transform ------------------------------------------------
    def _load(self, path: str, rng: np.random.Generator) -> np.ndarray:
        s = self.image_size
        if self._synthetic is not None:
            idx = int(path.split("://")[1])
            t = self._synthetic[self.labels[idx] % len(self._synthetic)]
            # nearest-neighbor upsample to EXACTLY s x s for any s (kron
            # with s//8 tiles silently truncated non-multiples of 8)
            ix = (np.arange(s) * t.shape[0]) // s
            img = t[ix][:, ix]
            img = img * 0.3 + rng.normal(size=img.shape).astype(np.float32) * 0.1
            return np.clip(img * 0.5 + 0.5, 0.0, 1.0)
        from PIL import Image

        with Image.open(path) as im:
            im = im.convert("RGB")
            w, h = im.size
            if self.train_transform:
                # random-resized crop: standard scale/ratio jitter
                for _ in range(10):
                    area = w * h * rng.uniform(0.08, 1.0)
                    ratio = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
                    cw = int(round(np.sqrt(area * ratio)))
                    ch = int(round(np.sqrt(area / ratio)))
                    if 0 < cw <= w and 0 < ch <= h:
                        x0 = int(rng.integers(0, w - cw + 1))
                        y0 = int(rng.integers(0, h - ch + 1))
                        im = im.resize((s, s), Image.BILINEAR,
                                       box=(x0, y0, x0 + cw, y0 + ch))
                        break
                else:
                    im = im.resize((s, s), Image.BILINEAR)
                if rng.random() < 0.5:
                    im = im.transpose(Image.FLIP_LEFT_RIGHT)
            else:
                short = int(round(s * 256 / 224))  # the standard 224->256 ratio
                scale = short / min(w, h)
                im = im.resize(
                    (max(s, int(round(w * scale))), max(s, int(round(h * scale)))),
                    Image.BILINEAR,
                )
                w2, h2 = im.size
                x0, y0 = (w2 - s) // 2, (h2 - s) // 2
                im = im.crop((x0, y0, x0 + s, y0 + s))
            return np.asarray(im, np.float32) / 255.0

    def next_batch(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(images [b, s, s, 3] float32 normalized, labels [b] int32) on
        the folder's device."""
        offset = self._index.consumed
        (idxs,) = self._index.next_batch()
        # per-batch rng: deterministic given (seed, global offset) so
        # restarts replay identical augmentations
        rng = np.random.default_rng((self.seed, offset))
        imgs = np.stack([self._load(self.paths[int(i)], rng) for i in idxs])
        imgs = ((imgs - MEAN) / STD).astype(np.float32)
        return (torch.from_numpy(imgs).to(self.device),
                torch.from_numpy(self.labels[idxs]).to(self.device))
