"""Real CIFAR-10 loader: cache-or-download, hash-pinned, synthetic fallback.

Parity with the reference's dataset helpers
(``srcs/python/kungfu/tensorflow/v1/helpers/cifar.py`` — downloads the
CIFAR archive and feeds it to the examples/benchmarks).  Same TPU-build
hardening as :mod:`kungfu_tpu_torch.datasets.mnist`:

* the archive is verified against a pinned SHA-256 before use;
* air-gapped environments fall back to a deterministic synthetic set with
  a loud warning (``synthetic_fallback=False`` restores strict behavior).

Cache layout: ``$KF_DATA_DIR`` (default ``~/.cache/kungfu_tpu``)
``/cifar10/cifar-10-python.tar.gz``.

Copy of ``kungfu_tpu/datasets/cifar.py``: the same pin, reader and
synthetic set, bit for bit.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import tarfile
import urllib.request
from typing import Tuple

import numpy as np

from kungfu_tpu_torch.utils.log import get_logger

_log = get_logger("cifar")

from kungfu_tpu_torch.datasets.cache import DATA_DIR_ENV  # noqa: F401

ARCHIVE = "cifar-10-python.tar.gz"
#: canonical archive digest (stable since 2009)
ARCHIVE_SHA256 = "6d958be074577803d12ecdefd02955f39262c83c16fe9348329d7fe0b5c001ce"

MIRRORS = (
    "https://www.cs.toronto.edu/~kriz/",
    "https://ossci-datasets.s3.amazonaws.com/cifar/",
)

NUM_CLASSES = 10
IMAGE_SHAPE = (32, 32, 3)


def data_dir() -> str:
    from kungfu_tpu_torch.datasets.cache import cache_dir

    return cache_dir("cifar10")


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _fetch(dest: str, timeout: float) -> bool:
    for mirror in MIRRORS:
        try:
            tmp = dest + ".part"
            with urllib.request.urlopen(mirror + ARCHIVE, timeout=timeout) as r, open(
                tmp, "wb"
            ) as f:
                for block in iter(lambda: r.read(1 << 20), b""):
                    f.write(block)
            os.replace(tmp, dest)
            return True
        except OSError as e:
            _log.debug("mirror %s failed: %s", mirror, e)
    return False


def _read_batches(archive_path: str):
    """Extract (train_x, train_y, test_x, test_y) uint8 arrays from the
    tar without unpacking it to disk."""
    train_x, train_y = [], []
    test_x = test_y = None
    with tarfile.open(archive_path, "r:gz") as tf:
        for member in tf.getmembers():
            name = os.path.basename(member.name)
            if not (name.startswith("data_batch_") or name == "test_batch"):
                continue
            f = tf.extractfile(member)
            if f is None:
                continue
            d = pickle.load(f, encoding="bytes")
            x = np.asarray(d[b"data"], np.uint8).reshape(-1, 3, 32, 32)
            x = x.transpose(0, 2, 3, 1)  # NCHW on disk -> NHWC for TPU convs
            y = np.asarray(d[b"labels"], np.int32)
            if name == "test_batch":
                test_x, test_y = x, y
            else:
                train_x.append((name, x))
                train_y.append((name, y))
    if len(train_x) != 5 or test_x is None:
        raise ValueError(f"{archive_path}: incomplete CIFAR-10 archive")
    train_x.sort()
    train_y.sort()
    return (
        np.concatenate([x for _, x in train_x]),
        np.concatenate([y for _, y in train_y]),
        test_x,
        test_y,
    )


def _synthetic(n_train: int, n_test: int, seed: int = 0):
    """Deterministic class-conditioned blobs: each class gets a fixed
    random color/texture template plus noise — linearly separable enough
    for convergence tests, shaped exactly like the real set."""
    rng = np.random.default_rng(seed)
    templates = rng.normal(size=(NUM_CLASSES,) + IMAGE_SHAPE).astype(np.float32)

    def make(n, salt):
        r = np.random.default_rng((seed, salt))
        y = r.integers(0, NUM_CLASSES, size=n).astype(np.int32)
        x = templates[y] * 0.35 + r.normal(size=(n,) + IMAGE_SHAPE).astype(np.float32) * 0.25
        x = np.clip(x * 0.5 + 0.5, 0.0, 1.0).astype(np.float32)
        return x, y

    return make(n_train, 1), make(n_test, 2)


def load_cifar10(
    verify: bool = True,
    synthetic_fallback: bool = True,
    timeout: float = 30.0,
    n_synthetic_train: int = 4096,
    n_synthetic_test: int = 512,
) -> Tuple[Tuple[np.ndarray, np.ndarray], Tuple[np.ndarray, np.ndarray]]:
    """Returns ``((x_train, y_train), (x_test, y_test))``; images are
    float32 NHWC in [0, 1], labels int32."""
    directory = data_dir()
    path = os.path.join(directory, ARCHIVE)
    if not os.path.exists(path):
        os.makedirs(directory, exist_ok=True)
        if not _fetch(path, timeout):
            if not synthetic_fallback:
                raise OSError(
                    f"cannot download {ARCHIVE} and no cache at {path}"
                )
            _log.warning(
                "CIFAR-10 unavailable (no egress?) — using a deterministic "
                "SYNTHETIC set; results are not comparable to real CIFAR"
            )
            return _synthetic(n_synthetic_train, n_synthetic_test)
    if verify:
        digest = _sha256(path)
        if digest != ARCHIVE_SHA256:
            raise ValueError(
                f"{path}: sha256 {digest} does not match the pinned digest "
                f"{ARCHIVE_SHA256} — delete the file and re-fetch"
            )
    train_x, train_y, test_x, test_y = _read_batches(path)
    to_f = lambda a: (a.astype(np.float32) / 255.0)
    return (to_f(train_x), train_y), (to_f(test_x), test_y)
