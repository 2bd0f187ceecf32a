"""Real MNIST loader: cache-or-download, hash-pinned, synthetic fallback.

Parity with the reference's dataset helpers
(``srcs/python/kungfu/tensorflow/v1/helpers/mnist.py`` — it downloads the
IDX files and feeds them to the examples).  TPU-build differences:

* files are verified against pinned SHA-256 digests before use (a
  corrupted or swapped cache must not silently train garbage);
* air-gapped environments (no egress) fall back to a deterministic
  synthetic set with a loud warning instead of crashing, so the examples
  and convergence tests run everywhere (``synthetic_fallback=False``
  restores strict behavior).

Cache layout: ``$KF_DATA_DIR`` (default ``~/.cache/kungfu_tpu``)
``/mnist/<idx file>`` — either the raw IDX files or their ``.gz``
originals are accepted.

Copy of ``kungfu_tpu/datasets/mnist.py``: the same pins, IDX reader and
synthetic stand-in, bit for bit.
"""

from __future__ import annotations

import gzip
import hashlib
import os
import struct
import urllib.request
from typing import Optional, Tuple

import numpy as np

from kungfu_tpu_torch.utils.log import get_logger

_log = get_logger("mnist")

from kungfu_tpu_torch.datasets.cache import DATA_DIR_ENV  # noqa: F401

# canonical gzipped IDX files and their SHA-256 digests (stable since 1998)
FILES = {
    "train-images-idx3-ubyte.gz": "440fcabf73cc546fa21475e81ea370265605f56be210a4024d2ca8f203523609",
    "train-labels-idx1-ubyte.gz": "3552534a0a558bbed6aed32b30c495cca23d567ec52cac8be1a0730e8010255c",
    "t10k-images-idx3-ubyte.gz": "8d422c7b0a1c1c79245a5bcf07fe86e33eeafee792b84584aec276f5a2dbc4e6",
    "t10k-labels-idx1-ubyte.gz": "f7ae60f92e00ec6debd23a6088c31dbd2371eca3ffa0defaefb259924204aec6",
}

MIRRORS = (
    "https://storage.googleapis.com/cvdf-datasets/mnist/",
    "https://ossci-datasets.s3.amazonaws.com/mnist/",
)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def data_dir() -> str:
    from kungfu_tpu_torch.datasets.cache import cache_dir

    return cache_dir("mnist")


def _fetch(name: str, dest: str, timeout: float) -> bool:
    for mirror in MIRRORS:
        try:
            tmp = dest + ".part"
            with urllib.request.urlopen(mirror + name, timeout=timeout) as r, open(
                tmp, "wb"
            ) as f:
                f.write(r.read())
            os.replace(tmp, dest)
            return True
        except OSError as e:
            _log.debug("mirror %s failed for %s: %s", mirror, name, e)
    return False


def _read_idx(raw: bytes) -> np.ndarray:
    """Parse the IDX format (magic 0x801 labels / 0x803 images)."""
    magic, = struct.unpack(">I", raw[:4])
    ndim = magic & 0xFF
    if (magic >> 8) != 0x08 or ndim not in (1, 3):
        raise ValueError(f"not an MNIST IDX file (magic {magic:#x})")
    dims = struct.unpack(f">{ndim}I", raw[4 : 4 + 4 * ndim])
    data = np.frombuffer(raw, dtype=np.uint8, offset=4 + 4 * ndim)
    return data.reshape(dims)


def _load_file(directory: str, gz_name: str, verify: bool, timeout: float) -> Optional[np.ndarray]:
    gz_path = os.path.join(directory, gz_name)
    raw_path = gz_path[: -len(".gz")]
    if not os.path.exists(gz_path) and not os.path.exists(raw_path):
        os.makedirs(directory, exist_ok=True)
        if not _fetch(gz_name, gz_path, timeout):
            return None
    if os.path.exists(gz_path):
        if verify:
            digest = _sha256(gz_path)
            if digest != FILES[gz_name]:
                raise ValueError(
                    f"{gz_path}: sha256 {digest} does not match the pinned "
                    f"digest {FILES[gz_name]} — delete the file and re-fetch"
                )
        with gzip.open(gz_path, "rb") as f:
            return _read_idx(f.read())
    # pre-extracted raw IDX: there is no pin for the extracted form, so a
    # verified load cannot accept it (a swapped raw file would silently
    # train garbage — the exact thing the pins exist to stop); pass
    # verify=False to opt in to an unverified local cache
    if verify:
        raise ValueError(
            f"{raw_path} is an unverifiable raw cache (only the .gz "
            "originals are hash-pinned) — keep the .gz alongside it or "
            "load with verify=False"
        )
    with open(raw_path, "rb") as f:
        return _read_idx(f.read())


def synthetic_mnist(n: int = 4096, seed: int = 42) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic linearly-separable stand-in with MNIST shapes."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 28 * 28).astype(np.float32)
    w_true = rng.randn(28 * 28, 10).astype(np.float32)
    y = np.argmax(x @ w_true, axis=1).astype(np.int32)
    return x, y


def load_mnist(
    split: str = "train",
    cache_dir: Optional[str] = None,
    normalize: bool = True,
    verify: bool = True,
    synthetic_fallback: bool = True,
    timeout: float = 20.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Return ``(images [N, 784] float32, labels [N] int32)``.

    Looks in the cache, then the download mirrors; with
    ``synthetic_fallback`` (default) an unreachable network degrades to
    :func:`synthetic_mnist` with a warning instead of failing — so the
    same example code runs on an air-gapped TPU pod and a laptop."""
    if split not in ("train", "test"):
        raise ValueError(f"split {split!r}")
    directory = cache_dir or data_dir()
    prefix = "train" if split == "train" else "t10k"
    try:
        images = _load_file(directory, f"{prefix}-images-idx3-ubyte.gz", verify, timeout)
        labels = _load_file(directory, f"{prefix}-labels-idx1-ubyte.gz", verify, timeout)
    except (ValueError, OSError):
        if not synthetic_fallback:
            raise
        images = labels = None
    if images is None or labels is None:
        if not synthetic_fallback:
            raise RuntimeError(
                f"MNIST {split} files unavailable in {directory} and no "
                "mirror reachable; place the IDX .gz files there"
            )
        _log.warning(
            "MNIST unavailable (no cache in %s, no egress) — using the "
            "deterministic synthetic stand-in", directory,
        )
        return synthetic_mnist()
    if len(images) != len(labels):
        raise ValueError(f"images/labels length mismatch {len(images)}/{len(labels)}")
    x = images.reshape(len(images), -1).astype(np.float32)
    if normalize:
        x /= 255.0
    return x, labels.astype(np.int32)
