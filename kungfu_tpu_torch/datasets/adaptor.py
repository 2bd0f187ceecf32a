"""Elastic dataset adaptor — shard/batch/skip that survives resizes.

Parity with reference ``kungfu/tensorflow/v1/datasets/adaptor.py:4-45``,
which rebuilds a tf.data pipeline from mutable shard/offset variables so a
worker joining (or surviving) a resize continues from the global sample
offset instead of restarting the epoch.  Here the adaptor is an indexable-
array pipeline (numpy in, device batch out):

* a deterministic per-epoch global permutation (all ranks agree on it by
  seed — no coordination needed);
* the global stream is cut into *global batches* of
  ``batch_size × cluster_size``; each rank takes its ``rank``-th slice;
* progress is tracked in **samples consumed**, so after ``set_cluster``
  (resize) or a restart, ``skip(consumed)`` resumes exactly where the old
  cluster stopped, under the new shape.

Short final batches are dropped (every rank must see the same batch count
per epoch or collectives deadlock — same invariant as the reference).

Copy of ``kungfu_tpu/datasets/adaptor.py``: numpy in and out, the same
permutation, shards and offsets bit for bit;
:func:`~kungfu_tpu_torch.datasets.prefetch.prefetch_to_device` stages
the batches on the card.
"""

from __future__ import annotations

from typing import Iterator, Sequence, Tuple

import numpy as np


class ElasticDataset:
    def __init__(
        self,
        arrays: Sequence[np.ndarray],
        batch_size: int,
        rank: int = 0,
        size: int = 1,
        seed: int = 0,
        shuffle: bool = True,
    ):
        arrays = [np.asarray(a) for a in arrays]
        if not arrays:
            raise ValueError("need at least one array")
        n = len(arrays[0])
        for a in arrays:
            if len(a) != n:
                raise ValueError("arrays must share the leading dimension")
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        self.arrays = arrays
        self.n = n
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.consumed = 0  # global samples consumed across the cluster
        self.set_cluster(rank, size)

    # -- elasticity -------------------------------------------------------
    def set_cluster(self, rank: int, size: int) -> None:
        """Re-shard after a membership change (the reference's mutable
        shard variables).  ``consumed`` is kept: the stream continues."""
        if not (0 <= rank < size):
            raise ValueError(f"rank {rank} outside size {size}")
        self.rank = rank
        self.size = size

    def skip(self, consumed_samples: int) -> None:
        """Fast-forward the global stream (restart/recovery resume)."""
        if consumed_samples < 0:
            raise ValueError("consumed_samples must be >= 0")
        self.consumed = consumed_samples

    # -- iteration --------------------------------------------------------
    @property
    def global_batch(self) -> int:
        return self.batch_size * self.size

    def batches_per_epoch(self) -> int:
        return self.n // self.global_batch

    def _epoch_perm(self, epoch: int) -> np.ndarray:
        if not self.shuffle:
            return np.arange(self.n)
        return np.random.default_rng((self.seed, epoch)).permutation(self.n)

    def next_batch(self) -> Tuple[np.ndarray, ...]:
        """The next per-rank batch at the current global offset."""
        gb = self.global_batch
        per_epoch = self.batches_per_epoch() * gb
        if per_epoch == 0:
            raise ValueError(
                f"dataset of {self.n} samples smaller than one global batch {gb}"
            )
        # realign to a global-batch boundary: after a resize mid-epoch the
        # consumed count may not divide the new global batch
        offset = ((self.consumed + gb - 1) // gb) * gb
        epoch, pos = divmod(offset, per_epoch)
        perm = self._epoch_perm(epoch)
        sl = perm[pos + self.rank * self.batch_size:
                  pos + (self.rank + 1) * self.batch_size]
        self.consumed = offset + gb
        return tuple(a[sl] for a in self.arrays)

    def sync_consumed(self, peer) -> int:
        """Adopt the cluster-wide MAX consumed-samples offset (host-plane
        allreduce).  A worker that just joined (or restarted without a
        local checkpoint) holds offset 0 while survivors are mid-stream;
        without this sync each rank would slice a DIFFERENT global batch
        and the data-parallel step would silently mix sample windows.

        Call it at the same engine-op sequence point on every member:
        right after ``broadcast_parameters`` at startup, and right after
        ``set_cluster`` in the resize branch (see
        ``examples/cifar_elastic.py``)."""
        engine = peer.engine()
        if engine is not None:
            # control-plane traffic: record=False keeps the rendezvous
            # wait at resize boundaries out of the strategy-adaptation
            # throughput windows
            out = engine.all_reduce(
                np.array([self.consumed], np.int64), op="max", record=False
            )
            self.skip(int(out[0]))
        return self.consumed

    def epochs(self, n_epochs: int) -> Iterator[Tuple[np.ndarray, ...]]:
        """Iterate whole epochs from the current offset."""
        gb = self.global_batch
        per_epoch = self.batches_per_epoch() * gb
        if per_epoch == 0:
            raise ValueError(
                f"dataset of {self.n} samples smaller than one global batch {gb}"
            )
        end = (self.consumed // per_epoch + n_epochs) * per_epoch
        while self.consumed < end:
            yield self.next_batch()
