"""MNIST SLP — the minimum end-to-end distributed training slice (port
of ``examples/mnist_slp.py``).

An SLP trained with synchronous SGD across N workers: weights broadcast
from rank 0 at init, gradients mean-allreduced over the host engine
every step.  Data is synthetic MNIST-shaped (images random, labels from
a fixed hidden linear map), so the loss falls iff training works end to
end.

Run::

    python -m kungfu_tpu_torch -np 4 python3 -m \\
        kungfu_tpu_torch.examples.mnist_slp --n-epochs 3

(``-backend cpu`` runs the workers on the host.)
"""

from __future__ import annotations

import argparse
import sys


def synthetic_mnist(n=4096, seed=42):
    """The reference example's synthetic MNIST (``datasets.mnist``)."""
    from kungfu_tpu_torch.datasets.mnist import synthetic_mnist as _syn

    return _syn(n, seed)


def loss_and_grads(loss_fn, params, batch):
    """``(loss, grads)`` of ``loss_fn(params, batch)``, the gradients a
    tree like ``params``."""
    import torch

    from kungfu_tpu_torch.utils.tree import tree_flatten, tree_unflatten

    leaves, treedef = tree_flatten(params)
    own = [t.detach().requires_grad_(True) for t in leaves]
    loss = loss_fn(tree_unflatten(treedef, own), batch)
    grads = torch.autograd.grad(loss, own)
    return loss.detach(), tree_unflatten(treedef, list(grads))


def sgd_step(model, opt, params, opt_state, batch, engine=None):
    """One S-SGD step: the loss and gradients of ``batch``, the gradients
    mean-allreduced over ``engine`` (when there is one, fused to one
    buffer), then ``opt``'s update.  ``(params, opt_state, loss)``."""
    from kungfu_tpu_torch.ops.fuse import defuse, fuse
    from kungfu_tpu_torch.optimizers import apply_updates

    loss, grads = loss_and_grads(model.loss, params, batch)
    if engine is not None:
        flat, spec = fuse(grads)
        red = engine.all_reduce(flat.cpu(), op="mean")
        grads = defuse(red.to(flat.device), spec)
    updates, opt_state = opt.update(grads, opt_state, params)
    return apply_updates(params, updates), opt_state, loss


def batches(x, y, batch_size: int, device):
    """The epoch's batches of a data shard, in order, on ``device``."""
    import torch

    for i in range(len(x) // batch_size):
        sl = slice(i * batch_size, (i + 1) * batch_size)
        yield (torch.from_numpy(x[sl]).to(device),
               torch.from_numpy(y[sl]).long().to(device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-epochs", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.2)
    ap.add_argument("--restart", type=int, default=0)
    ap.add_argument("--data", choices=["auto", "real", "synthetic"],
                    default="synthetic",
                    help="'real' = cached MNIST (hash-pinned); 'auto' falls "
                         "back to synthetic off-line; the default keeps "
                         "runs deterministic")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import kungfu_tpu_torch as kf
    from kungfu_tpu_torch.initializer import broadcast_parameters
    from kungfu_tpu_torch.models import mnist_slp
    from kungfu_tpu_torch.ops.fuse import fuse
    from kungfu_tpu_torch.optimizers import sgd

    peer = kf.init()
    device = peer.device()
    rank, size = kf.current_rank(), kf.cluster_size()
    print(f"worker {rank}/{size} up", flush=True)

    model = mnist_slp()
    # deliberately different per rank, then re-synced from rank 0
    params = model.init(torch.Generator().manual_seed(7 + rank),
                        device=device)
    params = broadcast_parameters(params, peer)

    if args.data == "synthetic":
        x, y = synthetic_mnist()
    else:
        from kungfu_tpu_torch.datasets.mnist import load_mnist

        x, y = load_mnist("train", synthetic_fallback=args.data == "auto")
    shard = np.arange(len(x)) % size == rank  # data-parallel shard
    x, y = x[shard], y[shard]

    opt = sgd(args.lr)
    opt_state = opt.init(params)
    engine = peer.engine()
    first = last = None
    for epoch in range(args.n_epochs):
        losses = []
        for batch in batches(x, y, args.batch_size, device):
            params, opt_state, loss = sgd_step(model, opt, params,
                                               opt_state, batch, engine)
            losses.append(float(loss))
        if first is None:
            first = losses[0]
        last = sum(losses) / len(losses)
        if rank == 0:
            print(f"epoch {epoch}: mean loss {last:.4f}", flush=True)

    xt = torch.from_numpy(x).to(device)
    yt = torch.from_numpy(y).long().to(device)
    acc = float(model.accuracy(params, (xt, yt)))
    print(f"worker {rank}: final loss {last:.4f} acc {acc:.3f}", flush=True)
    if not (last < first):
        print("FAIL: loss did not decrease", flush=True)
        return 1
    # every replica holds the same weights after synchronous training
    digest = float(fuse(params)[0].double().sum())
    if engine is not None:
        lo = engine.all_reduce(np.array([digest]), op="min")[0]
        hi = engine.all_reduce(np.array([digest]), op="max")[0]
        if rank == 0 and not np.isclose(lo, hi):
            print("FAIL: replicas diverged", flush=True)
            return 1
    print(f"worker {rank}: OK", flush=True)
    kf.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
