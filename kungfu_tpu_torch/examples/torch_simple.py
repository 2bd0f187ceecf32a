"""Torch S-SGD under the launcher (port of ``examples/torch_simple.py``,
the reference's ``torch_simple_example.py``; its CI runs it at np 1..4).

A small ``torch.nn`` regression model, broadcast from rank 0, trained
with ``SynchronousSGDOptimizer``: every ``step()`` mean-allreduces the
gradients over the host engine.  The model sits on the worker's device
(the card, or the host under ``-backend cpu``)::

    python -m kungfu_tpu_torch -np 2 python3 -m kungfu_tpu_torch.examples.torch_simple
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=50)
    args = p.parse_args(argv)

    import torch

    import kungfu_tpu_torch as kf
    from kungfu_tpu_torch.torch import (SynchronousSGDOptimizer,
                                        broadcast_parameters)

    peer = kf.init()
    device = peer.device()
    rank, size = kf.current_rank(), kf.cluster_size()

    torch.manual_seed(1234)  # same init everywhere; broadcast confirms it
    model = torch.nn.Sequential(
        torch.nn.Linear(8, 16), torch.nn.ReLU(), torch.nn.Linear(16, 1)
    ).to(device)
    broadcast_parameters(model.state_dict())
    opt = SynchronousSGDOptimizer(torch.optim.SGD(model.parameters(), lr=0.05))

    g = torch.Generator().manual_seed(rank)  # each rank sees its own shard
    w_true = torch.randn(8, 1, generator=torch.Generator().manual_seed(0))
    loss = None
    for _ in range(args.steps):
        x = torch.randn(32, 8, generator=g)
        y = (x @ w_true).to(device)
        opt.zero_grad()
        loss = ((model(x.to(device)) - y) ** 2).mean()
        loss.backward()
        opt.step()

    print(f"rank={rank}/{size} final_loss={loss.item():.5f}")
    if loss.item() < 1.0:
        print("OK")
    kf.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
