"""kf-serve demo: requests survive a chaos worker kill, zero lost (port
of ``examples/serve_demo.py``).

A 4-peer deployment in this process (ranks 0..2 serving workers, each a
continuous-batching engine over a small transformer; rank 3 the router)
takes a steady request stream while the chaos layer kills worker 1 at
its 10th decode iteration (``die:step=10,rank=1,mode=raise``).  The
router's progress-deadline ladder detects the death, excludes the
worker and replays its in-flight requests from their last committed
decode position on the survivors.  The script asserts:

* every accepted request completes with its full token budget, the
  ones in flight on the victim included;
* at least one request was replayed (the kill landed mid-flight);
* the victim is on the router's dead list and the survivors are not;
* a replayed continuation equals the deterministic greedy reference;
* prefix reuse engaged (the shared system prompt prefilled once a
  worker, later requests reused its pages).

Run: ``python -m kungfu_tpu_torch.examples.serve_demo`` (the engines on
the card; ``KF_JAX_PLATFORM=cpu``, which the launcher's ``-backend cpu``
stamps, puts them on the host).  ``--base-port`` 0, the default, takes
ports found free.
"""

from __future__ import annotations

import argparse
import sys
import time

#: the demo's environment, set for ``main``'s run only
ENV = {"KF_NATIVE_ENGINE": "0",
       "KF_CHAOS_SPEC": "die:step=10,rank=1,mode=raise"}
ENV_DEFAULT = {"KF_CONFIG_LOG_LEVEL": "WARNING"}
#: the shared prefix: 2 pages of 8 tokens
SYSTEM_PROMPT = list(range(1, 17))


def build(device):
    """``(model, params)``: the demo's transformer, f32, seed 0."""
    import torch

    from kungfu_tpu_torch.models.transformer import (Transformer,
                                                     TransformerConfig)

    cfg = TransformerConfig(vocab_size=96, d_model=32, n_layers=2,
                            n_heads=2, d_ff=64, max_seq=128,
                            dtype="float32")
    model = Transformer(cfg)
    return model, model.init(torch.Generator().manual_seed(0), device=device)


def greedy(model, params, prompt, n: int) -> list:
    """``n`` greedy tokens after ``prompt``, each from a full forward."""
    import torch

    ref = list(prompt)
    dev = params["embed"]["table"].device
    with torch.inference_mode():
        for _ in range(n):
            logits = model.apply(params, torch.tensor([ref], device=dev))
            ref.append(int(logits[0, -1].argmax()))
    return ref[len(prompt):]


def serve(model, params, peers, n_requests: int, n_tokens: int) -> dict:
    """The demo on started ``peers`` (three workers, then the router):
    submit, wait, assert, print.  Returns every request's prompt and
    tokens and the router's counts."""
    from kungfu_tpu_torch.monitor.registry import REGISTRY
    from kungfu_tpu_torch.serve.engine import InferenceEngine
    from kungfu_tpu_torch.serve.kvcache import KVCachePool, PageSpec
    from kungfu_tpu_torch.serve.router import ServeRouter, ServeWorker

    cfg = model.cfg
    servers = []
    router = None
    try:
        for p in peers[:3]:
            eng = InferenceEngine(
                model, params,
                pool=KVCachePool(PageSpec.for_model(cfg, page_tokens=8), 256),
                max_batch=4, max_seq=cfg.max_seq, rank=p.chaos_rank())
            eng.warmup(prompt_lens=(len(SYSTEM_PROMPT) + 4,))
            servers.append(ServeWorker(p, eng, commit_every=2).start())
        router = ServeRouter(peers[3], worker_ranks=[0, 1, 2],
                             queue_depth=64, deadline_s=2.0)
        reused0 = REGISTRY.counter("kf_serve_prefill_tokens_total",
                                   what="reused").value
        handles = []
        for i in range(n_requests):
            handles.append(router.submit(SYSTEM_PROMPT + [20 + i], n_tokens))
            time.sleep(0.02)  # a steady offered load, not one burst
        outs = [h.wait(120) for h in handles]
        assert all(len(o) == n_tokens for o in outs), \
            f"lost tokens: {[len(o) for o in outs]}"
        assert router.completed == n_requests
        assert router.dead_workers == [1], router.dead_workers
        assert router.replayed >= 1, "the kill landed between requests"
        assert servers[1].dead and not servers[0].dead

        # determinism: a replayed request equals the greedy reference
        replayed = next(h for h in handles if h.replays > 0)
        assert replayed.tokens == greedy(model, params, replayed.prompt,
                                         n_tokens), \
            "replayed continuation diverged from the reference"

        # prefix reuse engaged on the shared system prompt
        reused = REGISTRY.counter("kf_serve_prefill_tokens_total",
                                  what="reused").value - reused0
        assert reused > 0, "no prefix reuse measured"

        print(
            f"serve-demo: survived worker kill; "
            f"{router.completed}/{n_requests} requests completed "
            f"(replayed {router.replayed}, dead {router.dead_workers}, "
            f"reused {reused} prefill tokens)"
        )
        return {"requests": [(h.prompt, list(h.tokens)) for h in handles],
                "replays": [h.replays for h in handles],
                "replayed": router.replayed, "reused": reused}
    finally:
        if router is not None:
            router.close()
        for s in servers:
            if not s.dead:
                s.stop()


def main(argv=None, report=None) -> int:
    """``report``, a dict when given, receives :func:`serve`'s result."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--base-port", type=int, default=0,
                    help="worker r on base-port + r; 0 finds free ports")
    ns = ap.parse_args(argv)

    from kungfu_tpu_torch.examples._local import (close_all, local_peers,
                                                  scoped_env)

    with scoped_env(ENV, ENV_DEFAULT):
        peers = local_peers(4, ns.base_port)
        try:
            model, params = build(peers[0].device())
            out = serve(model, params, peers, ns.requests, ns.tokens)
        finally:
            close_all(peers)
    if report is not None:
        report.update(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
