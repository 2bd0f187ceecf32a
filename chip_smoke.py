#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (kungfu_tpu_torch) on one GPU and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failed check exits non-zero before the result line):

1. probe   — torch/CUDA versions, device name, compute capability,
             ``nvidia-smi`` name and power limit;
2. build   — nvcc builds every hand-written kernel from ``csrc/``;
3. kernels — each kernel against its plain PyTorch version on the card,
             at the main path's shape and at the edge cases, with the
             tolerances below; timed (median of 21 CUDA-event windows)
             beside its plain version and one PyTorch library call;
4. forward — the flagship forward (vocab 32128, d_model 768, 12 layers,
             12 heads, d_ff 3072, RoPE, causal, bf16, ids [4, 256]) with
             random weights from a seed, through the kernel, held
             against the same model under ``KF_TPU_ATTN=xla``;
5. serve   — the continuous-batching engine on the same model answers
             six requests (two sharing a 64-token prefix), held against
             full-context greedy decoding through the forward.

It prints a ``kernels`` JSON line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Imports neither jax nor kungfu_tpu.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: bf16 kernel vs plain version: both round O once to bf16 (half an ulp
#: is 2^-9 relative, |O| < 4 here), and P is rounded to bf16 against the
#: running max in the kernel but the global max in the plain version
BF16_O_ATOL = 2e-2
#: lse is f32 from f32-accumulated scores in another summation order
BF16_LSE_ATOL = 1e-3
#: f32: the reference kernel's own tolerance (tests/test_pallas.py)
F32_ATOL = 2e-5
#: flagship logits, flash kernel vs plain attention, both bf16: the two
#: round attention outputs differently and the difference travels
#: through 12 layers; logits have a spread of about 0.2 here
LOGITS_ATOL = 5e-2
#: serving vs full-context greedy: where the engine's token is not the
#: reference's top-1, the reference's top-1 logit may beat the engine's
#: token by at most this (the same bf16 noise as LOGITS_ATOL)
GREEDY_MARGIN = 5e-2

FLAGSHIP = dict(vocab_size=32128, d_model=768, n_layers=12, n_heads=12,
                d_ff=3072, max_seq=512, causal=True, pos="rope",
                dtype="bfloat16")


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise SmokeFailure(f"nvidia-smi failed: {e}")
    check(out.returncode == 0, f"nvidia-smi exited {out.returncode}: "
          f"{out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, fn, iters: int = 20, windows: int = 21) -> float:
    """Median over ``windows`` CUDA-event windows of the device time of
    one ``fn()`` in ms.  A sleep kernel holds the stream while the host
    enqueues ``iters`` calls, so the events time back-to-back device
    work, not the host's launch overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)  # ~50 ms at H100 clocks
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def phase_kernels(torch, attention, spec):
    """Kernel vs plain version at the main shape and the edge cases."""
    import torch.nn.functional as F

    cases = [
        # name, (B, H, S, D), dtype, causal
        ("main", (4, 12, 256, 64), torch.bfloat16, True),
        ("f32_causal_ragged", (2, 4, 200, 64), torch.float32, True),
        ("bf16_noncausal", (4, 12, 256, 64), torch.bfloat16, False),
        ("bf16_d128", (2, 8, 256, 128), torch.bfloat16, True),
        ("bf16_d32_ragged_noncausal", (2, 4, 130, 32), torch.bfloat16, False),
        ("f32_d128_noncausal", (1, 2, 100, 128), torch.float32, False),
        ("f32_d32", (1, 3, 70, 32), torch.float32, True),
    ]
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for name, (b, h, s, d), dtype, causal in cases:
        q, k, v = (torch.randn((b * h, s, d), generator=gen, device="cuda"
                               ).to(dtype) for _ in range(3))
        out, lse = attention.flash_attention_with_lse(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref_o, ref_lse = attention.flash_attention_reference(q, k, v, causal)
        o_err = (out.float() - ref_o.float()).abs().max().item()
        l_err = (lse - ref_lse).abs().max().item()
        o_tol, l_tol = ((BF16_O_ATOL, BF16_LSE_ATOL) if dtype == torch.bfloat16
                        else (F32_ATOL, F32_ATOL))
        print(f"kernel {name}: shape {(b, h, s, d)} {str(dtype)[6:]} "
              f"causal={causal} max|dO|={o_err:.3e} (tol {o_tol}) "
              f"max|dlse|={l_err:.3e} (tol {l_tol})")
        check(bool(torch.isfinite(out.float()).all()), f"{name}: non-finite O")
        check(o_err <= o_tol, f"{name}: O error {o_err} > {o_tol}")
        check(l_err <= l_tol, f"{name}: lse error {l_err} > {l_tol}")
        results[name] = {"o_err": o_err, "lse_err": l_err}

    # timing at the main path's shape (contiguous [BH, S, D]; warm L2)
    b, h, s, d = 4, 12, 256, 64
    q, k, v = (torch.randn((b * h, s, d), generator=gen, device="cuda"
                           ).to(torch.bfloat16) for _ in range(3))
    q4, k4, v4 = (t.view(b, h, s, d) for t in (q, k, v))
    ms = device_ms(torch, lambda: attention.flash_attention_with_lse(
        q, k, v, causal=True))
    plain_ms = device_ms(torch, lambda: attention.flash_attention_reference(
        q, k, v, True))
    library_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True))
    # least time: causal pairs need 4*D FLOPs each (QK^T and PV); bytes
    # are q, k, v read once, O written once (bf16), lse written (f32)
    flops = 4 * d * b * h * s * (s + 1) // 2
    nbytes = 4 * b * h * s * d * 2 + b * h * s * 4
    t_ops = flops / spec["bf16_flops"] * 1e3
    t_bytes = nbytes / spec["hbm_bytes_s"] * 1e3
    timing = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
              "bound_ms": max(t_ops, t_bytes),
              "bound_by": "operations" if t_ops > t_bytes else "bytes",
              "flops": flops, "bytes": nbytes}
    print(f"kernel timing main shape: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
          f"{timing['bound_ms']:.4f} ms ({timing['bound_by']}); "
          f"{flops / ms / 1e9:.1f} TFLOP/s")
    return results, timing


def phase_forward(torch, attention, tr, model, params, ids):
    """The flagship forward once through the kernel (launches counted),
    then against the plain attention, then timed."""
    attention.reset_launch_counts()
    logits = model.apply(params, ids)
    torch.cuda.synchronize()
    launches = dict(attention.launch_counts)
    print(f"forward path launches: {launches}")
    check(launches["flash_fwd"] == model.cfg.n_layers,
          f"flash kernel launched {launches['flash_fwd']} times in one "
          f"forward, expected {model.cfg.n_layers}")
    check(tuple(logits.shape) == (4, 256, model.cfg.vocab_size),
          f"logits shape {tuple(logits.shape)}")
    check(logits.dtype == torch.float32, f"logits dtype {logits.dtype}")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    saved = os.environ.get("KF_TPU_ATTN")
    os.environ["KF_TPU_ATTN"] = "xla"
    try:
        check(tr.pick_attention() is tr.default_attention,
              "KF_TPU_ATTN=xla did not select the plain attention")
        ref = model.apply(params, ids)
    finally:
        if saved is None:
            os.environ.pop("KF_TPU_ATTN")
        else:
            os.environ["KF_TPU_ATTN"] = saved
    err = (logits - ref).abs().max().item()
    spread = ref.std().item()
    print(f"forward logits vs KF_TPU_ATTN=xla: max|d|={err:.3e} "
          f"(tol {LOGITS_ATOL}, logit std {spread:.3f})")
    check(err <= LOGITS_ATOL, f"logits error {err} > {LOGITS_ATOL}")

    def wall_ms(fn, n=10):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    fwd_ms = wall_ms(lambda: model.apply(params, ids))
    plain_fwd_ms = wall_ms(lambda: model.apply(params, ids,
                                               attn_fn=tr.default_attention))
    toks = ids.numel() / (fwd_ms / 1e3)
    print(f"forward: {fwd_ms:.3f} ms/forward ({toks:.0f} tokens/s) through "
          f"the kernel; {plain_fwd_ms:.3f} ms with plain attention")
    return {"launches": launches["flash_fwd"], "logits_err": err,
            "ms": fwd_ms, "tokens_s": toks, "plain_attn_ms": plain_fwd_ms}


def phase_serve(torch, np, attention, model, params):
    from kungfu_tpu_torch.monitor.registry import REGISTRY
    from kungfu_tpu_torch.serve import slo
    from kungfu_tpu_torch.serve.engine import InferenceEngine

    vocab = model.cfg.vocab_size
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, vocab, size=64).tolist()
    wave1 = {"r17": rng.integers(0, vocab, size=17).tolist(),
             "p73": prefix + rng.integers(0, vocab, size=9).tolist(),
             "r150": rng.integers(0, vocab, size=150).tolist(),
             "r200": rng.integers(0, vocab, size=200).tolist()}
    # the second wave arrives after the first has committed its pages,
    # so the shared 64-token prefix comes out of the paged cache
    wave2 = {"p94": prefix + rng.integers(0, vocab, size=30).tolist(),
             "r40": rng.integers(0, vocab, size=40).tolist()}
    new = 16
    engine = InferenceEngine(model, params, max_batch=8, max_seq=512)
    dev = params["embed"]["table"].device
    t0 = time.perf_counter()
    engine.warmup(prompt_lens=(200,))
    print(f"serve warmup: {time.perf_counter() - t0:.2f} s")
    REGISTRY.reset()
    attention.reset_launch_counts()
    done = {}
    t0 = time.perf_counter()
    steps = 0
    for wave in (wave1, wave2):
        for rid, toks in wave.items():
            engine.submit(rid, toks, new)
        while engine.pending_count or engine.active_count:
            for ev in engine.step():
                if ev["kind"] == "done":
                    done[ev["rid"]] = ev
            steps += 1
    wall = time.perf_counter() - t0
    launches = dict(attention.launch_counts)
    print(f"serve path launches: {launches} (the engine's attention is the "
          f"plain masked softmax, as in the reference engine)")
    prompts = {**wave1, **wave2}
    check(set(done) == set(prompts), f"completed {sorted(done)}")
    for rid, ev in done.items():
        check(len(ev["tokens"]) == new,
              f"{rid}: {len(ev['tokens'])} tokens, budget {new}")
    reused = sum(ev["reused_tokens"] for ev in done.values())
    check(reused > 0, "no prefill tokens were reused from the prefix cache")
    check(done["p94"]["reused_tokens"] == 64,
          f"p94 reused {done['p94']['reused_tokens']} tokens, expected 64")

    # full-context greedy reference through the forward (kernel path),
    # teacher-forced on the engine's tokens: one forward per request
    exact = total = 0
    worst = 0.0
    for rid, ev in done.items():
        seq = prompts[rid] + ev["tokens"]
        logits = model.apply(params, torch.tensor([seq[:-1]], device=dev))
        rows = logits[0, len(prompts[rid]) - 1:]          # [new, vocab]
        top = rows.argmax(dim=-1)
        got = torch.tensor(ev["tokens"], device=dev)
        gap = (rows.gather(1, top[:, None]) - rows.gather(1, got[:, None]))
        worst = max(worst, gap.max().item())
        exact += int((top == got).sum())
        total += new
    print(f"serve vs full-context greedy: {exact}/{total} tokens identical; "
          f"largest top-1 margin over the engine's token {worst:.3e} "
          f"(tol {GREEDY_MARGIN})")
    check(worst <= GREEDY_MARGIN,
          f"engine token loses to the greedy top-1 by {worst} > "
          f"{GREEDY_MARGIN}")
    tok = slo.slo_snapshot()["token"]
    ttfts = sorted(ev["ttft_s"] * 1e3 for ev in done.values())
    gen_tokens = new * len(done)
    print(f"serve: {len(done)} requests, {steps} steps, {wall:.3f} s wall, "
          f"{gen_tokens / wall:.1f} generated tokens/s; TTFT ms "
          f"{[round(t, 2) for t in ttfts]}; decode step p50 "
          f"{tok.get('p50', 0) * 1e3:.3f} ms mean "
          f"{tok['sum'] / max(tok['count'], 1) * 1e3:.3f} ms; reused "
          f"prefill tokens {reused}")
    return {"launches": launches["flash_fwd"], "wall_s": wall,
            "ttft_ms": ttfts, "decode_step_mean_ms":
                tok["sum"] / max(tok["count"], 1) * 1e3,
            "decode_step_p50_ms": tok.get("p50", 0) * 1e3,
            "greedy_exact": exact, "greedy_total": total,
            "greedy_worst_margin": worst, "reused_tokens": reused}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; chip_smoke.py "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from kungfu_tpu_torch.models import transformer as tr
    from kungfu_tpu_torch.ops import costmodel
    from kungfu_tpu_torch.ops.cuda import attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. probe
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi()
    print(f"probe: python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {name!r} capability {cap} "
          f"count {torch.cuda.device_count()}")
    check(cap == (9, 0), f"compute capability {cap}, the kernels target 9.0")
    spec = costmodel.card_spec(name)
    check(spec is not None, f"no datasheet entry for {name!r}")

    # 2. build
    t0 = time.perf_counter()
    built = attention.load()
    print(f"build: {built.path.name} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {built.seconds:.2f} s)")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # 3. kernels against their plain versions
    errs, timing = phase_kernels(torch, attention, spec)

    # 4. + 5. the main path: flagship forward, then the serving engine
    model = tr.Transformer(tr.TransformerConfig(**FLAGSHIP))
    t0 = time.perf_counter()
    params = model.init(torch.Generator().manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    print(f"init: {time.perf_counter() - t0:.2f} s")
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, FLAGSHIP["vocab_size"], size=(4, 256))).cuda()
    fwd = phase_forward(torch, attention, tr, model, params, ids)
    serve = phase_serve(torch, np, attention, model, params)

    kernels = [{
        "name": "attention._fwd_kernel",
        "route": "cuda",
        "source": "kungfu_tpu_torch/ops/cuda/csrc/flash_fwd.cu",
        "replaces": "kungfu_tpu/ops/pallas/attention.py:77",
        "launches": fwd["launches"] + serve["launches"],
        "max_abs_err": errs["main"]["o_err"],
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
    }]
    print("details: " + json.dumps({"forward": fwd, "serve": serve,
                                    "kernel_errors": errs,
                                    "kernel_timing": timing}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        sys.exit(1)
