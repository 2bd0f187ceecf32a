#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (kungfu_tpu_torch) on one GPU and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failed check exits non-zero before the result line):

1. probe   — torch/CUDA versions, device name, compute capability,
             ``nvidia-smi`` name and power limit;
2. build   — nvcc builds every hand-written CUDA kernel from ``csrc/``,
             one nvcc per source, all started together (the Triton
             kernels compile at their first launch, in phase 3); the
             wgmma/TMA flash kernels must show no register spills in
             ptxas's report and HGMMA and UTMALDG instructions in their
             SASS (``cuobjdump``), and so must the LM head's wgmma
             forward, dh and dW kernels;
3. kernels — each kernel against its plain PyTorch version on the card,
             at the main path's shape and at the edge cases (for the
             flash kernels also a bf16 grid of sequence lengths around
             their tile edges, head dims 32/64/128, causal and not),
             with the tolerances below; timed (median of CUDA-event
             windows) beside its plain version and one PyTorch library
             call, the flash forward at its three main-path shapes and
             dQ and dK/dV at the two training shapes, and all three
             without a mask at one BERT-base rank's [96, 512, 64], the
             cross-entropy at the flagship's [8192, 32128] and BERT's
             [4096, 30528], with the host µs per launch;
4. forward — the flagship forward (vocab 32128, d_model 768, 12 layers,
             12 heads, d_ff 3072, RoPE, causal, bf16, ids [4, 256]) with
             random weights from a seed, through the kernel, held
             against the same model under ``KF_TPU_ATTN=xla``;
5. serve   — the continuous-batching engine on the same model answers
             six requests (two sharing a 64-token prefix), held against
             full-context greedy decoding through the forward;
6. train   — the flagship training step (``gpt_small(max_seq=2048)``,
             f32 params, bf16 compute, ids/targets [4, 2048]): flash
             attention + fused cross-entropy through ``dp_train_step`` and
             ``synchronous_sgd(sgd(0.05, momentum=0.9))``; launches per
             step, first-step gradients against the plain path, ten steps
             of falling loss, one step through ``Transformer.loss`` under
             ``KF_TPU_XENT=fused``, step ms, tokens/s, MFU, peak memory;
7. train   — the same step with the fused LM head (``hidden`` +
             ``lm_head_nll``: the logits never reach device memory), held
             against flash + plain head + plain cross-entropy, and one
             step through ``Transformer.loss`` under
             ``KF_TPU_LM_HEAD=fused``; the same measurements;
8. S-SGD   — phase 6's step on four co-resident ranks of one card
             (``Communicator(devices=["cuda:0"] * 4)``, one batch row per
             rank), ``synchronous_sgd(..., schedule="pallas_ring",
             fuse_grads=True)``: one ring reduce-scatter and one ring
             all-gather over the fused gradient; the first loss and the
             reduced gradient against phase 6's single-rank ones, ten
             steps of falling loss, step ms, tokens/s, peak memory;
9. ZeRO    — ZeRO-2 and ZeRO-3 (``zero_train_step(...,
             schedule="pallas_ring")``) on the same ranks: 129 bucketed
             ring launches per direction, params after one step against
             phase 8's, falling loss, step ms, tokens/s, peak memory,
             per-rank optimizer bytes, and the ring bytes counted in one
             step against ``zero_comm_bytes``;
10. replicas — ``bert_base()`` (vocab 30528, learned positions,
             bidirectional) at full width and depth on the same four
             ranks, 8 x 512 tokens each, phase 6's loss, inner
             ``sgd(1e-3, momentum=0.9)``: SMA (``synchronous_averaging``,
             alpha 0.1) over stacked per-replica params, each rank's
             first step against the same step under KF_TPU_ATTN=xla, the
             ranks apart after it, ten steps of falling loss and a
             cross-rank spread below alpha 0's; AdaptiveSGD (switch at
             step 5: the spread falls across it); the GNS and variance
             monitors on the replicated step, their first-step square
             norms, variance and raw GNS against f64 on the host;
             ``Communicator.autotune_strategy`` at 4 MiB a rank (the
             pallas_ring candidate launches both ring kernels; the
             winner is installed and agrees with psum); step ms,
             tokens/s, MFU, launches and peak memory of the SMA and GNS
             steps;
11. elastic — phase 9's model under ZeRO-2 (``pallas_ring``, inner
             ``adam``) through the step-based schedule ``4:3,2:3,4:2``
             (``[1, 2048]`` a rank at four ranks, ``[2, 2048]`` at two),
             driven the KungFu way: a ``ConfigServer`` on an OS-assigned
             port holds the cluster, each change of size is a PUT of
             ``cluster.resize(n)`` read back with ``fetch_cluster``, and
             the new world is placed from the ``ZeroBoundary`` and the
             ``StepSnapshot`` committed after every step.  Each step
             after a resize is bitwise equal to a fixed-world step from
             the same boundary hand-repadded; at 4 -> 2 ``zero1_reshard``,
             ``zero_snapshot`` -> ``zero_restore``, ``zero_reshard_p2p``
             and chunk mode (four ``PyHostChannel``s on loopback, ring
             mirrors, ranks 1 and 3 dead) give the boundary's state bit
             for bit, and a step from chunk mode's equals the fixed
             world's; a ZeRO-3 param shard re-carved 4 -> 2 gathers
             bitwise and trains a stage-3 step at two ranks; every
             step's launches are exact at k = 4 and k = 2; the loss
             falls; commit, recarve, place and wire times, step ms and
             peak memory;
12. host engine — benchmarks/system.py's ``--backend host --model bert``
             loop with phase 10's model, batch and loss (the real
             gradient in place of the fake sizes): each step every
             rank's gradient goes into its pinned f32 buffer, four
             ``CollectiveEngine``s (one thread a rank) over
             ``NativeHostChannel``s from ``HostChannel``'s default
             ``auto`` mean-allreduce them in place in the C++ executor
             (the native library built with g++ from the checkout), and
             ``sgd(1e-3, momentum=0.9)`` applies the result on the card.
             Checks: (a) native channels and executor; (b) the four
             reduced buffers bitwise equal to each other and to the
             plain graph walk; (c) the C++ executor and the Python path
             bitwise equal for all eight strategies on 64 MiB a rank,
             and on the whole buffer under AUTO; (d) params after step 1
             within 1e-5 relative L2 per leaf of the device-plane S-SGD
             step; (e) falling loss; (f) ``set_strategy`` at a step
             boundary, the next step passing (b); (g) ZeRO-2 over the
             host plane (``host_bucket_pipeline`` and
             ``host_bucket_all_gather``), pipelined bitwise equal to
             serial, within 1e-5 of (d); (h) ``host_noise_scale`` against
             phase 10's GNS monitor.  Step ms split into grads, D2H,
             allreduce and H2D + update, GB/s per strategy, pinned bytes,
             peak memory and launches per step.

13. recover — the peer runtime and in-flight failure recovery on phase
             6's gpt_small: four ``Peer``s (one thread each) from
             ``parse_config_from_env`` over env dicts in
             ``single_machine_env``'s shape on ports found free, under a
             ``ConfigServer``; rank r takes row r of phase 6's batch.  A
             step: each rank's gradient on the card, D2H into its pinned
             buffer, ``host_bucket_pipeline``'s mean reduce-scatter over
             ``peer.engine()``, ``sgd(0.05, momentum=0.9)`` on the rank's
             chunks on the card, ``host_bucket_all_gather``; then
             ``ZeroBoundary.commit_local`` with ring-buddy mirrors,
             ``StepSnapshot.commit``, ``PersistPlane.commit`` (period 0)
             and ``elastic_step``.  ``KF_CHAOS_SPEC`` kills old rank 3
             (``mode=raise``) at its first engine collective of step 4;
             the survivors call ``recover_from_failure``, replay from
             step 3 at three ranks for steps 4-6; a ``preempt:all``
             clause fires at ``elastic_step``'s announcement of step 6,
             and two fresh peers with ``KF_PERSIST_RESTORE=1`` agree on
             the step-6 manifest, restore their shares and take step 7.
             Checks: (a) each survivor's ``PeerFailureError`` names rank
             3 within the peer deadline plus slack, every thread join
             bounded; (b) three peers at cluster version 1 with one
             digest, the shrunk cluster on the config server; (c) the
             agreed replay step 3, its params bitwise step 3's; (d) the
             re-carved momentum bitwise the step-3 state repadded into
             three chunks (rank 3's chunk from its ring buddy); (e)
             steps 4-6 bitwise a fixed world of three fresh peers; (f)
             the manifest's state bitwise step 6's repadded into two
             chunks, and step 7 bitwise a fixed two-rank world; (g) exact
             launches every step; (h) finite, falling loss.  Step ms at
             4, 3 and 2 ranks split into grads, D2H, reduce-scatter,
             update, all-gather and commits; detection, ping sweep,
             consensus, replay, re-carve, place, persist and restore
             times; pinned bytes, peak memory.
14. gossip — pair averaging on phase 10's bert_base(), batch and loss
             over four ``Peer``s from ``start_local_cluster(4,
             devices=["cuda"])`` (native channels, TCP on loopback), one
             thread each, inner ``sgd(1e-3, momentum=0.9)``, rank r's
             params the shared init perturbed by its own generator; the
             ranks' forward and backward run in turn on the main thread
             (in (b) under one lock).  (a) ``PairAveragingOptimizer``, f32
             wire, roundrobin, three steps in lockstep (a barrier after
             the pulls and after every step): every pulled buffer bitwise
             the version its target published, every peer's params
             bitwise a single-thread replay of the recurrence on the card
             with no wire, step 1's params within phase 10's tolerance of
             the same step under ``KF_TPU_ATTN=xla`` (the gradient's
             distance reported), exact launches.  (b)
             ``AsyncPairAveragingOptimizer``, bf16 wire, random targets,
             ``max_staleness=4``, ten free-running steps a peer: every
             taken buffer bitwise one version another peer published (a
             digest a version), at least nine averaged steps a peer, no
             landing reused past the bound, every puller joined within
             its bound at ``close()``, the cross-peer spread after ten
             steps below ten local steps', a falling mean loss, exact
             launches.  Step ms split into grads, pull, H2D, average +
             update and D2H + publish, pull GB/s and its share of the
             step, fused bytes, pinned bytes, peak memory;
15. adapt  — (a) ``DeviceBanditDriver(comm, check_every=2, min_pulls=1)``
             over psum, two_stage, ring and pallas_ring on S-SGD steps of
             bert_base() over four co-resident ranks (the fused gradient
             and the loss mean-allreduced through ``comm.all_reduce``, the
             large and the small bucket), fourteen steps: every arm of
             the large bucket measured; each arm's reduced gradient
             within 1e-6 relative L2 of psum's; pallas_ring's ring
             reduce-scatter and all-gather launches exact; every hook
             latency at least the CUDA-event time of its own collective
             (events recorded inside the hook's window); each bucket's
             installed arm equal to ``ArmStats.select`` recomputed from
             ``summary()``; one ``swap`` event per bucket and swap with
             the reference's fields; falling loss.  (b) bench.py:1285
             payload_adapt's scenario on three port peers: 200 KiB f32,
             ``delay:ms=30`` on the 0<->1 link for send and ping,
             ``KF_NATIVE_ENGINE=0``, ``HostBanditDriver(check_every=2,
             min_pulls=1, min_swap_collectives=1)``, forty steps after
             ten of each fixed strategy: lockstep swaps, one ``swap``
             event a rank at every swap seq, one final arm, each MST
             install equal to ``minimum_spanning_tree`` of the agreed
             latency matrix and without the 0-1 edge, exact values; the
             steady step against the best fixed strategy is recorded,
             not checked.  (c) ``AdaptiveStrategyDriver`` and
             ``monitored_all_reduce`` on the same peers: one interference
             vote on every rank, lockstep swaps, exact values.

Phase 3 also holds the ring reduce-scatter and all-gather kernels
bitwise against their plain versions, at the main path's shapes (a
262,144-column bucket over four ranks, and the fused [4, 134,404,608]
gradient), at the reference suite's edges and at rows the kernels'
vector loads cannot take whole (a base off 16 bytes, a row stride off 4
elements, odd chunks and cuts, k = 16; 2-, 4- and 8-byte elements for
the all-gather), and times each with its host µs per launch, also at
phase 11's two-rank bucket (524,288 columns).  The fused
LM head's cases other than the flagship's (``LMH_CASES``: all-bf16,
all-f32, ragged N, D and V, clusters of three, four and eight CTAs for
the wgmma dh and dW kernels, and bf16 h with D past the largest
cluster, where dh and dW take the SIMT kernels) each run in a process
of their own (``python3 chip_smoke.py --lm-head-case NAME``), all
started together, so that a kernel that hangs or faults names its case.

Each path's launches are counted from zero just before it runs.  It
prints a ``kernels`` JSON line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Imports neither jax nor kungfu_tpu.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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

#: flash backward, f32: the reference's own tolerances
#: (tests/test_pallas.py:61-145) against the blocked plain version on the
#: same saved (O, lse) and against autograd through plain attention
F32_GRAD_ATOL_BLOCKED = 2e-4
F32_GRAD_ATOL_AUTOGRAD = 5e-4
#: flash backward, bf16, as a share of the largest |gradient|: the kernel
#: rounds dO V^T's inputs, P and dS to bf16 (half an ulp is 2^-9
#: relative) and writes dQ/dK/dV in bf16, where the plain versions keep
#: f32 throughout; each gradient sums up to 2048 such terms, so a few
#: ulps at the top of the range (2^-7 relative is 0.8%) is the expected
#: difference, and 2e-2 leaves room for the longest rows
BF16_GRAD_RTOL = 2e-2
#: xent loss against the one-pass plain version: the reference kernel's
#: own tolerances (tests/test_pallas.py:181-225)
XENT_LOSS_ATOL_F32 = 1e-4
XENT_LOSS_ATOL_BF16 = 1e-3
#: dlogits against the blocked plain version: f32 as the reference's
#: kernel test; bf16 within one bf16 rounding of the largest |dlogit|
XENT_DLOGITS_ATOL_F32 = 2e-5
XENT_DLOGITS_RTOL_BF16 = 2 ** -8
#: first-step gradients, flash + fused xent against plain attention +
#: plain xent, relative L2 per leaf (denominator floored at 1e-3 of the
#: largest leaf's norm: the key biases' gradient is zero in exact
#: arithmetic, as softmax ignores a per-row shift, so both paths return
#: rounding noise there).  The plain attention rounds its scores to bf16
#: before the softmax, the kernel keeps them in f32; that 2^-9 relative
#: noise on the scores travels through 12 layers of bf16 activations
TRAIN_GRAD_REL_L2 = 5e-2
#: fused LM head, loss and lse against the plain version: the reference's
#: own tolerances (tests/test_pallas.py:384-386), |d| <= atol + rtol|ref|;
#: both sides take f32 products (exact for bf16 operands) in another
#: summation order, so they hold in every dtype case
LMH_LOSS_RTOL, LMH_LOSS_ATOL = 2e-5, 1e-6
#: f32 dh and dW: |d| <= rtol|ref| + share * max|ref|, the reference's
#: rtol 1e-4 (:393-395) plus an absolute term scaled to max|grad|: at
#: N = 8192 a dW element sums 8192 f32 terms (a dh element 32128) in
#: another order than cuBLAS, each addition rounding at 2^-24 of a
#: running sum up to max|grad|, so an element that cancels to near zero
#: keeps about sqrt(8192) * 2^-24 = 5.4e-6 of max|grad| of absolute
#: error; the share is twice that
LMH_GRAD_RTOL_F32, LMH_GRAD_ATOL_SHARE = 1e-4, 1e-5
#: bf16 dh and dW: both sides round an f32 sum once; where the two sums
#: straddle a rounding boundary they differ by one bf16 ulp, at most
#: 2^-7 of the value (equal at a power of two); the tolerance is two ulps
LMH_GRAD_RTOL_BF16 = 2 ** -6
#: Transformer.loss against the step's own first loss: the same
#: computation reached through the model's dispatch
MODEL_LOSS_RTOL = 1e-4
#: four ranks' mean loss against phase 6's one-rank loss over the same
#: tokens and params: the same sum of 8192 token losses, taken as four
#: f32 means of 2048 and their mean instead of one mean of 8192
RANKS_LOSS_RTOL = 1e-5
#: the four ranks' reduced first-step gradient against phase 6's
#: one-rank gradient, relative L2 per leaf (floored as for phase 6): the
#: ranks run the same kernels on [1, 2048] slices of phase 6's [4, 2048]
#: batch, so only the GEMMs' tiling at another M and the order of the
#: f32 sums over tokens differ; a bf16 activation that rounds the other
#: way in one layer travels through the rest, and the key biases'
#: gradient is rounding noise in both (zero in exact arithmetic)
RANKS_GRAD_REL_L2 = 5e-2
#: ZeRO params after one step against S-SGD's when they are not bitwise
#: equal: the reference's own tolerance (tests/test_zero.py:70-72)
ZERO_RTOL, ZERO_ATOL = 1e-5, 1e-6

FLAGSHIP = dict(vocab_size=32128, d_model=768, n_layers=12, n_heads=12,
                d_ff=3072, max_seq=512, causal=True, pos="rope",
                dtype="bfloat16")
#: the training path: bench.py:payload_lm's gpt_small at ids [4, 2048]
TRAIN_BATCH, TRAIN_SEQ = 4, 2048
TRAIN_STEPS = 10
#: co-resident ranks of phases 8 and 9: one batch row each
RANKS = 4
#: f32 parameters of gpt_small(max_seq=2048); the 4-rank ring chunk
FLAGSHIP_PARAMS = 134_404_608

#: phase 11: the step-based resize schedule (size:steps, KungFu's
#: ``step_based_schedule`` form) of gpt_small under ZeRO-2 on one card,
#: and its inner optimizer: adam, so the committed boundary carries a
#: replicated scalar leaf (``count``) beside the two vector leaves
ELASTIC_SCHEDULE = "4:3,2:3,4:2"
ELASTIC_LR = 3e-4

#: phase 10: bert_base() (vocab 30528, learned positions, bidirectional)
#: on RANKS co-resident ranks, 8 x 512 tokens a rank; the inner
#: optimizer of benchmarks/system.py:103, sgd(1e-3, momentum=0.9)
BERT_ROWS, BERT_SEQ, BERT_VOCAB = 8, 512, 30528
BERT_PARAMS = 132_340_224
BERT_LR, BERT_MOMENTUM = 1e-3, 0.9
SMA_ALPHA = 0.1
ADA_CHANGE_STEP = 5
MONITOR_STEPS = 5
#: square norms and the variance, f32 on the card against f64 on the
#: host: sums of 132M squares a rank in another order, each rounding at
#: 2^-24 of a running sum (about sqrt(132M) * 6e-8 = 7e-4 relative at
#: worst for a sum of like-signed terms); the raw GNS divides a
#: difference of two such sums, so its error is larger
GNS_SQ_RTOL = 1e-3
GNS_RTOL = 1e-2
#: phase 12: main-path steps of the host engine before the two strategy
#: swaps; ZeRO-2's host bucket (columns a rank) and (c)'s slice
HOST_STEPS = 6
HOST_BUCKET = 1 << 20
HOST_SLICE_BYTES = 64 << 20
#: phase 12's params after one step against the device-plane S-SGD step,
#: relative L2 per leaf: only the order of the f32 four-term mean differs
HOST_PARAMS_RTOL = 1e-5
#: an allreduce mean under the autotuned schedule against psum's: four
#: f32 values summed in another order, rounded once each
AUTOTUNE_RTOL, AUTOTUNE_ATOL = 1e-5, 1e-6
#: phase 14: pair-averaging gossip on bert_base() over four peers: the
#: steps of the blocking optimizer (lockstep) and of the async one (free
#: running), the async run's staleness bound, and the absolute
#: perturbation of each rank's copy of the shared init (rank r draws
#: from its own generator, so the models differ)
GOSSIP_BLOCKING_STEPS = 3
GOSSIP_ASYNC_STEPS = 10
GOSSIP_STALENESS = 4
GOSSIP_PERTURB = 1e-3
#: async steps that must average with a landed model, of the ten: the
#: first blocks for its landing, so all ten should
GOSSIP_MIN_AVERAGED = 9
#: phase 15: device-bandit steps at check_every 2, so that every arm of
#: the large bucket is installed, settles for a window and is measured
#: in the next (four arms x two checks, ending on a check), and the
#: relative L2 of every arm's reduced gradient against psum's: four f32
#: terms summed in another order, rounded once each
ADAPT_STEPS = 14
ADAPT_CHECK_EVERY = 2
ADAPT_ARM_REL_L2 = 1e-6
#: phase 15's CUDA events are recorded inside the latency hook's window,
#: so the hook's seconds can fall short of the events' time only by the
#: events' resolution (0.5 us)
HOOK_EVENT_RESOLUTION_S = 1e-6
#: phase 15 (b)-(c): bench.py:1285 payload_adapt's scenario (three
#: peers, 200 KiB f32, 30 ms on the 0<->1 link for send and ping)
HOST_ADAPT_ELEMS = 50_000
HOST_ADAPT_WIRE_MS = 30
HOST_ADAPT_FIXED_STEPS = 10
HOST_ADAPT_STEPS = 40
HOST_ADAPT_FIXED_ARMS = ("STAR", "RING", "BINARY_TREE_STAR")
DRIVER_STEPS = 12


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


def bound(spec, flops: float, nbytes: float) -> dict:
    """Least time on the card: the larger of bf16 operations over the
    dense bf16 peak and bytes over the memory rate (datasheet)."""
    t_ops = flops / spec["bf16_flops"] * 1e3
    t_bytes = nbytes / spec["hbm_bytes_s"] * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


#: bf16 edge cases of the wgmma kernels' tiling (128-row q blocks and
#: kv tiles in the forward, 128 kv rows by 64- or 32-row q tiles in the
#: dK/dV kernel): sequence lengths on both sides of the tile edges
EDGE_SEQS = (1, 63, 65, 127, 129, 2047)
EDGE_BH = (1, 12)
EDGE_DIMS = (32, 64, 128)
#: the main-path shapes [BH, S, D] of the flash kernels and their mask:
#: the serving forward, the one-rank training step, one of four
#: co-resident ranks, and one BERT-base rank of phase 10 (8 x 512
#: tokens, 12 heads, bidirectional)
FLASH_SHAPES = {"s256": (48, 256, 64, True),
                "s2048": (48, TRAIN_SEQ, 64, True),
                "rank_s2048": (12, TRAIN_SEQ, 64, True),
                "bert_s512": (8 * 12, 512, 64, False)}
#: the backward's timed shapes: the two causal training shapes and BERT's
FLASH_BWD_SHAPES = ("s2048", "rank_s2048", "bert_s512")


def _edge_cases():
    """(name, (BH, S, D), causal, input scale) of the bf16 edge grid, and
    one case with q and k scaled by 8, so row maxima move across kv
    blocks."""
    cases = [(f"edge_bh{bh}_s{s}_d{d}_{'causal' if c else 'full'}",
              (bh, s, d), c, 1.0)
             for s in EDGE_SEQS for bh in EDGE_BH for d in EDGE_DIMS
             for c in (True, False)]
    cases.append(("edge_x8_bh12_s2047_d64_causal", (12, 2047, 64), True, 8.0))
    return cases


def host_us(torch, fn, calls: int = 200) -> float:
    """Host µs per call of ``fn`` (a kernel wrapper), enqueued behind a
    sleep kernel so the launch queue never blocks."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(400_000_000)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def phase_flash_forward(torch, attention, spec):
    """Forward kernel vs plain version at the main shapes and the edge
    cases."""
    import torch.nn.functional as F

    cases = [
        # name, (B, H, S, D), dtype, causal
        ("main", (4, 12, 256, 64), torch.bfloat16, True),
        ("train_main", (TRAIN_BATCH, 12, TRAIN_SEQ, 64), torch.bfloat16, True),
        ("bert_main", (BERT_ROWS, 12, BERT_SEQ, 64), torch.bfloat16, False),
        ("f32_causal_ragged", (2, 4, 200, 64), torch.float32, True),
        ("bf16_noncausal", (4, 12, 256, 64), torch.bfloat16, False),
        ("bf16_d128", (2, 8, 256, 128), torch.bfloat16, True),
        ("bf16_d32_ragged_noncausal", (2, 4, 130, 32), torch.bfloat16, False),
        ("f32_d128_noncausal", (1, 2, 100, 128), torch.float32, False),
        ("f32_d32", (1, 3, 70, 32), torch.float32, True),
    ]
    cases = ([(n, sh, dt, c, 1.0) for n, sh, dt, c in cases]
             + [(n, (1, *sh), torch.bfloat16, c, x)
                for n, sh, c, x in _edge_cases()])
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    worst = {"o_err": 0.0, "lse_err": 0.0}
    for name, (b, h, s, d), dtype, causal, x in cases:
        q, k, v = (torch.randn((b * h, s, d), generator=gen, device="cuda"
                               ) for _ in range(3))
        q, k, v = ((q * x).to(dtype), (k * x).to(dtype), v.to(dtype))
        out, lse = attention.flash_attention_with_lse(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref_o, ref_lse = attention.flash_attention_reference(q, k, v, causal)
        o_err = (out.float() - ref_o.float()).abs().max().item()
        l_err = (lse - ref_lse).abs().max().item()
        o_tol, l_tol = ((BF16_O_ATOL, BF16_LSE_ATOL) if dtype == torch.bfloat16
                        else (F32_ATOL, F32_ATOL))
        edge = name.startswith("edge_")
        if not edge:
            print(f"flash fwd {name}: shape {(b, h, s, d)} {str(dtype)[6:]} "
                  f"causal={causal} max|dO|={o_err:.3e} (tol {o_tol}) "
                  f"max|dlse|={l_err:.3e} (tol {l_tol})")
        check(bool(torch.isfinite(out.float()).all()), f"{name}: non-finite O")
        check(o_err <= o_tol, f"{name}: O error {o_err} > {o_tol}")
        check(l_err <= l_tol, f"{name}: lse error {l_err} > {l_tol}")
        results[name] = {"o_err": o_err, "lse_err": l_err}
        if edge:
            worst = {"o_err": max(worst["o_err"], o_err),
                     "lse_err": max(worst["lse_err"], l_err)}
        del q, k, v, out, lse, ref_o, ref_lse
    n_edge = len(_edge_cases())
    print(f"flash fwd bf16 edges: {n_edge} cases (S {EDGE_SEQS} x BH "
          f"{EDGE_BH} x D {EDGE_DIMS} x causal/full, and q, k x8 at "
          f"[12, 2047, 64]): worst max|dO|={worst['o_err']:.3e} (tol "
          f"{BF16_O_ATOL}), max|dlse|={worst['lse_err']:.3e} (tol "
          f"{BF16_LSE_ATOL})")

    # timing at the main-path shapes (contiguous [BH, S, D]; warm L2)
    timing = {}
    for label, (bh, s, d, causal) in FLASH_SHAPES.items():
        q, k, v = (torch.randn((bh, s, d), generator=gen, device="cuda"
                               ).to(torch.bfloat16) for _ in range(3))
        q4, k4, v4 = (t.view(1, bh, s, d) for t in (q, k, v))
        ms = device_ms(torch, lambda: attention._launch(q, k, v, causal))
        plain_ms = device_ms(torch, lambda: attention.flash_attention_reference(
            q, k, v, causal), iters=1, windows=5)
        library_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal))
        us = host_us(torch, lambda: attention._launch(q, k, v, causal))
        # each (q, k) pair needs 4*D FLOPs (QK^T and PV): s(s+1)/2 pairs
        # a row block under the causal mask, s*s without; bytes are q, k,
        # v read once, O written once (bf16), lse written (f32)
        pairs = bh * (s * (s + 1) // 2 if causal else s * s)
        t = bound(spec, 4 * d * pairs, 4 * bh * s * d * 2 + bh * s * 4)
        timing[label] = {"ms": ms, "plain_ms": plain_ms,
                         "library_ms": library_ms, "host_us": us, **t}
        print(f"flash fwd timing {label} [{bh}, {s}, {d}] causal={causal}: "
              f"kernel {ms:.4f} "
              f"ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}, "
              f"{t['bound_ms'] / ms:.1%} of it); "
              f"{t['flops'] / ms / 1e9:.1f} TFLOP/s; host {us:.1f} us per "
              f"launch")
        del q, k, v, q4, k4, v4
    return results, timing


def _grad_err(got, ref) -> float:
    return max((a.float() - b.float()).abs().max().item()
               for a, b in zip(got, ref))


def phase_flash_backward(torch, attention, spec):
    """dQ and dK/dV kernels (through the autograd op, with dO and dlse
    cotangents) vs the blocked plain version and vs autograd through the
    plain forward, at the main shape and the edge cases."""
    cases = [
        # name, (B, H, S, D), dtype, causal, nonzero dlse
        ("main", (TRAIN_BATCH, 12, TRAIN_SEQ, 64), torch.bfloat16, True, False),
        ("bert_main", (BERT_ROWS, 12, BERT_SEQ, 64), torch.bfloat16, False,
         False),
        ("bf16_dlse", (2, 4, 256, 64), torch.bfloat16, True, True),
        ("bf16_noncausal", (2, 4, 256, 64), torch.bfloat16, False, False),
        ("bf16_d32", (2, 4, 256, 32), torch.bfloat16, True, False),
        ("bf16_d128_ragged", (2, 4, 200, 128), torch.bfloat16, True, True),
        ("f32_causal_ragged", (2, 4, 200, 64), torch.float32, True, True),
        ("f32_noncausal", (1, 3, 130, 32), torch.float32, False, True),
        ("f32_d128", (1, 2, 100, 128), torch.float32, True, False),
    ]
    cases = ([(*c, 1.0) for c in cases]
             + [(n, (1, *sh), torch.bfloat16, c, False, x)
                for n, sh, c, x in _edge_cases()])
    gen = torch.Generator(device="cuda").manual_seed(1)
    results = {}
    worst = 0.0
    for name, (b, h, s, d), dtype, causal, with_dlse, x in cases:
        shape = (b * h, s, d)
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       for _ in range(4))
        q, k, v, do = ((q * x).to(dtype), (k * x).to(dtype), v.to(dtype),
                       do.to(dtype))
        dl = (torch.randn((b * h, s), generator=gen, device="cuda")
              if with_dlse else torch.zeros((b * h, s), device="cuda"))
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out, lse = attention.flash_attention_with_lse(*leaves, causal=causal)
        got = torch.autograd.grad((out, lse), leaves, (do, dl))
        torch.cuda.synchronize()
        delta = (do.float() * out.float()).sum(-1) - dl
        blocked = attention.flash_attention_backward_reference(
            q, k, v, out.detach(), lse.detach(), do, causal, delta=delta)
        f32 = [t.float().requires_grad_(True) for t in (q, k, v)]
        ro, rl = attention.flash_attention_reference(*f32, causal)
        auto = torch.autograd.grad((ro, rl), f32, (do.float(), dl))
        e_blk, e_auto = _grad_err(got, blocked), _grad_err(got, auto)
        if dtype == torch.bfloat16:
            top = max(t.abs().max().item() for t in auto)
            t_blk = t_auto = BF16_GRAD_RTOL * top
        else:
            t_blk, t_auto = F32_GRAD_ATOL_BLOCKED, F32_GRAD_ATOL_AUTOGRAD
        if name.startswith("edge_"):
            worst = max(worst, e_blk / t_blk, e_auto / t_auto)
        else:
            print(f"flash bwd {name}: shape {(b, h, s, d)} {str(dtype)[6:]} "
                  f"causal={causal} dlse={with_dlse} max|d(dq,dk,dv)| vs "
                  f"blocked {e_blk:.3e} (tol {t_blk:.3e}), vs autograd "
                  f"{e_auto:.3e} (tol {t_auto:.3e})")
        check(all(bool(torch.isfinite(g.float()).all()) for g in got),
              f"{name}: non-finite gradients")
        check(e_blk <= t_blk, f"{name}: backward vs blocked {e_blk} > {t_blk}")
        check(e_auto <= t_auto,
              f"{name}: backward vs autograd {e_auto} > {t_auto}")
        results[name] = {"dq_err": _grad_err(got[:1], blocked[:1]),
                         "dkv_err": _grad_err(got[1:], blocked[1:]),
                         "err_vs_autograd": e_auto}
        del q, k, v, do, leaves, out, lse, got, blocked, f32, ro, rl, auto
    print(f"flash bwd bf16 edges: {len(_edge_cases())} cases (as the "
          f"forward's), the largest error used {worst:.3f} of its tolerance "
          f"(vs blocked and vs autograd, {BF16_GRAD_RTOL} of max|grad|)")
    check(worst <= 1.0, "a bf16 edge case exceeded its tolerance")

    # timing at the training shapes: each kernel alone, the plain
    # backward, and SDPA's backward (forward + backward less the forward)
    import torch.nn.functional as F

    timing = {}
    for label in FLASH_BWD_SHAPES:
        bh, s, d, causal = FLASH_SHAPES[label]
        q, k, v, do = (torch.randn((bh, s, d), generator=gen, device="cuda"
                                   ).to(torch.bfloat16) for _ in range(4))
        out, lse = attention._launch(q, k, v, causal)
        delta = (do.float() * out.float()).sum(-1)
        dq_ms = device_ms(torch, lambda: attention._launch_bwd_dq(
            q, k, v, do, lse, delta, causal))
        dkv_ms = device_ms(torch, lambda: attention._launch_bwd_dkv(
            q, k, v, do, lse, delta, causal))
        dq_us = host_us(torch, lambda: attention._launch_bwd_dq(
            q, k, v, do, lse, delta, causal))
        dkv_us = host_us(torch, lambda: attention._launch_bwd_dkv(
            q, k, v, do, lse, delta, causal))
        plain_ms = device_ms(
            torch, lambda: attention.flash_attention_backward_reference(
                q, k, v, out, lse, do, causal), iters=1, windows=5)
        q4, k4, v4 = (t.view(1, bh, s, d).clone().requires_grad_(True)
                      for t in (q, k, v))
        do4 = do.view(1, bh, s, d)

        def sdpa_fwd_bwd():
            o = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
            torch.autograd.grad(o, (q4, k4, v4), do4)

        with torch.no_grad():
            sdpa_fwd = device_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal))
        library_ms = device_ms(torch, sdpa_fwd_bwd) - sdpa_fwd
        pairs = bh * (s * (s + 1) // 2 if causal else s * s)
        # dQ: 3 products per causal pair (QK^T, dO V^T, dS K), 2*D FLOPs
        # each; reads q, k, v, dO (bf16) and lse, delta (f32), writes dq
        # dK/dV: 4 products (QK^T, dO V^T, P^T dO, dS^T Q); writes dk, dv
        rows = bh * s * 4 * 2
        t_dq = bound(spec, 3 * 2 * d * pairs, 5 * bh * s * d * 2 + rows)
        t_dkv = bound(spec, 4 * 2 * d * pairs, 6 * bh * s * d * 2 + rows)
        timing[label] = {
            "dq": {"ms": dq_ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, "host_us": dq_us, **t_dq},
            "dkv": {"ms": dkv_ms, "plain_ms": plain_ms,
                    "library_ms": library_ms, "host_us": dkv_us, **t_dkv},
        }
        print(f"flash bwd timing {label} [{bh}, {s}, {d}] causal={causal}: "
              f"dQ {dq_ms:.4f} ms "
              f"(bound {t_dq['bound_ms']:.4f}, {t_dq['bound_by']}, "
              f"{t_dq['bound_ms'] / dq_ms:.1%} of it, "
              f"{t_dq['flops'] / dq_ms / 1e9:.1f} TFLOP/s, host "
              f"{dq_us:.1f} us per launch), dK/dV "
              f"{dkv_ms:.4f} ms (bound {t_dkv['bound_ms']:.4f}, "
              f"{t_dkv['bound_by']}, {t_dkv['bound_ms'] / dkv_ms:.1%} of it, "
              f"{t_dkv['flops'] / dkv_ms / 1e9:.1f} TFLOP/s, host "
              f"{dkv_us:.1f} us per launch); plain backward {plain_ms:.4f} "
              f"ms; sdpa backward {library_ms:.4f} ms (fwd+bwd less fwd "
              f"{sdpa_fwd:.4f})")
        del q, k, v, do, out, lse, delta, q4, k4, v4, do4
    return results, timing


def phase_xent(torch, xk, spec):
    """Fused cross-entropy forward and backward kernels vs their plain
    versions, at the main shape (f32 and bf16) and ragged edges."""
    import torch.nn.functional as F

    n_main, v_main = TRAIN_BATCH * TRAIN_SEQ, FLAGSHIP["vocab_size"]
    cases = [
        # name, N, V, dtype
        ("main", n_main, v_main, torch.float32),
        ("bf16_main", n_main, v_main, torch.bfloat16),
        ("bert_main", BERT_ROWS * BERT_SEQ, BERT_VOCAB, torch.float32),
        ("ragged_v", 300, 1000, torch.float32),
        ("ragged_n", 8191, 2048, torch.float32),
        ("bf16_ragged", 517, 1000, torch.bfloat16),
    ]
    gen = torch.Generator(device="cuda").manual_seed(2)
    results = {}
    for name, n, v, dtype in cases:
        x = (torch.randn((n, v), generator=gen, device="cuda") * 3).to(dtype)
        t = torch.randint(0, v, (n,), generator=gen, device="cuda")
        g = torch.randn((n,), generator=gen, device="cuda")
        loss, lse = xk.forward(x, t)
        dlog = xk.backward(x, t, lse, g)
        torch.cuda.synchronize()
        ref_loss, ref_lse = xk.xent_forward_reference(x, t)
        ref_d = xk.xent_backward_reference(x, t, ref_lse, g)
        l_err = (loss - ref_loss).abs().max().item()
        d_err = (dlog.float() - ref_d.float()).abs().max().item()
        if dtype == torch.bfloat16:
            l_tol = XENT_LOSS_ATOL_BF16
            d_tol = XENT_DLOGITS_RTOL_BF16 * ref_d.float().abs().max().item()
        else:
            l_tol, d_tol = XENT_LOSS_ATOL_F32, XENT_DLOGITS_ATOL_F32
        print(f"xent {name}: [{n}, {v}] {str(dtype)[6:]} max|dloss|="
              f"{l_err:.3e} (tol {l_tol}) max|ddlogits|={d_err:.3e} "
              f"(tol {d_tol:.3e})")
        check(bool(torch.isfinite(loss).all()), f"xent {name}: non-finite loss")
        check(dlog.dtype == dtype, f"xent {name}: dlogits dtype {dlog.dtype}")
        check(l_err <= l_tol, f"xent {name}: loss error {l_err} > {l_tol}")
        check(d_err <= d_tol, f"xent {name}: dlogits error {d_err} > {d_tol}")
        results[name] = {"loss_err": l_err, "dlogits_err": d_err}
        del x, t, g, loss, lse, dlog, ref_loss, ref_lse, ref_d

    # timing at the main shapes (the flagship step's, one BERT-base
    # rank's), f32 logits as the models produce them
    timing = {}
    for label, (n, v) in {"main": (n_main, v_main),
                          "bert": (BERT_ROWS * BERT_SEQ, BERT_VOCAB)}.items():
        x = torch.randn((n, v), generator=gen, device="cuda")
        t = torch.randint(0, v, (n,), generator=gen, device="cuda")
        g = torch.full((n,), 1.0 / n, device="cuda")
        _, lse = xk.forward(x, t)
        fwd_ms = device_ms(torch, lambda: xk.forward(x, t))
        bwd_ms = device_ms(torch, lambda: xk.backward(x, t, lse, g))
        fwd_us = host_us(torch, lambda: xk.forward(x, t))
        bwd_us = host_us(torch, lambda: xk.backward(x, t, lse, g))
        plain_fwd = device_ms(torch, lambda: xk.xent_forward_reference(x, t),
                              iters=1, windows=5)
        plain_bwd = device_ms(torch, lambda: xk.xent_backward_reference(
            x, t, lse, g), iters=1, windows=5)
        with torch.no_grad():
            lib_fwd = device_ms(torch, lambda: F.cross_entropy(
                x, t, reduction="none"), iters=1, windows=5)
        xr = x.clone().requires_grad_(True)

        def lib_fwd_bwd():
            torch.autograd.grad(F.cross_entropy(xr, t, reduction="none"), xr,
                                g)

        lib_bwd = device_ms(torch, lib_fwd_bwd, iters=1, windows=5) - lib_fwd
        # no matrix product: the forward reads the logits once (and writes
        # two [N] f32 vectors); the backward reads them once and writes
        # dlogits
        t_fwd = bound(spec, 0, n * v * 4 + n * 4 + 2 * n * 4)
        t_bwd = bound(spec, 0, 2 * n * v * 4 + n * 4 * 3)
        timing[label] = {
            "fwd": {"ms": fwd_ms, "plain_ms": plain_fwd,
                    "library_ms": lib_fwd, "host_us": fwd_us, **t_fwd},
            "bwd": {"ms": bwd_ms, "plain_ms": plain_bwd,
                    "library_ms": lib_bwd, "host_us": bwd_us, **t_bwd},
        }
        print(f"xent timing {label} [{n}, {v}] f32: fwd {fwd_ms:.4f} ms "
              f"(bound {t_fwd['bound_ms']:.4f}, plain {plain_fwd:.4f}, "
              f"F.cross_entropy {lib_fwd:.4f}); bwd {bwd_ms:.4f} ms (bound "
              f"{t_bwd['bound_ms']:.4f}, plain {plain_bwd:.4f}, "
              f"F.cross_entropy backward {lib_bwd:.4f}); "
              f"{t_fwd['bytes'] / fwd_ms / 1e6:.0f} and "
              f"{t_bwd['bytes'] / bwd_ms / 1e6:.0f} GB/s; host {fwd_us:.1f} "
              f"and {bwd_us:.1f} us per launch")
        del x, t, g, lse, xr
    return results, timing


def _ratio(got, ref, rtol: float, atol: float) -> float:
    """max over elements of |got - ref| / (atol + rtol |ref|); <= 1 passes."""
    ref = ref.float()
    d = (got.float() - ref).abs()
    return (d / (atol + rtol * ref.abs())).max().item()


#: the fused LM head's cases: N, D, V, h dtype, W dtype.  bf16 h takes
#: the wgmma forward, dh and dW kernels on the split of W (f32 h the
#: SIMT ones)
LMH_CASES = {
    "main": (TRAIN_BATCH * TRAIN_SEQ, FLAGSHIP["d_model"],
             FLAGSHIP["vocab_size"], "bfloat16", "float32"),
    "bf16": (2048, 768, 8192, "bfloat16", "bfloat16"),
    "f32": (1024, 768, 4096, "float32", "float32"),
    "ragged": (517, 200, 1000, "bfloat16", "float32"),
    "ragged_f32_wide": (130, 1000, 777, "float32", "float32"),
    # the wgmma kernels' edges: V not a multiple of their 64 or 128 vocab
    # columns, D not a multiple of 16, N not a multiple of their 64 or
    # 128 rows
    "ragged_bf16": (517, 200, 1000, "bfloat16", "bfloat16"),
    # a cluster of three CTAs, the last partly past D; D not a multiple
    # of 8, so h is copied to rows of a 16-byte pitch
    "ragged_cluster3": (300, 603, 777, "bfloat16", "float32"),
    # a cluster of four CTAs
    "ragged_cluster4": (130, 1000, 777, "bfloat16", "float32"),
    # the largest cluster, eight CTAs
    "ragged_cluster8": (130, 2048, 777, "bfloat16", "float32"),
    # bf16 h past a cluster's eight slices: the wgmma forward, the SIMT
    # dh and dW kernels
    "ragged_bf16_wide": (130, 2100, 777, "bfloat16", "float32"),
}


def lm_head_case(torch, lmk, name: str) -> dict:
    """One case of the fused LM head: the split kernel bitwise against
    its plain version (bf16 h), then the forward, dh and dW kernels
    against theirs, with out-of-vocab targets in the ragged cases; the
    backward takes the forward's split of W, as the autograd function
    passes it."""
    n, d, v, dt_h, dt_w = LMH_CASES[name]
    dt_h, dt_w = getattr(torch, dt_h), getattr(torch, dt_w)
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(
        3 + list(LMH_CASES).index(name))
    h = torch.randn((n, d), generator=gen, device="cuda").to(dt_h)
    w = (torch.randn((d, v), generator=gen, device="cuda") * 0.05).to(dt_w)
    t = torch.randint(0, v, (n,), generator=gen, device="cuda")
    if name.startswith("ragged"):
        t[:2] = torch.tensor([-1, v + 7])  # out of vocab: loss = lse
    g = torch.randn((n,), generator=gen, device="cuda")
    if dt_h == bf16:
        hi, lo = lmk.split_w(w)
        ref_hi, ref_lo = lmk.split_w_reference(w)
        torch.cuda.synchronize()
        check(torch.equal(hi.view(torch.int16), ref_hi.view(torch.int16))
              and (lo is None or torch.equal(lo.view(torch.int16),
                                             ref_lo.view(torch.int16))),
              f"lm_head {name}: split kernel != plain version")
        del hi, lo, ref_hi, ref_lo
    loss, lse, split = lmk.forward(h, w, t)
    check((split is not None) == (dt_h == bf16),
          f"lm_head {name}: the forward kept no split of W")
    dh, dw = lmk.backward(h, w, t, lse, g, split)
    del split
    torch.cuda.synchronize()
    ref_loss, ref_lse = lmk.lm_head_forward_reference(h, w, t)
    ref_dh, ref_dw = lmk.lm_head_backward_reference(h, w, t, ref_lse, g)
    ratios = {"loss": _ratio(loss, ref_loss, LMH_LOSS_RTOL, LMH_LOSS_ATOL),
              "lse": _ratio(lse, ref_lse, LMH_LOSS_RTOL, LMH_LOSS_ATOL)}
    for key, got, ref in (("dh", dh, ref_dh), ("dw", dw, ref_dw)):
        rtol = LMH_GRAD_RTOL_BF16 if got.dtype == bf16 else LMH_GRAD_RTOL_F32
        atol = LMH_GRAD_ATOL_SHARE * ref.float().abs().max().item()
        ratios[key] = _ratio(got, ref, rtol, atol)
    errs = {"loss_err": (loss - ref_loss).abs().max().item(),
            "dh_err": (dh.float() - ref_dh.float()).abs().max().item(),
            "dw_err": (dw.float() - ref_dw.float()).abs().max().item()}
    print(f"lm_head {name}: h [{n}, {d}] {str(dt_h)[6:]} W [{d}, {v}] "
          f"{str(dt_w)[6:]}: share of tolerance used: " + ", ".join(
              f"{k} {r:.3f}" for k, r in ratios.items())
          + f"; max|dloss| {errs['loss_err']:.3e} max|ddh| "
          f"{errs['dh_err']:.3e} (max|dh| {ref_dh.float().abs().max().item():.3e}) "
          f"max|ddW| {errs['dw_err']:.3e} (max|dW| "
          f"{ref_dw.float().abs().max().item():.3e})", flush=True)
    check(dh.dtype == dt_h and dw.dtype == dt_w,
          f"lm_head {name}: gradient dtypes {dh.dtype} {dw.dtype}")
    for key, r in ratios.items():
        check(r <= 1.0, f"lm_head {name}: {key} off by {r:.3f} of its "
              f"tolerance")
    if name.startswith("ragged"):
        check(bool(torch.equal(loss[:2], lse[:2])),
              f"lm_head {name}: out-of-vocab targets do not give lse")
    return {**errs, **{f"{k}_tol_share": r for k, r in ratios.items()}}


def _lm_head_edges() -> dict:
    """Every case but the main one, each in a process of its own (all
    started together), so that a hang or a fault names its case."""
    def run(name):
        try:
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--lm-head-case",
                 name], capture_output=True, text=True, timeout=300, cwd=HERE)
        except subprocess.TimeoutExpired:
            return name, None, "timed out after 300 s"
        lines = [ln for ln in out.stdout.splitlines()
                 if ln.startswith("LMH_CASE ")]
        for ln in out.stdout.splitlines():
            if ln.startswith("lm_head "):
                print(ln)
        if out.returncode != 0 or not lines:
            return name, None, (f"exit {out.returncode}: "
                                f"{out.stderr.strip()[-1500:]}")
        return name, json.loads(lines[-1][len("LMH_CASE "):]), None

    names = [k for k in LMH_CASES if k != "main"]
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        done = list(pool.map(run, names))
    for name, _, err in done:
        check(err is None, f"lm_head {name}: {err}")
    return {name: res for name, res, _ in done}


def phase_lm_head(torch, lmk, spec):
    """Fused LM-head forward, dh and dW kernels (and the split of W for
    the wgmma dW kernel) vs their plain versions at the flagship shape
    (bf16 h, f32 W) in this process, then the other cases of
    ``LMH_CASES`` each in its own process; then timed at the flagship
    shape beside the plain versions and the plain head they replace."""
    import torch.nn.functional as F

    bf16 = torch.bfloat16
    n_main, d_main, v_main = LMH_CASES["main"][:3]
    results = {"main": lm_head_case(torch, lmk, "main")}
    torch.cuda.empty_cache()
    results.update(_lm_head_edges())
    gen = torch.Generator(device="cuda").manual_seed(3)

    # timing at the main shape: each kernel alone (windows of 1-2
    # launches keep each kernel's timing to a few seconds), the plain
    # versions, and the plain head they replace: the f32 product plus
    # F.cross_entropy, and autograd's backward of that pair
    n, d, v = n_main, d_main, v_main
    h = torch.randn((n, d), generator=gen, device="cuda").to(bf16)
    w = torch.randn((d, v), generator=gen, device="cuda") * 0.05
    t = torch.randint(0, v, (n,), generator=gen, device="cuda")
    t32 = t.to(torch.int32)
    g = torch.full((n,), 1.0 / n, device="cuda")
    lse = lmk._launch_fwd(h, w, t32)[1]
    fwd_ms = device_ms(torch, lambda: lmk._launch_fwd(h, w, t32), iters=2,
                       windows=5)
    dh_ms = device_ms(torch, lambda: lmk._launch_dh(h, w, t32, lse, g),
                      iters=1, windows=5)
    dw_ms = device_ms(torch, lambda: lmk._launch_dw(h, w, t32, lse, g),
                      iters=1, windows=5)
    split_ms = device_ms(torch, lambda: lmk.split_w(w), iters=5, windows=5)
    host = {"fwd": host_us(torch, lambda: lmk._launch_fwd(h, w, t32), 10),
            "dh": host_us(torch, lambda: lmk._launch_dh(h, w, t32, lse, g), 10),
            "dw": host_us(torch, lambda: lmk._launch_dw(h, w, t32, lse, g), 10)}
    plain_fwd = device_ms(torch, lambda: lmk.lm_head_forward_reference(
        h, w, t), iters=1, windows=3)
    plain_bwd = device_ms(torch, lambda: lmk.lm_head_backward_reference(
        h, w, t, lse, g), iters=1, windows=3)
    with torch.no_grad():
        head_fwd = device_ms(torch, lambda: F.cross_entropy(
            h.float() @ w, t, reduction="none"), iters=1, windows=5)
    hr, wr = h.clone().requires_grad_(True), w.clone().requires_grad_(True)

    def head_fwd_bwd():
        torch.autograd.grad(F.cross_entropy(hr.float() @ wr, t,
                                            reduction="none"), (hr, wr), g)

    head_bwd = device_ms(torch, head_fwd_bwd, iters=1, windows=5) - head_fwd
    # one product is 2*N*D*V FLOPs (the forward does one, each backward
    # kernel two: the recomputed logits and its own); bytes: h, W,
    # targets read once (the backward also lse and g), loss and lse
    # written (f32), dh (h's dtype) or dW (W's dtype) written
    prod = 2 * n * d * v
    reads = h.numel() * h.element_size() + w.numel() * w.element_size() + n * 4
    timing = {}
    for key, ms, plain, head, flops, nbytes in (
            ("fwd", fwd_ms, plain_fwd, head_fwd, prod, reads + 2 * n * 4),
            ("dh", dh_ms, plain_bwd, head_bwd, 2 * prod,
             reads + 2 * n * 4 + h.numel() * h.element_size()),
            ("dw", dw_ms, plain_bwd, head_bwd, 2 * prod,
             reads + 2 * n * 4 + w.numel() * w.element_size())):
        timing[key] = {"ms": ms, "plain_ms": plain, "library_ms": None,
                       "plain_head_ms": head, "host_us": host[key],
                       "bound_fp32_ms": flops / spec["f32_flops"] * 1e3,
                       **bound(spec, flops, nbytes)}
    # the wgmma kernels run bf16 products of 2*N*D*V each: the logits
    # from W's two terms (all three kernels), then dW from dl's two terms
    # (four in all) or dh from dl_hi W_hi, dl_hi W_lo and dl_lo W_hi
    # (five); each times the split of W, which it makes when not given one
    for key, products in (("fwd", 2), ("dh", 5), ("dw", 4)):
        timing[key]["split_ms"] = split_ms
        timing[key]["bound_executed_ms"] = (products * prod
                                            / spec["bf16_flops"] * 1e3)
    print(f"lm_head timing main [{n}, {d}] x [{d}, {v}] bf16 h, f32 W: fwd "
          f"{fwd_ms:.4f} ms, dh {dh_ms:.4f} ms, dW {dw_ms:.4f} ms (bounds "
          f"{timing['fwd']['bound_ms']:.4f} / {timing['dh']['bound_ms']:.4f} "
          f"/ {timing['dw']['bound_ms']:.4f} at bf16 peak, "
          f"{timing['fwd']['bound_fp32_ms']:.4f} / "
          f"{timing['dh']['bound_fp32_ms']:.4f} / "
          f"{timing['dw']['bound_fp32_ms']:.4f} at FP32 peak; the kernels "
          f"execute {timing['fwd']['bound_executed_ms']:.4f} / "
          f"{timing['dh']['bound_executed_ms']:.4f} / "
          f"{timing['dw']['bound_executed_ms']:.4f} of bf16 work; the split "
          f"of W, {split_ms:.4f} ms, is in each time); host {host['fwd']:.1f} / "
          f"{host['dh']:.1f} / {host['dw']:.1f} us per launch; plain "
          f"versions fwd {plain_fwd:.4f} ms, bwd {plain_bwd:.4f} ms; plain "
          f"head (f32 product + F.cross_entropy, two calls) fwd "
          f"{head_fwd:.4f} ms, bwd {head_bwd:.4f} ms; "
          f"{prod / fwd_ms / 1e9:.1f} / {2 * prod / dh_ms / 1e9:.1f} / "
          f"{2 * prod / dw_ms / 1e9:.1f} TFLOP/s")
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


def _counts(kernels) -> dict:
    return {k: n for mod in kernels for k, n in mod.launch_counts.items()}


def _reset(kernels) -> None:
    for mod in kernels:
        mod.reset_launch_counts()


def phase_train(torch, np, kernels, tr, costmodel, spec, head: str):
    """The flagship training step through the kernels: launches per step,
    first-step gradients against the plain path, ten steps of falling
    loss on a fixed batch, one step through Transformer.loss under the
    knob that routes to the same kernels, then step time, tokens/s, MFU
    and the peak memory of the timed steps.

    ``head="plain"`` (phase 6): logits from the model, the fused xent
    kernels, held against plain attention + plain xent; the model step
    runs under KF_TPU_XENT=fused.  ``head="fused"`` (phase 7): the fused
    LM-head kernels on the final features, held against flash + plain
    head + plain xent, so the comparison isolates the head; the model
    step runs under KF_TPU_LM_HEAD=fused."""
    from kungfu_tpu_torch.comm.device import Communicator
    from kungfu_tpu_torch.ops import xent
    from kungfu_tpu_torch.ops.lm_head import lm_head_nll
    from kungfu_tpu_torch.optimizers import sgd, synchronous_sgd
    from kungfu_tpu_torch.parallel.train import dp_train_step

    t0 = time.perf_counter()
    model, params, batch, flash, loss_fn = _flagship_train(torch, np, tr,
                                                           kernels[0])
    cfg = model.cfg
    torch.cuda.synchronize()
    print(f"train ({head} head) init: {time.perf_counter() - t0:.2f} s")

    if head == "fused":
        def loss_fn(p, b):  # noqa: F811 -- the fused head replaces it
            h = model.hidden(p, b[0], train=True, attn_fn=flash)
            return lm_head_nll(h, p["head"]["w"], b[1]).mean()

        ref_attn, knob = flash, "KF_TPU_LM_HEAD"
        routed = {"lm_head_fwd": 1, "lm_head_bwd_dh": 1, "lm_head_bwd_dw": 1,
                  "lm_head_split": 1}
    else:
        ref_attn, knob = tr.default_attention, "KF_TPU_XENT"
        routed = {"xent_fwd": 1, "xent_bwd": 1}

    def loss_plain(p, b):
        logits = model.apply(p, b[0], train=True, attn_fn=ref_attn)
        logp = torch.log_softmax(logits, dim=-1)
        return -logp.gather(-1, b[1][..., None]).squeeze(-1).mean()

    comm = Communicator(devices=["cuda:0"])
    tx = synchronous_sgd(sgd(0.05, momentum=0.9), comm.axis)
    step = dp_train_step(loss_fn, tx, comm)
    opt = tx.init(params)

    # one step through the kernels, launches counted from zero
    _reset(kernels)
    p, o, loss = step(params, opt, batch)
    torch.cuda.synchronize()
    per_step = _counts(kernels)
    print(f"train step launches: {per_step}")
    want = {k: 0 for k in per_step}
    want.update(flash_fwd=cfg.n_layers, flash_bwd_dq=cfg.n_layers,
                flash_bwd_dkv=cfg.n_layers, **routed)
    check(per_step == want, f"one train step launched {per_step}, "
          f"expected {want}")
    losses = [float(loss)]

    # first-step gradients: kernels against the plain path
    g_kern, g_plain = (_grads(fn, params, batch)
                       for fn in (loss_fn, loss_plain))
    flat_f, flat_p = tr.flatten(g_kern), tr.flatten(g_plain)
    norms = {k: t.float().norm().item() for k, t in flat_p.items()}
    floor = 1e-3 * max(norms.values())
    rel = {k: (flat_f[k].float() - flat_p[k].float()).norm().item()
           / max(norms[k], floor) for k in flat_p}
    worst = max(rel, key=rel.get)
    print(f"first-step gradients vs plain path: worst leaf {worst} rel L2 "
          f"{rel[worst]:.3e} (tol {TRAIN_GRAD_REL_L2}); median "
          f"{statistics.median(rel.values()):.3e} over {len(rel)} leaves; "
          f"head/w {rel['head/w']:.3e}")
    check(all(bool(torch.isfinite(t).all()) for t in flat_f.values()),
          "non-finite gradients")
    check(rel[worst] <= TRAIN_GRAD_REL_L2,
          f"gradient of {worst} differs from the plain path by "
          f"{rel[worst]} > {TRAIN_GRAD_REL_L2}")
    del g_kern, g_plain, flat_f, flat_p

    # the remaining steps on the fixed batch, timed on the host clock;
    # counting starts again from zero, so the launches of the gradient
    # comparison above are not counted as the path's, and the peak
    # memory is the steps' own
    _reset(kernels)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(TRAIN_STEPS - 1):
        t0 = time.perf_counter()
        p, o, loss = step(p, o, batch)
        losses.append(float(loss))  # synchronises
        times.append((time.perf_counter() - t0) * 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"train losses: {[round(x, 4) for x in losses]}")
    check(all(np.isfinite(losses)), "non-finite loss")
    check(losses[-1] < losses[0],
          f"loss did not fall over {TRAIN_STEPS} steps: {losses}")

    # one step through Transformer.loss, routed to the same kernels
    saved = os.environ.get(knob)
    os.environ[knob] = "fused"
    try:
        xent.XENT_ENV.reload()
        model_step = dp_train_step(
            lambda q, b: model.loss(q, b, attn_fn=flash), tx, comm)
        before = _counts(kernels)
        _, _, m_loss = model_step(params, tx.init(params), batch)
        torch.cuda.synchronize()
        after = _counts(kernels)
    finally:
        if saved is None:
            os.environ.pop(knob)
        else:
            os.environ[knob] = saved
        xent.XENT_ENV.reload()
    via_model = {k: after[k] - before[k] for k in after}
    print(f"Transformer.loss step under {knob}=fused: loss "
          f"{float(m_loss):.6f} (first step {losses[0]:.6f}), launches "
          f"{via_model}")
    check(via_model == want, f"Transformer.loss step launched {via_model}")
    check(abs(float(m_loss) - losses[0]) <= MODEL_LOSS_RTOL * abs(losses[0]),
          f"Transformer.loss {float(m_loss)} != the step's {losses[0]}")
    launches = {k: v + per_step[k] for k, v in _counts(kernels).items()}

    step_ms = statistics.median(times)
    toks = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
    flops = costmodel.train_step_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    mfu = flops / (step_ms / 1e3) / spec["bf16_flops"]
    print(f"train ({head} head): {step_ms:.2f} ms/step median of "
          f"{len(times)} ({min(times):.2f}-{max(times):.2f}), {toks:.0f} "
          f"tokens/s, {flops / 1e12:.3f} TFLOP/step, MFU {mfu:.4f} against "
          f"{spec['bf16_flops'] / 1e12:.0f} TFLOP/s bf16; peak memory of "
          f"the timed steps {peak_gb:.2f} GiB")
    return {"launches": launches, "per_step": per_step, "losses": losses,
            "grad_rel_l2_worst": rel[worst], "grad_worst_leaf": worst,
            "grad_rel_l2_head_w": rel["head/w"], "model_loss": float(m_loss),
            "step_ms": step_ms, "step_ms_all": times, "tokens_s": toks,
            "flops_per_step": flops, "mfu": mfu, "peak_gib": peak_gb}


def phase_ring(torch, ringk, rc, spec):
    """Ring reduce-scatter and all-gather kernels against their plain
    versions, bitwise, at the reference suite's edges and the main
    path's shapes (one ZeRO bucket, the fused S-SGD gradient), then
    timed beside the plain versions and one PyTorch call each."""
    gen = torch.Generator(device="cuda").manual_seed(4)

    def data(k, length, dtype):
        if not dtype.is_floating_point:
            return torch.randint(-1000, 1000, (k, length), generator=gen,
                                 device="cuda", dtype=dtype)
        return torch.randn((k, length), generator=gen, device="cuda").to(dtype)

    def case(k, chunk, dtype, bidi):
        cut = rc.band_cut(chunk, dtype, bidi)
        x = data(k, k * chunk, dtype)
        rs = ringk.reduce_scatter(x, cut)
        ag = ringk.all_gather(rs, cut)
        torch.cuda.synchronize()
        ok = (torch.equal(rs, rc.ring_reduce_scatter_reference(x, cut))
              and torch.equal(ag, rc.ring_all_gather_reference(rs, cut)))
        if dtype == torch.int32:
            ok = ok and torch.equal(rs, x.view(k, k, chunk).sum(
                0, dtype=torch.int32))
        check(ok, f"ring k={k} chunk={chunk} {dtype} bidirectional={bidi}: "
              f"kernel != plain version")
        return cut < chunk

    def view_case(k, chunk, cut, dtype, off, pad):
        # rows of a wider buffer: the base `off` elements in (not 16-byte
        # aligned when off is 1), the row stride k*chunk + off + pad
        x = data(k, k * chunk + off + pad, dtype)[:, off:off + k * chunk]
        rs = ringk.reduce_scatter(x, cut)
        shards = data(k, chunk + off + pad, dtype)[:, off:off + chunk]
        shards.copy_(rs)
        ag = ringk.all_gather(shards, cut)
        torch.cuda.synchronize()
        ok = (torch.equal(rs, rc.ring_reduce_scatter_reference(x, cut))
              and torch.equal(ag, rc.ring_all_gather_reference(rs, cut)))
        check(ok, f"ring k={k} chunk={chunk} cut={cut} {dtype} rows at "
              f"offset {off}, stride {x.stride(0)}: kernel != plain version")

    split = 0
    cases = 0
    for k in (2, 3, 5, 8):
        for chunk in (2048, 1024, 1000, 40):
            for bidi in (False, True):
                split += case(k, chunk, torch.float32, bidi)
                cases += 1
        split += case(k, 4096, torch.bfloat16, True)
        split += case(k, 4096, torch.int32, True)
        case(k, 1000, torch.int32, False)
        cases += 3
    check(split > 0, "no edge case split into two bands")
    print(f"ring edges: {cases} cases (k 2/3/5/8, f32 chunk 2048/1024/1000/"
          f"40 x one or two directions, bf16 4096 and int32 4096/1000), "
          f"{split} with two bands: reduce-scatter and all-gather bitwise "
          f"equal to the plain versions; int32 equal to view(k, k, "
          f"chunk).sum(0)")
    views = 0
    for k in (3, 4, 16):
        for chunk in (1001, 4097):
            for dtype in (torch.float32, torch.bfloat16, torch.int32):
                for cut in (chunk // 2 | 1, chunk):
                    for off, pad in ((1, 0), (0, 3), (1, 3)):
                        view_case(k, chunk, cut, dtype, off, pad)
                        views += 1
    for bidi in (False, True):
        for dtype in (torch.float32, torch.bfloat16, torch.int32):
            case(16, 4096, dtype, bidi)
            views += 1
    # the all-gather moves 2-, 4- and 8-byte elements; the 4-byte ones
    # ran above, beside the reduce-scatter
    ag_views = 0
    for k in (3, 4, 16):
        for chunk in (1, 1001, 4097):
            for dtype in (torch.int16, torch.float64, torch.int64):
                for cut in sorted({chunk // 2 | 1, chunk}):
                    for off, pad in ((0, 0), (1, 0), (0, 3), (1, 3)):
                        shards = data(k, chunk + off + pad, dtype)[
                            :, off:off + chunk]
                        ag = ringk.all_gather(shards, cut)
                        torch.cuda.synchronize()
                        check(torch.equal(ag, rc.ring_all_gather_reference(
                            shards, cut)), f"ring all-gather k={k} "
                            f"chunk={chunk} cut={cut} {dtype} rows at offset "
                            f"{off}, stride {shards.stride(0)}: kernel != "
                            f"plain version")
                        ag_views += 1
    print(f"ring all-gather edges, 2- and 8-byte elements: {ag_views} cases "
          f"(k 3/4/16, chunk 1/1001/4097, int16/float64/int64, an odd cut "
          f"or one band, rows from element 0 or 1 with strides of chunk, "
          f"+ 1, + 3, + 4 elements): bitwise equal to the plain version")
    print(f"ring edges, unaligned rows: {views} cases (k 3/4/16, chunk 1001/"
          f"4097, f32/bf16/int32, an odd cut or one band; rows of a wider "
          f"buffer from element 1, and strides of k*chunk + 1, + 3, + 4 "
          f"elements; and k = 16 at chunk 4096 with the reference's cut): "
          f"reduce-scatter and all-gather bitwise equal to the plain "
          f"versions")

    # the main path's shapes: the ZeRO bucket at four ranks, the fused
    # S-SGD gradient, and phase 11's bucket at two ranks
    from kungfu_tpu_torch.ops.schedules import bucket_widths

    shapes = {"bucket": (RANKS, 262_144),
              "fused": (RANKS, FLAGSHIP_PARAMS // RANKS),
              "bucket_k2": (2, bucket_widths(FLAGSHIP_PARAMS // 2, 2, 4,
                                             4 << 20)[0])}
    timing = {}
    for label, (k, chunk) in shapes.items():
        x = data(k, k * chunk, torch.float32)
        rs = ringk.reduce_scatter(x)
        ag = ringk.all_gather(rs)
        torch.cuda.synchronize()
        ref_rs = rc.ring_reduce_scatter_reference(x)
        check(torch.equal(rs, ref_rs), f"ring rs {label}: kernel != plain")
        del ref_rs
        ref_ag = rc.ring_all_gather_reference(rs)
        check(torch.equal(ag, ref_ag), f"ring ag {label}: kernel != plain")
        del ref_ag, ag
        big = label == "fused"
        it, win = (5, 7) if big else (50, 11)
        rs_ms = device_ms(torch, lambda: ringk.reduce_scatter(x), it, win)
        ag_ms = device_ms(torch, lambda: ringk.all_gather(rs), it, win)
        rs_plain = device_ms(torch, lambda: rc.ring_reduce_scatter_reference(
            x), 1, 3 if big else 5)
        ag_plain = device_ms(torch, lambda: rc.ring_all_gather_reference(rs),
                             1, 3 if big else 5)
        rs_lib = device_ms(torch, lambda: x.view(k, k, chunk).sum(0), it, win)
        ag_lib = device_ms(torch, lambda: rs.reshape(1, -1).expand(
            k, -1).contiguous(), it, win)
        calls = 20 if big else 200
        rs_us = host_us(torch, lambda: ringk.reduce_scatter(x), calls)
        ag_us = host_us(torch, lambda: ringk.all_gather(rs), calls)
        # each kernel reads its input once and writes its output once:
        # k*k*chunk and k*chunk f32 elements, the other way round for the
        # all-gather; no arithmetic to speak of
        nbytes = (k * k * chunk + k * chunk) * 4
        t = bound(spec, 0, nbytes)
        timing[label] = {
            "rs": {"ms": rs_ms, "plain_ms": rs_plain, "library_ms": rs_lib,
                   "host_us": rs_us, **t},
            "ag": {"ms": ag_ms, "plain_ms": ag_plain, "library_ms": ag_lib,
                   "host_us": ag_us, **t}}
        print(f"ring timing {label} k={k} chunk={chunk} f32: reduce-scatter "
              f"{rs_ms:.4f} ms (plain {rs_plain:.4f}, view(k, k, chunk)."
              f"sum(0) {rs_lib:.4f}), all-gather {ag_ms:.4f} ms (plain "
              f"{ag_plain:.4f}, expand().contiguous() {ag_lib:.4f}); bound "
              f"{t['bound_ms']:.4f} ms ({nbytes} bytes); "
              f"{nbytes / rs_ms / 1e6:.0f} and {nbytes / ag_ms / 1e6:.0f} GB/s; "
              f"host {rs_us:.1f} and {ag_us:.1f} us per launch")
        del x, rs
        torch.cuda.empty_cache()
    return timing


def _flagship_train(torch, np, tr, attention):
    """gpt_small(max_seq=2048) with random weights from seed 0, ids and
    targets [4, 2048] from ``default_rng(0)``, the flash attention and
    phase 6's loss (plain head, fused cross-entropy)."""
    from kungfu_tpu_torch.ops import xent

    model = tr.gpt_small(max_seq=TRAIN_SEQ)
    params = model.init(torch.Generator().manual_seed(0), device="cuda")
    rng = np.random.default_rng(0)
    ids, targets = (torch.from_numpy(rng.integers(
        0, model.cfg.vocab_size, size=(TRAIN_BATCH, TRAIN_SEQ))).cuda()
        for _ in range(2))
    flash = attention.make_flash_attn()

    def loss_fn(p, b):
        logits = model.apply(p, b[0], train=True, attn_fn=flash)
        return xent.softmax_cross_entropy(logits, b[1]).mean()

    return model, params, (ids, targets), flash, loss_fn


def _grads(fn, params, batch):
    """The gradient tree of ``fn(params, batch)`` (one rank's pass)."""
    from kungfu_tpu_torch.parallel.train import per_rank_grads
    from kungfu_tpu_torch.utils.tree import tree_flatten, tree_unflatten

    grads = []
    per_rank_grads(fn, params, [batch], lambda r, g: grads.extend(g))
    return tree_unflatten(tree_flatten(params)[1], grads)


def _rank_launches(cfg, ranks: int = RANKS) -> dict:
    """One step's launches on ``ranks`` ranks, each running phase 6's
    per-rank forward and backward."""
    return dict(flash_fwd=ranks * cfg.n_layers,
                flash_bwd_dq=ranks * cfg.n_layers,
                flash_bwd_dkv=ranks * cfg.n_layers,
                xent_fwd=ranks, xent_bwd=ranks)


def _timed_steps(torch, np, step, p, o, batch, losses, steps=TRAIN_STEPS):
    """``steps`` - 1 more steps on the host clock; peak memory of those
    steps; returns (p, o, times, peak GiB)."""
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps - 1):
        t0 = time.perf_counter()
        p, o, loss = step(p, o, batch)
        losses.append(float(loss))  # synchronises
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(np.isfinite(losses)), f"non-finite loss {losses}")
    check(losses[-1] < losses[0],
          f"loss did not fall over {steps} steps: {losses}")
    return p, o, times, peak


def phase_ssgd(torch, np, kernels, tr, first_loss: float):
    """Phase 6's training step on RANKS co-resident ranks through the
    pallas_ring schedule, fused gradients: launches per step, the first
    loss and the reduced gradient against the one-rank step's, ten steps
    of falling loss, step ms, tokens/s and peak memory.  Returns the
    result and the params after the first step (phase 9 compares its
    own with them)."""
    from kungfu_tpu_torch.comm.device import Communicator
    from kungfu_tpu_torch.ops import collective
    from kungfu_tpu_torch.optimizers import (GradientTransformation, sgd,
                                             synchronous_sgd)
    from kungfu_tpu_torch.parallel.train import dp_train_step
    from kungfu_tpu_torch.utils.tree import tree_map

    model, params, batch, _, loss_fn = _flagship_train(torch, np, tr,
                                                       kernels[0])
    cfg = model.cfg
    inner = sgd(0.05, momentum=0.9)
    seen = {}

    def update(grads, state, p=None):
        # keep the first reduced gradient the inner optimizer receives
        if "grads" not in seen:
            seen["grads"] = tree_map(lambda g: g.clone(), grads)
        return inner.update(grads, state, p)

    comm = Communicator(devices=["cuda:0"] * RANKS, local_size=RANKS)
    tx = synchronous_sgd(GradientTransformation(inner.init, update),
                         comm.axis, schedule="pallas_ring", fuse_grads=True)
    step = dp_train_step(loss_fn, tx, comm)
    opt = tx.init(params)

    # one step, launches counted from zero; the ranks' replicated rows
    # are checked bitwise equal before one is taken
    _reset(kernels)
    collective.CHECK_REPLICAS = True
    try:
        p, o, loss = step(params, opt, batch)
        torch.cuda.synchronize()
    finally:
        collective.CHECK_REPLICAS = False
    per_step = _counts(kernels)
    want = {key: 0 for key in per_step}
    want.update(_rank_launches(cfg), ring_rs=1, ring_ag=1)
    print(f"S-SGD ({RANKS} ranks, pallas_ring) step launches: {per_step}")
    check(per_step == want, f"one S-SGD step launched {per_step}, expected "
          f"{want}")
    losses = [float(loss)]
    loss_rel = abs(losses[0] - first_loss) / abs(first_loss)
    print(f"S-SGD first loss {losses[0]:.6f} vs one rank {first_loss:.6f}: "
          f"rel {loss_rel:.3e} (tol {RANKS_LOSS_RTOL})")
    check(loss_rel <= RANKS_LOSS_RTOL, f"S-SGD first loss {losses[0]} != "
          f"phase 6's {first_loss}")

    # the reduced gradient against the one-rank gradient (phase 6's)
    g_one = _grads(loss_fn, params, batch)
    flat_r, flat_1 = tr.flatten(seen.pop("grads")), tr.flatten(g_one)
    norms = {key: t.norm().item() for key, t in flat_1.items()}
    floor = 1e-3 * max(norms.values())
    rel = {key: (flat_r[key] - flat_1[key]).norm().item()
           / max(norms[key], floor) for key in flat_1}
    worst = max(rel, key=rel.get)
    print(f"S-SGD reduced first-step gradient vs one rank: worst leaf "
          f"{worst} rel L2 {rel[worst]:.3e} (tol {RANKS_GRAD_REL_L2}); "
          f"median {statistics.median(rel.values()):.3e}; head/w "
          f"{rel['head/w']:.3e}")
    check(rel[worst] <= RANKS_GRAD_REL_L2,
          f"reduced gradient of {worst} differs by {rel[worst]}")
    del g_one, flat_r, flat_1
    p1 = tree_map(lambda t: t.clone(), p)

    _reset(kernels)
    p, o, times, peak = _timed_steps(torch, np, step, p, o, batch, losses)
    launches = {key: v + per_step[key] for key, v in _counts(kernels).items()}
    step_ms = statistics.median(times)
    toks = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
    print(f"S-SGD losses: {[round(x, 4) for x in losses]}")
    print(f"S-SGD ({RANKS} ranks on one card): {step_ms:.2f} ms/step median "
          f"of {len(times)} ({min(times):.2f}-{max(times):.2f}), {toks:.0f} "
          f"tokens/s over the global batch; peak memory of the timed steps "
          f"{peak:.2f} GiB")
    return {"launches": launches, "per_step": per_step, "losses": losses,
            "first_loss_rel": loss_rel, "grad_rel_l2_worst": rel[worst],
            "grad_worst_leaf": worst,
            "grad_rel_l2_median": statistics.median(rel.values()),
            "step_ms": step_ms, "step_ms_all": times, "tokens_s": toks,
            "peak_gib": peak}, p1


def phase_zero(torch, np, kernels, tr, stage: int, ssgd_p1):
    """ZeRO stage ``stage`` on the same ranks through the pallas_ring
    bucket schedule: launches and ring bytes of one step, params after
    it against S-SGD's, ten steps of falling loss, step ms, tokens/s,
    peak memory and per-rank optimizer bytes."""
    from kungfu_tpu_torch.comm.device import Communicator
    from kungfu_tpu_torch.ops import collectives
    from kungfu_tpu_torch.optimizers import sgd
    from kungfu_tpu_torch.parallel.zero import (opt_state_bytes_per_device,
                                                zero_train_step)

    model, params, batch, _, loss_fn = _flagship_train(torch, np, tr,
                                                       kernels[0])
    comm = Communicator(devices=["cuda:0"] * RANKS, local_size=RANKS)
    z = zero_train_step(loss_fn, sgd(0.05, momentum=0.9), comm, stage=stage,
                        schedule="pallas_ring")
    o = z.init_opt(params)
    p = z.init_params(params)
    geo = z._get(params)
    buckets = len(geo.widths)
    analytic = z.comm_bytes(params)
    del params

    _reset(kernels)
    collectives.reset_ring_bytes()
    p, o, loss = z.step(p, o, batch)
    torch.cuda.synchronize()
    per_step = _counts(kernels)
    ring_bytes = dict(collectives.ring_bytes)
    want = {key: 0 for key in per_step}
    want.update(_rank_launches(model.cfg), ring_rs=buckets,
                ring_ag=buckets if stage == 3 else 0)
    print(f"ZeRO-{stage} step launches ({buckets} buckets of "
          f"{geo.widths[0]} columns): {per_step}")
    check(per_step == want, f"one ZeRO-{stage} step launched {per_step}, "
          f"expected {want}")
    want_bytes = {"reduce_scatter": analytic["grad_bytes"],
                  "all_gather": analytic["param_bytes"] if stage == 3 else 0.0}
    print(f"ZeRO-{stage} ring bytes per rank in one step: {ring_bytes}; "
          f"zero_comm_bytes {analytic} (stages 1/2 regather the params with "
          f"a plain copy, the reference's partitioner all-gather)")
    for key, v in want_bytes.items():
        check(abs(ring_bytes[key] - v) <= 1e-9 * max(v, 1.0),
              f"ZeRO-{stage} {key} bytes {ring_bytes[key]} != {v}")

    # params after one step against S-SGD's after one step
    got = tr.flatten(z.gather_params(p))
    ref = tr.flatten(ssgd_p1)
    same = [key for key in ref if torch.equal(got[key], ref[key])]
    worst = max(((got[key] - ref[key]).abs().max().item(), key) for key in ref)
    ratio = max(_ratio(got[key], ref[key], ZERO_RTOL, ZERO_ATOL)
                for key in ref)
    bitwise = len(same) == len(ref)
    print(f"ZeRO-{stage} params after one step vs S-SGD's: "
          f"{len(same)}/{len(ref)} leaves bitwise equal; max|d| "
          f"{worst[0]:.3e} ({worst[1]}); {ratio:.3f} of rtol {ZERO_RTOL} "
          f"atol {ZERO_ATOL}")
    check(ratio <= 1.0, f"ZeRO-{stage} params differ from S-SGD's beyond "
          f"rtol {ZERO_RTOL} atol {ZERO_ATOL}")
    del got, ref

    losses = [float(loss)]
    _reset(kernels)
    p, o, times, peak = _timed_steps(torch, np, z.step, p, o, batch, losses)
    launches = {key: v + per_step[key] for key, v in _counts(kernels).items()}
    step_ms = statistics.median(times)
    toks = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
    opt_bytes = opt_state_bytes_per_device(o, RANKS)
    print(f"ZeRO-{stage} losses: {[round(x, 4) for x in losses]}")
    print(f"ZeRO-{stage} ({RANKS} ranks on one card): {step_ms:.2f} ms/step "
          f"median of {len(times)} ({min(times):.2f}-{max(times):.2f}), "
          f"{toks:.0f} tokens/s; peak memory of the timed steps {peak:.2f} "
          f"GiB; optimizer state {opt_bytes} bytes per rank")
    return {"launches": launches, "per_step": per_step, "losses": losses,
            "buckets": buckets, "ring_bytes": ring_bytes,
            "zero_comm_bytes": analytic, "params_bitwise_vs_ssgd": bitwise,
            "leaves_bitwise": len(same), "max_abs_vs_ssgd": worst[0],
            "step_ms": step_ms, "step_ms_all": times, "tokens_s": toks,
            "peak_gib": peak, "opt_state_bytes_per_rank": opt_bytes}


def _put_cluster(port: int, cluster) -> int:
    """PUT ``cluster`` to the config server on ``port``; its new version."""
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}/put",
                                 data=cluster.to_json().encode(), method="PUT")
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read().decode())["version"]


def _trees_bitwise(torch, got, want) -> tuple:
    """(leaves bitwise equal, leaves) of two trees of one structure."""
    from kungfu_tpu_torch.utils.tree import tree_leaves

    a, b = tree_leaves(got), tree_leaves(want)
    check(len(a) == len(b), f"trees of {len(a)} and {len(b)} leaves")
    same = sum(x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(a, b))
    return same, len(a)


def _check_bitwise(torch, got, want, what: str) -> None:
    same, n = _trees_bitwise(torch, got, want)
    print(f"elastic: {what}: {same}/{n} leaves bitwise equal")
    check(same == n, f"{what}: {n - same} of {n} leaves differ")


def _chunk_mode_4_to_2(o4, total: int, c2):
    """Check 3: each of four ranks commits its own row of the 4-rank
    state (chunk mode), mirrors it on its ring predecessor over a
    PyHostChannel on loopback (one thread a rank), ranks 1 and 3 die
    (their channels close), and ranks 0 and 2 re-carve to two ranks from
    the buddy mirrors; their rows, stacked on the card."""
    from kungfu_tpu_torch.comm.host import PyHostChannel
    from kungfu_tpu_torch.elastic import ZeroBoundary, place_stacked
    from kungfu_tpu_torch.plan import PeerID, PeerList
    from kungfu_tpu_torch.utils.tree import tree_map

    chans = [PyHostChannel(PeerID("127.0.0.1", 0), bind_host="127.0.0.1")
             for _ in range(RANKS)]
    peers = PeerList.of(*(c.self_id for c in chans))
    bounds = []
    for r in range(RANKS):
        b = ZeroBoundary()
        b.commit_local(0, tree_map(lambda t: t[r] if t.dim() == 2 else t, o4),
                       total=total, old_n=RANKS, my_old=r)
        bounds.append(b)

    class Peer:  # what the re-carve reads of a peer
        def __init__(self, chan):
            self.channel = chan
            self.config = type("C", (), {"self_id": chan.self_id})()

    def run(fns):
        with ThreadPoolExecutor(max_workers=len(fns)) as pool:
            return [f.result(timeout=600) for f in
                    [pool.submit(fn) for fn in fns]]

    survivors = (0, 2)
    try:
        t0 = time.perf_counter()
        sent = run([lambda b=b, c=c: b.replicate_ring(c, peers, tag="p11")
                    for b, c in zip(bounds, chans)])
        replicate_s = time.perf_counter() - t0
        for r in range(RANKS):
            if r not in survivors:
                chans[r].close()
        t0 = time.perf_counter()
        run([lambda r=r: bounds[r].recarve(
            2, peer=Peer(chans[r]), old_workers=peers,
            new_workers=peers.select(survivors), tag="p11", dead=(1, 3))
            for r in survivors])
        recarve_s = time.perf_counter() - t0
    finally:
        for c in chans:
            c.close()
    state = place_stacked([bounds[r] for r in survivors], c2)
    return state, {"wire_bytes": sum(sent), "replicate_s": replicate_s,
                   "recarve_s": recarve_s}


def phase_elastic(torch, np, kernels, tr):
    """gpt_small(max_seq=2048) under ZeRO-2 (pallas_ring, inner adam)
    through the step-based schedule ELASTIC_SCHEDULE, driven the KungFu
    way: a ConfigServer holds the cluster; at a change of size the loop
    PUTs ``cluster.resize(n)``, reads it back with ``fetch_cluster``,
    re-carves its ZeroBoundary, places it on a new Communicator and
    resumes from the StepSnapshot's params.  Checks, each fatal: the
    step after each resize bitwise equal to a fixed-world step from the
    same boundary hand-repadded; at 4 -> 2 four re-carve paths and chunk
    mode with dead ranks 1 and 3 bitwise equal; the ZeRO-3 shard
    re-carved 4 -> 2; exact launches of every step; falling loss."""
    from kungfu_tpu_torch.checkpoint import StepSnapshot
    from kungfu_tpu_torch.comm.device import Communicator
    from kungfu_tpu_torch.elastic import (ConfigServer, ZeroBoundary,
                                          fetch_cluster, step_based_schedule,
                                          total_steps)
    from kungfu_tpu_torch.ops.schedules import bucket_widths
    from kungfu_tpu_torch.optimizers import adam
    from kungfu_tpu_torch.parallel import zero
    from kungfu_tpu_torch.plan import Cluster, HostList
    from kungfu_tpu_torch.utils.tree import (tree_flatten, tree_leaves,
                                             tree_map, tree_unflatten)

    model, params, batch, _, loss_fn = _flagship_train(torch, np, tr,
                                                       kernels[0])
    cfg = model.cfg
    total = sum(t.numel() for t in tree_leaves(params))
    check(total == FLAGSHIP_PARAMS, f"gpt_small has {total} params")
    launches = {key: 0 for key in _counts(kernels)}

    def buckets(n):
        return len(bucket_widths(math.ceil(total / n), n, 4, 4 << 20))

    def counted_step(z, p, o, n, stage, what):
        """One step, its launches checked against the exact count."""
        _reset(kernels)
        t0 = time.perf_counter()
        p, o, loss = z.step(p, o, batch)
        loss = float(loss)  # synchronises
        ms = (time.perf_counter() - t0) * 1e3
        got = _counts(kernels)
        want = {key: 0 for key in got}
        want.update(_rank_launches(cfg, n), ring_rs=buckets(n),
                    ring_ag=buckets(n) if stage == 3 else 0)
        check(got == want, f"{what} ({n} ranks, ZeRO-{stage}) launched "
              f"{got}, expected {want}")
        for key, v in got.items():
            launches[key] += v
        check(math.isfinite(loss), f"{what}: loss {loss}")
        return p, o, loss, ms

    def world(n, version, strategy):
        comm = Communicator(devices=["cuda:0"] * n, local_size=n,
                            strategy=strategy, version=version)
        return comm, zero.zero_train_step(loss_fn, adam(ELASTIC_LR), comm,
                                          stage=2, schedule="pallas_ring")

    def to_card(tree):
        return tree_map(lambda t: t.to("cuda"), tree)

    hosts = HostList.parse(f"127.0.0.1:{RANKS}")
    server = ConfigServer(port=0, host="127.0.0.1", cluster=Cluster(
        hosts.gen_runner_list(), hosts.gen_peer_list(RANKS))).start()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    try:
        cluster, version = fetch_cluster(server.url)
        comm, z = world(cluster.size(), version, "psum")
        o, p = z.init_opt(params), params
        boundary, snap = ZeroBoundary(), StepSnapshot()
        losses, step_ms = [], {}
        commit_ms, snap_ms, resizes = [], [], []
        chunk_mode = None
        for step in range(total_steps(ELASTIC_SCHEDULE)):
            n = step_based_schedule(ELASTIC_SCHEDULE, step)
            fixed = None
            if n != comm.size:
                old_n, strategy = comm.size, comm.strategy
                got_v = _put_cluster(server.port, cluster.resize(n))
                cluster, version = fetch_cluster(server.url)
                check(version == got_v and cluster.size() == n,
                      f"config server: version {version} with "
                      f"{cluster.size()} workers after a PUT of {n}")
                rec = {"step": step, "from": old_n, "to": n,
                       "version": version}
                # the strategy carries across the resize
                new_comm, new_z = world(n, version, strategy)
                committed = boundary.export_carve()
                if n < old_n:
                    # check 2 (+ 3): the other re-carve paths, from the
                    # live old-world state, each kept until compared
                    t0 = time.perf_counter()
                    paths = {"zero1_reshard": zero.zero1_reshard(
                        o, p, new_comm)}
                    torch.cuda.synchronize()
                    rec["zero1_reshard_s"] = time.perf_counter() - t0
                    t0 = time.perf_counter()
                    fresh = zero.zero_train_step(
                        loss_fn, adam(ELASTIC_LR), new_comm).init_opt(params)
                    paths["snapshot_restore"] = zero.zero_restore(
                        zero.zero_snapshot(o), fresh, p, new_comm=new_comm)
                    del fresh
                    rec["snapshot_restore_s"] = time.perf_counter() - t0
                    t0 = time.perf_counter()
                    paths["p2p"] = zero.zero_reshard_p2p(o, p, new_comm)
                    torch.cuda.synchronize()
                    rec["p2p_s"] = time.perf_counter() - t0
                    paths["chunk_mode"], chunk_mode = _chunk_mode_4_to_2(
                        o, total, new_comm)
                # free the old world's step, state and graphs
                del z, o, p
                torch.cuda.empty_cache()
                comm, z = new_comm, new_z
                del new_comm, new_z
                t0 = time.perf_counter()
                boundary.recarve(n)
                rec["recarve_s"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                o = boundary.place(comm)
                torch.cuda.synchronize()
                rec["place_s"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                p = to_card(snap.last()[1])
                torch.cuda.synchronize()
                rec["params_restore_s"] = time.perf_counter() - t0
                # check 1's fixed world: the committed state hand-repadded
                # in plain torch, on a communicator and step of its own
                _, _, _, _, _, _, vec, scal = committed
                chunk = math.ceil(total / n)
                o_fx = []
                for i in range(len(vec) + len(scal)):
                    if i in vec:
                        buf = torch.zeros(chunk * n, dtype=vec[i].dtype)
                        buf[:total] = vec[i][:total]
                        o_fx.append(buf.view(n, chunk).cuda())
                    else:
                        o_fx.append(scal[i].cuda())
                o_fx = tree_unflatten(tree_flatten(o)[1], o_fx)
                del committed, vec, scal
                for name, state in (paths.items() if n < old_n else ()):
                    _check_bitwise(torch, state, o, f"{old_n} -> {n} "
                                   f"{name} vs ZeroBoundary full mode")
                if n < old_n:
                    del paths["zero1_reshard"], paths["snapshot_restore"], \
                        paths["p2p"]
                    torch.cuda.empty_cache()
                _check_bitwise(torch, o_fx, o, f"{old_n} -> {n} hand "
                               "repad vs ZeroBoundary full mode")
                _, z_fx = world(n, version, strategy)
                fixed = counted_step(z_fx, to_card(snap.last()[1]), o_fx, n,
                                     2, f"fixed-world step {step}")
                del z_fx, o_fx
                if n < old_n:
                    ck = counted_step(z, to_card(snap.last()[1]),
                                      paths.pop("chunk_mode"), n, 2,
                                      f"chunk-mode step {step}")
                    _check_bitwise(torch, ck[:2], fixed[:2], f"step "
                                   f"{step} from the chunk-mode carve vs "
                                   "the fixed world")
                    del ck
                resizes.append(rec)
                print(f"elastic: resize {old_n} -> {n} at step {step} "
                      f"(config version {version}): " + ", ".join(
                          f"{k} {v:.3f}" for k, v in rec.items()
                          if k.endswith("_s")))
            p, o, loss, ms = counted_step(z, p, o, n, 2,
                                          f"elastic step {step}")
            losses.append(loss)
            step_ms.setdefault(n, []).append(ms)
            if fixed is not None:
                _check_bitwise(torch, (p, o), fixed[:2], f"step {step} "
                               f"after the resize to {n} vs the fixed world")
                check(loss == fixed[2], f"step {step} loss {loss} != "
                      f"fixed world's {fixed[2]}")
                del fixed
            t0 = time.perf_counter()
            boundary.commit(step, o, p)
            commit_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            snap.commit(step, p)
            snap_ms.append((time.perf_counter() - t0) * 1e3)
        sizes = [step_based_schedule(ELASTIC_SCHEDULE, s)
                 for s in range(len(losses))]
        print(f"elastic: schedule {ELASTIC_SCHEDULE}, sizes {sizes}, "
              f"losses {[round(x, 4) for x in losses]}")
        check(losses[-1] < losses[0], f"elastic loss did not fall: {losses}")
    finally:
        server.stop()
    del z, o, p, boundary, snap
    torch.cuda.empty_cache()

    # check 4: ZeRO-3 at four ranks, its param shard (and state)
    # re-carved to two, gathered bitwise, and one stage-3 step at two
    c4 = Communicator(devices=["cuda:0"] * RANKS, local_size=RANKS)
    z3 = zero.zero_train_step(loss_fn, adam(ELASTIC_LR), c4, stage=3,
                              schedule="pallas_ring")
    ps, o3, loss3, ms3 = counted_step(z3, z3.init_params(params),
                                      z3.init_opt(params), RANKS, 3,
                                      "ZeRO-3 step")
    b3 = ZeroBoundary()
    b3.commit(0, {"opt": o3, "p": ps}, params)
    full_old = tree_map(torch.clone, z3.gather_params(ps))
    del z3, ps, o3
    torch.cuda.empty_cache()
    b3.recarve(2)
    c2 = Communicator(devices=["cuda:0"] * 2, local_size=2)
    st = b3.place(c2)
    z32 = zero.zero_train_step(loss_fn, adam(ELASTIC_LR), c2, stage=3,
                               schedule="pallas_ring")
    z32.init_params(params)  # binds the stage-3 geometry
    _check_bitwise(torch, z32.gather_params(st["p"]), full_old,
                   "ZeRO-3 params gathered after the 4 -> 2 re-carve vs "
                   "before")
    del full_old
    _, _, loss32, ms32 = counted_step(z32, st["p"], st["opt"], 2, 3,
                                      "ZeRO-3 step at 2 ranks")
    del z32, st, b3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    wall = time.perf_counter() - t_phase
    ms4 = statistics.median(step_ms[RANKS])
    ms2 = statistics.median(step_ms[2])
    print(f"elastic: step ms median {ms4:.2f} at 4 ranks "
          f"({step_ms[RANKS]}), {ms2:.2f} at 2 ({step_ms[2]}); "
          f"ZeroBoundary.commit ms median {statistics.median(commit_ms):.2f} "
          f"({[round(x, 2) for x in commit_ms]}, D2H of "
          f"{2 * total * 4} bytes of Adam state); StepSnapshot.commit ms "
          f"median {statistics.median(snap_ms):.2f} ({total * 4} bytes of "
          f"params)")
    print(f"elastic: chunk mode, dead ranks 1 and 3: replicate_ring "
          f"{chunk_mode['wire_bytes']} bytes on the wire in "
          f"{chunk_mode['replicate_s']:.3f} s "
          f"({chunk_mode['wire_bytes'] / chunk_mode['replicate_s'] / 1e9:.2f}"
          f" GB/s), recarve {chunk_mode['recarve_s']:.3f} s; ZeRO-3 steps "
          f"{ms3:.2f} ms at 4 ranks, {ms32:.2f} at 2; peak memory "
          f"{peak:.2f} GiB; phase {wall:.1f} s")
    return {"launches": launches, "schedule": ELASTIC_SCHEDULE,
            "losses": losses, "step_ms": {str(k): v for k, v in
                                          step_ms.items()},
            "step_ms_median_4": ms4, "step_ms_median_2": ms2,
            "boundary_commit_ms": commit_ms, "snapshot_commit_ms": snap_ms,
            "resizes": resizes, "chunk_mode": chunk_mode,
            "zero3_step_ms": [ms3, ms32], "zero3_losses": [loss3, loss32],
            "peak_gib": peak, "wall_s": wall}


def _spread(tree) -> float:
    """The cross-rank spread of a stacked tree: the largest standard
    deviation over the ranks of any element of any leaf."""
    from kungfu_tpu_torch.utils.tree import tree_leaves

    return max(float(t.float().std(0).max()) for t in tree_leaves(tree))


def _recording(tx, seen: dict):
    """``tx`` whose first ``update`` keeps a copy of the (stacked)
    gradients it receives in ``seen["grads"]``."""
    from kungfu_tpu_torch.optimizers import GradientTransformation
    from kungfu_tpu_torch.utils.tree import tree_map

    def update(grads, state, params=None):
        if "grads" not in seen:
            seen["grads"] = tree_map(lambda g: g.clone(), grads)
        return tx.update(grads, state, params)

    return GradientTransformation(tx.init, update)


def _rel_l2_per_rank(tr, got, ref) -> tuple:
    """Worst relative L2 over leaves and ranks of two stacked trees
    (denominator floored at 1e-3 of the largest leaf norm of the rank),
    with its leaf and rank."""
    flat_g, flat_r = tr.flatten(got), tr.flatten(ref)
    worst = (0.0, "", 0)
    for r in range(RANKS):
        norms = {k: t[r].float().norm().item() for k, t in flat_r.items()}
        floor = 1e-3 * max(norms.values())
        for k in flat_r:
            rel = ((flat_g[k][r].float() - flat_r[k][r].float()).norm().item()
                   / max(norms[k], floor))
            worst = max(worst, (rel, k, r))
    return worst


def _host_noise_stats(torch, grads, b_small: int) -> dict:
    """The mean over ranks of the square norms, the square norm of the
    mean, the variance and the raw GNS of stacked gradients, in f64 on
    the host, leaf by leaf."""
    from kungfu_tpu_torch.utils.tree import tree_leaves

    local = torch.zeros(RANKS, dtype=torch.float64)
    global_sq = 0.0
    for g in tree_leaves(grads):
        h = g.detach().to("cpu", torch.float64).reshape(RANKS, -1)
        local += (h * h).sum(1)
        m = h.mean(0)
        global_sq += float((m * m).sum())
        del h, m
    local_sq = float(local.mean())
    b_big = b_small * RANKS
    g2 = (b_big * global_sq - b_small * local_sq) / (b_big - b_small)
    s = (local_sq - global_sq) / (1.0 / b_small - 1.0 / b_big)
    return {"local_sq": local_sq, "global_sq": global_sq,
            "variance": local_sq - global_sq, "gns": s / abs(g2)}


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def _bert_build(torch, np, tr, kernels):
    """bert_base() with random weights from seed 0 on the card, the
    global batch ([RANKS * BERT_ROWS, BERT_SEQ] ids and targets from
    ``default_rng(0)``) and phase 6's loss with the flash attention:
    ``(model, params, batch, loss_fn)``, shared by phases 10 and 12."""
    from kungfu_tpu_torch.ops import xent
    from kungfu_tpu_torch.utils.tree import tree_leaves

    t0 = time.perf_counter()
    model = tr.bert_base()
    cfg = model.cfg
    params = model.init(torch.Generator().manual_seed(0), device="cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    rng = np.random.default_rng(0)
    rows = RANKS * BERT_ROWS
    batch = tuple(torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(rows, BERT_SEQ))).cuda() for _ in range(2))
    flash = kernels[0].make_flash_attn()
    torch.cuda.synchronize()
    print(f"bert: bert_base() {n_params} f32 params (vocab "
          f"{cfg.vocab_size}, d_model {cfg.d_model}, {cfg.n_layers} layers, "
          f"{cfg.n_heads} heads, d_ff {cfg.d_ff}, pos {cfg.pos}, causal "
          f"{cfg.causal}, compute {cfg.dtype}); {RANKS} ranks x "
          f"[{BERT_ROWS}, {BERT_SEQ}] tokens; init "
          f"{time.perf_counter() - t0:.2f} s")
    check(n_params == BERT_PARAMS, f"bert_base() has {n_params} params, "
          f"expected {BERT_PARAMS}")

    def loss_fn(p, b):
        logits = model.apply(p, b[0], train=True, attn_fn=flash)
        return xent.softmax_cross_entropy(logits, b[1]).mean()

    return model, params, batch, loss_fn


def phase_replicas(torch, np, kernels, tr, costmodel, spec, bert):
    """bert_base() on RANKS co-resident ranks: SMA and AdaptiveSGD over
    stacked per-replica params, the GNS and variance monitors on the
    replicated step, and the autotune of the allreduce schedule.  Each
    main-path run counts its launches from zero; the comparison runs
    (the step under KF_TPU_ATTN=xla, SMA with alpha 0) are not
    counted."""
    from kungfu_tpu_torch.comm.device import Communicator
    from kungfu_tpu_torch.ops import collective, xent
    from kungfu_tpu_torch.ops.monitor import rank_sq_norms
    from kungfu_tpu_torch.ops.schedules import ALLREDUCE_SCHEDULES
    from kungfu_tpu_torch.optimizers import (adaptive_sgd,
                                             monitor_gradient_noise_scale,
                                             monitor_gradient_variance, sgd,
                                             synchronous_averaging)
    from kungfu_tpu_torch.parallel.train import (dp_train_step,
                                                 stack_for_replicas)
    from kungfu_tpu_torch.utils.tree import tree_leaves

    model, params, batch, loss_fn = bert
    cfg = model.cfg
    n_params = sum(t.numel() for t in tree_leaves(params))
    rows = RANKS * BERT_ROWS

    def loss_xla(p, b):  # attention picked by KF_TPU_ATTN, set to xla
        logits = model.apply(p, b[0], train=True)
        return xent.softmax_cross_entropy(logits, b[1]).mean()

    comm = Communicator(devices=["cuda:0"] * RANKS, local_size=RANKS)
    inner = sgd(BERT_LR, momentum=BERT_MOMENTUM)
    want_step = {key: 0 for key in _counts(kernels)}
    want_step.update(flash_fwd=RANKS * cfg.n_layers,
                     flash_bwd_dq=RANKS * cfg.n_layers,
                     flash_bwd_dkv=RANKS * cfg.n_layers,
                     xent_fwd=RANKS, xent_bwd=RANKS)
    tokens = rows * BERT_SEQ
    flops = costmodel.train_step_flops(cfg, rows, BERT_SEQ)
    launches = {key: 0 for key in want_step}
    out = {"params": n_params}

    def add(counts):
        for key, v in counts.items():
            launches[key] += v

    def measure(name, times, peak, per_step):
        step_ms = statistics.median(times)
        m = {"step_ms": step_ms, "step_ms_all": times,
             "tokens_s": tokens / (step_ms / 1e3),
             "mfu": flops / (step_ms / 1e3) / spec["bf16_flops"],
             "launches_per_step": per_step, "peak_gib": peak}
        print(f"replicas {name} ({RANKS} ranks on one card): {step_ms:.2f} "
              f"ms/step median of {len(times)} ({min(times):.2f}-"
              f"{max(times):.2f}), {m['tokens_s']:.0f} tokens/s over the "
              f"global batch, {flops / 1e12:.3f} TFLOP/step, MFU "
              f"{m['mfu']:.4f}; launches per step {per_step}; peak memory "
              f"of the timed steps {peak:.2f} GiB")
        return m

    def stacked_start(tx):
        return (stack_for_replicas(params, RANKS),
                stack_for_replicas(tx.init(params), RANKS))

    # 1. SMA: the first step through the kernels, launches from zero
    seen = {}
    tx = _recording(synchronous_averaging(inner, comm.axis, alpha=SMA_ALPHA),
                    seen)
    step = dp_train_step(loss_fn, tx, comm, replicated_params=False)
    p, o = stacked_start(tx)
    _reset(kernels)
    p, o, loss = step(p, o, batch)
    torch.cuda.synchronize()
    per_step = _counts(kernels)
    add(per_step)
    print(f"replicas SMA step launches: {per_step}")
    check(per_step == want_step, f"one SMA step launched {per_step}, "
          f"expected {want_step}")
    losses = [float(loss)]
    g_kern = seen.pop("grads")

    # the same first step under KF_TPU_ATTN=xla (not counted)
    seen_x = {}
    tx_x = _recording(synchronous_averaging(inner, comm.axis,
                                            alpha=SMA_ALPHA), seen_x)
    saved = os.environ.get("KF_TPU_ATTN")
    os.environ["KF_TPU_ATTN"] = "xla"
    try:
        p_x, _, loss_x = dp_train_step(
            loss_xla, tx_x, comm, replicated_params=False)(
                *stacked_start(tx_x), batch)
        torch.cuda.synchronize()
    finally:
        if saved is None:
            os.environ.pop("KF_TPU_ATTN")
        else:
            os.environ["KF_TPU_ATTN"] = saved
    p_rel = _rel_l2_per_rank(tr, p, p_x)
    g_rel = _rel_l2_per_rank(tr, g_kern, seen_x.pop("grads"))
    del g_kern, p_x
    # each rank's params are held; its gradient (the whole update at step
    # 1, whose pull is 0) is reported: the flash backward's q and k
    # gradients stand further from the plain path's at BERT's nearly
    # uniform attention than phase 6's causal ones do (PERF.md §6)
    print(f"replicas SMA step 1 vs the same step under KF_TPU_ATTN=xla: "
          f"loss {losses[0]:.6f} vs {float(loss_x):.6f}; each rank's params "
          f"worst rel L2 {p_rel[0]:.3e} ({p_rel[1]}, rank {p_rel[2]}; tol "
          f"{TRAIN_GRAD_REL_L2}); each rank's gradient worst rel L2 "
          f"{g_rel[0]:.3e} ({g_rel[1]}, rank {g_rel[2]})")
    check(p_rel[0] <= TRAIN_GRAD_REL_L2,
          f"SMA step 1 params differ from the xla step's: {p_rel}")
    head = tr.flatten(p)["head/w"]
    differ = sum(not all(torch.equal(t[0], t[r]) for r in range(1, RANKS))
                 for t in tree_leaves(p))
    spread1 = _spread(p)
    print(f"replicas SMA after step 1: {differ} of {len(tree_leaves(p))} "
          f"leaves differ between ranks; spread {spread1:.3e}")
    check(spread1 > 0 and not torch.equal(head[0], head[1]),
          "SMA step 1 left the replicas equal: the step replicated")

    _reset(kernels)
    p, o, times, peak = _timed_steps(torch, np, step, p, o, batch, losses)
    add(_counts(kernels))
    spread_sma = _spread(p)
    print(f"replicas SMA losses: {[round(x, 4) for x in losses]}")
    out["sma"] = {"losses": losses, "first_loss_xla": float(loss_x),
                  "params_rel_l2_vs_xla": p_rel[0],
                  "grads_rel_l2_vs_xla": g_rel[0],
                  "leaves_differing_after_step1": differ,
                  "spread_after_step1": spread1,
                  "spread": spread_sma,
                  **measure("SMA", times, peak, per_step)}
    del p, o, step, tx

    # SMA with alpha 0 (local SGD), the same ten steps (not counted)
    tx0 = synchronous_averaging(inner, comm.axis, alpha=0.0)
    step0 = dp_train_step(loss_fn, tx0, comm, replicated_params=False)
    p, o = stacked_start(tx0)
    for _ in range(TRAIN_STEPS):
        p, o, _ = step0(p, o, batch)
    spread0 = _spread(p)
    del p, o, step0
    print(f"replicas SMA cross-rank spread after {TRAIN_STEPS} steps: alpha "
          f"{SMA_ALPHA} {spread_sma:.3e}, alpha 0 {spread0:.3e}")
    check(spread_sma < spread0, "SMA's pull did not hold the replicas closer "
          "than local SGD")
    out["sma"]["spread_alpha0"] = spread0
    torch.cuda.empty_cache()

    # 2. AdaptiveSGD: SMA for ADA_CHANGE_STEP steps, the full pull, S-SGD
    tx = adaptive_sgd(inner, comm.axis, change_step=ADA_CHANGE_STEP)
    step = dp_train_step(loss_fn, tx, comm, replicated_params=False)
    p, o = stacked_start(tx)
    _reset(kernels)
    losses, spreads = [], []
    for _ in range(TRAIN_STEPS):
        p, o, loss = step(p, o, batch)
        losses.append(float(loss))
        spreads.append(_spread(p))
    add(_counts(kernels))
    before, after = spreads[ADA_CHANGE_STEP - 1], spreads[ADA_CHANGE_STEP]
    print(f"replicas AdaptiveSGD losses: {[round(x, 4) for x in losses]}; "
          f"spread per step {[float(f'{x:.3e}') for x in spreads]}; right "
          f"before the switch (step {ADA_CHANGE_STEP}) {before:.3e}, right "
          f"after the switch step {after:.3e}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"AdaptiveSGD loss did not fall: {losses}")
    check(after < before, "AdaptiveSGD's switch did not bring the replicas "
          "closer")
    check(o.step.tolist() == [TRAIN_STEPS] * RANKS,
          f"AdaptiveSGD step counts {o.step.tolist()}")
    out["adaptive_sgd"] = {"losses": losses, "spreads": spreads,
                           "spread_before_switch": before,
                           "spread_after_switch": after}
    del p, o, step, tx
    torch.cuda.empty_cache()

    # 3. the monitors on the replicated step
    def monitor_run(name, make_tx):
        seen = {}
        tx = _recording(make_tx(), seen)
        step = dp_train_step(loss_fn, tx, comm)
        p, o = params, tx.init(params)
        _reset(kernels)
        p, o, loss = step(p, o, batch)
        torch.cuda.synchronize()
        per_step = _counts(kernels)
        check(per_step == want_step, f"one {name} step launched {per_step}")
        first = o
        losses = [float(loss)]
        _reset(kernels)
        p, o, times, peak = _timed_steps(torch, np, step, p, o, batch, losses,
                                         steps=MONITOR_STEPS)
        counts = _counts(kernels)
        add(per_step)
        add(counts)
        print(f"replicas {name} losses: {[round(x, 4) for x in losses]}")
        return seen.pop("grads"), first, o, losses, times, peak, per_step

    g, first, last, losses, times, peak, per_step = monitor_run(
        "GNS", lambda: monitor_gradient_noise_scale(
            inner, comm.axis, local_batch_size=BERT_ROWS))
    host = _host_noise_stats(torch, g, BERT_ROWS)
    with comm.world():
        dev_local = float(collective.all_reduce(
            rank_sq_norms(g), comm.axis, op="mean")[0])
        dev_global = float(rank_sq_norms(collective.all_reduce(
            g, comm.axis, op="mean"))[0])
    del g
    raw = float(first.noise_scale)  # the EMA's first sample is the raw one
    errs = {"local_sq": _rel(dev_local, host["local_sq"]),
            "global_sq": _rel(dev_global, host["global_sq"]),
            "gns": _rel(raw, host["gns"])}
    print(f"replicas GNS step 1: mean |g_r|^2 {dev_local:.6e} (f64 "
          f"{host['local_sq']:.6e}, rel {errs['local_sq']:.2e}), |mean g|^2 "
          f"{dev_global:.6e} (f64 {host['global_sq']:.6e}, rel "
          f"{errs['global_sq']:.2e}), tol {GNS_SQ_RTOL}; raw GNS {raw:.6e} "
          f"(f64 {host['gns']:.6e}, rel {errs['gns']:.2e}, tol {GNS_RTOL}); "
          f"smoothed after {MONITOR_STEPS} steps "
          f"{float(last.noise_scale):.6e}")
    check(errs["local_sq"] <= GNS_SQ_RTOL and errs["global_sq"] <= GNS_SQ_RTOL,
          f"square norms differ from f64: {errs}")
    check(errs["gns"] <= GNS_RTOL, f"raw GNS differs from f64: {errs}")
    check(math.isfinite(float(last.noise_scale)), "non-finite noise scale")
    out["gns"] = {"losses": losses, "host_f64": host,
                  "device_local_sq": dev_local, "device_global_sq": dev_global,
                  "raw_gns_step1": raw, "rel_errors": errs,
                  "noise_scale": float(last.noise_scale),
                  **measure("GNS", times, peak, per_step)}
    del first, last
    torch.cuda.empty_cache()

    g, first, last, losses, *_ = monitor_run(
        "variance", lambda: monitor_gradient_variance(inner, comm.axis))
    host = _host_noise_stats(torch, g, BERT_ROWS)
    del g
    var = float(first.variance)
    err = _rel(var, host["variance"])
    print(f"replicas variance step 1: {var:.6e} (f64 {host['variance']:.6e}, "
          f"rel {err:.2e}, tol {GNS_SQ_RTOL}); after {MONITOR_STEPS} steps "
          f"{float(last.variance):.6e}")
    check(err <= GNS_SQ_RTOL, f"variance differs from f64 by {err}")
    check(float(last.variance) >= 0.0, "negative variance")
    out["variance"] = {"losses": losses, "variance_step1": var,
                       "host_f64": host["variance"], "rel_error": err,
                       "variance": float(last.variance)}
    del first, last, params
    torch.cuda.empty_cache()

    # 4. the autotune of the allreduce schedule (4 MiB a rank)
    _reset(kernels)
    winner = comm.autotune_strategy()
    torch.cuda.synchronize()
    counts = _counts(kernels)
    add(counts)
    times = comm.autotune_times
    print(f"replicas autotune: {winner} over "
          f"{ {k: round(v * 1e3, 4) for k, v in times.items()} } ms per "
          f"allreduce of 4 MiB a rank; launches {counts}")
    check(comm.strategy == winner, "autotune did not install its winner")
    check(set(times) == set(ALLREDUCE_SCHEDULES)
          and all(0 < v < 1e8 for v in times.values()),
          f"autotune did not time every schedule: {times}")
    check(counts["ring_rs"] > 0 and counts["ring_ag"] > 0,
          f"autotune's pallas_ring candidate launched {counts}")
    x = torch.randn((RANKS, 1 << 20), generator=torch.Generator(
        device="cuda").manual_seed(5), device="cuda")
    got = comm.all_reduce(x, op="mean")
    ref = Communicator(devices=["cuda:0"] * RANKS).all_reduce(x, op="mean")
    ratio = _ratio(got, ref, AUTOTUNE_RTOL, AUTOTUNE_ATOL)
    print(f"replicas allreduce mean under {winner} vs psum: {ratio:.3f} of "
          f"rtol {AUTOTUNE_RTOL} atol {AUTOTUNE_ATOL}")
    check(ratio <= 1.0, f"allreduce under {winner} differs from psum's")
    out["autotune"] = {"winner": winner, "ms": {k: v * 1e3 for k, v in
                                                 times.items()},
                       "launches": counts, "vs_psum_ratio": ratio}
    out["launches"] = launches
    return out

def _run_ranks(fns, timeout: float = 600.0,
               return_exceptions: bool = False) -> list:
    """Each callable on a daemon thread of its own (one a rank), their
    results in order; a thread still running after ``timeout`` fails the
    run instead of hanging it.  The first exception any raised is raised
    here, or with ``return_exceptions`` stands in the results."""
    import threading

    outs = [None] * len(fns)

    def wrap(i, fn):
        try:
            outs[i] = fn()
        except BaseException as e:  # noqa: BLE001 - raised or returned below
            outs[i] = e

    ts = [threading.Thread(target=wrap, args=(i, fn), daemon=True)
          for i, fn in enumerate(fns)]
    for t in ts:
        t.start()
    deadline = time.monotonic() + timeout
    for t in ts:
        t.join(max(0.0, deadline - time.monotonic()))
    hung = [i for i, t in enumerate(ts) if t.is_alive()]
    check(not hung, f"threads {hung} still running after {timeout} s")
    if not return_exceptions:
        for x in outs:
            if isinstance(x, BaseException):
                raise x
    return outs


def _host_zero_geometry(total: int, n: int):
    """``(chunk, bucket widths)`` of an ``n``-rank host-plane ZeRO world."""
    chunk = math.ceil(total / n)
    nb, rem = divmod(chunk, HOST_BUCKET)
    return chunk, [HOST_BUCKET] * nb + ([rem] if rem else [])


def _host_sq_norms(np, bufs, avg) -> tuple:
    """``(mean over ranks of |g_r|^2, |avg|^2)`` in f64 numpy, as
    ``host_noise_scale`` takes them."""
    local = [float(np.sum(np.square(b.numpy().astype(np.float64))))
             for b in bufs]
    return (sum(local) / len(local),
            float(np.sum(np.square(avg.numpy().astype(np.float64)))))


def phase_host_engine(torch, np, kernels, tr, bert, gns10):
    """benchmarks/system.py's ``--backend host --model bert`` loop on the
    real model: each step, every rank's bert_base() gradient on the card
    (phase 10's model, batch and loss), copied into the rank's pinned
    f32 buffer, mean-allreduced in place by four CollectiveEngines (one
    thread a rank) over NativeHostChannels from HostChannel's default
    ``auto`` on loopback, copied back to the card and applied with
    ``sgd(1e-3, momentum=0.9)``.  Checks (a)-(h), each fatal: (a) native
    channels and the C++ executor; (b) the four reduced buffers bitwise
    equal to each other and to the plain graph walk; (c) the C++ executor
    and the Python path bitwise equal for every strategy on a 64 MiB
    slice, and on the whole buffer for the default strategy; (d) the
    params after step 1 against the device-plane S-SGD step; (e) falling
    loss; (f) a strategy swap at a step boundary; (g) ZeRO-2 over the
    host plane, pipelined bitwise equal to serial and close to (d); (h)
    host_noise_scale against phase 10's GNS monitor.  Launches are
    counted over the main-path steps only."""
    import shutil
    import tempfile

    from kungfu_tpu_torch.comm import engine as E
    from kungfu_tpu_torch.comm.host import HostChannel, NativeHostChannel
    from kungfu_tpu_torch.native import transport as nt
    from kungfu_tpu_torch.plan import PeerID, PeerList
    from kungfu_tpu_torch.utils.tree import tree_flatten

    t_phase = time.perf_counter()
    model, params, batch, loss_fn = bert
    leaves, treedef = tree_flatten(params)
    sizes = [t.numel() for t in leaves]
    total = sum(sizes)
    check(total == BERT_PARAMS, f"{total} params, expected {BERT_PARAMS}")
    out = {"params": total}

    # (a) the library built from the checkout's sources, the channels
    # from the factory's default auto, the engines on AUTO
    t0 = time.perf_counter()
    check(nt.available(), "the native host library did not build")
    out["native_build_s"] = time.perf_counter() - t0
    for k in ("KF_TPU_HOST_TRANSPORT", "KF_NATIVE_ENGINE", "KF_CHAOS_SPEC",
              "KF_CONFIG_CHUNK_SIZE"):
        os.environ.pop(k, None)
    sock_dir = tempfile.mkdtemp(prefix="kfsock")
    os.environ["KF_SOCK_DIR"] = sock_dir
    unix = len(sock_dir) < 64  # AF_UNIX paths stop at 107 bytes
    os.environ["KF_TPU_USE_UNIXSOCK"] = "1" if unix else "0"
    chans = [HostChannel(PeerID("127.0.0.1", 0), bind_host="127.0.0.1")
             for _ in range(RANKS)]
    try:
        check(all(type(c) is NativeHostChannel for c in chans),
              f"HostChannel gave {[type(c).__name__ for c in chans]}")
        peers = PeerList.of(*(c.self_id for c in chans))
        engines = [E.CollectiveEngine(c, peers) for c in chans]
        chunk_bytes = E.engine_chunk_size(True)
        print(f"host engine: {RANKS} NativeHostChannels on {peers} "
              f"({'unix sockets' if unix else 'TCP'} on loopback), library "
              f"built in {out['native_build_s']:.2f} s; strategy AUTO = "
              f"{E.auto_select(1)}, {len(engines[0]._graphs)} graph pairs; "
              f"chunk {chunk_bytes} B; {E.engine_threads()} executor "
              f"threads a rank")
        out.update(_host_engine_steps(torch, np, kernels, E, engines, model,
                                      params, batch, loss_fn, treedef, sizes,
                                      chunk_bytes, gns10))
    finally:
        for c in chans:
            c.close()
        shutil.rmtree(sock_dir, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def _host_engine_steps(torch, np, kernels, E, engines, model, params, batch,
                       loss_fn, treedef, sizes, chunk_bytes, gns10):
    """Phase 12's steps and checks over the engines (see
    :func:`phase_host_engine`)."""
    from kungfu_tpu_torch.comm.device import Communicator
    from kungfu_tpu_torch.ops.monitor import host_noise_scale
    from kungfu_tpu_torch.optimizers import (apply_updates, sgd,
                                             synchronous_sgd)
    from kungfu_tpu_torch.parallel.train import (dp_train_step,
                                                 per_rank_grads, split_batch)
    from kungfu_tpu_torch.parallel.zero import (host_bucket_all_gather,
                                                host_bucket_pipeline,
                                                host_bucket_spans)
    from kungfu_tpu_torch.plan import Strategy
    from kungfu_tpu_torch.utils.tree import tree_flatten, tree_unflatten

    total = sum(sizes)
    shapes = [t.shape for t in tree_flatten(params)[0]]
    cfg = model.cfg
    shards = split_batch(batch, RANKS)
    inner = sgd(BERT_LR, momentum=BERT_MOMENTUM)
    bufs = [torch.empty(total, dtype=torch.float32, pin_memory=True)
            for _ in range(RANKS)]
    dev = torch.empty((RANKS, total), dtype=torch.float32, device="cuda")
    pinned = sum(b.numel() * b.element_size() for b in bufs)
    want_step = {key: 0 for key in _counts(kernels)}
    want_step.update(_rank_launches(cfg))
    launches = {key: 0 for key in want_step}
    out = {"pinned_bytes": pinned}

    def unflat(flat):
        parts, off = [], 0
        for k, shape in zip(sizes, shapes):
            parts.append(flat[off:off + k].view(shape))
            off += k
        return tree_unflatten(treedef, parts)

    def allreduce(tag, inplace=True, srcs=None):
        srcs = bufs if srcs is None else srcs
        return _run_ranks([lambda i=i: engines[i].all_reduce(
            srcs[i], op="mean", inplace=inplace, name=tag)
            for i in range(RANKS)])

    def step(p, o, k):
        """One main-path step; its phase times in ms and the loss."""
        _reset(kernels)
        t0 = time.perf_counter()

        def sink(r, grads):
            off = 0
            for g, n in zip(grads, sizes):
                dev[r, off:off + n].copy_(g.reshape(-1))
                off += n

        outs, _ = per_rank_grads(loss_fn, p, shards, sink)
        loss = sum(float(x) for x in outs) / RANKS  # synchronises
        t1 = time.perf_counter()
        for r in range(RANKS):
            bufs[r].copy_(dev[r])
        t2 = time.perf_counter()
        per = _counts(kernels)
        for key, v in per.items():
            launches[key] += v
        check(per == want_step, f"host-engine step {k} launched {per}, "
              f"expected {want_step}")
        return loss, {"grads_ms": (t1 - t0) * 1e3, "d2h_ms": (t2 - t1) * 1e3}

    def finish(p, o, times):
        t0 = time.perf_counter()
        allreduce(f"g{len(losses)}")
        t1 = time.perf_counter()
        g = unflat(bufs[0].to("cuda", non_blocking=True))
        u, o = inner.update(g, o, p)
        p = apply_updates(p, u)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        times.update(allreduce_ms=(t1 - t0) * 1e3,
                     h2d_update_ms=(t2 - t1) * 1e3)
        times["step_ms"] = sum(times[k] for k in (
            "grads_ms", "d2h_ms", "allreduce_ms", "h2d_update_ms"))
        return p, o

    def check_b(inputs, what):
        """(b): every rank's reduced buffer bitwise equal to the others'
        and to the plain walk of the engines' current graphs."""
        t0 = time.perf_counter()
        plain = E.graph_all_reduce_reference(inputs, engines[0]._graphs,
                                             "mean", chunk_size=chunk_bytes)
        same = [torch.equal(bufs[r], bufs[0]) for r in range(RANKS)]
        walk = [torch.equal(bufs[r], plain[r]) for r in range(RANKS)]
        print(f"host engine {what}: reduced buffers bitwise equal to rank "
              f"0's {same}, to the plain graph walk {walk} (walk "
              f"{time.perf_counter() - t0:.2f} s)")
        check(all(same) and all(walk), f"{what}: reduced buffers differ")

    losses, rows = [], []
    p, o = params, inner.init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # step 1, with every check of the step-1 gradients
    loss, times = step(p, o, 1)
    losses.append(loss)
    inputs = [b.clone() for b in bufs]
    p, o = finish(p, o, times)
    rows.append(times)
    check(all(e.native_runs == 1 for e in engines),
          f"(a) the C++ executor ran {[e.native_runs for e in engines]}")
    check_b(inputs, "step 1")
    reduced = bufs[0].clone()

    # (h) the noise scale over the host plane against phase 10's monitor
    t0 = time.perf_counter()
    raw = _run_ranks([lambda i=i: host_noise_scale(
        engines[i], inputs[i], bufs[i], BERT_ROWS) for i in range(RANKS)])
    local_sq, global_sq = _host_sq_norms(np, inputs, reduced)
    errs = {"local_sq": _rel(local_sq, gns10["device_local_sq"]),
            "global_sq": _rel(global_sq, gns10["device_global_sq"]),
            "gns": max(_rel(x, gns10["raw_gns_step1"]) for x in raw)}
    print(f"host engine (h): host_noise_scale per rank {raw}; phase 10's "
          f"raw GNS {gns10['raw_gns_step1']:.6e}; mean |g_r|^2 "
          f"{local_sq:.6e} vs {gns10['device_local_sq']:.6e}, |mean g|^2 "
          f"{global_sq:.6e} vs {gns10['device_global_sq']:.6e}; rel "
          f"{errs} (tol {GNS_SQ_RTOL} norms, {GNS_RTOL} GNS; "
          f"{time.perf_counter() - t0:.2f} s)")
    check(len(set(raw)) == 1, f"(h) ranks disagree: {raw}")
    check(errs["local_sq"] <= GNS_SQ_RTOL and errs["global_sq"] <= GNS_SQ_RTOL
          and errs["gns"] <= GNS_RTOL, f"(h) noise scale differs: {errs}")
    out["noise_scale"] = {"raw": raw[0], "local_sq": local_sq,
                          "global_sq": global_sq, "rel_errors": errs}

    # (d) the params after step 1 against the device-plane S-SGD step
    comm = Communicator(devices=["cuda:0"] * RANKS, local_size=RANKS)
    p_dev, _, loss_dev = dp_train_step(
        loss_fn, synchronous_sgd(inner, comm.axis), comm)(
            params, inner.init(params), batch)
    p_dev_leaves = tree_flatten(p_dev)[0]
    p1_leaves = tree_flatten(p)[0]
    rel_d = max(float((a - b).norm() / b.norm())
                for a, b in zip(p1_leaves, p_dev_leaves))
    print(f"host engine (d): params after step 1 vs the device-plane S-SGD "
          f"step: worst rel L2 per leaf {rel_d:.3e} (tol {HOST_PARAMS_RTOL});"
          f" loss {losses[0]:.6f} vs {float(loss_dev):.6f}")
    check(rel_d <= HOST_PARAMS_RTOL, f"(d) params differ by {rel_d}")
    out["params_vs_device_ssgd"] = rel_d
    p1_host = torch.cat([t.reshape(-1).cpu() for t in p1_leaves])
    del p_dev, p_dev_leaves

    # (g) ZeRO-2 over the host plane on the same gradients
    chunk, widths = _host_zero_geometry(total, RANKS)
    spans = host_bucket_spans(chunk, widths)
    p0_host = torch.cat([t.reshape(-1).cpu() for t in tree_flatten(
        params)[0]])
    zero = {}
    for pipelined in (True, False):
        def rank(i, pipelined=pipelined):
            own = p0_host[i * chunk:(i + 1) * chunk].clone()
            mom = torch.zeros(chunk)

            def compute(b, red):
                off, w = spans[b]
                m = red + mom[off:off + w] * BERT_MOMENTUM
                mom[off:off + w] = m
                own[off:off + w] += -BERT_LR * m

            tag = "z2p" if pipelined else "z2s"
            host_bucket_pipeline(engines[i], inputs[i], widths, compute,
                                 op="mean", pipelined=pipelined, name=tag)
            return host_bucket_all_gather(engines[i], own, widths,
                                          pipelined=pipelined,
                                          name=tag + "g")

        t0 = time.perf_counter()
        zero[pipelined] = _run_ranks([lambda i=i: rank(i)
                                      for i in range(RANKS)])
        zero[f"{pipelined}_s"] = time.perf_counter() - t0
    z_same = all(torch.equal(zero[True][r], zero[False][r]) and
                 torch.equal(zero[True][r], zero[True][0])
                 for r in range(RANKS))
    z_rel = max(float((zero[True][0][off:off + k] - p1_host[off:off + k]).norm()
                      / p1_host[off:off + k].norm())
                for off, k in zip([0] + [int(x) for x in np.cumsum(sizes)[:-1]],
                                  sizes))
    print(f"host engine (g): ZeRO-2 over the host plane, {len(widths)} "
          f"buckets of {HOST_BUCKET} columns a rank: pipelined "
          f"{zero['True_s']:.2f} s, serial {zero['False_s']:.2f} s; "
          f"pipelined bitwise equal to serial on every rank {z_same}; vs (d)'s"
          f" params worst rel L2 per leaf {z_rel:.3e} (tol "
          f"{HOST_PARAMS_RTOL})")
    check(z_same, "(g) pipelined ZeRO-2 differs from serial")
    check(z_rel <= HOST_PARAMS_RTOL, f"(g) ZeRO-2 params differ by {z_rel}")
    out["zero2"] = {"buckets": len(widths), "pipelined_s": zero["True_s"],
                    "serial_s": zero["False_s"], "rel_vs_d": z_rel}
    del zero, p0_host, p1_host

    # (c) the C++ executor against the Python path, every strategy on a
    # 64 MiB slice of step 1's gradients, the whole buffer for AUTO
    cut = HOST_SLICE_BYTES // 4
    sl = [x[:cut].clone() for x in inputs]
    strategies = {}
    for strat in [s for s in Strategy if s != Strategy.AUTO]:
        for e in engines:
            e.set_strategy(strat)
        t0 = time.perf_counter()
        cxx = allreduce(f"c.{strat.value}.x", inplace=False, srcs=sl)
        t1 = time.perf_counter()
        # the engine's own stats of the C++ run: bytes over summed chunk
        # seconds, per graph pair
        gbs = [float(b / t / 1e9) if t else 0.0 for b, t in engines[0].stats]
        os.environ["KF_NATIVE_ENGINE"] = "0"
        try:
            py = allreduce(f"c.{strat.value}.p", inplace=False, srcs=sl)
        finally:
            os.environ.pop("KF_NATIVE_ENGINE")
        t2 = time.perf_counter()
        plain = E.graph_all_reduce_reference(sl, engines[0]._graphs, "mean",
                                             chunk_size=chunk_bytes)
        ok = all(torch.equal(cxx[r], py[r]) and torch.equal(cxx[r], plain[r])
                 and torch.equal(cxx[r], cxx[0]) for r in range(RANKS))
        strategies[strat.value] = {
            "pairs": len(engines[0]._graphs), "cxx_s": t1 - t0,
            "python_s": t2 - t1, "wall_gb_s_cxx": HOST_SLICE_BYTES / (t1 - t0)
            / 1e9, "wall_gb_s_python": HOST_SLICE_BYTES / (t2 - t1) / 1e9,
            "stats_gb_s": gbs, "bitwise": ok}
        print(f"host engine (c) {strat.value}: {len(engines[0]._graphs)} "
              f"pairs; C++ {t1 - t0:.3f} s ({HOST_SLICE_BYTES / (t1 - t0) / 1e9:.3f}"
              f" GB/s of buffer), Python path {t2 - t1:.3f} s "
              f"({HOST_SLICE_BYTES / (t2 - t1) / 1e9:.3f} GB/s); per-pair "
              f"stats GB/s {[round(x, 3) for x in gbs]}; C++ = Python = "
              f"plain walk bitwise {ok}")
        check(ok, f"(c) {strat.value}: the C++ executor and the Python path "
              "differ")
    del sl
    for e in engines:
        e.set_strategy(Strategy.AUTO)
    t0 = time.perf_counter()
    os.environ["KF_NATIVE_ENGINE"] = "0"
    try:
        py_full = allreduce("c.full.p", inplace=False, srcs=inputs)
    finally:
        os.environ.pop("KF_NATIVE_ENGINE")
    full_s = time.perf_counter() - t0
    full_ok = all(torch.equal(x, reduced) for x in py_full)
    print(f"host engine (c) AUTO, whole buffer ({total * 4} B a rank): Python "
          f"path {full_s:.2f} s ({total * 4 / full_s / 1e9:.3f} GB/s), C++ "
          f"step 1 {rows[0]['allreduce_ms'] / 1e3:.2f} s; bitwise equal "
          f"{full_ok}")
    check(full_ok, "(c) the Python path differs from the C++ executor on "
          "the whole buffer")
    out["strategies"] = strategies
    out["python_path_full_s"] = full_s
    del py_full, inputs

    # (e) the timed steps, then (f) a swap at each of two step boundaries
    for k in range(2, HOST_STEPS + 1):
        loss, times = step(p, o, k)
        losses.append(loss)
        p, o = finish(p, o, times)
        rows.append(times)
    for strat in (Strategy.STAR, Strategy.RING):
        for e in engines:
            e.set_strategy(strat)
        loss, times = step(p, o, len(losses) + 1)
        losses.append(loss)
        inputs = [b.clone() for b in bufs]
        p, o = finish(p, o, times)
        check_b(inputs, f"(f) the step after set_strategy({strat.value})")
        del inputs
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    timed = losses[:HOST_STEPS]
    print(f"host engine (e): losses {[round(x, 4) for x in losses]}")
    check(all(np.isfinite(losses)), f"non-finite loss {losses}")
    check(timed[-1] < timed[0], f"(e) loss did not fall: {timed}")
    check(all(e.native_runs >= HOST_STEPS + 3 for e in engines),
          f"(a) native runs {[e.native_runs for e in engines]}")
    med = {k: statistics.median(r[k] for r in rows[1:]) for k in rows[0]}
    print(f"host engine step ({RANKS} ranks, {total * 4} B a rank, median of "
          f"steps 2-{HOST_STEPS}): {med['step_ms']:.2f} ms = grads "
          f"{med['grads_ms']:.2f} + D2H {med['d2h_ms']:.2f} + allreduce "
          f"{med['allreduce_ms']:.2f} + H2D and update "
          f"{med['h2d_update_ms']:.2f}; first step {rows[0]['step_ms']:.2f} "
          f"ms ({ {k: round(v, 2) for k, v in rows[0].items()} }); allreduce "
          f"{total * 4 / (med['allreduce_ms'] / 1e3) / 1e9:.3f} GB/s of buffer"
          f"; pinned {out['pinned_bytes']} B; peak device memory "
          f"{peak:.2f} GiB; launches per step {want_step}")
    out.update(losses=losses, step_rows=rows, median=med, first=rows[0],
               peak_gib=peak, launches=launches, per_step=want_step,
               native_runs=[e.native_runs for e in engines])
    return out


#: phase 13: sgd on the host plane's ZeRO-2 step through a kill, a shrink
#: and a cold restore.  Steps 1-3 run at four ranks; old rank 3 dies in
#: mode=raise at its first engine collective of step 4; the survivors
#: replay from step 3 and run steps 4-6 at three ranks; a preempt:all
#: clause fires at elastic_step's announcement of step 6, and two fresh
#: peers restore the step-6 manifest and take step 7
RECOVER_LR, RECOVER_MOMENTUM = 0.05, 0.9
RECOVER_RANKS = (4, 3, 2)
RECOVER_KILL_STEP, RECOVER_PREEMPT_STEP, RECOVER_LAST = 4, 6, 7
RECOVER_VICTIM = 3
#: per-peer deadline of the phase's engine collectives (s): above the
#: largest skew of a healthy step (rank 0 waits out its params manifest
#: before elastic_step's sync), below what a kill may cost
RECOVER_DEADLINE_S = 20.0
#: the kill's detection may take the deadline plus this (check (a))
RECOVER_DETECT_SLACK_S = 15.0
#: complete manifests kept by rank 0's GC
RECOVER_KEEP = 2


def _repad(torch, flat, total: int, n: int):
    """``flat``'s first ``total`` elements zero-padded into ``n`` chunks,
    ``[n, chunk]`` on the host: a state laid out for an ``n``-rank world
    by hand, in plain torch."""
    chunk = math.ceil(total / n)
    out = torch.zeros(n * chunk, dtype=flat.dtype)
    out[:total] = flat[:total].cpu()
    return out.view(n, chunk)


class _RecoverRank:
    """One rank of phase 13's host-plane ZeRO-2 world: its peer, pinned
    buffers, parameter and momentum chunks on the card, and (on the
    main path) its boundary, snapshot and persist plane."""

    def __init__(self, torch, peer, r: int, n: int, total: int, flat_params,
                 mom_chunk):
        from kungfu_tpu_torch.optimizers._transform import TraceState

        self.peer, self.r, self.n = peer, r, n
        self.chunk, self.widths = _host_zero_geometry(total, n)
        c = self.chunk
        self.gbuf = torch.zeros(n * c, dtype=torch.float32, pin_memory=True)
        self.red = torch.empty(c, dtype=torch.float32, pin_memory=True)
        self.own = torch.empty(c, dtype=torch.float32, pin_memory=True)
        padded = _repad(torch, flat_params, total, n)
        self.p_own = padded[r].to("cuda")
        self.mom = TraceState(mom_chunk.reshape(-1).to("cuda"))
        self.zb = self.snap = self.plane = self.full = self.times = None


def _recover_body(torch, rk, k: int, inner, total: int, unflat, commit,
                  state):
    """Rank ``rk``'s part of step ``k`` on its own thread: the mean
    reduce-scatter of its pinned gradient, the sgd update of its chunks
    on the card, the all-gather of the params; on the main path the
    commits and ``elastic_step``.  Returns ``(gathered params, times,
    elastic state)``."""
    from kungfu_tpu_torch.elastic.hooks import elastic_step
    from kungfu_tpu_torch.optimizers import apply_updates
    from kungfu_tpu_torch.parallel.zero import (host_bucket_all_gather,
                                                host_bucket_pipeline,
                                                host_bucket_spans)

    eng = rk.peer.engine()
    spans = host_bucket_spans(rk.chunk, rk.widths)

    def keep(b, red):
        off, w = spans[b]
        rk.red[off:off + w].copy_(red)

    t0 = time.perf_counter()
    host_bucket_pipeline(eng, rk.gbuf, rk.widths, keep, op="mean",
                         name=f"g{k}")
    t1 = time.perf_counter()
    u, rk.mom = inner.update(rk.red.to("cuda", non_blocking=True), rk.mom,
                             rk.p_own)
    rk.p_own = apply_updates(rk.p_own, u)
    rk.own.copy_(rk.p_own)  # synchronises
    t2 = time.perf_counter()
    full = host_bucket_all_gather(eng, rk.own, rk.widths, name=f"p{k}")
    t3 = time.perf_counter()
    rk.full = full
    times = {"reduce_scatter_ms": (t1 - t0) * 1e3,
             "update_ms": (t2 - t1) * 1e3,
             "all_gather_ms": (t3 - t2) * 1e3}
    rk.times = times
    if not commit:
        return full, times, state
    flat = full[:total]
    rk.zb.commit_local(k, rk.mom, total=total, old_n=rk.n, my_old=rk.r)
    t4 = time.perf_counter()
    rk.zb.replicate_ring(rk.peer.channel, rk.peer.cluster.workers,
                         tag=f"s{k}")
    t5 = time.perf_counter()
    rk.snap.commit(k, unflat(flat))
    t6 = time.perf_counter()
    rk.plane.commit(k, rk.zb, replicated={"params": flat}
                    if rk.r == 0 else None)
    t7 = time.perf_counter()
    rk.plane.persist_fence()
    t8 = time.perf_counter()
    times.update(boundary_commit_ms=(t4 - t3) * 1e3,
                 buddy_ms=(t5 - t4) * 1e3, snapshot_ms=(t6 - t5) * 1e3,
                 persist_issue_ms=(t7 - t6) * 1e3,
                 persist_fence_ms=(t8 - t7) * 1e3)
    state, _, _ = elastic_step(rk.peer, state, None, unflat(flat),
                               zero_boundary=rk.zb)
    times["elastic_step_ms"] = (time.perf_counter() - t8) * 1e3
    return full, times, state


def _shrink_marks(events, ends) -> dict:
    """Seconds between the shrink marks of the recovery: per old rank,
    the ping sweep and the drain of in-flight handles (``ping-confirm``
    to ``consensus``) and the exclusion consensus (``consensus`` to
    ``propose``); over the ranks, the replay broadcast (first ``replay``
    to last ``zero-recarve``) and the re-carve (last ``zero-recarve`` to
    the last rank's return, ``ends`` on the timeline's clock)."""
    by = {}
    for ev in events:
        if ev["kind"] == "shrink":
            by.setdefault(ev["name"], []).append(
                (ev["ts"], ev["rank"], ev["attrs"]))
    out = {"find_dead_ranks_s": {}, "consensus_s": {}}
    for ts, rank, _ in by.get("ping-confirm", []):
        nxt = [t for t, r, _ in by.get("consensus", []) if r == rank]
        prop = [t for t, r, _ in by.get("propose", []) if r == rank]
        if nxt:
            out["find_dead_ranks_s"][rank] = nxt[0] - ts
            if prop:
                out["consensus_s"][rank] = prop[0] - nxt[0]
    rep = [t for t, _, _ in by.get("replay", [])]
    rec = [t for t, _, _ in by.get("zero-recarve", [])]
    if rep and rec:
        out["replay_broadcast_s"] = max(rec) - min(rep)
        out["recarve_s"] = max(ends) - max(rec)
    out["marks"] = sorted(by)
    return out


def phase_recover(torch, np, kernels, tr):
    """The peer runtime and in-flight failure recovery on gpt_small
    (max_seq 2048, the build of phases 6, 8, 9 and 11): four Peers, one
    thread each, made by ``parse_config_from_env`` from env dicts in
    ``single_machine_env``'s shape on ports found free
    (``start_local_cluster``), under a ConfigServer; rank r takes row r
    of phase 6's batch.  A step: every rank's gradient on the card
    (kernel rows 1-5), copied into its pinned buffer, mean
    reduce-scattered by ``host_bucket_pipeline`` over ``peer.engine()``,
    ``sgd(0.05, momentum=0.9)`` on the rank's chunks on the card, the
    params regathered by ``host_bucket_all_gather``; then
    ``ZeroBoundary.commit_local`` with ring-buddy mirrors,
    ``StepSnapshot.commit``, ``PersistPlane.commit`` (period 0), the
    fence and ``elastic_step``.  Old rank 3 dies at step 4's first
    engine collective; the survivors recover, replay from step 3 and run
    steps 4-6; a whole-job preemption after step 6 ends the run, and two
    fresh peers restore the step-6 manifest and take step 7.  Checks
    (a)-(h) of the module docstring, each fatal."""
    import shutil
    import tempfile
    from dataclasses import replace

    from kungfu_tpu_torch import chaos
    from kungfu_tpu_torch.checkpoint import StepSnapshot
    from kungfu_tpu_torch.comm.device import Communicator
    from kungfu_tpu_torch.comm.faults import PeerFailureError
    from kungfu_tpu_torch.elastic import ConfigServer, ZeroBoundary
    from kungfu_tpu_torch.elastic.hooks import ElasticState
    from kungfu_tpu_torch.elastic.persist import (PersistPlane,
                                                  agreed_manifest_path,
                                                  choose_manifest,
                                                  restore_from_manifest)
    from kungfu_tpu_torch.elastic.resize import fetch_cluster
    from kungfu_tpu_torch.monitor import timeline
    from kungfu_tpu_torch.optimizers import sgd
    from kungfu_tpu_torch.parallel.train import per_rank_grads, split_batch
    from kungfu_tpu_torch.parallel.zero import reshard_plan
    from kungfu_tpu_torch.peer import start_local_cluster
    from kungfu_tpu_torch.plan import Cluster, HostList
    from kungfu_tpu_torch.utils import envs
    from kungfu_tpu_torch.utils.tree import (tree_flatten, tree_leaves,
                                             tree_unflatten)

    t_phase = time.perf_counter()
    smi = nvidia_smi()  # stamped on every number the phase prints
    model, params, batch, _, loss_fn = _flagship_train(torch, np, tr,
                                                       kernels[0])
    cfg = model.cfg
    leaves, treedef = tree_flatten(params)
    sizes = [t.numel() for t in leaves]
    shapes = [t.shape for t in leaves]
    total = sum(sizes)
    check(total == FLAGSHIP_PARAMS, f"gpt_small has {total} params")
    shards = split_batch(batch, TRAIN_BATCH)
    inner = sgd(RECOVER_LR, momentum=RECOVER_MOMENTUM)
    flat0 = torch.cat([t.reshape(-1) for t in leaves]).cpu()
    del params, leaves

    def unflat(flat):
        parts, off = [], 0
        for m, shape in zip(sizes, shapes):
            parts.append(flat[off:off + m].view(shape))
            off += m
        return tree_unflatten(treedef, parts)

    def flatten(tree):
        return torch.cat([t.reshape(-1) for t in tree_leaves(tree)])

    dev = torch.empty((RANKS, total), dtype=torch.float32, device="cuda")
    launches = {key: 0 for key in _counts(kernels)}
    rows, losses, writes = {}, {}, []
    out = {"params": total, "deadline_s": RECOVER_DEADLINE_S}
    saved_env = {k: os.environ.get(k) for k in (
        "KF_CHAOS_SPEC", "KF_CONFIG_PEER_DEADLINE", "KF_PERSIST_PERIOD",
        "KF_PERSIST_KEEP", "KF_PERSIST_RESTORE", "KF_CONFIG_ENABLE_TRACE",
        "KF_TPU_USE_UNIXSOCK")}

    def step(world, k, flat, body, what="main path"):
        """Step ``k`` on ``world`` from the params ``flat``: the ranks'
        gradients on the main thread (launches checked), then
        ``body(rank)`` on a thread a rank; returns the loss, the bodies'
        results (or exceptions) and the step's main-thread times."""
        n = len(world)
        _reset(kernels)
        t0 = time.perf_counter()
        p = unflat(flat.to("cuda"))

        def sink(r, grads):
            off = 0
            for g, m in zip(grads, sizes):
                dev[r, off:off + m].copy_(g.reshape(-1))
                off += m

        outs, _ = per_rank_grads(loss_fn, p, shards[:n], sink)
        loss = sum(float(x) for x in outs) / n  # synchronises
        t1 = time.perf_counter()
        for r, rk in enumerate(world):
            rk.gbuf[:total].copy_(dev[r])
        t2 = time.perf_counter()
        got = _counts(kernels)
        want = {key: 0 for key in got}
        want.update(_rank_launches(cfg, n))
        check(got == want, f"(g) {what} step {k} at {n} ranks launched "
              f"{got}, expected {want}")
        if what == "main path":
            for key, v in got.items():
                launches[key] += v
        check(math.isfinite(loss), f"(h) {what} step {k}: loss {loss}")
        del p
        res = _run_ranks([lambda rk=rk: body(rk) for rk in world],
                         timeout=600, return_exceptions=True)
        return loss, res, {"grads_ms": (t1 - t0) * 1e3,
                           "d2h_ms": (t2 - t1) * 1e3,
                           "ranks_ms": (time.perf_counter() - t2) * 1e3}

    def plain_body(k, states=None):
        commit = states is not None

        def body(rk):
            return _recover_body(torch, rk, k, inner, total, unflat, commit,
                                 states[rk.r] if commit else None)
        return body

    def finish(world, res, k, loss, times, label):
        """Every rank's gathered params bitwise alike; the step's row and
        its persist writes (from the timeline's ckpt marks)."""
        bad = [x for x in res if isinstance(x, BaseException)]
        check(not bad, f"{label} step {k} raised {bad}")
        fulls = [rk.full for rk in world]
        check(all(torch.equal(f, fulls[0]) for f in fulls),
              f"{label} step {k}: the ranks' gathered params differ")
        row = dict(times)
        for key in res[0][1]:
            row[key] = statistics.median(x[1][key] for x in res
                                         if key in x[1])
        row["step_ms"] = sum(v for key, v in row.items()
                             if key.endswith("_ms") and key != "ranks_ms")
        row["loss"] = loss
        rows.setdefault(label, []).append(row)
        return fulls[0][:total].clone()

    def ckpt_writes():
        """(rank, step, s from issue to durable) of the persist marks
        since the last call."""
        issued = {}
        for ev in timeline.snapshot():
            if ev["kind"] != "ckpt":
                continue
            key = (ev["rank"], ev["attrs"].get("step"))
            if ev["name"] == "persist-issue":
                issued[key] = ev["ts"]
            elif ev["name"] == "persist-done" and key in issued:
                writes.append((key[0], key[1], ev["ts"] - issued[key],
                               ev["attrs"].get("nbytes")))
        timeline.reset()

    def fixed_world(n, flat, mom_rows, steps, tag):
        """``steps`` of a fresh ``n``-peer world (no commits) from the
        params ``flat`` and momentum rows ``mom_rows``, as the main path
        runs them: its engines, strategy and rows."""
        ps = start_local_cluster(n, devices=["cuda"])
        try:
            w = [_RecoverRank(torch, p, r, n, total, flat, mom_rows[r])
                 for r, p in enumerate(ps)]
            for k in steps:
                loss, res, times = step(w, k, flat, plain_body(k),
                                        what=f"fixed {tag}")
                flat = finish(w, res, k, loss, times, f"fixed_{n}")
                losses[f"fixed_{n}_{k}"] = loss
            return flat, torch.stack([rk.mom.trace.cpu() for rk in w])
        finally:
            for p in ps:
                p.close()

    hosts = HostList.parse(f"127.0.0.1:{RANKS}")
    server = ConfigServer(port=0, host="127.0.0.1", cluster=Cluster(
        hosts.gen_runner_list(), hosts.gen_peer_list(RANKS))).start()
    root = tempfile.mkdtemp(prefix="kfpersist")
    peers = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        chaos.reset()
        timeline.reset()
        os.environ["KF_TPU_USE_UNIXSOCK"] = "0"
        os.environ["KF_CONFIG_PEER_DEADLINE"] = str(RECOVER_DEADLINE_S)
        os.environ["KF_PERSIST_PERIOD"] = "0"
        os.environ["KF_PERSIST_KEEP"] = str(RECOVER_KEEP)
        os.environ["KF_CONFIG_ENABLE_TRACE"] = "1"
        os.environ.pop("KF_PERSIST_RESTORE", None)
        n4, n3, n2 = RECOVER_RANKS
        c4, w4 = _host_zero_geometry(total, n4)
        # the victim's Nth engine collective: a healthy step runs one
        # reduce-scatter and one all-gather a bucket and elastic_step's
        # step sync
        kill_coll = (2 * len(w4) + 1) * (RECOVER_KILL_STEP - 1) + 1
        spec = (f"die:coll={kill_coll},rank={RECOVER_VICTIM},mode=raise;"
                f"preempt:all,step={RECOVER_PREEMPT_STEP},mode=raise")
        os.environ["KF_CHAOS_SPEC"] = spec
        t0 = time.perf_counter()
        peers = start_local_cluster(
            n4, env={envs.CONFIG_SERVER: server.url}, devices=["cuda"])
        out["start_s"] = time.perf_counter() - t0
        comm = peers[0].communicator()
        check(comm.device.type == "cuda",
              f"a peer's communicator is on {comm.device}")
        print(f"recover: {n4} Peers {[str(p.config.self_id) for p in peers]}"
              f" started in {out['start_s']:.2f} s under ConfigServer "
              f"{server.url}; chaos {spec!r}; peer deadline "
              f"{RECOVER_DEADLINE_S} s; {len(w4)} buckets a rank at 4")
        world = [_RecoverRank(torch, p, r, n4, total, flat0,
                              torch.zeros(c4)) for r, p in enumerate(peers)]
        for rk in world:
            rk.zb, rk.snap = ZeroBoundary(), StepSnapshot()
            rk.plane = PersistPlane(root, rk.r, cluster_version=0)
        out["pinned_bytes_4"] = sum(
            b.numel() * 4 for rk in world for b in (rk.gbuf, rk.red, rk.own))
        states = [ElasticState(step=1) for _ in world]
        flat = flat0
        for k in range(1, RECOVER_KILL_STEP):
            loss, res, times = step(world, k, flat, plain_body(k, states))
            flat = finish(world, res, k, loss, times, str(n4))
            states = [x[2] for x in res]
            losses[k] = loss
            ckpt_writes()
        ctl = chaos.controller_for(RECOVER_VICTIM)
        check(ctl._colls == kill_coll - 1, f"the victim ran {ctl._colls} "
              f"engine collectives in steps 1-3, not {kill_coll - 1}")
        flat3 = flat
        # the optimizer's own state, not the boundary under test
        mom3 = torch.cat([rk.mom.trace.cpu() for rk in world])

        # the kill: old rank 3 dies at step 4's first engine collective
        deaths, errs, recov, ends = {}, {}, {}, []

        def kill_body(rk):
            try:
                _recover_body(torch, rk, RECOVER_KILL_STEP, inner, total,
                              unflat, True, states[rk.r])
                return "no failure"
            except chaos.InjectedDeath:
                deaths[rk.r] = time.perf_counter()
                rk.plane.close()
                rk.peer.close()  # its sockets stop answering pings
                return "died"
            except PeerFailureError as err:
                errs[rk.r] = (time.perf_counter(), err)
                shrunk, replay = rk.peer.recover_from_failure(
                    err, snapshot=rk.snap, zero_boundary=rk.zb)
                recov[rk.r] = time.perf_counter()
                ends.append(time.time())  # the timeline's clock
                return shrunk, replay

        loss4_dead, res, _ = step(world, RECOVER_KILL_STEP, flat, kill_body)
        marks = _shrink_marks(timeline.snapshot(), ends)
        timeline.reset()
        survivors = [rk for rk in world if rk.r != RECOVER_VICTIM]
        check(res[RECOVER_VICTIM] == "died" and set(deaths) ==
              {RECOVER_VICTIM}, f"the victim: {res[RECOVER_VICTIM]}")
        # (a) detection: a typed error naming the victim, in time
        detect = {}
        for rk in survivors:
            check(rk.r in errs, f"(a) rank {rk.r} got no PeerFailureError: "
                  f"{res[rk.r]}")
            t_err, err = errs[rk.r]
            detect[rk.r] = t_err - deaths[RECOVER_VICTIM]
            check(err.rank == RECOVER_VICTIM, f"(a) rank {rk.r}'s "
                  f"PeerFailureError names rank {err.rank}: {err}")
            check(detect[rk.r] <= RECOVER_DEADLINE_S + RECOVER_DETECT_SLACK_S,
                  f"(a) rank {rk.r} took {detect[rk.r]:.2f} s to detect")
        # (b) membership: three peers at version 1, one digest, published
        digests = {rk.peer.cluster.digest() for rk in survivors}
        check(all(rk.peer.size() == n3 and rk.peer.cluster_version == 1
                  and not rk.peer.detached for rk in survivors)
              and len(digests) == 1,
              f"(b) membership {[(rk.peer.size(), rk.peer.cluster_version) for rk in survivors]}, {len(digests)} digests")
        published, pub_v = fetch_cluster(server.url)
        check(published.workers == survivors[0].peer.cluster.workers,
              f"(b) the config server holds {published} (version {pub_v})")
        # (c) the agreed replay point: step 3's params, bitwise
        replay_bytes = len(survivors[0].snap.serialize())
        flat_r = None
        for rk in survivors:
            shrunk, replay = res[rk.r]
            check(shrunk and replay is not None and replay[0] ==
                  RECOVER_KILL_STEP - 1, f"(c) rank {rk.r}: shrunk "
                  f"{shrunk}, replay step {replay and replay[0]}")
            got = flatten(replay[1])
            check(torch.equal(got, flat3), f"(c) rank {rk.r}'s replayed "
                  "params differ from step 3's")
            flat_r = got
        # (d) the re-carve, the dead rank's chunk from its ring buddy
        want3 = _repad(torch, mom3, total, n3)
        for rk in survivors:
            got = rk.zb.chunks()[1][0]
            check(torch.equal(got, want3[rk.r]), f"(d) rank {rk.r}'s "
                  "re-carved momentum chunk differs from step 3's state "
                  "repadded into three chunks")
        plan = reshard_plan(total, n4, n3)
        moved = sum(ln for o, r, _, ln in plan
                    if (o if o != RECOVER_VICTIM else o - 1) != r) * 4
        comm3 = Communicator(devices=["cuda:0"] * n3, local_size=n3,
                             version=1)
        t0 = time.perf_counter()
        rows3 = [rk.zb.place(comm3) for rk in survivors]
        torch.cuda.synchronize()
        place_s = time.perf_counter() - t0
        world3 = []
        for rk, st in zip(survivors, rows3):
            nr = _RecoverRank(torch, rk.peer, rk.r, n3, total, flat_r,
                              st.trace)
            nr.zb, nr.snap = rk.zb, rk.snap
            nr.plane = PersistPlane(root, rk.r,
                                    cluster_version=rk.peer.cluster_version)
            rk.plane.close()
            world3.append(nr)
        del world, rows3
        out["pinned_bytes_3"] = sum(
            b.numel() * 4 for rk in world3 for b in (rk.gbuf, rk.red, rk.own))
        recover_s = {rk.r: recov[rk.r] - errs[rk.r][0] for rk in survivors}
        out.update(detect_s=detect, recover_s=recover_s, shrink=marks,
                   replay_bytes=replay_bytes, recarve_bytes=moved,
                   place_s=place_s, kill_coll=kill_coll,
                   replay_step=RECOVER_KILL_STEP - 1)
        print(f"recover: old rank {RECOVER_VICTIM} died at its engine "
              f"collective {kill_coll} (step {RECOVER_KILL_STEP}); kill -> "
              f"PeerFailureError s {detect}; recover_from_failure s "
              f"{recover_s}; ping sweep s {marks['find_dead_ranks_s']}, "
              f"exclusion consensus s {marks['consensus_s']}, replay "
              f"broadcast {marks.get('replay_broadcast_s', float('nan')):.3f}"
              f" s for {replay_bytes} B; re-carve "
              f"{marks.get('recarve_s', float('nan')):.3f} s, {moved} B "
              f"moved; place {place_s:.3f} s; cluster version 1 of {n3} "
              f"peers, published (config version {pub_v}); {smi}")

        # steps 4-6 at three ranks, from the replay point
        states = [replace(states[rk.r], step=RECOVER_KILL_STEP)
                  for rk in world3]
        flat = flat_r
        preempted = {}

        def last_body(rk):
            try:
                return _recover_body(torch, rk, RECOVER_PREEMPT_STEP, inner,
                                     total, unflat, True, states[rk.r])
            except chaos.InjectedDeath:
                preempted[rk.r] = True
                rk.plane.close()
                rk.peer.close()
                return (rk.full, rk.times, None)

        for k in range(RECOVER_KILL_STEP, RECOVER_PREEMPT_STEP + 1):
            body = (last_body if k == RECOVER_PREEMPT_STEP
                    else plain_body(k, states))
            loss, res, times = step(world3, k, flat, body)
            flat = finish(world3, res, k, loss, times, str(n3))
            states = [x[2] for x in res]
            losses[k] = loss
            ckpt_writes()
        check(sorted(preempted) == list(range(n3)),
              f"preempt:all fired on ranks {sorted(preempted)}")
        flat6 = flat
        mom6 = torch.cat([rk.mom.trace.cpu() for rk in world3])
        mdir6 = os.path.join(root, f"step_{RECOVER_PREEMPT_STEP:08d}.v1")
        manifest_bytes = sum(os.path.getsize(os.path.join(mdir6, f))
                             for f in os.listdir(mdir6))
        del world3
        peers = []
        chaos.reset()
        os.environ.pop("KF_CHAOS_SPEC")
        os.environ.pop("KF_CONFIG_ENABLE_TRACE")

        # (e) a fixed three-rank world from (c) + (d), steps 4-6
        fx6, fx_mom6 = fixed_world(n3, flat3, want3,
                                   range(RECOVER_KILL_STEP,
                                         RECOVER_PREEMPT_STEP + 1), "3")
        _check_bitwise(torch, [flat6, mom6], [fx6, fx_mom6.reshape(-1)],
                       "recover (e): params and momentum after steps 4-6 "
                       "vs a fixed three-rank world")
        for k in range(RECOVER_KILL_STEP, RECOVER_PREEMPT_STEP + 1):
            check(losses[k] == losses[f"fixed_3_{k}"],
                  f"(e) step {k} loss {losses[k]} != the fixed world's")

        # (f) the cold restore: two fresh peers agree on the newest
        # complete manifest and restore their shares of it
        os.environ["KF_PERSIST_RESTORE"] = "1"
        check(envs.persist_knobs()["restore"], "KF_PERSIST_RESTORE unarmed")
        t0 = time.perf_counter()
        peers = start_local_cluster(n2, devices=["cuda"])

        def restore_body(p):
            r = p.rank()
            plane = PersistPlane(root, r, cluster_version=p.cluster_version)
            s, v = choose_manifest(root) if r == 0 else (-1, -1)
            s, v = plane.agree_manifest(p.channel, p.cluster.workers, r, s, v)
            rs = restore_from_manifest(agreed_manifest_path(root, s, v), r,
                                       n2)
            zb = ZeroBoundary()
            rs.install_into_boundary(zb)
            plane.close()
            return rs, zb

        restored = _run_ranks([lambda p=p: restore_body(p) for p in peers],
                              timeout=300, return_exceptions=True)
        restore_s = time.perf_counter() - t0
        want2 = _repad(torch, mom6, total, n2)
        for r, x in enumerate(restored):
            check(not isinstance(x, BaseException), f"(f) restore: {x}")
            rs, zb = x
            check(rs.step == RECOVER_PREEMPT_STEP and rs.meta["old_n"] == n3,
                  f"(f) rank {r} restored step {rs.step} of "
                  f"{rs.meta['old_n']} ranks")
            check(torch.equal(rs.vec[0], want2[r]) and
                  torch.equal(zb.chunks()[1][0], want2[r]),
                  f"(f) rank {r}'s restored momentum differs from step 6's "
                  "state repadded into two chunks")
            check(torch.equal(rs.replicated["params"], flat6),
                  f"(f) rank {r}'s restored params differ from step 6's")
        world2 = [_RecoverRank(torch, p, r, n2, total,
                               restored[r][0].replicated["params"],
                               restored[r][0].vec[0])
                  for r, p in enumerate(peers)]
        k = RECOVER_LAST
        loss, res, times = step(world2, k,
                                restored[0][0].replicated["params"],
                                plain_body(k))
        flat7 = finish(world2, res, k, loss, times, str(n2))
        losses[k] = loss
        mom7 = torch.cat([rk.mom.trace.cpu() for rk in world2])
        del world2
        for p in peers:
            p.close()
        peers = []
        fx7, fx_mom7 = fixed_world(n2, flat6, want2, [k], "2")
        _check_bitwise(torch, [flat7, mom7], [fx7, fx_mom7.reshape(-1)],
                       "recover (f): params and momentum after step 7 from "
                       "the manifest vs a fixed two-rank world")
        check(losses[k] == losses[f"fixed_2_{k}"],
              f"(f) step {k} loss {losses[k]} != the fixed world's")
    finally:
        for p in peers:
            p.close()
        server.stop()
        shutil.rmtree(root, ignore_errors=True)
        for key, v in saved_env.items():
            if v is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = v
        chaos.reset()
        timeline.reset()
    # (h) the loss
    main = [losses[k] for k in range(1, RECOVER_LAST + 1)]
    print(f"recover (h): losses of steps 1-{RECOVER_LAST} "
          f"{[round(x, 4) for x in main]}")
    check(main[-1] < main[0], f"(h) the loss did not fall: {main}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    med = {}
    for label, rs_ in rows.items():
        keys = {key for r in rs_ for key in r if key != "loss"}
        med[label] = {key: statistics.median(r[key] for r in rs_ if key in r)
                      for key in keys}
    w_rank0 = [w[2] for w in writes if w[0] == 0]
    w_other = [w[2] for w in writes if w[0] != 0]
    wall = time.perf_counter() - t_phase
    for label in (str(n) for n in RECOVER_RANKS):
        m = med[label]
        print(f"recover step ms at {label} ranks (median of "
              f"{len(rows[label])}): {m['step_ms']:.2f} = grads "
              f"{m['grads_ms']:.2f} + D2H {m['d2h_ms']:.2f} + "
              f"reduce-scatter {m['reduce_scatter_ms']:.2f} + update "
              f"{m['update_ms']:.2f} + all-gather {m['all_gather_ms']:.2f}"
              + "".join(f" + {key[:-3]} {m[key]:.2f}" for key in (
                  "boundary_commit_ms", "buddy_ms", "snapshot_ms",
                  "persist_issue_ms", "persist_fence_ms", "elastic_step_ms")
                  if key in m) + f"; {smi}")
    print(f"recover: persist {manifest_bytes} B in the step-6 manifest; "
          f"writer-thread s per write rank 0 "
          f"{[round(x, 3) for x in w_rank0]}, other ranks median "
          f"{statistics.median(w_other) if w_other else float('nan'):.3f}; "
          f"agree_manifest + restore {restore_s:.3f} s (2 peers started "
          f"with it); pinned {out['pinned_bytes_4']} B at 4 ranks; peak "
          f"device memory {peak:.2f} GiB; phase {wall:.1f} s; {smi}")
    out.update(launches=launches, losses={str(k): v for k, v in
                                          losses.items()},
               step_rows=rows, median=med, persist_writes=writes,
               manifest_bytes=manifest_bytes, restore_s=restore_s,
               peak_gib=peak, wall_s=wall)
    return out


#: the wgmma/TMA kernels: their ptxas report must show no spills and
#: their SASS must hold wgmma (HGMMA) and TMA load (UTMALDG) instructions
def _loss_grads(fn, params, shard):
    """``(loss, gradient tree)`` of ``fn(params, shard)``, one rank's pass."""
    from kungfu_tpu_torch.parallel.train import per_rank_grads
    from kungfu_tpu_torch.utils.tree import tree_flatten, tree_unflatten

    grads = []
    outs, _ = per_rank_grads(fn, params, [shard], lambda r, g: grads.extend(g))
    return outs[0], tree_unflatten(tree_flatten(params)[1], grads)


def _tree_rel_l2(got, ref) -> tuple:
    """Worst relative L2 over the leaves of two trees (denominator
    floored at 1e-3 of the largest leaf norm), with its leaf index."""
    from kungfu_tpu_torch.utils.tree import tree_leaves

    g, r = tree_leaves(got), tree_leaves(ref)
    norms = [t.float().norm().item() for t in r]
    floor = 1e-3 * max(norms)
    return max(((a.float() - b.float()).norm().item() / max(nb, floor), i)
               for i, (a, b, nb) in enumerate(zip(g, r, norms)))


def _trees_equal(torch, a, b) -> bool:
    from kungfu_tpu_torch.utils.tree import tree_leaves

    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                  tree_leaves(b)))


def _peer_spread(torch, trees) -> float:
    """The spread across separate trees: the largest standard deviation
    over the trees of any element of any leaf."""
    from kungfu_tpu_torch.utils.tree import tree_leaves

    leaves = [tree_leaves(t) for t in trees]
    return max(float(torch.stack(ls).float().std(0).max())
               for ls in zip(*leaves))


def _device_digest(torch, t) -> tuple:
    """A digest of a tensor's bytes, taken on the card in slices: two
    weighted sums of its 16-bit words (int64 arithmetic a slice)."""
    w = t.contiguous().view(torch.int16).reshape(-1)
    a = b = 0
    for off in range(0, w.numel(), 1 << 25):
        x = w[off:off + (1 << 25)].to(torch.int64)
        i = torch.arange(off, off + x.numel(), device=x.device,
                         dtype=torch.int64)
        a += int((x * (i % 65521 + 1)).sum())
        b += int((x * (i * 2654435761 % 2147483647)).sum())
    return a, b


def _set_env(pairs: dict) -> dict:
    """Set (or, for None, unset) env vars; returns the old values."""
    old = {k: os.environ.get(k) for k in pairs}
    for k, v in pairs.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    return old


def _time_parts(torch, o, rows) -> dict:
    """Wrap ``o``'s H2D of a pulled model, its average + update and its
    publish with timers (the first two drain the card's queue, so the
    card's time lands in its part); each step's parts in ms are appended
    to ``rows`` at its publish.  Returns the open step's dict, for a
    caller's own parts."""
    t = {}

    def timed(name, fn, drain):
        def run(*a):
            t0 = time.perf_counter()
            res = fn(*a)
            if drain:
                torch.cuda.current_stream().synchronize()
            t[name] = t.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            return res

        return run

    o._deserialize_buf = timed("h2d_ms", o._deserialize_buf, True)
    o._step_fn = timed("average_update_ms", o._step_fn, True)
    publish = timed("publish_ms", o._publish_buf, False)

    def publish_and_row(fused):
        publish(fused)
        rows.append(dict(t))
        t.clear()

    o._publish_buf = publish_and_row
    return t


def phase_gossip(torch, np, kernels, tr, bert):
    """Pair-averaging gossip on bert_base() (phase 10's model, batch and
    loss) over four ``Peer``s from ``start_local_cluster(4,
    devices=["cuda"])``, one thread each, on HostChannel's default
    ``auto`` (native) over TCP on loopback; inner ``sgd(1e-3,
    momentum=0.9)``; rank r's params are the shared init perturbed by
    its own generator.  The ranks' forward and backward run on the main
    thread (in (b) under one lock), one after another, as on every
    co-resident phase.  Checks (a)-(b) of the module docstring."""
    from kungfu_tpu_torch.optimizers import (AsyncPairAveragingOptimizer,
                                             PairAveragingOptimizer, sgd)
    from kungfu_tpu_torch.parallel.train import split_batch
    from kungfu_tpu_torch.peer import start_local_cluster
    from kungfu_tpu_torch.utils.tree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    smi = nvidia_smi()
    model, params, batch, loss_fn = bert
    cfg = model.cfg
    shards = split_batch(batch, RANKS)
    inner = sgd(BERT_LR, momentum=BERT_MOMENTUM)
    per_step = {key: 0 for key in _counts(kernels)}
    per_step.update(_rank_launches(cfg))
    launches = {key: 0 for key in per_step}
    total = sum(t.numel() for t in tree_leaves(params))

    def start(r):
        gen = torch.Generator(device="cuda").manual_seed(1000 + r)
        return tree_map(lambda t: t + GOSSIP_PERTURB * torch.randn(
            t.shape, generator=gen, device=t.device, dtype=t.dtype), params)

    starts = [start(r) for r in range(RANKS)]
    out = {"params": total, "fused_bytes_f32": total * 4,
           "fused_bytes_bf16": total * 2, "card": smi}
    old = _set_env({"KF_TPU_USE_UNIXSOCK": "0", "KF_CHAOS_SPEC": None,
                    "KF_NATIVE_ENGINE": None, "KF_TPU_HOST_TRANSPORT": None,
                    "KF_CONFIG_ENABLE_TRACE": None})
    try:
        out["blocking"] = _gossip_blocking(
            torch, np, kernels, start_local_cluster, PairAveragingOptimizer,
            model, starts, shards, loss_fn, inner, per_step, launches)
        torch.cuda.empty_cache()
        out["async"] = _gossip_async(
            torch, np, kernels, start_local_cluster,
            AsyncPairAveragingOptimizer, starts, shards, loss_fn, inner,
            per_step, launches)
    finally:
        _set_env(old)
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def _gossip_blocking(torch, np, kernels, start_local_cluster, Opt, model,
                     starts, shards, loss_fn, inner, per_step, launches):
    """(a): the blocking optimizer, f32 wire, roundrobin, three steps in
    lockstep: every pulled buffer bitwise the version its target
    published, every peer's params bitwise a single-thread replay of the
    recurrence on the card with no wire, and step 1 held against the
    same step under KF_TPU_ATTN=xla."""
    import types

    from kungfu_tpu_torch.ops import xent
    from kungfu_tpu_torch.ops.fuse import fuse
    from kungfu_tpu_torch.utils.tree import tree_map

    n = RANKS
    peers = start_local_cluster(n, devices=["cuda"])
    try:
        kinds = {type(p.channel).__name__ for p in peers}
        check(kinds == {"NativeHostChannel"},
              f"(a) gossip peers on {kinds}, expected the native channel")
        opts = [Opt(inner, peer=p, name="model", selector="roundrobin")
                for p in peers]
        times = [[] for _ in range(n)]
        pulled = []

        def instrument(r, o):
            t = _time_parts(torch, o, times[r])
            o_pull = o._pull

            def pull(target):
                t0 = time.perf_counter()
                got = o_pull(target)
                t["pull_ms"] = (time.perf_counter() - t0) * 1e3
                want = peers[target].store.get(o.name,
                                               version=str(o._step_count))
                pulled.append((r, target, o._step_count + 1,
                               got is not None and want is not None
                               and np.array_equal(np.asarray(got), want)))
                # lockstep: every peer has pulled before any publishes
                o.peer.barrier()
                return got

            o._pull = pull

        for r, o in enumerate(opts):
            instrument(r, o)
        params = [tree_map(torch.clone, s) for s in starts]
        states = _run_ranks([lambda r=r: opts[r].init(params[r])
                             for r in range(n)], timeout=300)
        # the replay: the same recurrence on the card, no wire
        replay = types.SimpleNamespace(fuse_dtype=torch.float32, inner=inner)
        rp = [tree_map(torch.clone, s) for s in starts]
        rs = [inner.init(p) for p in rp]
        rf = [fuse(p, dtype=torch.float32)[0] for p in rp]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, grads_ms, rows = [], [], []
        for k in range(1, GOSSIP_BLOCKING_STEPS + 1):
            _reset(kernels)
            t0 = time.perf_counter()
            outs = [_loss_grads(loss_fn, params[r], shards[r])
                    for r in range(n)]
            loss = sum(float(x) for x, _ in outs) / n  # synchronises
            grads_ms.append((time.perf_counter() - t0) * 1e3)
            got = _counts(kernels)
            check(got == per_step, f"(a) gossip step {k} launched {got}, "
                  f"expected {per_step}")
            for key, v in got.items():
                launches[key] += v
            losses.append(loss)
            grads = [g for _, g in outs]
            t1 = time.perf_counter()
            res = _run_ranks([lambda r=r: opts[r].step(params[r], grads[r],
                                                       states[r])
                              for r in range(n)], timeout=600)
            rows.append((time.perf_counter() - t1) * 1e3)
            params, states = [x[0] for x in res], [x[1] for x in res]
            # the replay of step k: rank r averages with its roundrobin
            # target's fused params of step k - 1
            new = []
            for r in range(n):
                others = [j for j in range(n) if j != r]
                tgt = others[(k - 1) % len(others)]
                new.append(Opt._step_fn(replay, rp[r], grads[r], rs[r],
                                        rf[tgt]))
            rp, rs, rf = ([x[0] for x in new], [x[1] for x in new],
                          [x[2] for x in new])
            same = [_trees_equal(torch, params[r], rp[r]) for r in range(n)]
            print(f"gossip (a) step {k}: loss {loss:.6f}; params bitwise "
                  f"equal to the replay {same}")
            check(all(same), f"(a) gossip step {k} params differ from the "
                  f"replay: {same}")
            if k == 1:
                p1, g1 = params, grads
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        bad = [p for p in pulled if not p[3]]
        print(f"gossip (a): {len(pulled)} pulls, each bitwise the version "
              f"its target published: {not bad}")
        check(len(pulled) == n * GOSSIP_BLOCKING_STEPS and not bad,
              f"(a) pulled buffers differ from the published ones: {bad}")
        check(all(o.averaged_steps == GOSSIP_BLOCKING_STEPS for o in opts),
              f"(a) averaged steps {[o.averaged_steps for o in opts]}")
        del rp, rs, rf

        # step 1 under KF_TPU_ATTN=xla (not counted): the same average and
        # update from the plain path's gradient
        def loss_xla(p, b):
            logits = model.apply(p, b[0], train=True)
            return xent.softmax_cross_entropy(logits, b[1]).mean()

        saved = _set_env({"KF_TPU_ATTN": "xla"})
        p_rel, g_rel = (0.0, 0), (0.0, 0)
        try:
            for r in range(n):
                _, gx = _loss_grads(loss_xla, starts[r], shards[r])
                tgt = [j for j in range(n) if j != r][0]  # step 1's target
                px = Opt._step_fn(replay, starts[r], gx, inner.init(starts[r]),
                                  fuse(starts[tgt], dtype=torch.float32)[0])[0]
                p_rel = max(p_rel, _tree_rel_l2(p1[r], px))
                g_rel = max(g_rel, _tree_rel_l2(g1[r], gx))
                del gx, px
        finally:
            _set_env(saved)
        print(f"gossip (a) step 1 vs the same step under KF_TPU_ATTN=xla: "
              f"each peer's params worst rel L2 {p_rel[0]:.3e} (leaf "
              f"{p_rel[1]}; tol {TRAIN_GRAD_REL_L2}); each peer's gradient "
              f"worst rel L2 {g_rel[0]:.3e} (leaf {g_rel[1]}, reported: the "
              f"flash backward's q/k gradients at BERT's nearly uniform "
              f"attention, PERF.md section 6)")
        check(p_rel[0] <= TRAIN_GRAD_REL_L2,
              f"(a) step 1 params differ from the xla step's: {p_rel}")
        per = {key: statistics.median([t[key] for r in range(n)
                                       for t in times[r]])
               for key in times[0][0]}
        grads_med = statistics.median(grads_ms)
        step_ms = grads_med + sum(per.values())
        pull_s = sum(o.pull_seconds for o in opts)
        pull_b = sum(o.pull_bytes for o in opts)
        res = {"losses": losses, "grads_ms": grads_ms,
               "threads_wall_ms": rows, "per_peer_median_ms": per,
               "step_ms": step_ms, "pull_gb_s": pull_b / pull_s / 1e9,
               "pull_share_of_step": per["pull_ms"] / step_ms,
               "pinned_landing_bytes": sum(o._recv_buf.nbytes for o in opts),
               # the store's window of three versions a peer
               "pinned_published_bytes": n * 3 * opts[0]._model_nbytes(
                   starts[0]),
               "peak_gib": peak, "params_rel_l2_vs_xla": p_rel[0],
               "grads_rel_l2_vs_xla": g_rel[0]}
        print(f"gossip (a) blocking, f32 wire, {n} peers: step "
              f"{step_ms:.2f} ms = grads of the four ranks in turn "
              f"{grads_med:.2f} ms + per peer (the four threads at once) "
              f"pull {per['pull_ms']:.2f} ms, H2D {per['h2d_ms']:.2f} ms, "
              f"average + update {per['average_update_ms']:.2f} ms, D2H + "
              f"publish {per['publish_ms']:.2f} ms (threads' wall with the "
              f"harness's checks {statistics.median(rows):.2f} ms); pulls "
              f"at {res['pull_gb_s']:.3f} GB/s, "
              f"{res['pull_share_of_step']:.3f} of the step; pinned landing "
              f"buffers {res['pinned_landing_bytes']} B; peak {peak:.2f} GiB")
        return res
    finally:
        for p in peers:
            p.close()


def _gossip_async(torch, np, kernels, start_local_cluster, Opt, starts,
                  shards, loss_fn, inner, per_step, launches):
    """(b): the async optimizer, bf16 wire, random targets, staleness
    bound 4, ten free-running steps a peer: every taken buffer bitwise
    one version a peer other than the taker published, at least nine
    averaged steps a peer, no landing reused more than the bound in a
    row, every puller joined within its bound, a cross-peer spread below
    ten local steps', a falling loss and exact launches.  The digests are
    taken on the card (the fused output before its publish, the copy of
    a taken landing after its H2D) and left out of the step times."""
    import threading

    from kungfu_tpu_torch.ops.fuse import fuse
    from kungfu_tpu_torch.optimizers import apply_updates
    from kungfu_tpu_torch.utils.tree import tree_map

    n = RANKS
    peers = start_local_cluster(n, devices=["cuda"])
    opts = []
    try:
        opts = [Opt(inner, peer=p, name="model-bf16", selector="random",
                    fuse_dtype=torch.bfloat16,
                    max_staleness=GOSSIP_STALENESS) for p in peers]
        published = [set() for _ in range(n)]
        taken = [[] for _ in range(n)]
        parts = [[] for _ in range(n)]
        digest_s = [0.0] * n

        def note(r, t):
            t0 = time.perf_counter()
            d = _device_digest(torch, t)
            digest_s[r] += time.perf_counter() - t0
            return d

        for r, o in enumerate(opts):
            _time_parts(torch, o, parts[r])  # timers inside the digests
            o_pub, o_pub_buf, o_h2d = (o._publish, o._publish_buf,
                                       o._deserialize_buf)

            def publish(params, r=r, orig=o_pub):  # the init's version
                published[r].add(note(r, fuse(params,
                                              dtype=torch.bfloat16)[0]))
                orig(params)

            def publish_buf(fused, r=r, orig=o_pub_buf):
                published[r].add(note(r, fused))  # before it can be served
                orig(fused)

            def h2d(blob, device, r=r, orig=o_h2d):
                other = orig(blob, device)
                taken[r].append(note(r, other))
                return other

            o._publish, o._publish_buf = publish, publish_buf
            o._deserialize_buf = h2d
        params = [tree_map(torch.clone, s) for s in starts]
        states = _run_ranks([lambda r=r: opts[r].init(params[r])
                             for r in range(n)], timeout=300)
        lock = threading.Lock()
        losses = [[] for _ in range(n)]
        reuse = [[] for _ in range(n)]
        step_ms = [[] for _ in range(n)]
        grads_ms = [[] for _ in range(n)]

        def run(r):
            p, s = params[r], states[r]
            for _ in range(GOSSIP_ASYNC_STEPS):
                t0 = time.perf_counter()
                with lock:  # the ranks' passes run in turn on the card
                    t1 = time.perf_counter()
                    loss, g = _loss_grads(loss_fn, p, shards[r])
                    losses[r].append(float(loss))  # synchronises
                    t2 = time.perf_counter()
                h0 = digest_s[r]
                p, s = opts[r].step(p, g, s)
                torch.cuda.current_stream().synchronize()
                t3 = time.perf_counter()
                grads_ms[r].append((t2 - t1) * 1e3)
                # the step's wall, less the harness's digests
                step_ms[r].append((t3 - t0 - (digest_s[r] - h0)) * 1e3)
                reuse[r].append(opts[r]._consumed_same)
            return p

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset(kernels)
        t0 = time.perf_counter()
        final = _run_ranks([lambda r=r: run(r) for r in range(n)],
                           timeout=900)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        got = _counts(kernels)
        want = {k: v * GOSSIP_ASYNC_STEPS for k, v in per_step.items()}
        check(got == want, f"(b) async gossip launched {got}, expected "
              f"{want}")
        for key, v in got.items():
            launches[key] += v
        averaged = [o.averaged_steps for o in opts]
        bad = [(r, i) for r in range(n) for i, d in enumerate(taken[r])
               if not any(d in published[j] for j in range(n) if j != r)]
        print(f"gossip (b): {sum(map(len, taken))} pulled models averaged "
              f"with, each "
              f"bitwise one version another peer published: {not bad}; "
              f"averaged steps {averaged}; landing reuse per step {reuse}")
        check(not bad and all(taken), f"(b) taken buffers match no "
              f"published version: {bad}")
        check(all(a >= GOSSIP_MIN_AVERAGED for a in averaged),
              f"(b) averaged steps {averaged} < {GOSSIP_MIN_AVERAGED}")
        check(max(max(x) for x in reuse) <= GOSSIP_STALENESS,
              f"(b) a landing was reused past the bound: {reuse}")
        pull_s = sum(o.pull_seconds for o in opts)
        pull_b = sum(o.pull_bytes for o in opts)
        landings = [o._puller.seq for o in opts]
        slots = sum(sum(b.nbytes for b in o._puller._slots) for o in opts)
        joins = []
        for o in opts:
            puller, bound = o._puller, 3.0 * o._pull_timeout + 5.0
            t1 = time.perf_counter()
            o.close()
            joins.append(time.perf_counter() - t1)
            check(not puller.is_alive() and joins[-1] <= bound,
                  f"(b) a puller did not join within {bound} s "
                  f"({joins[-1]:.2f} s)")
        mean_loss = [sum(losses[r][k] for r in range(n)) / n
                     for k in range(GOSSIP_ASYNC_STEPS)]
        check(all(math.isfinite(x) for x in mean_loss)
              and mean_loss[-1] < mean_loss[0],
              f"(b) mean loss did not fall: {mean_loss}")
        spread = _peer_spread(torch, final)
        del final, params, states

        # the same ten steps with gossip off (not counted)
        local = []
        for r in range(n):
            p, s = tree_map(torch.clone, starts[r]), inner.init(starts[r])
            for _ in range(GOSSIP_ASYNC_STEPS):
                _, g = _loss_grads(loss_fn, p, shards[r])
                u, s = inner.update(g, s, p)
                p = apply_updates(p, u)
            local.append(p)
            del s
        spread_local = _peer_spread(torch, local)
        del local
        print(f"gossip (b) cross-peer spread after {GOSSIP_ASYNC_STEPS} "
              f"steps: {spread:.4e} with gossip, {spread_local:.4e} with "
              f"local steps only; mean loss {[round(x, 4) for x in mean_loss]}")
        check(spread < spread_local, "(b) gossip did not bring the peers "
              "closer than local steps")
        per = {key: statistics.median([row.get(key, 0.0) for r in range(n)
                                       for row in parts[r]])
               for key in ("h2d_ms", "average_update_ms", "publish_ms")}
        res = {"mean_losses": mean_loss, "averaged_steps": averaged,
               "per_peer_median_ms": per,
               "landings": landings, "reuse": reuse,
               "step_ms": statistics.median(sum(step_ms, [])),
               "grads_ms": statistics.median(sum(grads_ms, [])),
               "wall_s": wall, "pull_gb_s": pull_b / pull_s / 1e9,
               "pull_bytes": pull_b, "close_s": joins,
               "spread": spread, "spread_local": spread_local,
               "pinned_slot_bytes": slots,
               "pinned_published_bytes": n * 3 * opts[0]._model_nbytes(
                   starts[0]),
               "peak_gib": peak}
        print(f"gossip (b) async, bf16 wire, {n} peers free-running: step "
              f"{res['step_ms']:.2f} ms a peer (its own grads "
              f"{res['grads_ms']:.2f} ms, under the lock the four peers "
              f"share; H2D {per['h2d_ms']:.2f} ms, average + update "
              f"{per['average_update_ms']:.2f} ms, D2H + publish "
              f"{per['publish_ms']:.2f} ms; the rest waits for the lock or "
              f"a landing), {GOSSIP_ASYNC_STEPS} steps in {wall:.2f} s; "
              f"{landings} landings at {res['pull_gb_s']:.3f} GB/s per pull; "
              f"close joins {[round(x, 3) for x in joins]} s; pinned slots "
              f"{slots} B; peak {peak:.2f} GiB")
        return res
    finally:
        for o in opts:
            o.close()
        for p in peers:
            p.close()


def phase_adapt(torch, np, kernels, tr, bert):
    """The online adaptation plane: (a) the device bandit over the four
    allreduce schedules on bert_base()'s S-SGD steps over four
    co-resident ranks; (b) the host bandit under injected interference
    (bench.py:1285 payload_adapt's scenario) on three port peers; (c)
    ``AdaptiveStrategyDriver`` and ``monitored_all_reduce`` on the same
    peers.  Checks of the module docstring."""
    t_phase = time.perf_counter()
    out = {"card": nvidia_smi()}
    old = _set_env({"KF_CONFIG_ENABLE_TRACE": "1", "KF_TPU_USE_UNIXSOCK": "0",
                    "KF_CHAOS_SPEC": None, "KF_NATIVE_ENGINE": None,
                    "KF_TPU_HOST_TRANSPORT": None})
    try:
        out["device"] = _adapt_device(torch, np, kernels, bert)
        torch.cuda.empty_cache()
        out.update(_adapt_host(np))
    finally:
        _set_env(old)
    out["launches"] = out["device"].pop("launches")
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def _adapt_device(torch, np, kernels, bert):
    """(a): S-SGD on four co-resident ranks of the card, the fused
    gradient and the loss mean-allreduced through ``comm.all_reduce``,
    ``DeviceBanditDriver(comm, check_every=2, min_pulls=1)`` over every
    schedule."""
    from kungfu_tpu_torch.comm.device import Communicator
    from kungfu_tpu_torch.monitor import timeline
    from kungfu_tpu_torch.monitor.adapt_device import DeviceBanditDriver
    from kungfu_tpu_torch.ops.schedules import (ALLREDUCE_SCHEDULES,
                                                SIZE_BUCKETS, size_bucket)
    from kungfu_tpu_torch.optimizers import apply_updates, sgd
    from kungfu_tpu_torch.parallel.train import per_rank_grads, split_batch
    from kungfu_tpu_torch.policy import ArmStats
    from kungfu_tpu_torch.utils.tree import tree_flatten, tree_unflatten

    model, params, batch, loss_fn = bert
    cfg = model.cfg
    shards = split_batch(batch, RANKS)
    inner = sgd(BERT_LR, momentum=BERT_MOMENTUM)
    leaves, treedef = tree_flatten(params)
    sizes, shapes = [t.numel() for t in leaves], [t.shape for t in leaves]
    total = sum(sizes)
    comm = Communicator(devices=["cuda:0"] * RANKS, local_size=RANKS)
    timeline.reset()
    drv = DeviceBanditDriver(comm, check_every=ADAPT_CHECK_EVERY, min_pulls=1)
    check(drv.table.arms == ALLREDUCE_SCHEDULES,
          f"(a) arms {drv.table.arms}")
    # CUDA events around each allreduce's launches, inside the latency
    # hook's window (the window drains the card's queue on both sides)
    events, records = [], []
    axis_reduce = comm._axis_reduce

    def timed_axis_reduce(*a, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        res = axis_reduce(*a, **kw)
        e1.record()
        events.append((e0, e1))
        return res

    def hook(nbytes, sched, seconds):
        e0, e1 = events[-1]
        events.clear()
        records.append((nbytes, sched, seconds, e0.elapsed_time(e1) / 1e3))
        drv._on_collective(nbytes, sched, seconds)

    comm._axis_reduce = timed_axis_reduce
    comm.set_latency_hook(hook)
    dev = torch.empty((RANKS, total), dtype=torch.float32, device="cuda")

    def sink(r, grads):
        off = 0
        for g, m in zip(grads, sizes):
            dev[r, off:off + m].copy_(g.reshape(-1))
            off += m

    def unflat(flat):
        parts, off = [], 0
        for m, shape in zip(sizes, shapes):
            parts.append(flat[off:off + m].view(shape))
            off += m
        return tree_unflatten(treedef, parts)

    per_step = {key: 0 for key in _counts(kernels)}
    per_step.update(_rank_launches(cfg))
    p, o = params, inner.init(params)
    losses, step_ms, installs = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset(kernels)
    for k in range(1, ADAPT_STEPS + 1):
        t0 = time.perf_counter()
        outs, _ = per_rank_grads(loss_fn, p, shards, sink)
        loss = comm.all_reduce(torch.stack([x.float() for x in outs])[:, None],
                               op="mean")
        red = comm.all_reduce(dev, op="mean")
        u, o = inner.update(unflat(red[0]), o, p)
        p = apply_updates(p, u)
        del red
        losses.append(float(loss[0, 0]))
        swapped = drv.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        installs.append([comm.strategy_for_bucket(b)
                         for b in range(len(SIZE_BUCKETS))])
        print(f"adapt (a) step {k}: loss {losses[-1]:.6f}, installed "
              f"{dict(zip(SIZE_BUCKETS, installs[-1]))}, swapped {swapped}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    comm.set_latency_hook(None)
    comm._axis_reduce = axis_reduce
    got = _counts(kernels)
    ring = sum(1 for _, s, _, _ in records if s == "pallas_ring")
    want = {key: v * ADAPT_STEPS for key, v in per_step.items()}
    want.update(ring_rs=ring, ring_ag=ring)
    print(f"adapt (a) launches {got}, expected {want} ({ring} allreduces "
          f"under pallas_ring, one ring reduce-scatter and all-gather each)")
    check(ring > 0 and got == want, f"(a) launches {got}, expected {want}")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"(a) loss did not fall: {losses}")
    check(len(records) == 2 * ADAPT_STEPS,
          f"(a) the hook saw {len(records)} allreduces")
    short = [(n, s, t, e) for n, s, t, e in records
             if t + HOOK_EVENT_RESOLUTION_S < e]
    check(not short, f"(a) hook latencies below the CUDA-event time of the "
          f"same collective: {short}")
    # the bucket table against a select recomputed from the summary
    summary = drv.summary()
    for b, row in summary.items():
        t = ArmStats(drv.table.arms, min_pulls=1)
        for arm, st in row["arms"].items():
            if st["count"]:
                t.observe(arm, st["mean_s"], count=st["count"])
        check(t.select() == row["active"] == comm.strategy_for_bucket(b),
              f"(a) bucket {SIZE_BUCKETS[b]}: installed "
              f"{comm.strategy_for_bucket(b)}, summary {row['active']}, "
              f"recomputed {t.select()}")
    large = summary[1]["arms"]
    check(all(v["count"] > 0 for v in large.values()),
          f"(a) an arm of the large bucket was never measured: {large}")
    # one swap event per bucket per swap, with the reference's fields
    swaps = [e for e in timeline.snapshot() if e["kind"] == "swap"]
    keys = [(e["attrs"]["seq"], e["attrs"]["bucket"]) for e in swaps]
    check(len(swaps) == drv.swaps > 0 and len(set(keys)) == len(keys)
          and all(e["attrs"]["plane"] == "device"
                  and {"plane", "bucket", "seq", "prev", "step"}
                  <= set(e["attrs"]) for e in swaps),
          f"(a) swap events {swaps} for {drv.swaps} swaps")
    # every arm's reduced gradient against psum's (the last step's)
    comm.set_bucket_strategy(0, None)
    red = {}
    ring_counts = {}
    for arm in ALLREDUCE_SCHEDULES:
        comm.set_bucket_strategy(1, arm)
        _reset(kernels)
        red[arm] = comm.all_reduce(dev, op="mean")[0].clone()
        torch.cuda.synchronize()
        ring_counts[arm] = (kernels[3].launch_counts["ring_rs"],
                            kernels[3].launch_counts["ring_ag"])
    rel = {arm: float(torch.linalg.vector_norm(red[arm] - red["psum"])
                      / torch.linalg.vector_norm(red["psum"]))
           for arm in ALLREDUCE_SCHEDULES}
    del red
    print(f"adapt (a) each arm's reduced gradient vs psum's, rel L2: {rel} "
          f"(tol {ADAPT_ARM_REL_L2}); ring launches {ring_counts}")
    check(all(v <= ADAPT_ARM_REL_L2 for v in rel.values()),
          f"(a) an arm differs from psum: {rel}")
    check(ring_counts["pallas_ring"] == (1, 1)
          and all(ring_counts[a] == (0, 0) for a in ALLREDUCE_SCHEDULES
                  if a != "pallas_ring"), f"(a) ring launches {ring_counts}")
    lat = {}
    for nbytes, sched, t, e in records:
        b = SIZE_BUCKETS[size_bucket(nbytes)]
        lat.setdefault(b, {}).setdefault(sched, []).append((t, e))
    mean_ms = {b: {s: {"hook_ms": 1e3 * sum(t for t, _ in v) / len(v),
                       "event_ms": 1e3 * sum(e for _, e in v) / len(v),
                       "n": len(v)}
                   for s, v in d.items()} for b, d in lat.items()}
    winners = {SIZE_BUCKETS[b]: row["active"] for b, row in summary.items()}
    print(f"adapt (a) mean latency per bucket and arm (hook, CUDA events): "
          f"{json.dumps(mean_ms)}; winners {winners}; {drv.swaps} swaps; "
          f"step {statistics.median(step_ms):.2f} ms median; peak "
          f"{peak:.2f} GiB")
    return {"losses": losses, "step_ms": step_ms, "installs": installs,
            "latency": mean_ms, "winners": winners, "swaps": drv.swaps,
            "rel_l2_vs_psum": rel, "summary": {SIZE_BUCKETS[b]: v for b, v in
                                              summary.items()},
            "peak_gib": peak, "launches": got}


def _adapt_host(np):
    """(b) and (c) on three port peers with 30 ms on the 0<->1 link for
    send and ping; the engines on the Python path (the chaos hooks ride
    it), as bench.py's."""
    import threading
    from collections import Counter

    from kungfu_tpu_torch import chaos
    from kungfu_tpu_torch.monitor import adapt, adaptive, timeline
    from kungfu_tpu_torch.monitor.adapt_device import MST_ARM, HostBanditDriver
    from kungfu_tpu_torch.peer import start_local_cluster
    from kungfu_tpu_torch.plan.graph import Graph
    from kungfu_tpu_torch.plan.mst import minimum_spanning_tree

    os.environ["KF_NATIVE_ENGINE"] = "0"
    os.environ["KF_CHAOS_SPEC"] = ";".join(
        f"delay:ms={HOST_ADAPT_WIRE_MS},rank={a},peer={b},on={on}"
        for a, b in ((0, 1), (1, 0)) for on in ("send", "ping"))
    chaos.reset()
    data = np.ones(HOST_ADAPT_ELEMS, np.float32)

    def measure(p, driver=None):
        t0 = time.perf_counter()
        got = p.engine().all_reduce(data, op="sum")
        dt = time.perf_counter() - t0
        check(bool(np.all(got == 3.0)), f"(b) allreduce gave {got[:4]}")
        return dt, driver.step(dt) if driver is not None else False

    def peers_on(strategy):
        return start_local_cluster(
            3, env={"KF_ALLREDUCE_STRATEGY": strategy}, devices=["cuda"])

    out = {}
    try:
        fixed = {}
        for s in HOST_ADAPT_FIXED_ARMS:
            ps = peers_on(s)
            try:
                times = []
                for _ in range(HOST_ADAPT_FIXED_STEPS):
                    dts = _run_ranks([lambda p=p: measure(p)[0] for p in ps],
                                     timeout=120)
                    times.append(max(dts))
                fixed[s] = statistics.median(times[2:])
            finally:
                for p in ps:
                    p.close()
        timeline.reset()
        ps = peers_on(HOST_ADAPT_FIXED_ARMS[0])
        mats, trees = {}, []
        lock = threading.Lock()
        latency_matrix = adapt.latency_matrix

        def recording_matrix(peer, samples=1):
            m = latency_matrix(peer, samples)
            with lock:
                mats.setdefault(peer.rank(), []).append(m)
            return m

        adapt.latency_matrix = recording_matrix
        for p in ps:
            def set_tree(forest, p=p, orig=p.set_tree):
                orig(forest)
                with lock:  # the matrix this rank's MST was taken from
                    trees.append((p.rank(), len(mats[p.rank()]) - 1,
                                  list(forest),
                                  p.engine()._graphs[0][1].digest_bytes()))

            p.set_tree = set_tree
        try:
            drivers = [HostBanditDriver(p, check_every=2, min_pulls=1,
                                        min_swap_collectives=1) for p in ps]
            times, swap_steps, actives = [], [], []
            for i in range(HOST_ADAPT_STEPS):
                res = _run_ranks([lambda p=p, d=d: measure(p, d)
                                  for p, d in zip(ps, drivers)], timeout=120)
                flags = {s for _, s in res}
                check(len(flags) == 1, f"(b) non-lockstep swap at step {i}")
                times.append(max(dt for dt, _ in res))
                actives.append(drivers[0].active)
                if flags.pop():
                    swap_steps.append(i)
            check(len({d.active for d in drivers}) == 1,
                  f"(b) ranks ended on {[d.active for d in drivers]}")
            evs = [e for e in timeline.snapshot() if e["kind"] == "swap"]
            by_seq = Counter((e["attrs"]["seq"], e["name"]) for e in evs)
            seqs = Counter(e["attrs"]["seq"] for e in evs)
            check(evs and all(v == 3 for v in by_seq.values())
                  and all(v == 3 for v in seqs.values()),
                  f"(b) swap events per seq {dict(by_seq)}")
            check(trees, "(b) the bandit never installed the MST arm")
            for r, k, forest, digest in trees:
                m = mats[r][k]
                check(all(np.array_equal(m, mats[j][k]) for j in mats),
                      "(b) the ranks' latency matrices differ")
                check(forest == minimum_spanning_tree(m)
                      and digest == Graph.from_forest_array(
                          forest).digest_bytes(),
                      f"(b) rank {r} installed {forest}, the MST of its "
                      f"matrix is {minimum_spanning_tree(m)}")
                check(forest[1] != 0 and forest[0] != 1,
                      f"(b) the MST {forest} keeps the 0-1 edge")
            steady = statistics.median(times[-8:])
            best = min(fixed.values())
            print(f"adapt (b) host bandit: swaps at steps {swap_steps}, arms "
                  f"per step {actives}; swap events per seq "
                  f"{ {f'seq{s}:{a}': c for (s, a), c in sorted(by_seq.items())} }; "
                  f"MST installs {[(r, f) for r, _, f, _ in trees]} of the "
                  f"matrix {mats[0][-1].round(5).tolist()}; steady step "
                  f"{steady * 1e3:.2f} ms against the best fixed strategy "
                  f"{min(fixed, key=fixed.get)} "
                  f"{best * 1e3:.2f} ms (fixed {[(k, round(v * 1e3, 2)) for k, v in fixed.items()]})"
                  f"; a host timing, recorded only")
            out["host_bandit"] = {
                "fixed_ms": {k: v * 1e3 for k, v in fixed.items()},
                "steady_ms": steady * 1e3, "step_ms": [t * 1e3 for t in times],
                "swap_steps": swap_steps, "final_arm": drivers[0].active,
                "mst_installs": [f for _, _, f, _ in trees],
                "latency_matrix": mats[0][-1].tolist(),
                "mst_installed": drivers[0].active == MST_ARM}

            # (c) the interference driver on the same peers
            votes = {}
            vote = adaptive.majority_vote_interference

            def recording_vote(peer, suspected):
                agreed = vote(peer, suspected)
                with lock:
                    votes.setdefault(peer.rank(), []).append(agreed)
                return agreed

            adaptive.majority_vote_interference = recording_vote
            try:
                ds = [adaptive.AdaptiveStrategyDriver(p, check_every=2)
                      for p in ps]
                swaps = []
                for i in range(DRIVER_STEPS):
                    res = _run_ranks([lambda p=p, d=d: (
                        adaptive.monitored_all_reduce(p.engine(), data, d),
                        d.swaps) for p, d in zip(ps, ds)], timeout=120)
                    for got, _ in res:
                        check(bool(np.all(got == 3.0)),
                              f"(c) allreduce gave {got[:4]}")
                    swaps.append({s for _, s in res})
                    check(len(swaps[-1]) == 1, f"(c) non-lockstep swap at "
                          f"step {i}: {swaps[-1]}")
            finally:
                adaptive.majority_vote_interference = vote
            check(len(votes) == 3 and all(votes[r] == votes[0]
                                          for r in votes)
                  and len(votes[0]) == DRIVER_STEPS // 2,
                  f"(c) interference votes differ: {votes}")
            print(f"adapt (c) AdaptiveStrategyDriver: votes {votes[0]} on "
                  f"every rank, swaps {[s.pop() for s in swaps]}, strategy "
                  f"{ps[0].engine().strategy}")
            out["interference_driver"] = {"votes": votes[0],
                                          "swaps": ds[0].swaps}
        finally:
            adapt.latency_matrix = latency_matrix
            for p in ps:
                p.close()
    finally:
        chaos.reset()
    return out


WGMMA_KERNELS = ("flash_fwd_bf16_wgmma_kernel",
                 "flash_bwd_dq_bf16_wgmma_kernel",
                 "flash_bwd_dkv_bf16_wgmma_kernel",
                 "lm_head_fwd_wgmma_kernel",
                 "lm_head_bwd_dh_wgmma_kernel",
                 "lm_head_bwd_dw_wgmma_kernel")
#: their instantiations: the flash kernels at D 32/64/128; the LM head's
#: forward, dh and dW, each for f32 and bf16 W
WGMMA_INSTANTIATIONS = 3 * 3 + 3 * 2


def _ptxas_report(log: str) -> dict:
    """{mangled kernel name: its ptxas lines} from an ``-Xptxas -v`` log."""
    import re

    report, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([\w]+)'?", line)
        if m:
            cur = m.group(1)
            report.setdefault(cur, [])
        elif cur is not None and ("registers" in line or "spill" in line):
            report[cur].append(line.strip().replace("ptxas info    : ", ""))
    return report


def _sass_counts(torch, path) -> dict:
    """{mangled kernel name: {"HGMMA": n, "UTMALDG": n}} for the wgmma
    kernels in a built library, from ``cuobjdump --dump-sass``."""
    import re
    from pathlib import Path

    from kungfu_tpu_torch.ops.cuda import _build

    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "--dump-sass", str(path)],
                         capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump exited {out.returncode}: "
          f"{out.stderr.strip()[:500]}")
    counts, cur = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1) if any(k in m.group(1) for k in WGMMA_KERNELS) else None
            if cur:
                counts[cur] = {"HGMMA": 0, "UTMALDG": 0}
        elif cur:
            for op in ("HGMMA", "UTMALDG"):
                counts[cur][op] += bool(re.search(rf"\b{op}\b", line))
    return counts


def build_all(torch, attention, lmk, ringk) -> dict:
    """nvcc for each CUDA source, all started together; then each wgmma
    kernel's ptxas report (no spills allowed) and SASS counts (HGMMA and
    UTMALDG must be there)."""
    import re

    t0 = time.perf_counter()
    loaders = (attention.load, attention.load_bwd, lmk.load, ringk.load)
    with ThreadPoolExecutor(max_workers=len(loaders)) as pool:
        futures = [pool.submit(fn) for fn in loaders]
        built = [f.result() for f in futures]
    wall = time.perf_counter() - t0
    print(f"build: {wall:.2f} s wall")
    info = {"wall_s": wall, "kernels": {}}
    for b in built:
        print(f"  {b.path.name}: nvcc {b.seconds:.2f} s")
        for line in b.log.splitlines():
            # "Performance": ptxas's warning that it serialised wgmma
            if any(w in line for w in ("registers", "spill", "Compiling",
                                       "Performance")):
                print(f"  ptxas: {line.strip()}")
    for b in built[:3]:
        report = _ptxas_report(b.log)
        for fn, counts in _sass_counts(torch, b.path).items():
            lines = report.get(fn, [])
            print(f"wgmma kernel {fn}: {'; '.join(lines)}; SASS HGMMA "
                  f"{counts['HGMMA']}, UTMALDG {counts['UTMALDG']}")
            check(bool(lines), f"{fn}: no ptxas report")
            check(all(re.search(r"\b0 bytes spill stores", ln)
                      for ln in lines if "spill" in ln),
                  f"{fn} spills registers: {lines}")
            check(counts["HGMMA"] > 0 and counts["UTMALDG"] > 0,
                  f"{fn}: SASS without wgmma or TMA loads: {counts}")
            info["kernels"][fn] = {"ptxas": lines, **counts}
    names = " ".join(info["kernels"])
    check(all(k in names for k in WGMMA_KERNELS)
          and len(info["kernels"]) == WGMMA_INSTANTIATIONS,
          f"expected {WGMMA_INSTANTIATIONS} wgmma kernels (flash at D "
          f"32/64/128; LM-head forward, dh and dW for f32 and bf16 W), "
          f"found {names}")
    return info


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; chip_smoke.py "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from kungfu_tpu_torch.models import transformer as tr
    from kungfu_tpu_torch.ops import collectives as rc
    from kungfu_tpu_torch.ops import costmodel
    from kungfu_tpu_torch.ops.cuda import attention
    from kungfu_tpu_torch.ops.cuda import collectives as ringk
    from kungfu_tpu_torch.ops.cuda import lm_head as lmk
    from kungfu_tpu_torch.ops.triton import xent as xk

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
    build = build_all(torch, attention, lmk, ringk)

    # 3. kernels against their plain versions
    t0 = time.perf_counter()
    fwd_errs, fwd_timing = phase_flash_forward(torch, attention, spec)
    bwd_errs, bwd_timing = phase_flash_backward(torch, attention, spec)
    xent_errs, xent_timing = phase_xent(torch, xk, spec)
    torch.cuda.empty_cache()
    lmh_errs, lmh_timing = phase_lm_head(torch, lmk, spec)
    torch.cuda.empty_cache()
    ring_timing = phase_ring(torch, ringk, rc, spec)
    print(f"kernels phase: {time.perf_counter() - t0:.2f} s")

    # 4. + 5. the forward and serving paths, without autograd graphs
    model = tr.Transformer(tr.TransformerConfig(**FLAGSHIP))
    t0 = time.perf_counter()
    params = model.init(torch.Generator().manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    print(f"init: {time.perf_counter() - t0:.2f} s")
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, FLAGSHIP["vocab_size"], size=(4, 256))).cuda()
    with torch.inference_mode():
        fwd = phase_forward(torch, attention, tr, model, params, ids)
        serve = phase_serve(torch, np, attention, model, params)
    del model, params
    torch.cuda.empty_cache()

    # 6. + 7. the training path, plain head then fused LM head; each
    # phase's peak memory is its own timed steps'
    kernels = (attention, xk, lmk, ringk)
    train = phase_train(torch, np, kernels, tr, costmodel, spec, "plain")
    torch.cuda.empty_cache()
    train_fused = phase_train(torch, np, kernels, tr, costmodel, spec, "fused")
    print(f"train, fused LM head against the plain head: "
          f"{train_fused['step_ms']:.2f} vs {train['step_ms']:.2f} ms/step, "
          f"peak {train_fused['peak_gib']:.2f} vs {train['peak_gib']:.2f} GiB")
    torch.cuda.empty_cache()

    # 8. + 9. the same step on four co-resident ranks: S-SGD, then ZeRO
    ssgd, ssgd_p1 = phase_ssgd(torch, np, kernels, tr, train["losses"][0])
    torch.cuda.empty_cache()
    zero2 = phase_zero(torch, np, kernels, tr, 2, ssgd_p1)
    torch.cuda.empty_cache()
    zero3 = phase_zero(torch, np, kernels, tr, 3, ssgd_p1)
    del ssgd_p1
    torch.cuda.empty_cache()

    # 10. bert_base() on the same ranks: SMA, AdaptiveSGD, the monitors
    # and the autotune of the allreduce schedule
    t0 = time.perf_counter()
    bert = _bert_build(torch, np, tr, kernels)
    replicas = phase_replicas(torch, np, kernels, tr, costmodel, spec, bert)
    print(f"replicas phase: {time.perf_counter() - t0:.2f} s")
    torch.cuda.empty_cache()

    # 11. ZeRO-2 through a live 4 -> 2 -> 4 resize of the same ranks
    t0 = time.perf_counter()
    elastic = phase_elastic(torch, np, kernels, tr)
    print(f"elastic phase: {time.perf_counter() - t0:.2f} s")
    torch.cuda.empty_cache()

    # 12. the host engine: system.py's --backend host loop on bert_base()
    host_engine = phase_host_engine(torch, np, kernels, tr, bert,
                                    replicas["gns"])
    print(f"host engine phase: {host_engine['phase_s']:.2f} s")
    torch.cuda.empty_cache()

    # 13. the peer runtime: a rank killed mid-collective, the survivors
    # shrunk and replayed, a whole-job preemption restored from manifests
    recover = phase_recover(torch, np, kernels, tr)
    print(f"recover phase: {recover['wall_s']:.2f} s")
    torch.cuda.empty_cache()

    # 14. pair-averaging gossip on bert_base() over four peers
    gossip = phase_gossip(torch, np, kernels, tr, bert)
    print(f"gossip phase: {gossip['phase_s']:.2f} s")
    torch.cuda.empty_cache()

    # 15. the adaptation plane: the device bandit on bert_base()'s S-SGD
    # steps, the host bandit and the interference driver under chaos
    adapt = phase_adapt(torch, np, kernels, tr, bert)
    print(f"adapt phase: {adapt['phase_s']:.2f} s")
    del bert
    torch.cuda.empty_cache()
    paths = (train, train_fused, ssgd, zero2, zero3, replicas, elastic,
             host_engine, recover, gossip, adapt)

    def row(name, route, source, replaces, key, err, timing, bert=None):
        extra = {k: timing[k] for k in ("plain_head_ms", "bound_fp32_ms",
                                        "bound_executed_ms", "split_ms",
                                        "host_us") if k in timing}
        if bert is not None:  # the same kernel at phase 10's shape
            extra.update({f"bert_{k}": bert[k] for k in (
                "ms", "plain_ms", "bound_ms", "library_ms", "host_us")})
        return {"name": name, "route": route, "source": source,
                "replaces": replaces,
                "launches": (fwd["launches"] + serve["launches"]
                             if key == "flash_fwd" else 0)
                + sum(path["launches"][key] for path in paths),
                "max_abs_err": err,
                **{k: timing[k] for k in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")},
                **extra}

    def ring_row(name, replaces, key, kind):
        # the fused S-SGD shape; the 4 MiB ZeRO bucket at four ranks and
        # at two (phase 11) beside it.  Both kernels are held bitwise, so
        # the error is 0
        out = row(name, "cuda", cu + "ring.cu", replaces, key, 0.0,
                  ring_timing["fused"][kind])
        for label in ("bucket", "bucket_k2"):
            out.update({f"{label}_{k}": ring_timing[label][kind][k] for k in (
                "ms", "plain_ms", "bound_ms", "library_ms", "host_us")})
        return out

    cu = "kungfu_tpu_torch/ops/cuda/csrc/"
    tri = "kungfu_tpu_torch/ops/triton/xent.py"
    pal = "kungfu_tpu/ops/pallas/"
    rows = [
        row("attention._fwd_kernel", "cuda", cu + "flash_fwd.cu",
            pal + "attention.py:77", "flash_fwd",
            fwd_errs["train_main"]["o_err"], fwd_timing["s2048"],
            fwd_timing["bert_s512"]),
        row("attention._bwd_dq_kernel", "cuda", cu + "flash_bwd.cu",
            pal + "attention.py:241", "flash_bwd_dq",
            bwd_errs["main"]["dq_err"], bwd_timing["s2048"]["dq"],
            bwd_timing["bert_s512"]["dq"]),
        row("attention._bwd_dkv_kernel", "cuda", cu + "flash_bwd.cu",
            pal + "attention.py:288", "flash_bwd_dkv",
            bwd_errs["main"]["dkv_err"], bwd_timing["s2048"]["dkv"],
            bwd_timing["bert_s512"]["dkv"]),
        row("xent._fwd_kernel", "triton", tri, pal + "xent.py:49",
            "xent_fwd", xent_errs["main"]["loss_err"],
            xent_timing["main"]["fwd"], xent_timing["bert"]["fwd"]),
        row("xent._bwd_kernel", "triton", tri, pal + "xent.py:163",
            "xent_bwd", xent_errs["main"]["dlogits_err"],
            xent_timing["main"]["bwd"], xent_timing["bert"]["bwd"]),
        row("lm_head._fwd_kernel", "cuda", cu + "lm_head.cu",
            pal + "lm_head.py:60", "lm_head_fwd",
            lmh_errs["main"]["loss_err"], lmh_timing["fwd"]),
        row("lm_head._bwd_dh_kernel", "cuda", cu + "lm_head.cu",
            pal + "lm_head.py:113", "lm_head_bwd_dh",
            lmh_errs["main"]["dh_err"], lmh_timing["dh"]),
        row("lm_head._bwd_dw_kernel", "cuda", cu + "lm_head.cu",
            pal + "lm_head.py:139", "lm_head_bwd_dw",
            lmh_errs["main"]["dw_err"], lmh_timing["dw"]),
        ring_row("collectives._rs_kernel", pal + "collectives.py:287",
                 "ring_rs", "rs"),
        ring_row("collectives._ag_kernel", pal + "collectives.py:359",
                 "ring_ag", "ag"),
    ]
    for k in rows:
        check(k["launches"] > 0, f"{k['name']} never launched on the main path")
    for key in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "xent_fwd",
                "xent_bwd", "ring_rs", "ring_ag"):
        check(replicas["launches"][key] > 0,
              f"phase 10 never launched {key}")
        check(elastic["launches"][key] > 0,
              f"phase 11 never launched {key}")
    for key in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "xent_fwd",
                "xent_bwd"):
        check(host_engine["launches"][key] > 0,
              f"phase 12 never launched {key}")
        check(recover["launches"][key] > 0,
              f"phase 13 never launched {key}")
        check(gossip["launches"][key] > 0,
              f"phase 14 never launched {key}")
    for key in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "xent_fwd",
                "xent_bwd", "ring_rs", "ring_ag"):
        check(adapt["launches"][key] > 0, f"phase 15 never launched {key}")
    print("details: " + json.dumps({
        "forward": fwd, "serve": serve, "train": train,
        "train_fused_head": train_fused, "ssgd_4_ranks": ssgd,
        "zero2_4_ranks": zero2, "zero3_4_ranks": zero3,
        "replicas_bert_4_ranks": replicas, "elastic_4_2_4": elastic,
        "host_engine_bert_4_ranks": host_engine,
        "recover_gpt_4_3_2": recover, "gossip_bert_4_peers": gossip,
        "adapt_bert_4_ranks_3_peers": adapt,
        "ring_timing": ring_timing, "build": build,
        "flash_fwd_errors": fwd_errs, "flash_fwd_timing": fwd_timing,
        "flash_bwd_errors": bwd_errs, "flash_bwd_timing": bwd_timing,
        "xent_errors": xent_errs, "xent_timing": xent_timing,
        "lm_head_errors": lmh_errs, "lm_head_timing": lmh_timing}))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


def lm_head_case_main(name: str) -> int:
    """``--lm-head-case NAME``: one case of ``LMH_CASES`` (phase 3 runs
    each edge case so), its result as a ``LMH_CASE`` JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from kungfu_tpu_torch.ops.cuda import lm_head as lmk

    torch.backends.cuda.matmul.allow_tf32 = False
    print("LMH_CASE " + json.dumps(lm_head_case(torch, lmk, name)))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--lm-head-case"]:
            sys.exit(lm_head_case_main(sys.argv[2]))
        sys.exit(main())
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        sys.exit(1)
